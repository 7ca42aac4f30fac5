"""Lightweight Kubernetes-shaped object model: the port's own copy of the
subset of ``autoscaler_tpu/kube/objects.py`` that a reconcile tick reads
(resource vectors, pods, nodes, taints, selectors, volumes, and for
scale-down the drain annotations, DaemonSets and PodDisruptionBudgets).

The control plane works on these plain dataclasses; the estimator flattens
them into dense tensors. Only the fields the tick reads are modeled.
The reference's process-global pod-profile id registry is not copied: the
mask engine and the term tensors intern ``Pod.profile_key()`` locally,
per pass.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Resource axis indices inside all dense resource vectors (the resource
# kinds the scheduler's NodeResourcesFit evaluates, plus the pods count).
CPU = 0        # millicores
MEMORY = 1     # bytes
EPHEMERAL = 2  # bytes
GPU = 3        # count
TPU = 4        # count (device-plugin style extended resource)
PODS = 5       # pod-count capacity (always 1 per pod)
NUM_RESOURCES = 6

RESOURCE_NAMES = ("cpu", "memory", "ephemeral-storage", "gpu", "tpu", "pods")

# Taint effects.
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

# Taints the autoscaler itself manages (cluster-autoscaler/utils/taints/
# taints.go ToBeDeletedTaint / DeletionCandidateTaint); templates drop them.
TO_BE_DELETED_TAINT = "ToBeDeletedByClusterAutoscaler"
DELETION_CANDIDATE_TAINT = "DeletionCandidateOfClusterAutoscaler"

# Annotations the scale-down half reads (cluster-autoscaler/utils/drain/
# drain.go:33-43 and core/scaledown/eligibility/eligibility.go:66).
SAFE_TO_EVICT_ANNOTATION = "cluster-autoscaler.kubernetes.io/safe-to-evict"
SCALE_DOWN_DISABLED_ANNOTATION = "cluster-autoscaler.kubernetes.io/scale-down-disabled"
SAFE_TO_EVICT_LOCAL_VOLUMES_ANNOTATION = (
    "cluster-autoscaler.kubernetes.io/safe-to-evict-local-volumes"
)

# Pseudo-resource namespace for the minimal DRA ResourceClaim model: a claim
# of device class <c> becomes the counted extended resource
# "dra.k8s.io/<c>" (Pod.resource_claims folds in at construction).
DRA_CLAIM_PREFIX = "dra.k8s.io/"


@dataclass(frozen=True)
class Resources:
    """A dense resource vector with named accessors.

    cpu is in millicores, memory/ephemeral in bytes, gpu/tpu in device
    counts. ``extended`` carries named extended resources as a sorted
    ((name, qty), ...) tuple; each name is its own fit dimension."""

    cpu_m: float = 0.0
    memory: float = 0.0
    ephemeral: float = 0.0
    gpu: float = 0.0
    tpu: float = 0.0
    pods: float = 0.0
    extended: Tuple[Tuple[str, float], ...] = ()

    def as_tuple(self) -> Tuple[float, ...]:
        return (self.cpu_m, self.memory, self.ephemeral, self.gpu, self.tpu, self.pods)

    @staticmethod
    def _merge_extended(a, b, sign: float) -> Tuple[Tuple[str, float], ...]:
        if not a and not b:
            return ()
        m = dict(a)
        for name, qty in b:
            m[name] = m.get(name, 0.0) + sign * qty
        return tuple(sorted((k, v) for k, v in m.items() if v != 0.0))

    def __add__(self, other: "Resources") -> "Resources":
        base = [a + b for a, b in zip(self.as_tuple(), other.as_tuple())]
        return Resources(
            *base,
            extended=self._merge_extended(self.extended, other.extended, 1.0),
        )

    def __sub__(self, other: "Resources") -> "Resources":
        base = [a - b for a, b in zip(self.as_tuple(), other.as_tuple())]
        return Resources(
            *base,
            extended=self._merge_extended(self.extended, other.extended, -1.0),
        )


@dataclass(frozen=True)
class Toleration:
    """Pod toleration. operator: "Equal" (default) or "Exists". Empty key +
    Exists tolerates all; empty effect matches all effects."""

    key: str = ""
    operator: str = "Equal"
    value: str = ""
    effect: str = ""

    def tolerates(self, taint: "Taint") -> bool:
        if self.operator == "Exists":
            key_ok = self.key == "" or self.key == taint.key
            value_ok = True
        else:
            key_ok = self.key == taint.key
            value_ok = self.value == taint.value
        effect_ok = self.effect == "" or self.effect == taint.effect
        return key_ok and value_ok and effect_ok


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = NO_SCHEDULE


@dataclass(frozen=True)
class LabelSelectorRequirement:
    """One matchExpressions entry: key op values, op in {In, NotIn, Exists,
    DoesNotExist, Gt, Lt}."""

    key: str
    operator: str
    values: Tuple[str, ...] = ()


@dataclass(frozen=True)
class LabelSelector:
    match_labels: Tuple[Tuple[str, str], ...] = ()
    match_expressions: Tuple[LabelSelectorRequirement, ...] = ()

    @staticmethod
    def from_dict(d: Optional[Dict[str, str]]) -> "LabelSelector":
        return LabelSelector(match_labels=tuple(sorted((d or {}).items())))

    def matches(self, labels: Dict[str, str]) -> bool:
        for k, v in self.match_labels:
            if labels.get(k) != v:
                return False
        for req in self.match_expressions:
            val = labels.get(req.key)
            if req.operator == "In":
                if val is None or val not in req.values:
                    return False
            elif req.operator == "NotIn":
                if val is not None and val in req.values:
                    return False
            elif req.operator == "Exists":
                if val is None:
                    return False
            elif req.operator == "DoesNotExist":
                if val is not None:
                    return False
            elif req.operator == "Gt":
                if val is None or not _num_cmp(val, req.values, lambda a, b: a > b):
                    return False
            elif req.operator == "Lt":
                if val is None or not _num_cmp(val, req.values, lambda a, b: a < b):
                    return False
            else:
                return False
        return True


def _num_cmp(val: str, values: Tuple[str, ...], op) -> bool:
    try:
        return bool(values) and op(int(val), int(values[0]))
    except ValueError:
        return False


@dataclass(frozen=True)
class PodAffinityTerm:
    """One required pod (anti-)affinity term."""

    selector: LabelSelector
    topology_key: str
    namespaces: Tuple[str, ...] = ()  # empty = pod's own namespace


@dataclass(frozen=True)
class Affinity:
    """Required scheduling constraints (the predicate-relevant subset)."""

    node_selector_terms: Tuple[LabelSelector, ...] = ()  # ORed terms
    pod_affinity: Tuple[PodAffinityTerm, ...] = ()       # ANDed
    pod_anti_affinity: Tuple[PodAffinityTerm, ...] = ()  # ANDed


@dataclass(frozen=True)
class TopologySpreadConstraint:
    """PodTopologySpread filter input. Only when_unsatisfiable=
    "DoNotSchedule" is a hard predicate: the host mask engine applies it
    against placed pods, and the estimator's dynamic scan against the pods
    it places itself."""

    max_skew: int
    topology_key: str
    selector: LabelSelector
    when_unsatisfiable: str = "DoNotSchedule"
    min_domains: Optional[int] = None
    node_affinity_policy: str = "Honor"
    node_taints_policy: str = "Ignore"
    match_label_keys: Tuple[str, ...] = ()


@dataclass(frozen=True)
class OwnerRef:
    kind: str = ""
    name: str = ""
    controller: bool = True


@dataclass(frozen=True)
class LegacyVolume:
    """An inline legacy in-tree volume source subject to the
    VolumeRestrictions same-volume conflict rules:

    - ``gce-pd``:  conflict unless BOTH mounts read-only
    - ``aws-ebs``: conflict ALWAYS
    - ``iscsi``:   conflict unless both read-only
    - ``rbd``:     conflict when the monitor lists overlap and not both
      read-only
    """

    kind: str                          # gce-pd | aws-ebs | iscsi | rbd
    key: str
    read_only: bool = False
    monitors: Tuple[str, ...] = ()     # rbd only

    def conflicts(self, other: "LegacyVolume") -> bool:
        if self.kind != other.kind or self.key != other.key:
            return False
        if self.kind == "aws-ebs":
            return True
        if self.kind == "rbd" and not (
            set(self.monitors) & set(other.monitors)
        ):
            return False
        return not (self.read_only and other.read_only)


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    requests: Resources = field(default_factory=Resources)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)
    affinity: Optional[Affinity] = None
    topology_spread: Tuple[TopologySpreadConstraint, ...] = ()
    owner_ref: Optional[OwnerRef] = None
    priority: int = 0
    # spec.preemptionPolicy: "" (= PreemptLowerPriority) or "Never"
    preemption_policy: str = ""
    node_name: str = ""          # "" = unscheduled/pending
    host_ports: Tuple[int, ...] = ()
    # (csi driver, volume handle) pairs the pod mounts (NodeVolumeLimits)
    csi_volumes: Tuple[Tuple[str, str], ...] = ()
    # per bound volume: the PV's required node-affinity terms (ORed within
    # a volume, volumes ANDed)
    volume_node_affinity: Tuple[Tuple[LabelSelector, ...], ...] = ()
    # ReadWriteOncePod claims the pod mounts
    rwop_handles: Tuple[str, ...] = ()
    # inline legacy in-tree volume sources (same-volume node conflicts)
    legacy_volumes: Tuple[LegacyVolume, ...] = ()
    mirror: bool = False
    daemonset: bool = False
    restartable: bool = True
    local_storage: bool = False
    creation_ts: float = 0.0
    deletion_ts: Optional[float] = None
    phase: str = ""
    # (device class, devices) pairs, folded into requests.extended under
    # "dra.k8s.io/<class>" at construction
    resource_claims: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.resource_claims:
            want: Dict[str, float] = {}
            for cls, n in self.resource_claims:
                k = DRA_CLAIM_PREFIX + cls
                want[k] = want.get(k, 0.0) + float(n)
            cur = dict(self.requests.extended)
            cur.update(want)
            self.requests = dataclasses.replace(
                self.requests, extended=tuple(sorted(cur.items()))
            )

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def profile_key(self) -> tuple:
        """(namespace, sorted label items): the identity of a pod's
        selector verdicts, used by the profile factorization of the mask
        engine and the term tensors. Memoized on the instance; labels are
        never mutated after construction."""
        pk = self.__dict__.get("_profile_key")
        if pk is None:
            pk = (self.namespace, tuple(sorted(self.labels.items())))
            self.__dict__["_profile_key"] = pk
        return pk

    def effective_requests(self) -> Resources:
        """The requests with the pods count at 1: what the pod charges a
        node (a template's daemon overhead sums these)."""
        return dataclasses.replace(self.requests, pods=1.0)


@dataclass
class Node:
    name: str
    allocatable: Resources = field(default_factory=Resources)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    ready: bool = True
    unschedulable: bool = False
    creation_ts: float = 0.0
    provider_id: str = ""
    # CSI driver → max attachable volumes; absent drivers are unlimited
    csi_attach_limits: Dict[str, int] = field(default_factory=dict)
    # template nodes only: DaemonSet/mirror overhead a new node boots with
    daemon_overhead: Resources = field(default_factory=Resources)

    def packing_capacity(self) -> Resources:
        """allocatable minus daemon overhead, floored at zero — what pending
        pods may actually claim on a fresh node of this shape."""
        reduced = self.allocatable - self.daemon_overhead
        return Resources(
            *[max(v, 0.0) for v in reduced.as_tuple()],
            extended=tuple(
                (name, max(qty, 0.0)) for name, qty in reduced.extended
            ),
        )


@dataclass
class DaemonSet:
    """The slice of an apps/v1 DaemonSet the autoscaler needs: identity for
    is-it-running-here checks, scheduling constraints for is-it-suitable
    checks, and per-pod requests for capacity charging (--force-ds,
    reference simulator/nodes.go:56 GetDaemonSetPodsForNode)."""

    name: str
    namespace: str = "default"
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)
    requests: Resources = field(default_factory=Resources)
    # required node affinity from the DS pod template (ORed terms), the
    # scheduling-style DS targeting (reference simulator/nodes.go:38-56)
    node_selector_terms: Tuple[LabelSelector, ...] = ()

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def suitable_for(self, node: "Node") -> bool:
        """nodeSelector subset-match + required node affinity + taint
        toleration, through a pod proxy so the selector, affinity and taint
        semantics are the filter plugins' own."""
        proxy = Pod(
            name=self.name,
            namespace=self.namespace,
            node_selector=dict(self.node_selector),
            tolerations=list(self.tolerations),
            affinity=(
                Affinity(node_selector_terms=self.node_selector_terms)
                if self.node_selector_terms else None
            ),
        )
        return node_matches_selector(proxy, node) and pod_tolerates_taints(
            proxy, node.taints
        )


@dataclass
class PodDisruptionBudget:
    name: str
    namespace: str = "default"
    selector: LabelSelector = field(default_factory=LabelSelector)
    disruptions_allowed: int = 0

def pod_tolerates_taints(pod: Pod, taints: List[Taint]) -> bool:
    """NoSchedule/NoExecute taints block scheduling unless tolerated
    (PreferNoSchedule is soft and never blocks)."""
    for taint in taints:
        if taint.effect == PREFER_NO_SCHEDULE:
            continue
        if not any(tol.tolerates(taint) for tol in pod.tolerations):
            return False
    return True


# Sentinel label key carrying node.name into selector matching, for PV
# matchFields on metadata.name.
NODE_NAME_FIELD_KEY = "__field.metadata.name"


def pod_volumes_match_node(pod: Pod, node: Node) -> bool:
    """Bound-PV node affinity: every volume's required terms must admit the
    node."""
    if not pod.volume_node_affinity:
        return True
    labels = {**node.labels, NODE_NAME_FIELD_KEY: node.name}
    for terms in pod.volume_node_affinity:
        if terms and not any(t.matches(labels) for t in terms):
            return False
    return True


def node_matches_selector(pod: Pod, node: Node) -> bool:
    """nodeSelector + required node affinity (NodeAffinity filter)."""
    for k, v in pod.node_selector.items():
        if node.labels.get(k) != v:
            return False
    if pod.affinity and pod.affinity.node_selector_terms:
        labels = {**node.labels, NODE_NAME_FIELD_KEY: node.name}
        if not any(t.matches(labels) for t in pod.affinity.node_selector_terms):
            return False
    return True
