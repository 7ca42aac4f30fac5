"""Cluster API (CAPI) cloud provider: MachineDeployment/MachineSet-backed
node groups over the management cluster's CRD API.

Reference: cluster-autoscaler/cloudprovider/clusterapi/ — annotation-driven
discovery (clusterapi_utils.go:30-38 capacity keys, :254-281 the
CAPI_GROUP-derived min/max/machine/delete-machine keys), node group
semantics (clusterapi_nodegroup.go:78 IncreaseSize via the scale
subresource, :95 DeleteNodes = membership check + min-bound + delete-machine
annotation + replicas-1, :244 TemplateNodeInfo from capacity annotations
gated on CanScaleFromZero, :335 newNodeGroupFromScalableResource's
max-min>=1 and zero-replica gates), and the controller's node→machine→owner
resolution (clusterapi_controller.go:579 nodeGroupForNode).

This adapter matters beyond its own distro: Cluster API is the generic
machine-management layer most on-prem and multi-cloud Kubernetes distros
scale through, and unlike the hyperscaler adapters it needs NO cloud
egress — the "cloud" is the management cluster's own API server, which this
repo already speaks natively (kube/client.KubeRestClient). The transport is
an injectable `CapiApi` in the same shape as gce.GceApi: `InMemoryCapiApi`
for tests/dry-runs, `RestCapiApi` for a real management cluster.

TPU-first note: capacity annotations may carry a `gpu-count`; TPU pools
surface through the generic extended-resource path instead (the template's
labels annotation can pin `gke-tpu-accelerator`-style selectors, and
device-plugin capacity rides Resources.extended via DRA or named extended
resources — PREDICATES divergence 4).

The port's copy of ``autoscaler_tpu/cloudprovider/clusterapi.py``.
"""
from __future__ import annotations

import abc
import copy
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.cloudprovider.interface import (
    CloudProvider,
    Instance,
    InstanceErrorClass,
    InstanceErrorInfo,
    InstanceState,
    NodeGroup,
    NodeGroupError,
    ResourceLimiter,
)
from autoscaler_tpu_torch.kube.convert import parse_cpu_millis, parse_quantity
from autoscaler_tpu_torch.kube.objects import Node, Resources, Taint


def capi_group() -> str:
    """API group for all CAPI objects; CAPI_GROUP env overrides, matching
    the reference's getCAPIGroup (clusterapi_utils.go:245)."""
    return os.environ.get("CAPI_GROUP", "cluster.x-k8s.io")


def min_size_key() -> str:
    return f"{capi_group()}/cluster-api-autoscaler-node-group-min-size"


def max_size_key() -> str:
    return f"{capi_group()}/cluster-api-autoscaler-node-group-max-size"


def machine_annotation_key() -> str:
    """Node annotation naming its Machine as 'ns/name'."""
    return f"{capi_group()}/machine"


def delete_machine_key() -> str:
    return f"{capi_group()}/delete-machine"


# capacity.<group> scale-from-zero annotation keys (clusterapi_utils.go:31)
_CAP_PREFIX = "capacity.cluster-autoscaler.kubernetes.io/"
CPU_KEY = _CAP_PREFIX + "cpu"
MEMORY_KEY = _CAP_PREFIX + "memory"
DISK_KEY = _CAP_PREFIX + "ephemeral-disk"
GPU_COUNT_KEY = _CAP_PREFIX + "gpu-count"
MAX_PODS_KEY = _CAP_PREFIX + "maxPods"
LABELS_KEY = _CAP_PREFIX + "labels"
TAINTS_KEY = _CAP_PREFIX + "taints"

_KIND_PLURAL = {
    "MachineDeployment": "machinedeployments",
    "MachineSet": "machinesets",
    "Machine": "machines",
}


def cluster_name_label() -> str:
    return f"{capi_group()}/cluster-name"


class AutoDiscoverySpec:
    """One parsed --node-group-auto-discovery entry:
    'clusterapi:namespace=ns,clusterName=c,key=value,...' — unknown keys
    are exact-match label requirements (clusterapi_autodiscovery.go:37)."""

    def __init__(self, spec: str):
        discoverer, sep, body = spec.partition(":")
        if not sep or discoverer != "clusterapi":
            raise ValueError(
                f"spec {spec!r} should be clusterapi:key=value,key=value"
            )
        self.namespace = ""
        self.cluster_name = ""
        self.labels: Dict[str, str] = {}
        for arg in body.split(","):
            if not arg:
                continue
            k, s, v = arg.partition("=")
            if not s:
                raise ValueError(f"invalid key=value pair {arg!r} in {spec!r}")
            if k == "namespace":
                self.namespace = v
            elif k == "clusterName":
                self.cluster_name = v
            else:
                self.labels[k] = v

    def allows(self, obj: dict) -> bool:
        meta = _meta(obj)
        if self.namespace and self.namespace != meta.get("namespace", "default"):
            return False
        if self.cluster_name and self.cluster_name != _cluster_name_of(obj):
            return False
        labels = meta.get("labels") or {}
        return all(labels.get(k) == v for k, v in self.labels.items())


def _cluster_name_of(obj: dict) -> str:
    """spec.clusterName when present (v1alpha3+), else the cluster-name
    label (clusterapi_utils.go:232 clusterNameFromResource)."""
    name = (obj.get("spec") or {}).get("clusterName")
    if name:
        return str(name)
    return (_meta(obj).get("labels") or {}).get(cluster_name_label(), "")


class CapiApi(abc.ABC):
    """Management-cluster transport for the CAPI objects the provider
    consumes. Objects travel as raw dicts (the CRD JSON shape)."""

    @abc.abstractmethod
    def list_scalables(self) -> List[dict]:
        """All MachineDeployments + MachineSets, cluster-wide."""

    @abc.abstractmethod
    def list_machines(self, namespace: str) -> List[dict]: ...

    @abc.abstractmethod
    def get_scale(self, kind: str, namespace: str, name: str) -> int: ...

    @abc.abstractmethod
    def set_scale(
        self, kind: str, namespace: str, name: str, replicas: int
    ) -> None: ...

    @abc.abstractmethod
    def annotate_machine(
        self, namespace: str, name: str, key: str, value: Optional[str]
    ) -> None:
        """Set (or clear, when value is None) one machine annotation."""


class InMemoryCapiApi(CapiApi):
    """Dict-backed management cluster for tests and dry runs."""

    def __init__(self) -> None:
        self.objects: Dict[Tuple[str, str, str], dict] = {}  # (kind, ns, name)
        self.writes: List[tuple] = []

    def add(self, obj: dict) -> dict:
        kind = obj["kind"]
        meta = obj.setdefault("metadata", {})
        key = (kind, meta.get("namespace", "default"), meta["name"])
        self.objects[key] = obj
        return obj

    def list_scalables(self) -> List[dict]:
        return [
            copy.deepcopy(o)
            for (k, _, _), o in sorted(self.objects.items())
            if k in ("MachineDeployment", "MachineSet")
        ]

    def list_machines(self, namespace: str) -> List[dict]:
        return [
            copy.deepcopy(o)
            for (k, ns, _), o in sorted(self.objects.items())
            if k == "Machine" and ns == namespace
        ]

    def get_scale(self, kind: str, namespace: str, name: str) -> int:
        obj = self.objects[(kind, namespace, name)]
        return int(obj.get("spec", {}).get("replicas", 0))

    def set_scale(
        self, kind: str, namespace: str, name: str, replicas: int
    ) -> None:
        obj = self.objects[(kind, namespace, name)]
        obj.setdefault("spec", {})["replicas"] = int(replicas)
        self.writes.append(("scale", kind, namespace, name, replicas))

    def annotate_machine(
        self, namespace: str, name: str, key: str, value: Optional[str]
    ) -> None:
        obj = self.objects[("Machine", namespace, name)]
        ann = obj.setdefault("metadata", {}).setdefault("annotations", {})
        if value is None:
            ann.pop(key, None)
        else:
            ann[key] = value
        self.writes.append(("annotate", namespace, name, key, value))


class RestCapiApi(CapiApi):
    """KubeRestClient-backed transport: CRD list endpoints + the /scale
    subresource (the reference scales through managementScaleClient,
    clusterapi_unstructured.go:94-128)."""

    def __init__(self, rest, version: str = "v1beta1"):
        self.rest = rest
        self.base = f"/apis/{capi_group()}/{version}"

    def _list(self, plural: str, namespace: Optional[str] = None) -> List[dict]:
        path = (
            f"{self.base}/namespaces/{namespace}/{plural}"
            if namespace
            else f"{self.base}/{plural}"
        )
        return (self.rest.get(path) or {}).get("items", [])

    def list_scalables(self) -> List[dict]:
        out = []
        for kind in ("MachineDeployment", "MachineSet"):
            for obj in self._list(_KIND_PLURAL[kind]):
                obj.setdefault("kind", kind)
                out.append(obj)
        return out

    def list_machines(self, namespace: str) -> List[dict]:
        items = self._list("machines", namespace)
        for obj in items:
            obj.setdefault("kind", "Machine")
        return items

    def get_scale(self, kind: str, namespace: str, name: str) -> int:
        path = f"{self.base}/namespaces/{namespace}/{_KIND_PLURAL[kind]}/{name}/scale"
        return int((self.rest.get(path).get("spec") or {}).get("replicas", 0))

    def set_scale(
        self, kind: str, namespace: str, name: str, replicas: int
    ) -> None:
        path = f"{self.base}/namespaces/{namespace}/{_KIND_PLURAL[kind]}/{name}/scale"
        scale = self.rest.get(path)
        scale.setdefault("spec", {})["replicas"] = int(replicas)
        self.rest.put(path, scale)

    def annotate_machine(
        self, namespace: str, name: str, key: str, value: Optional[str]
    ) -> None:
        path = f"{self.base}/namespaces/{namespace}/machines/{name}"
        self.rest.merge_patch(
            path, {"metadata": {"annotations": {key: value}}}
        )


def _meta(obj: dict) -> dict:
    return obj.get("metadata") or {}


def _annotations(obj: dict) -> Dict[str, str]:
    return _meta(obj).get("annotations") or {}


def _owner_of(obj: dict, kind: str) -> Optional[str]:
    for ref in _meta(obj).get("ownerReferences") or []:
        if ref.get("kind") == kind:
            return ref.get("name")
    return None


def _selector_labels(obj: dict) -> Dict[str, str]:
    return ((obj.get("spec") or {}).get("selector") or {}).get(
        "matchLabels"
    ) or {}


def _matches(selector: Dict[str, str], labels: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def parse_capacity_taints(val: str) -> List[Taint]:
    """'key1=value1:Effect,key2=value2:Effect' → taints (entries that don't
    parse are skipped, as the reference's parseTaint path does)."""
    out: List[Taint] = []
    for part in val.split(","):
        part = part.strip()
        if ":" not in part:
            continue
        kv, effect = part.rsplit(":", 1)
        key, _, value = kv.partition("=")
        if key and effect:
            out.append(Taint(key=key, value=value, effect=effect))
    return out


class CapiScalable:
    """One MachineDeployment or MachineSet with autoscaler annotations —
    the reference's unstructuredScalableResource."""

    def __init__(self, api: CapiApi, obj: dict):
        self.api = api
        self.obj = obj
        self.kind = obj["kind"]
        meta = _meta(obj)
        self.namespace = meta.get("namespace", "default")
        self.name = meta["name"]
        ann = _annotations(obj)
        # raises ValueError on malformed annotations — refresh() logs and
        # skips the one bad resource (the reference's discovery does the
        # same) instead of letting a typo disable autoscaling cluster-wide
        self.min_size = int(ann.get(min_size_key(), 0))
        self.max_size = int(ann.get(max_size_key(), 0))

    @property
    def id(self) -> str:
        # path.Join(Kind, Namespace, Name) — clusterapi_unstructured.go:44
        return f"{self.kind}/{self.namespace}/{self.name}"

    def replicas(self) -> int:
        return self.api.get_scale(self.kind, self.namespace, self.name)

    def set_size(self, n: int) -> None:
        if n > self.max_size:
            raise NodeGroupError(
                f"size increase too large - desired:{n} max:{self.max_size}"
            )
        if n < self.min_size:
            raise NodeGroupError(
                f"size decrease too large - desired:{n} min:{self.min_size}"
            )
        self.api.set_scale(self.kind, self.namespace, self.name, n)

    def machines(self) -> List[dict]:
        sel = _selector_labels(self.obj)
        if not sel:
            return []
        return [
            m
            for m in self.api.list_machines(self.namespace)
            if _matches(sel, _meta(m).get("labels") or {})
        ]

    def capacity(self) -> Optional[Resources]:
        """Scale-from-zero capacity from annotations; None unless BOTH cpu
        and memory are present (CanScaleFromZero,
        clusterapi_unstructured.go:208)."""
        ann = _annotations(self.obj)
        if CPU_KEY not in ann or MEMORY_KEY not in ann:
            return None
        return Resources(
            cpu_m=parse_cpu_millis(ann[CPU_KEY]),
            memory=parse_quantity(ann[MEMORY_KEY]),
            ephemeral=parse_quantity(ann.get(DISK_KEY, 0)),
            gpu=parse_quantity(ann.get(GPU_COUNT_KEY, 0)),
            pods=parse_quantity(ann.get(MAX_PODS_KEY, 110)),
        )

    def template_labels(self) -> Dict[str, str]:
        val = _annotations(self.obj).get(LABELS_KEY, "")
        out: Dict[str, str] = {}
        for part in val.split(","):
            k, sep, v = part.partition("=")
            if sep and k:
                out[k.strip()] = v.strip()
        return out

    def template_taints(self) -> List[Taint]:
        return parse_capacity_taints(_annotations(self.obj).get(TAINTS_KEY, ""))


class CapiNodeGroup(NodeGroup):
    """Reference semantics from clusterapi_nodegroup.go."""

    def __init__(self, provider: "ClusterAPIProvider", scalable: CapiScalable):
        self.provider = provider
        self.scalable = scalable

    def id(self) -> str:
        return self.scalable.id

    def min_size(self) -> int:
        return self.scalable.min_size

    def max_size(self) -> int:
        return self.scalable.max_size

    def target_size(self) -> int:
        return self.scalable.replicas()

    def increase_size(self, delta: int) -> None:
        if delta <= 0:
            raise NodeGroupError("size increase must be positive")
        self.scalable.set_size(self.scalable.replicas() + delta)

    def delete_nodes(self, nodes: Sequence[Node]) -> None:
        replicas = self.scalable.replicas()
        if replicas <= self.min_size():
            raise NodeGroupError("min size reached, nodes will not be deleted")
        # membership check BEFORE any write (clusterapi_nodegroup.go:109)
        for node in nodes:
            owner = self.provider.node_group_for_node(node)
            if owner is None or owner.id() != self.id():
                raise NodeGroupError(
                    f"node {node.name!r} doesn't belong to node group "
                    f"{self.id()!r}"
                )
        if replicas - len(nodes) < self.min_size():
            raise NodeGroupError(
                f"unable to delete {len(nodes)} machines in {self.id()!r}: "
                f"replicas {replicas}, minSize {self.min_size()}"
            )
        for node in nodes:
            machine = self.provider.machine_for_node(node)
            if machine is None:
                raise NodeGroupError(f"unknown machine for node {node.name!r}")
            if _meta(machine).get("deletionTimestamp"):
                continue  # already on its way out
            ns, name = (
                _meta(machine).get("namespace", "default"),
                _meta(machine)["name"],
            )
            self.scalable.api.annotate_machine(
                ns, name, delete_machine_key(), str(time.time())
            )
            try:
                self.scalable.set_size(replicas - 1)
            except Exception:
                # roll the mark back on ANY shrink failure — incl. transport
                # errors (ApiError/timeout), not just bound violations — so
                # the machine isn't condemned by a failed shrink and then
                # reaped on the next unrelated scale-down
                # (clusterapi_nodegroup.go:160-163)
                self.scalable.api.annotate_machine(
                    ns, name, delete_machine_key(), None
                )
                raise
            replicas -= 1

    def decrease_target_size(self, delta: int) -> None:
        if delta >= 0:
            raise NodeGroupError("size decrease must be negative")
        replicas = self.scalable.replicas()
        provisioned = len(self.scalable.machines())
        if replicas + delta < provisioned:
            raise NodeGroupError(
                f"attempt to delete existing nodes: target {replicas + delta} "
                f"< provisioned {provisioned}"
            )
        self.scalable.set_size(replicas + delta)

    def nodes(self) -> List[Instance]:
        out: List[Instance] = []
        for m in self.scalable.machines():
            meta = _meta(m)
            status = m.get("status") or {}
            provider_id = (m.get("spec") or {}).get("providerID")
            phase = (status.get("phase") or "").lower()
            failure = status.get("failureMessage") or ""
            error_info: Optional[InstanceErrorInfo] = None
            if meta.get("deletionTimestamp") or phase == "deleting":
                state = InstanceState.DELETING
            elif failure or phase == "failed":
                # A failed machine must surface InstanceErrorInfo so the
                # core rides the fast deleteCreatedNodesWithErrors path
                # instead of waiting out maxNodeProvisionTime (the
                # reference's failed-machine marker id,
                # clusterapi_controller.go findMachine failure handling;
                # same contract as the gce/external_grpc providers here).
                state = InstanceState.CREATING
                error_info = InstanceErrorInfo(
                    error_class=InstanceErrorClass.OTHER,
                    error_code=status.get("failureReason") or "MachineFailed",
                    error_message=failure or f"machine phase {phase}",
                )
            elif provider_id and phase in ("running", "provisioned", ""):
                state = InstanceState.RUNNING
            else:
                state = InstanceState.CREATING
            out.append(
                Instance(
                    # the capi:// id is STABLE for a failed machine even if
                    # a providerID later appears: deletion by id must find
                    # the same machine the error was reported against
                    id=(
                        f"capi://{meta.get('namespace', 'default')}/{meta['name']}"
                        if error_info is not None
                        else provider_id
                        or f"capi://{meta.get('namespace', 'default')}/{meta['name']}"
                    ),
                    state=state,
                    error_info=error_info,
                )
            )
        return out

    def template_node_info(self) -> Node:
        cap = self.scalable.capacity()
        if cap is None:
            raise NodeGroupError(
                f"{self.id()} cannot scale from zero: no capacity annotations"
            )
        name = f"{self.scalable.name}-template"
        labels = {
            "kubernetes.io/os": "linux",
            "kubernetes.io/arch": "amd64",
            "kubernetes.io/hostname": name,
        }
        labels.update(self.scalable.template_labels())
        return Node(
            name=name,
            allocatable=cap,
            labels=labels,
            taints=self.scalable.template_taints(),
            ready=True,
        )

    def exist(self) -> bool:
        return True

    def autoprovisioned(self) -> bool:
        return False


class ClusterAPIProvider(CloudProvider):
    """CloudProvider over a CAPI management cluster. refresh() re-lists the
    scalable resources; groups are any MachineDeployment/MachineSet with
    max-min >= 1 (annotation-driven discovery), skipping zero-replica groups
    that cannot scale from zero — both gates from
    newNodeGroupFromScalableResource (clusterapi_nodegroup.go:335)."""

    def __init__(self, api: CapiApi, discovery_specs: Sequence["AutoDiscoverySpec"] = ()):
        self.api = api
        self.discovery_specs = list(discovery_specs)
        self._groups: List[CapiNodeGroup] = []
        self._by_id: Dict[str, CapiNodeGroup] = {}
        self._owner_md: Dict[Tuple[str, str], Optional[str]] = {}
        self._machines_cache: Dict[str, List[dict]] = {}
        self.refresh()

    def name(self) -> str:
        return "clusterapi"

    def refresh(self) -> None:
        """Re-list the scalable resources ONCE per loop and derive every
        lookup structure from that snapshot (node_group_for_node and the
        delete-membership loop must not pay full-cluster LISTs per node):
        the group set, the MachineSet→MachineDeployment owner map, and a
        per-namespace machines memo (filled lazily, cleared here)."""
        import logging

        groups: List[CapiNodeGroup] = []
        owner_md: Dict[Tuple[str, str], Optional[str]] = {}
        for obj in self.api.list_scalables():
            meta = _meta(obj)
            ns = meta.get("namespace", "default")
            if obj.get("kind") == "MachineSet":
                owner_md[(ns, meta.get("name", ""))] = _owner_of(
                    obj, "MachineDeployment"
                )
            if self.discovery_specs and not any(
                spec.allows(obj) for spec in self.discovery_specs
            ):
                continue  # outside every autodiscovery scope
            try:
                s = CapiScalable(self.api, obj)
                if s.max_size - s.min_size < 1:
                    continue  # no autoscaler annotations → not managed
                replicas = int((obj.get("spec") or {}).get("replicas", 0))
                if replicas == 0 and s.capacity() is None:
                    continue  # empty and cannot scale from zero
            except (ValueError, TypeError, KeyError) as e:
                # one typo'd annotation must not disable autoscaling for
                # the whole cluster — log and skip the one bad resource
                logging.getLogger("clusterapi").warning(
                    "skipping %s %s/%s: malformed autoscaler annotations "
                    "(%s)", obj.get("kind"), ns, meta.get("name"), e,
                )
                continue
            groups.append(CapiNodeGroup(self, s))
        self._groups = groups
        self._by_id = {g.id(): g for g in groups}
        self._owner_md = owner_md
        self._machines_cache = {}

    def node_groups(self) -> List[NodeGroup]:
        return list(self._groups)

    def _machines(self, namespace: str) -> List[dict]:
        if namespace not in self._machines_cache:
            self._machines_cache[namespace] = self.api.list_machines(namespace)
        return self._machines_cache[namespace]

    def machine_for_node(self, node: Node) -> Optional[dict]:
        """Node → its Machine: the cluster.x-k8s.io/machine annotation
        ('ns/name', the path CAPI maintains on every node), with a
        providerID sweep as fallback (controller.findMachineByProviderID).
        Reads the refresh-scoped machines memo — no per-call LISTs."""
        ref = (node.annotations or {}).get(machine_annotation_key())
        if ref and "/" in ref:
            ns, name = ref.split("/", 1)
            for m in self._machines(ns):
                if _meta(m)["name"] == name:
                    return m
        # capi://ns/name ids (unregistered or FAILED machines reported by
        # CapiNodeGroup.nodes) resolve directly — the core deletes errored
        # instances by the id the provider reported them under
        for pid in (node.provider_id, node.name):
            if pid and pid.startswith("capi://") and "/" in pid[7:]:
                ns, name = pid[7:].split("/", 1)
                for m in self._machines(ns):
                    if _meta(m)["name"] == name:
                        return m
        if node.provider_id:
            for ns in sorted({g.scalable.namespace for g in self._groups}):
                for m in self._machines(ns):
                    if (m.get("spec") or {}).get("providerID") == node.provider_id:
                        return m
        return None

    def node_group_for_node(self, node: Node) -> Optional[NodeGroup]:
        machine = self.machine_for_node(node)
        if machine is None:
            return None
        ns = _meta(machine).get("namespace", "default")
        ms_name = _owner_of(machine, "MachineSet")
        if ms_name is None:
            return None
        # The owning MachineDeployment takes precedence when managed (the
        # common CAPI setup annotates the MachineDeployment); owner map
        # comes from the refresh snapshot
        md_name = self._owner_md.get((ns, ms_name))
        if md_name:
            md_group = self._by_id.get(f"MachineDeployment/{ns}/{md_name}")
            if md_group is not None:
                return md_group
        return self._by_id.get(f"MachineSet/{ns}/{ms_name}")

    def get_resource_limiter(self) -> ResourceLimiter:
        return ResourceLimiter()

    def pricing(self):
        return None


def build_clusterapi_provider(
    rest,
    version: str = "v1beta1",
    auto_discovery: Sequence[str] = (),
) -> ClusterAPIProvider:
    """Provider over a live management cluster (rest = KubeRestClient).
    ``auto_discovery``: raw --node-group-auto-discovery entries; only the
    clusterapi: ones apply (others raise, matching the reference's
    unsupported-discoverer error)."""
    specs = [AutoDiscoverySpec(s) for s in auto_discovery]
    return ClusterAPIProvider(RestCapiApi(rest, version=version), specs)
