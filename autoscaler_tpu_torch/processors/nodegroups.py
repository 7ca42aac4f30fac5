"""Node autoprovisioning (NAP): invent node groups from pending pod shapes.

Reference: cluster-autoscaler/processors/nodegroups/ — NodeGroupListProcessor
(the extension point the orchestrator calls at orchestrator.go:124 to extend
the candidate group list) and NodeGroupManager (group lifecycle; deletion of
empty autoprovisioned groups lives in processors/pipeline.NodeGroupManager).
The orchestrator creates the group for real only when an autoprovisioned
candidate wins the expander (orchestrator.go:217 CreateNodeGroup).

A candidate is built per pod equivalence group that no existing template can
host, from a machine-shape catalog (for GCE/TPU pools: gce.MACHINE_TYPES),
choosing the cheapest shape that fits the pod. Candidate templates carry the
pod's nodeSelector labels so the predicate mask admits the pods onto them.

The port's copy of ``autoscaler_tpu/processors/nodegroups.py``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from autoscaler_tpu_torch.cloudprovider.interface import (
    CloudProvider,
    Instance,
    NodeGroup,
    NodeGroupError,
)
from autoscaler_tpu_torch.kube import objects as k8s
from autoscaler_tpu_torch.kube.objects import Node, Pod, Resources


@dataclass
class MachineShape:
    name: str
    cpu_m: float
    memory: float
    gpu: float = 0.0
    tpu: float = 0.0
    price_per_hour: float = 1.0
    pods: float = 110.0


DEFAULT_SHAPES = [
    MachineShape("small-2", 2000, 8 * 1024**3, price_per_hour=0.07),
    MachineShape("medium-4", 4000, 16 * 1024**3, price_per_hour=0.13),
    MachineShape("large-8", 8000, 32 * 1024**3, price_per_hour=0.27),
    MachineShape("xlarge-16", 16000, 64 * 1024**3, price_per_hour=0.54),
    MachineShape("gpu-8", 8000, 30 * 1024**3, gpu=1, price_per_hour=2.8),
    MachineShape("tpu-v5e-4", 112000, 192 * 1024**3, tpu=4, price_per_hour=4.8),
]


class CandidateNodeGroup(NodeGroup):
    """A not-yet-existing group: exist() is False until the orchestrator
    calls create() (which registers it with the provider via the factory)."""

    def __init__(
        self,
        name: str,
        template: Node,
        max_size: int,
        factory: Callable[["CandidateNodeGroup"], NodeGroup],
        price_per_hour: float = 1.0,
    ):
        self._name = name
        self._template = template
        self._max = max_size
        self._factory = factory
        self.price_per_hour = price_per_hour

    def id(self) -> str:
        return self._name

    def min_size(self) -> int:
        return 0

    def max_size(self) -> int:
        return self._max

    def target_size(self) -> int:
        return 0

    def exist(self) -> bool:
        return False

    def autoprovisioned(self) -> bool:
        return True

    def create(self) -> NodeGroup:
        return self._factory(self)

    def increase_size(self, delta: int) -> None:
        raise NodeGroupError(f"group {self._name} does not exist yet; create() first")

    def delete_nodes(self, nodes: Sequence[Node]) -> None:
        raise NodeGroupError("candidate group has no nodes")

    def decrease_target_size(self, delta: int) -> None:
        raise NodeGroupError("candidate group has no target")

    def nodes(self) -> List[Instance]:
        return []

    def template_node_info(self) -> Node:
        return self._template


def _affinity_label_candidates(pod: Pod):
    """Yield label dicts that could satisfy the pod's required node affinity,
    one per ORed node-selector term (synthesizable expressions only:
    matchLabels, In → first value, Exists → marker). A pod that places itself
    via affinity instead of nodeSelector must still get a candidate template
    carrying those labels, or its own candidate group rejects it forever."""
    if not (pod.affinity and pod.affinity.node_selector_terms):
        yield {}
        return
    for term in pod.affinity.node_selector_terms:
        labels = {k: v for k, v in term.match_labels}
        ok = True
        for req in term.match_expressions:
            if req.operator == "In" and req.values:
                labels[req.key] = req.values[0]
            elif req.operator == "Exists":
                labels.setdefault(req.key, "true")
            elif req.operator in ("NotIn", "DoesNotExist"):
                continue  # absence satisfies
            else:
                ok = False  # Gt/Lt: don't guess numeric label values
                break
        if ok:
            yield labels


def _pod_fits_template(pod: Pod, template: Node) -> bool:
    req, alloc = pod.requests, template.allocatable
    if (
        req.cpu_m > alloc.cpu_m
        or req.memory > alloc.memory
        or req.gpu > alloc.gpu
        or req.tpu > alloc.tpu
    ):
        return False
    return (
        k8s.pod_tolerates_taints(pod, template.taints)
        and k8s.node_matches_selector(pod, template)
        and k8s.pod_volumes_match_node(pod, template)
    )


class AutoprovisioningNodeGroupListProcessor:
    """reference NodeGroupListProcessor.Process: returns EXTRA candidate
    groups for pods no existing group can host."""

    def __init__(
        self,
        group_factory: Callable[[CandidateNodeGroup], NodeGroup],
        shapes: Sequence[MachineShape] = tuple(DEFAULT_SHAPES),
        max_autoprovisioned_groups: int = 15,
        max_group_size: int = 100,
    ):
        self.group_factory = group_factory
        self.shapes = sorted(shapes, key=lambda s: s.price_per_hour)
        self.max_autoprovisioned_groups = max_autoprovisioned_groups
        self.max_group_size = max_group_size

    def process(
        self,
        provider: CloudProvider,
        pending_pods: Sequence[Pod],
        existing_groups: Sequence[NodeGroup],
    ) -> List[NodeGroup]:
        budget = self.max_autoprovisioned_groups - sum(
            1 for g in existing_groups if g.autoprovisioned()
        )
        if budget <= 0:
            return []
        templates = []
        existing_ids = {g.id() for g in existing_groups}
        for g in existing_groups:
            try:
                templates.append(g.template_node_info())
            except Exception:
                continue

        candidates: Dict[str, CandidateNodeGroup] = {}
        for pod in pending_pods:
            if any(_pod_fits_template(pod, t) for t in templates):
                continue
            shape = self._cheapest_shape_for(pod)
            if shape is None:
                continue
            template = None
            name = ""
            for aff_labels in _affinity_label_candidates(pod):
                labels = {**aff_labels, **pod.node_selector}
                name = self._group_name(shape, pod, labels)
                cand = Node(
                    name=f"{name}-template",
                    allocatable=Resources(
                        cpu_m=shape.cpu_m,
                        memory=shape.memory,
                        gpu=shape.gpu,
                        tpu=shape.tpu,
                        pods=shape.pods,
                    ),
                    labels={"kubernetes.io/hostname": f"{name}-template", **labels},
                )
                # the pod must accept its own candidate, or the group would be
                # rebuilt (dead) every loop while the pod stays pending
                if _pod_fits_template(pod, cand):
                    template = cand
                    break
            if template is None:
                continue
            # a name collision with a live group (e.g. its template fetch
            # failed this loop) must not re-create/overwrite that group
            if name in candidates or name in existing_ids:
                continue
            candidates[name] = CandidateNodeGroup(
                name,
                template,
                self.max_group_size,
                self.group_factory,
                shape.price_per_hour,
            )
            if len(candidates) >= budget:
                break
        return list(candidates.values())

    def _cheapest_shape_for(self, pod: Pod) -> Optional[MachineShape]:
        req = pod.requests
        for shape in self.shapes:  # sorted by price
            if (
                req.cpu_m <= shape.cpu_m
                and req.memory <= shape.memory
                and req.gpu <= shape.gpu
                and req.tpu <= shape.tpu
            ):
                return shape
        return None

    @staticmethod
    def _group_name(shape: MachineShape, pod: Pod, labels=None) -> str:
        key = sorted(labels.items()) if labels is not None else sorted(
            pod.node_selector.items()
        )
        sel = hashlib.sha1(repr(key).encode()).hexdigest()[:6]
        return f"nap-{shape.name}-{sel}"
