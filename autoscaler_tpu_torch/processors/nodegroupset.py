"""Balancing similar node groups: find look-alike groups and spread a
scale-up across them.

Reference: cluster-autoscaler/processors/nodegroupset/ —
BalancingNodeGroupSetProcessor (FindSimilarNodeGroups balancing_processor.go
:37, BalanceScaleUpBetweenGroups :79) and the similarity comparator
compare_nodegroups.go:84,103 (allocatable within 5%, memory capacity within
1.5%, free resources within 5%, matching labels up to an ignore-list of
zone/hostname-style keys).

The port's copy of ``autoscaler_tpu/processors/nodegroupset.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.cloudprovider.interface import NodeGroup
from autoscaler_tpu_torch.config.options import NodeGroupDifferenceRatios
from autoscaler_tpu_torch.kube.objects import Node

# labels ignored when comparing groups (compare_nodegroups.go ignore list)
DEFAULT_IGNORED_LABELS = {
    "kubernetes.io/hostname",
    "topology.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/zone",
    "topology.kubernetes.io/region",
    "failure-domain.beta.kubernetes.io/region",
    "beta.kubernetes.io/instance-type",
    "node.kubernetes.io/instance-type",
}


def _within(a: float, b: float, max_ratio: float) -> bool:
    if a == b:
        return True
    larger = max(abs(a), abs(b))
    if larger == 0:
        return True
    return abs(a - b) / larger <= max_ratio


@dataclass
class BalancingNodeGroupSetProcessor:
    ratios: NodeGroupDifferenceRatios = field(default_factory=NodeGroupDifferenceRatios)
    ignored_labels: set = field(default_factory=lambda: set(DEFAULT_IGNORED_LABELS))
    # non-empty -> the reference's --balancing-label mode: similarity is
    # decided by these label values ALONE (CreateLabelNodeInfoComparator,
    # compare_nodegroups.go:54) — resource/remaining-label comparisons are
    # skipped entirely, per the flag's documented contract
    label_keys: List[str] = field(default_factory=list)

    def is_similar(self, a: Node, b: Node) -> bool:
        """compare_nodegroups.go:84 IsCloudProviderNodeInfoSimilar."""
        if self.label_keys:
            return all(
                a.labels.get(k) == b.labels.get(k) for k in self.label_keys
            )
        if not _within(
            a.allocatable.cpu_m, b.allocatable.cpu_m,
            self.ratios.max_allocatable_difference_ratio,
        ):
            return False
        if not _within(
            a.allocatable.memory, b.allocatable.memory,
            self.ratios.max_capacity_memory_difference_ratio,
        ):
            return False
        if a.allocatable.gpu != b.allocatable.gpu:
            return False
        la = {k: v for k, v in a.labels.items() if k not in self.ignored_labels}
        lb = {k: v for k, v in b.labels.items() if k not in self.ignored_labels}
        return la == lb

    def find_similar_node_groups(
        self,
        group: NodeGroup,
        templates: Dict[str, Node],
        all_groups: Sequence[NodeGroup],
    ) -> List[NodeGroup]:
        """balancing_processor.go:37."""
        base = templates.get(group.id())
        if base is None:
            return []
        out = []
        for other in all_groups:
            if other.id() == group.id():
                continue
            tmpl = templates.get(other.id())
            if tmpl is not None and self.is_similar(base, tmpl):
                out.append(other)
        return out

    def balance_scale_up(
        self, groups: Sequence[NodeGroup], new_nodes: int
    ) -> List[Tuple[NodeGroup, int]]:
        """balancing_processor.go:79 BalanceScaleUpBetweenGroups: even out
        target sizes — repeatedly grow the currently-smallest group, skipping
        full ones."""
        sizes = {g.id(): g.target_size() for g in groups}
        caps = {g.id(): g.max_size() for g in groups}
        by_id = {g.id(): g for g in groups}
        added: Dict[str, int] = {gid: 0 for gid in sizes}
        for _ in range(new_nodes):
            candidates = [
                gid for gid in sizes if sizes[gid] + added[gid] < caps[gid]
            ]
            if not candidates:
                break
            smallest = min(candidates, key=lambda gid: sizes[gid] + added[gid])
            added[smallest] += 1
        return [(by_id[gid], n) for gid, n in added.items() if n > 0]
