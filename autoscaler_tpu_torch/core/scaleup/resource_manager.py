"""Cluster-wide resource limits for scale-up.

Reference: cluster-autoscaler/core/scaleup/resource/manager.go —
DeltaForNode :62, ResourcesLeft :88, ApplyLimits :146,
CheckDeltaWithinLimits :184. Limits come from the cloud provider's
ResourceLimiter (cores/memory/GPU cluster caps) plus max_nodes_total.

The port's copy of ``autoscaler_tpu/core/scaleup/resource_manager.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from autoscaler_tpu_torch.cloudprovider.interface import ResourceLimiter
from autoscaler_tpu_torch.kube.objects import Node

CPU_RES = "cpu"
MEM_RES = "memory"
GPU_RES = "gpu"

_INF = float("inf")


@dataclass
class ResourceDelta:
    """Per-node resource footprint. cpu in millicores, memory in MiB."""

    resources: Dict[str, float] = field(default_factory=dict)

    @staticmethod
    def for_node(node: Node) -> "ResourceDelta":
        a = node.allocatable
        d = {CPU_RES: a.cpu_m, MEM_RES: a.memory / (1024.0 * 1024.0)}
        if a.gpu:
            d[GPU_RES] = a.gpu
        return ResourceDelta(d)

    def times(self, count: int) -> "ResourceDelta":
        return ResourceDelta({k: v * count for k, v in self.resources.items()})


@dataclass
class ResourcesLeft:
    left: Dict[str, float] = field(default_factory=dict)

    def exceeded_by(self, delta: ResourceDelta) -> List[str]:
        """reference CheckDeltaWithinLimits (manager.go:184)."""
        return [
            r
            for r, v in delta.resources.items()
            if v > 0 and self.left.get(r, _INF) < v
        ]


class ScaleUpResourceManager:
    def __init__(self, limiter: ResourceLimiter):
        self.limiter = limiter

    def resources_left(self, nodes: Sequence[Node]) -> ResourcesLeft:
        """max limits minus current cluster totals (manager.go:88)."""
        totals: Dict[str, float] = {CPU_RES: 0.0, MEM_RES: 0.0, GPU_RES: 0.0}
        for node in nodes:
            d = ResourceDelta.for_node(node)
            for k, v in d.resources.items():
                totals[k] = totals.get(k, 0.0) + v
        left: Dict[str, float] = {}
        for r, total in totals.items():
            if self.limiter.has_max(r):
                left[r] = max(0.0, self.limiter.get_max(r) - total)
        return ResourcesLeft(left)

    def apply_limits(
        self, new_count: int, left: ResourcesLeft, template: Node
    ) -> int:
        """Cap node count so the delta stays within remaining limits
        (manager.go:146)."""
        per_node = ResourceDelta.for_node(template)
        count = new_count
        for r, v in per_node.resources.items():
            if v <= 0:
                continue
            available = left.left.get(r, _INF)
            if available < _INF:
                count = min(count, int(available // v))
        return max(count, 0)
