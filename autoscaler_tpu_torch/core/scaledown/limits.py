"""Cluster-wide resource floors for scale-down.

Reference: cluster-autoscaler/core/scaledown/resource/limits.go —
LimitsFinder.LimitsLeft :64 (cluster totals minus configured minimums,
nodes mid-deletion excluded from the totals), CheckDeltaWithinLimits :208
and TryDecrementBy :224 (all-or-nothing decrement per node). The reference
refuses to delete a node that would push total cores/memory/custom
resources under the operator's floor; the floors come from the cloud
provider's ResourceLimiter, which itself defaults to the
min/max_*_total AutoscalingOptions (context/autoscaling_context.go:79).

Units follow core/scaleup/resource_manager.py: cpu in millicores, memory
in MiB, gpu in device count.

The port's copy of ``autoscaler_tpu/core/scaledown/limits.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from autoscaler_tpu_torch.cloudprovider.interface import CloudProvider, ResourceLimiter
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.core.scaleup.resource_manager import (
    CPU_RES,
    MEM_RES,
    ResourceDelta,
)
from autoscaler_tpu_torch.kube.objects import Node


def build_resource_limiter(
    options: AutoscalingOptions, provider: Optional[CloudProvider] = None
) -> ResourceLimiter:
    """Effective limiter: the options-derived floors/caps, overridden by any
    entries the cloud provider declares (the reference consults the
    provider's ResourceLimiter, which wraps the options defaults)."""
    min_limits: Dict[str, float] = {}
    max_limits: Dict[str, float] = {}
    if options.min_cores_total > 0:
        min_limits[CPU_RES] = options.min_cores_total
    max_limits[CPU_RES] = options.max_cores_total
    if options.min_memory_total > 0:
        min_limits[MEM_RES] = options.min_memory_total
    max_limits[MEM_RES] = options.max_memory_total_mib
    for name, (lo, hi) in options.gpu_total.items():
        if lo > 0:
            min_limits[name] = float(lo)
        max_limits[name] = float(hi)
    if provider is not None:
        plim = provider.get_resource_limiter()
        min_limits.update(plim.min_limits)
        max_limits.update(plim.max_limits)
    return ResourceLimiter(min_limits=min_limits, max_limits=max_limits)


class ScaleDownLimits:
    """Remaining deletable amount per limited resource. No entry = no floor
    (limits.go:77 'only actual limits into final map')."""

    def __init__(self, left: Dict[str, float]):
        self.left = left

    def check_delta(self, delta: ResourceDelta) -> List[str]:
        """Resources whose floor the delta would breach (limits.go:208)."""
        return [
            r
            for r, v in delta.resources.items()
            if v > 0 and r in self.left and v > self.left[r]
        ]

    def try_decrement(self, delta: ResourceDelta) -> List[str]:
        """All-or-nothing decrement (limits.go:224): on success ([] returned)
        the remaining headroom shrinks by the node's footprint; an exceeded
        delta leaves the limits untouched."""
        exceeded = self.check_delta(delta)
        if exceeded:
            return exceeded
        for r, v in delta.resources.items():
            if r in self.left:
                self.left[r] -= v
        return []


class LimitsFinder:
    """limits.go:53 — computes how much of each limited resource scale-down
    may still delete."""

    def __init__(self, limiter: ResourceLimiter):
        self.limiter = limiter

    def limits_left(
        self,
        nodes: Sequence[Node],
        is_being_deleted: Callable[[str], bool] = lambda name: False,
    ) -> ScaleDownLimits:
        """Cluster totals (excluding nodes mid-deletion, limits.go:113) minus
        each configured minimum, floored at zero (limits.go:100)."""
        totals: Dict[str, float] = {}
        for node in nodes:
            if is_being_deleted(node.name):
                continue
            for r, v in ResourceDelta.for_node(node).resources.items():
                totals[r] = totals.get(r, 0.0) + v
        left: Dict[str, float] = {}
        for r, floor in self.limiter.min_limits.items():
            if floor > 0:
                left[r] = max(0.0, totals.get(r, 0.0) - floor)
        return ScaleDownLimits(left)
