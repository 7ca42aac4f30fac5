"""Balancer: split N replicas across targets by priority or proportion.

Reference: balancer/pkg/policy/ — GetPlacement policy.go:27 (policy
dispatch + fallback when a target can't absorb its share),
distributeByPriority priority.go:22 (fill targets in priority order up to
per-target max), distributeByProportions proportional.go:44 (largest-
remainder apportionment respecting min/max). CRD types are plain dataclasses
here (balancer/pkg/apis/balancer.x-k8s.io/v1alpha1/types.go).

The port's copy of ``autoscaler_tpu/balancer/policy.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Target:
    name: str
    min_replicas: int = 0
    max_replicas: int = 10**9
    # proportions: relative weight for proportional policy
    proportion: float = 0.0
    # priority: lower number = filled first for priority policy
    priority: int = 0
    # fallback: targets whose pods are failing are skipped (policy.go fallback)
    failing: bool = False


@dataclass
class Placement:
    assignments: Dict[str, int] = field(default_factory=dict)
    unassigned: int = 0


def distribute_by_priority(replicas: int, targets: List[Target]) -> Placement:
    """priority.go:22 — honor minimums first, then fill in priority order."""
    placement = Placement()
    active = [t for t in targets if not t.failing]
    remaining = replicas
    for t in active:
        take = min(t.min_replicas, remaining)
        placement.assignments[t.name] = take
        remaining -= take
    for t in sorted(active, key=lambda t: t.priority):
        room = t.max_replicas - placement.assignments.get(t.name, 0)
        take = min(room, remaining)
        placement.assignments[t.name] = placement.assignments.get(t.name, 0) + take
        remaining -= take
        if remaining == 0:
            break
    placement.unassigned = remaining
    return placement


def distribute_by_proportions(replicas: int, targets: List[Target]) -> Placement:
    """proportional.go:44 — largest-remainder apportionment under min/max."""
    placement = Placement()
    active = [t for t in targets if not t.failing]
    if not active:
        placement.unassigned = replicas
        return placement
    total_w = sum(max(t.proportion, 0.0) for t in active)
    if total_w <= 0:
        total_w = float(len(active))  # equal split fallback
        weights = {t.name: 1.0 for t in active}
    else:
        weights = {t.name: max(t.proportion, 0.0) for t in active}

    remaining = replicas
    # minimums first
    for t in active:
        take = min(t.min_replicas, remaining)
        placement.assignments[t.name] = take
        remaining -= take

    # ideal shares of what's left, capped by max
    shares: List[Tuple[float, Target]] = []
    float_share: Dict[str, float] = {}
    for t in active:
        share = remaining * weights[t.name] / total_w
        float_share[t.name] = share
    assigned_now: Dict[str, int] = {}
    for t in active:
        base = int(float_share[t.name])
        room = t.max_replicas - placement.assignments.get(t.name, 0)
        assigned_now[t.name] = min(base, room)
    used = sum(assigned_now.values())
    leftovers = remaining - used
    # largest remainder, skipping full targets
    order = sorted(
        active,
        key=lambda t: -(float_share[t.name] - int(float_share[t.name])),
    )
    idx = 0
    while leftovers > 0 and idx < 10_000:
        progressed = False
        for t in order:
            if leftovers == 0:
                break
            room = t.max_replicas - placement.assignments.get(t.name, 0) - assigned_now[t.name]
            if room > 0:
                assigned_now[t.name] += 1
                leftovers -= 1
                progressed = True
        if not progressed:
            break
        idx += 1
    for t in active:
        placement.assignments[t.name] = (
            placement.assignments.get(t.name, 0) + assigned_now[t.name]
        )
    placement.unassigned = replicas - sum(placement.assignments.values())
    return placement


def get_placement(
    replicas: int, targets: List[Target], policy: str = "priority"
) -> Placement:
    """policy.go:27 GetPlacement."""
    if policy == "priority":
        return distribute_by_priority(replicas, targets)
    if policy == "proportional":
        return distribute_by_proportions(replicas, targets)
    raise ValueError(f"unknown balancer policy {policy!r}")
