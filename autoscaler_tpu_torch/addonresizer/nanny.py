"""Addon-resizer ("nanny"): scale one workload's resources with cluster size.

Reference: addon-resizer/nanny/ — the linear estimator (base + per-node
delta) estimator.go:52,86 with a ±offset deadband so tiny cluster-size
changes don't churn the deployment, and the control loop
nanny_lib.go:103,125 (PollAPIServer → checkResource → updateResources).

The port's copy of ``autoscaler_tpu/addonresizer/nanny.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from autoscaler_tpu_torch.kube.objects import Resources


@dataclass
class LinearEstimator:
    base_cpu_m: float
    cpu_per_node_m: float
    base_memory: float
    memory_per_node: float
    deadband_fraction: float = 0.10  # nanny's acceptance range

    def estimate(self, num_nodes: int) -> Resources:
        """estimator.go:52 — linear in node count."""
        return Resources(
            cpu_m=self.base_cpu_m + self.cpu_per_node_m * num_nodes,
            memory=self.base_memory + self.memory_per_node * num_nodes,
        )

    def needs_update(self, current: Resources, num_nodes: int) -> Optional[Resources]:
        """nanny_lib.go:125 — return new resources when current requests are
        outside the ±deadband around the estimate, else None."""
        want = self.estimate(num_nodes)

        def outside(cur: float, target: float) -> bool:
            if target <= 0:
                return cur != 0
            return abs(cur - target) / target > self.deadband_fraction

        if outside(current.cpu_m, want.cpu_m) or outside(current.memory, want.memory):
            return want
        return None


class Nanny:
    """The control loop: watch node count, resize the dependent workload."""

    def __init__(self, estimator: LinearEstimator, update_fn):
        self.estimator = estimator
        self.update_fn = update_fn
        self.last_applied: Optional[Resources] = None

    def poll(self, current: Resources, num_nodes: int) -> bool:
        """→ True when an update was applied (nanny_lib.go:103)."""
        new = self.estimator.needs_update(current, num_nodes)
        if new is None:
            return False
        self.update_fn(new)
        self.last_applied = new
        return True
