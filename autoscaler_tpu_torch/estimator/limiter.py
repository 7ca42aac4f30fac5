"""Estimation limiter — caps how many nodes one estimate may open (the
port's copy of ``autoscaler_tpu/estimator/limiter.py``).

Reference: cluster-autoscaler/estimator/threshold_based_limiter.go. The
node cap becomes the carry size of the scan.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ThresholdBasedEstimationLimiter:
    max_nodes: int = 1000        # reference default --max-nodes-per-scaleup
    max_duration_s: float = 10.0  # reference default --max-nodegroup-binpacking-duration

    def node_cap(self, group_max_size_headroom: int) -> int:
        """Min of the limiter threshold and the group's remaining size
        headroom; never below 1."""
        cap = self.max_nodes
        if group_max_size_headroom > 0:
            cap = min(cap, group_max_size_headroom)
        return max(cap, 1)
