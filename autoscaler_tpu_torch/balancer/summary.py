"""Balancer pod summaries: how many pods of a target run, and how many
failed to start within the deadline.

Reference: balancer/pkg/pods/summary.go — CalculateSummary walks the pod
list: Running pods count toward total+running; Pending pods count toward
total, and toward NotStartedWithinDeadline once older than the startup
timeout. The controller marks a target for fallback when any pod missed
the deadline.

The port's copy of ``autoscaler_tpu/balancer/summary.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from autoscaler_tpu_torch.kube.objects import Pod


@dataclass
class Summary:
    """summary.go Summary (Total/Running/NotStartedWithinDeadline)."""

    total: int = 0
    running: int = 0
    not_started_within_deadline: int = 0


def _phase(pod: Pod) -> str:
    if pod.phase:
        return pod.phase
    # phase unknown (objects built in-process): scheduled ≈ Running,
    # unscheduled ≈ Pending
    return "Running" if pod.node_name else "Pending"


def calculate_summary(
    pods: Sequence[Pod], now_ts: float, startup_timeout_s: float
) -> Summary:
    """summary.go:42 CalculateSummary. Pods in terminal phases (Succeeded/
    Failed) or with unknown phase beyond Running/Pending are not counted,
    exactly like the reference's switch."""
    s = Summary()
    for pod in pods:
        phase = _phase(pod)
        if phase == "Running":
            s.total += 1
            s.running += 1
        elif phase == "Pending":
            s.total += 1
            if pod.creation_ts + startup_timeout_s < now_ts:
                s.not_started_within_deadline += 1
    return s


def target_failing(summary: Summary) -> bool:
    """The controller's fallback trigger: any pod missed its startup
    deadline (balancer/pkg/controller logic feeding Target.failing)."""
    return summary.not_started_within_deadline > 0
