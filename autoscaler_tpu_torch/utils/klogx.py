"""Quota-limited verbose logging.

Reference: cluster-autoscaler/utils/klogx/klogx.go — per-loop log quotas so
verbose per-pod / per-node lines cannot flood the log at scale (a 100k-pod
burst would otherwise emit 100k "pod is unschedulable" lines every loop),
plus defaults.go's pods quota (20 lines normally, 1000 at verbosity >= 5).

Backed by stdlib logging on the "autoscaler_tpu_torch" logger; verbosity mirrors
klog's -v levels (set_verbosity). Usage, mirroring the reference:

    quota = pods_logging_quota()
    for pod in pods:
        v(4).up_to(quota).info("Pod %s is unschedulable", pod.key())
    v(4).over(quota).info("%d other pods skipped", -quota.left)

The port's copy of ``autoscaler_tpu/utils/klogx.py``.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

logger = logging.getLogger("autoscaler_tpu_torch")

MAX_PODS_LOGGED = 20       # defaults.go MaxPodsLogged
MAX_PODS_LOGGED_V5 = 1000  # defaults.go MaxPodsLoggedV5

_verbosity = 0


def set_verbosity(n: int) -> None:
    """klog's -v flag analog (wired from main.py --v)."""
    global _verbosity
    _verbosity = int(n)


def verbosity() -> int:
    return _verbosity


@dataclass
class Quota:
    """Log lines that may still print before suppression (klogx.go Quota).
    `left` goes negative past the limit so the Over() summary can report
    exactly how many lines were swallowed."""

    limit: int
    left: int

    def reset(self) -> None:
        self.left = self.limit


def new_logging_quota(n: int) -> Quota:
    return Quota(n, n)


def pods_logging_quota() -> Quota:
    """Default per-loop quota for per-pod lines (defaults.go)."""
    return new_logging_quota(
        MAX_PODS_LOGGED_V5 if _verbosity >= 5 else MAX_PODS_LOGGED
    )


class Verbose:
    """klogx.Verbose: a maybe-enabled logging handle."""

    __slots__ = ("enabled",)

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def up_to(self, quota: Quota) -> "Verbose":
        """Consume one line of quota; disabled once the quota is spent."""
        if not self.enabled:
            return self
        quota.left -= 1
        return Verbose(quota.left >= 0)

    def over(self, quota: Quota) -> "Verbose":
        """Enabled only if the quota WAS exceeded — for the summary line."""
        if not self.enabled:
            return self
        return Verbose(quota.left < 0)

    def info(self, msg: str, *args) -> None:
        if self.enabled:
            logger.info(msg, *args)


def v(level: int) -> Verbose:
    """klogx.V: enabled iff the configured verbosity reaches `level`."""
    return Verbose(level <= _verbosity)
