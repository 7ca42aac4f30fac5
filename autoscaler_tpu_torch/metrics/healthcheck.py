"""Liveness health check with activity/failure deadlines.

Reference: cluster-autoscaler/metrics/healthcheck (NewHealthCheck wired at
main.go:502): the probe fails — forcing a process restart — when no loop
activity has happened within max-inactivity, or loops have been continuously
failing longer than max-failing-time.

The port's copy of ``autoscaler_tpu/metrics/healthcheck.py``.
"""
from __future__ import annotations

import time
from typing import Optional


class HealthCheck:
    def __init__(self, max_inactivity_s: float = 600.0, max_failing_s: float = 900.0):
        self.max_inactivity_s = max_inactivity_s
        self.max_failing_s = max_failing_s
        self._last_activity: Optional[float] = None
        self._last_success: Optional[float] = None
        self._started = time.monotonic()

    def update_last_activity(self, now: Optional[float] = None) -> None:
        self._last_activity = now if now is not None else time.monotonic()

    def update_last_success(self, now: Optional[float] = None) -> None:
        t = now if now is not None else time.monotonic()
        self._last_activity = t
        self._last_success = t

    def healthy(self, now: Optional[float] = None) -> tuple[bool, str]:
        t = now if now is not None else time.monotonic()
        last_activity = self._last_activity if self._last_activity is not None else self._started
        if t - last_activity > self.max_inactivity_s:
            return False, (
                f"no activity for {t - last_activity:.0f}s "
                f"(max {self.max_inactivity_s:.0f}s)"
            )
        last_success = self._last_success if self._last_success is not None else self._started
        if t - last_success > self.max_failing_s:
            return False, (
                f"failing for {t - last_success:.0f}s (max {self.max_failing_s:.0f}s)"
            )
        return True, "ok"
