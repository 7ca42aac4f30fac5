"""Shared daemon poll loop for the auxiliary binaries (VPA, nanny).

The port's copy of ``autoscaler_tpu/utils/poll.py``.

The reference's RunOnce loops log transient errors and keep ticking
(recommender routines/recommender.go, nanny nanny_lib.go:103); this is that
shape once, instead of re-inlined per binary. Sleep is drift-compensated:
the tick cadence is interval_s regardless of how long fn took.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Optional


def poll_loop(
    fn: Callable[[], object],
    interval_s: float,
    max_iterations: int = 0,
    logger: Optional[logging.Logger] = None,
) -> int:
    """Run ``fn`` every ``interval_s`` seconds until KeyboardInterrupt or
    ``max_iterations`` (0 = forever). Exceptions from ``fn`` are logged and
    the loop continues — a transient API error must not kill the daemon or
    its accumulated in-memory state. Returns 0 (the process exit code)."""
    log = logger or logging.getLogger("poll")
    iterations = 0
    try:
        while True:
            start = time.monotonic()
            try:
                fn()
            except Exception:  # noqa: BLE001 — log-and-continue by design
                log.exception("pass failed; continuing next tick")
            iterations += 1
            if max_iterations and iterations >= max_iterations:
                return 0
            time.sleep(max(interval_s - (time.monotonic() - start), 0.0))
    except KeyboardInterrupt:
        return 0
