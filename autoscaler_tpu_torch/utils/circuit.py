"""Generic circuit breaker: closed / open / half-open.

The reference has no breaker — its per-dispatch try/fallback re-attempts a
deterministically failing path on every loop, re-paying compile/dispatch
latency for the same failure each tick. This breaker converts that into a
degradation contract: after ``failure_threshold`` consecutive failures the
protected resource is OPEN (callers skip it outright), after ``cooldown_s``
a single half-open probe is admitted, and the probe's outcome decides
between CLOSED (recovered) and another full OPEN window.

Time is explicit (callers pass ``now``) rather than read from the wall
clock, so the breaker runs identically under the loadgen driver's simulated
clock — a prerequisite for byte-identical decision-log replay of fault
scenarios — and under long fake-clock horizons in tests.

Thread safety: all state moves under one lock. In HALF_OPEN exactly one
caller wins the probe slot; concurrent ``allow`` calls during the probe are
refused (they fall down their own ladder) so a recovering resource is never
stampeded — exercised by tests/test_resilience.py's concurrency stress.

The port's copy of ``autoscaler_tpu/utils/circuit.py`` (stdlib only).
"""
from __future__ import annotations

import enum
import threading
from typing import Callable, Optional


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown_s: float = 120.0,
        name: str = "",
        on_transition: Optional[
            Callable[[BreakerState, BreakerState], None]
        ] = None,
    ):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.name = name
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = BreakerState.CLOSED
        self._consecutive_failures = 0
        self._opened_ts = 0.0
        self._probe_in_flight = False

    @property
    def state(self) -> BreakerState:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive_failures

    def _transition_locked(self, new: BreakerState) -> None:
        # *_locked suffix = caller holds self._lock (the graftlint GL004
        # convention); the callback runs under it too — callbacks are
        # metric/log writes and must not call back into the breaker
        old = self._state
        if old is new:
            return
        self._state = new
        if self._on_transition is not None:
            self._on_transition(old, new)

    def allow(self, now: float) -> bool:
        """May a caller engage the protected resource right now? In
        HALF_OPEN at most one caller gets True (the probe); the probe slot
        is held until that caller records success or failure."""
        with self._lock:
            if self._state is BreakerState.CLOSED:
                return True
            if self._state is BreakerState.OPEN:
                if now - self._opened_ts < self.cooldown_s:
                    return False
                self._transition_locked(BreakerState.HALF_OPEN)
                self._probe_in_flight = True
                return True
            # HALF_OPEN
            if self._probe_in_flight:
                return False
            self._probe_in_flight = True
            return True

    def record_success(self, now: float) -> None:
        with self._lock:
            if self._state is BreakerState.HALF_OPEN:
                self._probe_in_flight = False
                self._consecutive_failures = 0
                self._transition_locked(BreakerState.CLOSED)
            elif self._state is BreakerState.CLOSED:
                self._consecutive_failures = 0
            # success reported while OPEN is a stale caller (admitted before
            # the trip): the open window stands

    def record_neutral(self, now: float) -> None:
        """The admitted caller could not exercise the resource at all (e.g.
        environmentally unavailable). Resolves a HALF_OPEN probe as success —
        an unexercisable resource is not faulting, and the breaker must not
        wedge open against it — but in CLOSED state changes NOTHING: in
        particular it does not reset the consecutive-failure streak, so
        interleaved unavailability can't keep a persistently faulting
        resource from ever tripping."""
        with self._lock:
            if self._state is BreakerState.HALF_OPEN:
                self._probe_in_flight = False
                self._consecutive_failures = 0
                self._transition_locked(BreakerState.CLOSED)

    def release_probe(self, now: float) -> None:
        """The admitted half-open prober could not engage the resource for
        THIS call (routed around it): return the probe slot so a later
        caller can probe, leaving the breaker HALF_OPEN — the resource was
        not exercised, so neither success nor failure can be concluded."""
        with self._lock:
            if self._state is BreakerState.HALF_OPEN:
                self._probe_in_flight = False

    def record_failure(self, now: float) -> None:
        with self._lock:
            if self._state is BreakerState.HALF_OPEN:
                self._probe_in_flight = False
                self._opened_ts = now
                self._transition_locked(BreakerState.OPEN)
            elif self._state is BreakerState.CLOSED:
                self._consecutive_failures += 1
                if self._consecutive_failures >= self.failure_threshold:
                    self._opened_ts = now
                    self._transition_locked(BreakerState.OPEN)
            # failures reported while OPEN are stale: re-extending the
            # window on them would starve the half-open probe
