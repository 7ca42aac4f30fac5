"""Kernel degradation ladder: circuit-broken rungs for the estimator.

The estimator's dispatch has four ways to compute the same FFD answer, in
descending preference: the hand-written CUDA kernels K1–K3, the torch loops
of ``ops/binpack.py`` on the estimator's device, the native serial FFD
(``csrc/ffd_serial.cpp`` via ``native_bridge``), and the pure-Python oracle
(``estimator/reference_impl.py``). All four share the one FFD order spec,
so *decisions are identical on every rung* — degradation costs latency,
never correctness.

Each rung sits behind a :class:`CircuitBreaker`: after
``failure_threshold`` consecutive failures the rung is OPEN and *skipped*
(the dispatch walks straight past it), and after ``cooldown_s`` one
half-open probe decides recovery. Environmental unavailability (not on a
CUDA device, a carry over a block's shared memory, no native library) is
NOT a failure: an unavailable rung resolves a half-open probe as success,
because the rung is not *faulting* — unavailability stays visible through
the route-metric reasons instead. A kernel that fails to build on a CUDA
device is a failure, not an unavailability.

On a CUDA device the estimator does not descend past a failing cuda rung:
the fault is recorded here (so the breaker trips and ``degraded()`` shows
it) and raised, and an open cuda breaker fails the dispatch until a
half-open probe closes it (``BinpackingNodeEstimator._walk_ladder``).
Off a CUDA device, and on the other rungs, a failure descends.

Time is injected (``tick(now)``, fed by ``StaticAutoscaler.run_once``) so
breaker cooldowns run on loop time and fault scenarios replay
byte-for-byte.

``fault_hook`` is the fault-injection seam: a callable(rung) that returns
a fault kind (``kernel_fault`` / ``device_lost``) when a scripted device
fault is armed for the rung. The hook is consulted before the rung's
availability gates — an armed fault models "the device faulted the moment
we touched it", so the breaker accounting works identically on the CPU and
on a card.

The port of ``autoscaler_tpu/estimator/ladder.py``, with the rungs named
for this card: ``cuda`` for the JAX package's ``pallas`` and ``torch`` for
its ``xla``; ``not_cuda`` is its ``not_tpu``.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from autoscaler_tpu_torch import trace
from autoscaler_tpu_torch.utils.circuit import BreakerState, CircuitBreaker

RUNG_CUDA = "cuda"
RUNG_TORCH = "torch"
RUNG_NATIVE = "native"
RUNG_PYTHON = "python"
LADDER_RUNGS = (RUNG_CUDA, RUNG_TORCH, RUNG_NATIVE, RUNG_PYTHON)
# rungs that touch the device — the ones device faults can hit
DEVICE_RUNGS = (RUNG_CUDA, RUNG_TORCH)

# Skip reasons that are HOST-LEVEL — true for every dispatch this process
# will ever make (not a CUDA device, no native library). A half-open probe
# landing on one of these resolves the breaker CLOSED: the rung can never
# fault here, so it must not stay reported as tripped. Every other skip
# reason (dedup routing, per-dispatch shared-memory/spread gates,
# unsupported families) is DISPATCH-LEVEL: the rung might still fault on a
# different dispatch, so a probe landing there is *released* (breaker stays
# half-open, slot returned) rather than resolved — a tripped rung must not
# be closed by a dispatch that never exercised it.
HOST_LEVEL_SKIP_REASONS = ("not_cuda", "native_unavailable")

_STATE_VALUE = {
    BreakerState.CLOSED: 0.0,
    BreakerState.HALF_OPEN: 1.0,
    BreakerState.OPEN: 2.0,
}

logger = logging.getLogger("estimator")


class KernelLadder:
    """Breaker-per-rung state shared by every dispatch of one estimator."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 120.0):
        self._now = 0.0
        self._metrics = None
        self._metrics_lock = threading.Lock()
        # fault seam: callable(rung) -> fault kind or None
        self.fault_hook: Optional[Callable[[str], Optional[str]]] = None
        self.breakers: Dict[str, CircuitBreaker] = {}
        for rung in LADDER_RUNGS:
            self.breakers[rung] = CircuitBreaker(
                failure_threshold=failure_threshold,
                cooldown_s=cooldown_s,
                name=rung,
                on_transition=self._transition_cb(rung),
            )

    # -- wiring ---------------------------------------------------------------
    def bind_metrics(self, metrics) -> None:
        """Attach an AutoscalerMetrics; breaker-state gauges are seeded so
        the series exist (at 0 = closed) before any transition."""
        with self._metrics_lock:
            self._metrics = metrics
        if metrics is not None:
            for rung, br in self.breakers.items():
                metrics.estimator_kernel_breaker_state.set(
                    _STATE_VALUE[br.state], rung=rung
                )

    def tick(self, now: float) -> None:
        """Advance the ladder clock (loop time: wall time in production, a
        synthetic clock in replays — which makes breaker cooldowns
        replayable)."""
        self._now = now

    @property
    def now(self) -> float:
        return self._now

    def _transition_cb(self, rung: str):
        def cb(old: BreakerState, new: BreakerState) -> None:
            m = self._metrics
            if m is not None:
                m.estimator_breaker_transitions_total.inc(
                    rung=rung, from_state=old.value, to_state=new.value
                )
                m.estimator_kernel_breaker_state.set(_STATE_VALUE[new], rung=rung)
            # stamp the transition on the tick trace (no-op outside one)
            trace.add_event(
                "breaker.transition",
                rung=rung, from_state=old.value, to_state=new.value,
            )
            logger.warning(
                "estimator kernel rung %r breaker: %s -> %s",
                rung, old.value, new.value,
            )

        return cb

    def _note_attempt(self, rung: str, outcome: str) -> None:
        m = self._metrics
        if m is not None:
            m.estimator_kernel_rung_attempts_total.inc(rung=rung, outcome=outcome)

    # -- the per-dispatch protocol -------------------------------------------
    def begin(self, rung: str) -> Optional[str]:
        """Engage a rung. Returns ``"breaker_open"`` when the rung must be
        skipped, an injected fault kind when a scripted fault fired (the
        failure is already recorded), or None when the caller should proceed
        — in which case it MUST follow up with exactly one of
        record_success / record_failure / record_unavailable /
        record_skipped_dispatch."""
        breaker = self.breakers[rung]
        if not breaker.allow(self._now):
            self._note_attempt(rung, "skipped")
            return "breaker_open"
        hook = self.fault_hook
        kind = hook(rung) if hook is not None else None
        if kind:
            self._note_attempt(rung, "fault")
            breaker.record_failure(self._now)
            return kind
        return None

    def record_success(self, rung: str) -> None:
        self._note_attempt(rung, "ok")
        self.breakers[rung].record_success(self._now)

    def record_failure(self, rung: str) -> None:
        self._note_attempt(rung, "fault")
        self.breakers[rung].record_failure(self._now)

    def record_unavailable(self, rung: str) -> None:
        """The rung cannot serve this dispatch for environmental reasons
        (not a CUDA device, missing library). Resolves a half-open probe as
        *success* — unavailability is not faulting, and a breaker must not
        stay open against a rung that cannot even be exercised (e.g. the
        cuda rung on a CPU-only host after faults clear) — but leaves a
        CLOSED breaker's failure streak intact, so dispatches that merely
        skip the rung interleaved with real faults can't keep it from ever
        tripping."""
        self._note_attempt(rung, "unavailable")
        self.breakers[rung].record_neutral(self._now)

    def record_skipped_dispatch(self, rung: str) -> None:
        """The rung was routed around for THIS dispatch only (dedup
        compression, per-dispatch shared-memory/spread gates, unsupported
        family). Releases a held half-open probe slot without resolving it
        — the rung was never exercised — and leaves every other breaker
        state untouched."""
        self._note_attempt(rung, "unavailable")
        self.breakers[rung].release_probe(self._now)

    # -- surfacing ------------------------------------------------------------
    def degraded(self) -> List[str]:
        """Rungs currently not CLOSED — nonempty means the estimator is in
        degraded mode (decisions still flow, on a lower rung)."""
        return [
            rung
            for rung in LADDER_RUNGS
            if self.breakers[rung].state is not BreakerState.CLOSED
        ]

    def states(self) -> Dict[str, str]:
        return {rung: br.state.value for rung, br in self.breakers.items()}
