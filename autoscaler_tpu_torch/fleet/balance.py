"""Health-weighted multi-endpoint balancing for the fleet client.

An earlier ``TpuSimulationClient`` had a *static* failover list: endpoint
order was fixed, first attempts always went to the current endpoint, and
a flapping replica kept eating first-attempt traffic until it happened to
fail at the exact moment a call went through it. This module replaces the
rotation with a per-endpoint **health scorer** feeding a
**power-of-two-choices** weighted picker with breaker-style outlier
ejection (ARCHITECTURE.md "Fleet HA"):

- **Scorer inputs** (per endpoint, mutated only under the balancer lock):
  EWMA of successful-call latency, windowed error rate over the last
  ``ERROR_WINDOW`` outcomes, the consecutive-UNAVAILABLE streak, and a
  drain-observed bit (the endpoint said "I am shutting down"). The score
  is seconds-shaped — latency plus penalty terms — so "healthier" is
  simply "lower".
- **Pick policy**: power-of-two-choices — draw two distinct candidates
  from the eligible set, keep the lower score (ties break on index, so
  picks are a pure function of the rng stream). P2C gives most traffic to
  healthy endpoints without the herd-to-the-single-best behavior a full
  argmin would have the instant one endpoint's EWMA dips.
- **Ejection + cooldown**: each endpoint owns a
  :class:`~autoscaler_tpu_torch.utils.circuit.CircuitBreaker`. Consecutive
  failures trip it OPEN and the endpoint leaves the eligible set; after
  the cooldown at most ONE pick per cooldown window is admitted as the
  half-open probe (the breaker's single-flight slot), whose outcome
  decides recovery vs. another OPEN window. When every endpoint is
  ejected the picker degrades to least-bad-score — the client must still
  send somewhere.

Determinism: the balancer holds no ambient state — ``clock`` and ``rng``
are injected-parameter seams (GL001), so the pick sequence is a pure
function of the (pick, record) call order, the clock readings, and the
rng stream. The loadgen fleet driver seeds both from the scenario seed,
which is what makes the fleet ledger's endpoint-choice column replay
byte-identically (hack/verify.sh diffs it).

The port's copy of ``autoscaler_tpu/fleet/balance.py``.
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Set

from autoscaler_tpu_torch.utils.circuit import BreakerState, CircuitBreaker

# sliding outcome window per endpoint (1 = failure, 0 = success): short
# enough that recovery shows within tens of calls, long enough that one
# blip doesn't read as a 100% error rate
ERROR_WINDOW = 32
# EWMA smoothing for successful-call latency
EWMA_ALPHA = 0.3
# score penalty terms, seconds-shaped so they compose with the EWMA:
# a fully erroring endpoint reads as +1s, each consecutive UNAVAILABLE
# adds half a second (capped), a drain-observed endpoint is effectively
# last-resort until a success clears the bit
ERROR_RATE_PENALTY_S = 1.0
UNAVAILABLE_PENALTY_S = 0.5
UNAVAILABLE_PENALTY_CAP = 8
DRAIN_PENALTY_S = 30.0


class EndpointHealth:
    """One endpoint's scorer inputs plus its ejection breaker. NOT
    thread-safe by itself: every mutation happens under the owning
    balancer's lock (the GL004 discipline — verdicts and state move
    together)."""

    def __init__(
        self, name: str, failure_threshold: int, cooldown_s: float
    ) -> None:
        self.name = name
        self.ewma_latency_s = 0.0
        self.outcomes: deque = deque(maxlen=ERROR_WINDOW)
        self.consecutive_unavailable = 0
        self.drain_observed = False
        self.breaker = CircuitBreaker(
            failure_threshold=failure_threshold,
            cooldown_s=cooldown_s,
            name=f"endpoint:{name}",
        )

    def error_rate(self) -> float:
        if not self.outcomes:
            return 0.0
        return sum(self.outcomes) / len(self.outcomes)

    def score(self) -> float:
        """Seconds-shaped health score — lower is healthier. A fresh
        endpoint scores 0.0 (cold endpoints look attractive, which is how
        a recovered replica earns traffic back)."""
        s = self.ewma_latency_s
        s += self.error_rate() * ERROR_RATE_PENALTY_S
        s += UNAVAILABLE_PENALTY_S * min(
            self.consecutive_unavailable, UNAVAILABLE_PENALTY_CAP
        )
        if self.drain_observed:
            s += DRAIN_PENALTY_S
        return s

    def note_success(self, latency_s: float) -> None:
        if self.ewma_latency_s == 0.0:
            self.ewma_latency_s = latency_s
        else:
            self.ewma_latency_s += EWMA_ALPHA * (
                latency_s - self.ewma_latency_s
            )
        self.outcomes.append(0)
        self.consecutive_unavailable = 0
        # a served request IS the evidence the drain completed (restart
        # finished, new process admitting) — clear the bit
        self.drain_observed = False

    def note_failure(self, unavailable: bool, drain: bool) -> None:
        self.outcomes.append(1)
        if unavailable:
            self.consecutive_unavailable += 1
        if drain:
            self.drain_observed = True


class EndpointBalancer:
    """Health-weighted P2C picker over a fixed endpoint set.

    ``clock``/``rng`` are injected-parameter seams (GL001): production
    clients take the wall defaults; replay drivers inject the sim clock
    and a seeded uniform so pick sequences replay byte-identically.
    ``rng`` returns uniforms in [0, 1).

    Thread safety: all state moves under one lock — the client's worker
    threads pick/record concurrently with a failover rewriting health."""

    def __init__(
        self,
        endpoints: Sequence[str],
        clock: Callable[[], float] = time.monotonic,
        rng: Callable[[], float] = random.random,
        eject_failure_threshold: int = 3,
        eject_cooldown_s: float = 5.0,
    ) -> None:
        names = [str(e) for e in endpoints]
        if not names:
            raise ValueError("EndpointBalancer needs at least one endpoint")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate endpoints in {names}")
        self._clock = clock
        self._rng = rng
        self._lock = threading.Lock()
        self._order: List[str] = names
        self._health: Dict[str, EndpointHealth] = {
            n: EndpointHealth(n, eject_failure_threshold, eject_cooldown_s)
            for n in names
        }

    @property
    def endpoints(self) -> List[str]:
        return list(self._order)

    # -- picking --------------------------------------------------------------
    def pick(
        self,
        exclude: Sequence[str] = (),
        healthy_only: bool = False,
    ) -> Optional[str]:
        """Pick one endpoint by health-weighted power-of-two-choices.

        ``exclude`` removes endpoints already tried this call (failover).
        ``healthy_only`` additionally refuses ejected and drain-observed
        endpoints outright and returns None when no healthy candidate
        remains — the hedge-leg mode: a hedge fired at a draining sidecar
        burns deadline budget for a guaranteed UNAVAILABLE, so no hedge
        beats a doomed hedge. Without ``healthy_only`` the picker always
        returns SOMETHING when any non-excluded endpoint exists (the
        primary attempt must go somewhere, even in a full outage)."""
        skip: Set[str] = set(exclude)
        with self._lock:
            now = self._clock()
            candidates = [n for n in self._order if n not in skip]
            if not candidates:
                return None
            eligible = [
                n for n in candidates
                if self._health[n].breaker.state is BreakerState.CLOSED
            ]
            if healthy_only:
                eligible = [
                    n for n in eligible
                    if not self._health[n].drain_observed
                    and self._health[n].consecutive_unavailable == 0
                ]
                if not eligible:
                    return None
                return self._p2c_locked(eligible)
            # a cooled-down ejected endpoint takes the pick OUTRIGHT as
            # its half-open probe: a probe that had to win a score
            # contest against a healthy peer would never run (its score
            # is exactly what ejected it), and the breaker's
            # single-flight slot already bounds probe traffic to one in
            # flight per cooldown window — a recovering replica is never
            # stampeded, and never starved of its comeback either.
            for n in candidates:
                h = self._health[n]
                if (
                    h.breaker.state is not BreakerState.CLOSED
                    and h.breaker.allow(now)
                ):
                    return n
            if eligible:
                return self._p2c_locked(eligible)
            # everything ejected and still cooling down: least-bad by
            # score — the call has to go somewhere
            return self._p2c_locked(candidates)

    def _p2c_locked(self, pool: List[str]) -> str:
        """Power-of-two-choices over ``pool`` (caller holds the lock):
        draw two DISTINCT candidates from the rng stream, keep the lower
        score; a tie keeps the FIRST draw — the first draw is uniform, so
        a fully-healthy (all-tied) fleet spreads picks evenly instead of
        herding onto the lowest index, and the choice stays a pure
        function of the rng stream. One candidate short-circuits without
        an rng draw, keeping the stream alignment predictable."""
        if len(pool) == 1:
            return pool[0]
        n = len(pool)
        i = min(int(self._rng() * n), n - 1)
        # second draw over the remaining n-1 slots, offset past i: always
        # distinct, exactly two rng draws per pick
        j = (i + 1 + min(int(self._rng() * (n - 1)), n - 2)) % n
        a, b = pool[i], pool[j]
        return b if self._health[b].score() < self._health[a].score() else a

    def pick_hedge(self, primary: str) -> Optional[str]:
        """The hedge-leg target: a HEALTHY endpoint other than the
        primary, or None (skip the hedge — see pick(healthy_only))."""
        return self.pick(exclude=(primary,), healthy_only=True)

    # -- outcome reporting ----------------------------------------------------
    def record_success(self, endpoint: str, latency_s: float) -> None:
        with self._lock:
            h = self._health.get(endpoint)
            if h is None:
                return
            h.note_success(max(float(latency_s), 0.0))
            h.breaker.record_success(self._clock())

    def record_failure(
        self, endpoint: str, unavailable: bool = True, drain: bool = False
    ) -> None:
        """One failed call at ``endpoint``. ``unavailable`` marks the
        UNAVAILABLE statuses (connection refused, dead process, drain) that
        feed the consecutive-streak input; a deadline blowout passes
        False — it is a slowness signal, not an outage signal. ``drain``
        sets the drain-observed bit (the endpoint SAID it is shutting
        down) so hedges and healthy-only picks route around it until a
        success clears it."""
        with self._lock:
            h = self._health.get(endpoint)
            if h is None:
                return
            h.note_failure(unavailable, drain)
            h.breaker.record_failure(self._clock())

    def record_drain(self, endpoint: str) -> None:
        self.record_failure(endpoint, unavailable=True, drain=True)

    def record_response(self, endpoint: str) -> None:
        """The endpoint ANSWERED, but with a status that is neither
        success-shaped nor outage-shaped (quota shed, invalid argument,
        internal error): the process is alive at the transport level.
        Resolves a held half-open probe (record_neutral) and clears the
        UNAVAILABLE streak — an answering endpoint is not mid-outage —
        but touches neither the EWMA nor the error window (an admission
        shed says nothing about latency) nor the drain bit (only a real
        success clears that). Without this, a probe that came back
        RESOURCE_EXHAUSTED would hold the single-flight slot forever and
        wedge the endpoint out of rotation permanently."""
        with self._lock:
            h = self._health.get(endpoint)
            if h is None:
                return
            h.consecutive_unavailable = 0
            h.breaker.record_neutral(self._clock())

    def release(self, endpoint: str) -> None:
        """The picked endpoint was never driven to an outcome (its hedge
        leg was cancelled after the other leg won): return a held
        half-open probe slot so a later pick can probe. Without it a
        cancelled probe leg wedges the endpoint HALF_OPEN forever — no
        outcome will ever arrive to resolve it."""
        with self._lock:
            h = self._health.get(endpoint)
            if h is None:
                return
            h.breaker.release_probe(self._clock())

    # -- observability --------------------------------------------------------
    def healthy(self, endpoint: str) -> bool:
        """Hedge-grade health: not ejected, no drain observed, no live
        UNAVAILABLE streak."""
        with self._lock:
            h = self._health.get(endpoint)
            if h is None:
                return False
            return (
                h.breaker.state is BreakerState.CLOSED
                and not h.drain_observed
                and h.consecutive_unavailable == 0
            )

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Per-endpoint scorer inputs + verdicts, sorted-key-safe for
        reports (consumed through sorted() only)."""
        with self._lock:
            out: Dict[str, Dict[str, object]] = {}
            for name in self._order:
                h = self._health[name]
                out[name] = {
                    "score": round(h.score(), 6),
                    "ewma_latency_s": round(h.ewma_latency_s, 6),
                    "error_rate": round(h.error_rate(), 4),
                    "consecutive_unavailable": h.consecutive_unavailable,
                    "drain_observed": h.drain_observed,
                    "breaker": h.breaker.state.value,
                }
            return out
