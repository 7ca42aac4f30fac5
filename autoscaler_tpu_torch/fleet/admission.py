"""Deadline-aware admission control for the fleet coalescer.

The overload story (ARCHITECTURE.md "Fleet overload & drain"): ``submit``
used to accept unboundedly — a tenant storm grew the queue without limit,
every queued ticket eventually resolved (late), and the only backpressure
was the caller's own deadline silently expiring while the ticket still
consumed a batch slot. This module makes every rejection *typed* and
*priced*:

- :class:`FleetOverloadError` — the queue is full or the tenant is over
  its token-bucket quota; carries ``retry_after_s`` so the RPC layer can
  surface RESOURCE_EXHAUSTED with a concrete retry hint and the client
  can pace itself instead of hammering a drowning server.
- :class:`FleetDrainError` — the coalescer is draining (sidecar shutting
  down); maps to UNAVAILABLE with a drain detail, the client's signal to
  fail over to another endpoint rather than retry here.
- :class:`FleetDeadlineError` — the ticket's deadline expired while it
  was queued; the coalescer sheds it *before* it consumes a batch slot
  (typed DEADLINE_EXCEEDED, never a silent hang).

Determinism (graftlint GL001/GL010): the token buckets run on the
coalescer's injected clock — under the loadgen drivers that is the
simulated scenario clock, so quota sheds (and their retry-after values)
replay byte-identically. All controller state is mutated ONLY under the
coalescer's queue lock (GL004: the admission verdict and the queue move
together — a verdict computed outside the lock could admit into a queue
that a concurrent drain already closed).

Closed admission-outcome vocabulary (metric labels + ledger fields):
``admitted``, ``shed_queue_full``, ``shed_quota``, ``shed_draining``,
``shed_deadline``.

The port's copy of ``autoscaler_tpu/fleet/admission.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from autoscaler_tpu_torch.fleet.tiers import TierPolicy, TierSpec
from autoscaler_tpu_torch.fleet.errors import (
    ADMIT_OK,
    SHED_DEADLINE,
    SHED_DRAINING,
    SHED_QUEUE_FULL,
    SHED_QUOTA,
    FleetDeadlineError,
    FleetDrainError,
    FleetOverloadError,
)

__all__ = [
    "ADMIT_OK",
    "SHED_DEADLINE",
    "SHED_DRAINING",
    "SHED_QUEUE_FULL",
    "SHED_QUOTA",
    "AdmissionController",
    "FleetDeadlineError",
    "FleetDrainError",
    "FleetOverloadError",
    "TokenBucket",
]

# the shared quota bucket tenants past the per-tenant bound fall into —
# same overflow discipline as the metric-label bound (coalescer
# OVERFLOW_TENANT): once the admission set is full it stays full, so an
# abusive tenant-id generator costs bounded memory AND shares one quota
OVERFLOW_BUCKET = "__overflow__"


class TokenBucket:
    """One tenant's request budget: ``rate`` tokens/second, ``burst``
    capacity. ``try_take`` runs on the injected clock (the caller passes
    ``now``) so refill arithmetic is a pure function of event times —
    replayable under the loadgen sim clock."""

    def __init__(self, rate: float, burst: float) -> None:
        if rate <= 0:
            raise ValueError(f"token rate must be positive, got {rate}")
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self._tokens = self.burst
        self._last: Optional[float] = None

    def try_take(self, now: float) -> float:
        """Take one token. Returns 0.0 on success, else the seconds until
        the next token becomes available (the retry-after hint).

        ``_last`` only ever advances: callers may present out-of-order
        timestamps (the coalescer reads its clock before taking the queue
        lock, so two racing submits can arrive swapped), and rewinding
        would re-credit the interval between the stamps — a quota leak
        under exactly the concurrency quotas exist to police."""
        if self._last is None:
            self._last = now
        elif now > self._last:
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return 0.0
        return (1.0 - self._tokens) / self.rate


@dataclass(frozen=True)
class AdmissionVerdict:
    """One submit's fate: the closed outcome label plus the retry hint
    (0.0 for admitted/draining — drain has no useful retry-here time).
    ``tier`` names the judged tenant's quota tier ("" when tiers are off)
    — the metric/ledger label."""

    outcome: str
    retry_after_s: float = 0.0
    tier: str = ""

    @property
    def admitted(self) -> bool:
        return self.outcome == ADMIT_OK


class AdmissionController:
    """Queue-depth + per-tenant-quota gate in front of the coalescing
    queue. NOT thread-safe by itself: every method is called under the
    coalescer's queue lock (the GL004 discipline documented in the module
    docstring), which also makes verdict order = submission order —
    deterministic under replay.

    ``max_queue_depth`` 0 disables the depth gate; ``tenant_qps`` 0
    disables quotas (both default off so embedders opt in via the
    --fleet-* surface).

    ``tiers`` (a fleet.tiers.TierPolicy, optional) supersedes the global
    per-tenant quota with per-TIER budgets: one shared token bucket per
    tier (tier.qps/burst; 0 = the tier is unmetered) plus a queue-share
    slice of ``max_queue_depth`` — a storming bronze tier fills its slice
    and sheds while gold's slice stays open, which is how "low tiers shed
    first under queue pressure" holds at admission time."""

    def __init__(
        self,
        max_queue_depth: int = 0,
        tenant_qps: float = 0.0,
        tenant_burst: float = 0.0,
        window_s: float = 0.005,
        max_tenants: int = 64,
        tiers: Optional[TierPolicy] = None,
    ) -> None:
        self.max_queue_depth = int(max_queue_depth)
        self.tenant_qps = float(tenant_qps)
        self.tenant_burst = float(tenant_burst) if tenant_burst > 0 else max(
            self.tenant_qps, 1.0
        )
        self.window_s = float(window_s)
        self.max_tenants = int(max_tenants)
        self.tiers = tiers
        self._buckets: Dict[str, TokenBucket] = {}
        # one shared bucket per TIER (tiers mode): the tier's tenants draw
        # from one budget, which is the whole point of a tier
        self._tier_buckets: Dict[str, TokenBucket] = {}
        # lifetime admission tallies by outcome (report/debug surface —
        # the per-series truth lives in fleet_admission_total)
        self.tallies: Dict[str, int] = {}

    def _bucket_for(self, tenant_id: str) -> TokenBucket:
        bucket = self._buckets.get(tenant_id)
        if bucket is not None:
            return bucket
        if self.max_tenants > 0 and len(self._buckets) >= self.max_tenants:
            overflow = self._buckets.get(OVERFLOW_BUCKET)
            if overflow is None:
                overflow = self._buckets[OVERFLOW_BUCKET] = TokenBucket(
                    self.tenant_qps, self.tenant_burst
                )
            return overflow
        bucket = self._buckets[tenant_id] = TokenBucket(
            self.tenant_qps, self.tenant_burst
        )
        return bucket

    def tier_for(self, tenant_id: str) -> Optional[TierSpec]:
        return self.tiers.tier_for(tenant_id) if self.tiers else None

    def _tier_bucket(self, tier: TierSpec) -> TokenBucket:
        bucket = self._tier_buckets.get(tier.name)
        if bucket is None:
            bucket = self._tier_buckets[tier.name] = TokenBucket(
                tier.qps, tier.burst if tier.burst > 0 else max(tier.qps, 1.0)
            )
        return bucket

    def admit(
        self, tenant_id: str, queue_depth: int, now: float,
        draining: bool = False, tier_depth: int = 0,
    ) -> AdmissionVerdict:
        """Judge one submit (caller holds the queue lock). Order matters
        and is part of the contract: drain first (an over-quota tenant
        hitting a draining sidecar must hear "go elsewhere", not "slow
        down"), then queue depth — global bound, then the tier's
        queue-share slice (``tier_depth`` = this tier's queued count) —
        then quota (the tier's shared bucket when tiers are configured,
        else the global per-tenant bucket)."""
        tier = self.tier_for(tenant_id)
        label = tier.name if tier is not None else ""
        if draining:
            return self._tally(AdmissionVerdict(SHED_DRAINING, tier=label))
        if self.max_queue_depth > 0:
            if queue_depth >= self.max_queue_depth:
                # the queue will not shrink before the next flush window
                # at the earliest — that is the honest retry hint
                return self._tally(AdmissionVerdict(
                    SHED_QUEUE_FULL, max(self.window_s, 1e-3), tier=label,
                ))
            if tier is not None and tier.queue_share < 1.0:
                share = max(1, int(tier.queue_share * self.max_queue_depth))
                if tier_depth >= share:
                    return self._tally(AdmissionVerdict(
                        SHED_QUEUE_FULL, max(self.window_s, 1e-3),
                        tier=label,
                    ))
        if tier is not None:
            if tier.qps > 0:
                wait = self._tier_bucket(tier).try_take(now)
                if wait > 0.0:
                    return self._tally(
                        AdmissionVerdict(SHED_QUOTA, wait, tier=label)
                    )
        elif self.tenant_qps > 0:
            wait = self._bucket_for(tenant_id).try_take(now)
            if wait > 0.0:
                return self._tally(AdmissionVerdict(SHED_QUOTA, wait))
        return self._tally(AdmissionVerdict(ADMIT_OK, tier=label))

    def admit_expired(self, tenant_id: str = "") -> AdmissionVerdict:
        """A request whose deadline budget was already spent at submit:
        shed typed (DEADLINE_EXCEEDED) — queueing it would burn a batch
        slot on an answer nobody can receive in time."""
        tier = self.tier_for(tenant_id)
        return self._tally(AdmissionVerdict(
            SHED_DEADLINE, tier=tier.name if tier is not None else "",
        ))

    def _tally(self, verdict: AdmissionVerdict) -> AdmissionVerdict:
        self.tallies[verdict.outcome] = self.tallies.get(verdict.outcome, 0) + 1
        return verdict

    def snapshot(self) -> Dict[str, int]:
        """Lifetime outcome tallies (caller holds the queue lock) —
        consumed by reports through sorted() only."""
        return dict(self.tallies)


def partition_expired(
    entries, now: float
) -> Tuple[list, list]:
    """Split (request, ticket) pairs into (live, expired) by ticket
    deadline at ``now``, preserving submission order — the shared shed
    step of ``flush`` and ``_dispatch_batch`` (an expired ticket must
    never consume a batch slot)."""
    live, expired = [], []
    for req, ticket in entries:
        deadline = getattr(ticket, "deadline_ts", None)
        if deadline is not None and now >= deadline:
            expired.append((req, ticket))
        else:
            live.append((req, ticket))
    return live, expired
