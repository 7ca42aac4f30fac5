"""The coalescing multi-tenant estimator service.

Many independent estimate/what-if requests → one sharded mesh dispatch.
The pipeline (ARCHITECTURE.md "Fleet serving"):

    admission → bucket → dispatch → demux

1. **Admission**: ``submit()`` parks a request (lock-disciplined queue,
   graftlint GL004) and returns a ticket. The RPC path runs a window
   thread that flushes the queue every coalescing window; deterministic
   drivers (loadgen, tests) call ``flush()`` themselves — batch formation
   is a pure function of submission order, which is what makes fleet
   decision ledgers byte-identical across replays.
2. **Bucketing**: each request is exact-padded to the smallest configured
   power-of-two (P, G, R) bucket (fleet/buckets.py carries the safety
   argument), same-bucket requests are chunked into batches of
   ``batch_scenarios`` scenario slots, and empty slots pad with zero
   worlds — one compiled kernel shape per bucket, pre-warmable.
3. **Dispatch**: one batched dispatch per batch
   (parallel/mesh.fleet_batch_estimate), walked down a circuit-broken
   ladder. On a CUDA card it is one rung, ``cuda``: the batch in ONE
   K1/K2 launch (``ops/ffd_scan.ffd_binpack_scenarios_cuda``, or the
   torch loop past the kernels' shared-memory gate), strict — a fault
   fails the batch's tickets with the error and no host rung serves them,
   an open breaker fails them until a half-open probe closes it. Off a
   card it is the JAX package's two rungs: the batched torch loop
   (``torch``, the JAX package's ``xla``), then the serial per-scenario
   oracle twin (``python``, estimator/reference_impl). Every rung shares
   the one FFD order spec, so a faulted batch degrades with IDENTICAL
   per-tenant verdicts.
4. **Demux**: tenant ``s``'s answer is the ``[:G, :P]`` slice of scenario
   ``s`` — plus what-if cost ranking when the request carried prices.

Time is injected (``clock``/``sleep`` parameter defaults — the GL001
sanctioned seam; ``tick(now)`` feeds the breaker cooldowns) so fault
scenarios replay byte-for-byte on a simulated clock.

The port's copy of ``autoscaler_tpu/fleet/coalescer.py``, with the ladder
named for the card (``NAME_MAP``: ``xla`` → ``torch``) and strict on it.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from autoscaler_tpu_torch import trace
from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.estimator.ladder import (
    RUNG_CUDA,
    RUNG_PYTHON,
    RUNG_TORCH,
    KernelLadder,
)
from autoscaler_tpu_torch.fleet.admission import AdmissionController, partition_expired
from autoscaler_tpu_torch.fleet.buckets import (
    DEFAULT_BUCKETS,
    BucketSpec,
    adhoc_bucket,
    pad_operands,
    padding_waste,
    parse_buckets,
    select_bucket,
)
from autoscaler_tpu_torch.fleet.tiers import parse_tiers
from autoscaler_tpu_torch.fleet.errors import (
    SHED_DEADLINE,
    SHED_DRAINING,
    SHED_QUEUE_FULL,
    TICKET_ABANDONED,
    TICKET_EXPIRED,
    TICKET_FAILED,
    TICKET_RESOLVED,
    FleetDeadlineError,
    FleetDrainError,
    FleetError,
    FleetOverloadError,
)
from autoscaler_tpu_torch.metrics import metrics as metrics_mod

# route labels on the estimator_kernel_route vocabulary pattern: which lane
# served a coalesced batch (perf-observatory records key on these)
ROUTE_BATCHED = "fleet_batched"
ROUTE_ORACLE = "fleet_oracle"

# the aggregate tenant label past --fleet-max-tenant-labels: a misbehaving
# fleet (or an abusive tenant-id generator) collapses into ONE series
# instead of exploding /metrics exposition
OVERFLOW_TENANT = "__overflow__"


@dataclass
class FleetRequest:
    """One tenant's estimate question, in packed-tensor form (the same
    operand set rpc Estimate carries, plus identity and optional what-if
    prices)."""

    tenant_id: str
    pod_req: np.ndarray          # [P, R] f32
    pod_masks: np.ndarray        # [G, P] bool
    template_allocs: np.ndarray  # [G, R] f32
    node_caps: np.ndarray        # [G] i32
    max_nodes: int
    prices: Optional[np.ndarray] = None  # [G] f32 — present = what-if ranking
    # origin trace context ("<trace_id>:<span_id>", trace.current_context):
    # the RPC path decodes it from the wire, programmatic submitters inside
    # a traced tick get it captured automatically at submit() — it parents
    # the shared fleetDispatch span's links and the SLI exemplars
    trace_context: str = ""
    # remaining deadline budget in seconds at submission (the RPC path
    # passes gRPC's context.time_remaining(), driver paths pass the
    # request's own budget; None = no deadline). The coalescer converts it
    # to an absolute instant on ITS injected clock, so expiry shedding is
    # deterministic under the loadgen sim clock.
    deadline_s: Optional[float] = None

    def shape(self) -> Tuple[int, int, int]:
        P, R = self.pod_req.shape
        return P, self.pod_masks.shape[0], R


@dataclass
class FleetAnswer:
    """One tenant's demuxed verdict plus batch provenance (observability
    fields — everything above ``bucket`` is byte-compared against solo)."""

    node_counts: np.ndarray      # [G] i32
    scheduled: np.ndarray        # [G, P] bool
    bucket: str = ""
    batch_size: int = 0          # co-batched real requests
    padding_waste: float = 0.0   # padded-cell fraction of the batch
    route: str = ROUTE_BATCHED   # which ladder rung served the batch
    best_group: int = -1         # what-if: argmin cost (prices present)
    best_cost: float = 0.0


class FleetTicket:
    """The demux hand-back: admission returns immediately, the answer
    arrives when the request's batch dispatches."""

    def __init__(self) -> None:
        self._done = threading.Event()
        self._answer: Optional[FleetAnswer] = None
        self._error: Optional[BaseException] = None
        # wall stamps (time.perf_counter — the sanctioned measurement
        # clock, never a replay artifact): admission, dispatch, and
        # resolution, so a caller can split its true service latency into
        # queue wait vs service even when its batch dispatched before
        # other buckets in the same flush
        self.submitted_wall: float = 0.0
        self.dispatched_wall: float = 0.0
        self.resolved_wall: float = 0.0
        # lifecycle stamps on the submitter's timeline clock (captured at
        # submit via trace.timeline_clock) — DETERMINISTIC under the
        # loadgen drivers' synthetic clocks, so the queue/service
        # decomposition can ride ledgers and SLO windows byte-stably:
        # submit → admit (queued) → dispatch (batch walk begins) → demux
        # (this ticket's slice cut) → resolve (answer/error visible).
        # ONE clock serves all five stamps even when dispatch happens on
        # the (untraced) window thread — mixing the submitter's timeline
        # with the bare-monotonic fallback would make the deltas garbage.
        self.t_submit: float = 0.0
        self.t_admit: float = 0.0
        self.t_dispatch: float = 0.0
        self.t_demux: float = 0.0
        self.t_resolve: float = 0.0
        # the captured stamp clock (seated by submit(); the coalescer's
        # injected clock when the submitter ran outside any trace)
        self.stamp_clock: Callable[[], float] = time.monotonic
        # origin trace context (copied from the request at submit) — the
        # span-link + exemplar identity of this ticket
        self.trace_context: str = ""
        # quota tier of the submitting tenant ("" when tiers are off) —
        # the tier label on the lifecycle SLI series and ledger rows
        self.tier: str = ""
        # absolute expiry instant on the COALESCER's injected clock (seated
        # by submit from FleetRequest.deadline_s; None = no deadline) —
        # flush/_dispatch_batch shed past-deadline tickets typed instead of
        # spending batch slots on answers nobody is waiting for
        self.deadline_ts: Optional[float] = None
        # abandonment: result(timeout) raising TimeoutError marks the
        # caller DEPARTED. A late resolve still completes the ticket (a
        # polling retry must never hang) but its lifecycle is counted
        # `abandoned`, not stamped into SLIs/exemplars as a fake good event
        self._state_lock = threading.Lock()
        self._abandoned = False

    @property
    def abandoned(self) -> bool:
        with self._state_lock:
            return self._abandoned

    def done(self) -> bool:
        """True once the ticket reached a terminal state (answer, typed
        failure, or typed shed) — the zero-hung-tickets audit reads this."""
        return self._done.is_set()

    def resolve(self, answer: FleetAnswer) -> bool:
        """Deliver the answer. Returns True when the caller was still
        waiting (lifecycle SLIs may be stamped), False when the ticket was
        abandoned — taken under the state lock so a ``result`` timing out
        concurrently cannot be half-counted on both sides."""
        with self._state_lock:
            abandoned = self._abandoned
            self._answer = answer
            self.resolved_wall = time.perf_counter()
            self._done.set()
        return not abandoned

    def fail(self, error: BaseException) -> bool:
        with self._state_lock:
            abandoned = self._abandoned
            self._error = error
            self.resolved_wall = time.perf_counter()
            self._done.set()
        return not abandoned

    def result(self, timeout: Optional[float] = None) -> FleetAnswer:
        if not self._done.wait(timeout):
            # atomic vs a concurrent resolve(): only a ticket that is
            # STILL unresolved is marked abandoned — if the answer landed
            # between the wait and here, the caller can still read it on
            # a retry and the lifecycle observation stays honest
            with self._state_lock:
                if not self._done.is_set():
                    self._abandoned = True
                    raise TimeoutError(
                        "fleet answer not ready within the deadline"
                    )
        with self._state_lock:
            error, answer = self._error, self._answer
        if error is not None:
            raise error
        assert answer is not None
        return answer


class FleetCoalescer:
    """One coalescer per serving process. ``mesh`` is the device mesh the
    batched dispatches run over (parallel/mesh.Mesh; None = one device,
    ``device``: None is the first CUDA card, ``"cpu"`` the host).
    ``ladder`` is a KernelLadder whose ``cuda`` breaker (on a card) or
    ``torch``/``python`` breakers (off it) guard the fleet rungs; a fault
    hook installed there injects device faults. ``observatory`` (a
    perf.PerfObservatory) sees every batch dispatch, which is where the
    per-bucket compile cache hit/miss telemetry comes from — each bucket is
    one (route, shape-signature) key."""

    def __init__(
        self,
        buckets: str = DEFAULT_BUCKETS,
        window_s: float = 0.005,
        batch_scenarios: int = 8,
        mesh: Any = None,
        metrics: Any = None,
        observatory: Any = None,
        ladder: Optional[KernelLadder] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        slo: Any = None,
        max_tenant_labels: int = 64,
        max_queue_depth: int = 0,
        tenant_qps: float = 0.0,
        tenant_burst: float = 0.0,
        tenant_tiers: str = "",
        latency_hook: Optional[Callable[[str], float]] = None,
        device: Any = None,
    ) -> None:
        if batch_scenarios < 1:
            raise ValueError(f"batch_scenarios must be >= 1, got {batch_scenarios}")
        self.buckets: List[BucketSpec] = parse_buckets(buckets)
        self.window_s = float(window_s)
        self.batch_scenarios = int(batch_scenarios)
        self.mesh = mesh
        self.device = (
            mesh.devices.flat[0] if mesh is not None else resolve_device(device)
        )
        self.metrics = metrics
        self.observatory = observatory
        # slo (an slo.SloEngine, optional): every resolved/failed ticket
        # feeds one fleet_e2e SLI event on its timeline stamps
        self.slo = slo
        # tenant label cardinality bound for the per-tenant metric series
        # (--fleet-max-tenant-labels): the first N distinct tenants keep
        # their own label, the rest aggregate into OVERFLOW_TENANT.
        # 0 = unbounded (trusted closed fleets only).
        self.max_tenant_labels = int(max_tenant_labels)
        self.ladder = ladder or KernelLadder()
        self.ladder.bind_metrics(metrics)
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[Tuple[FleetRequest, FleetTicket]] = []
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # drain bit (GL004: flipped only under the queue lock): True from
        # the moment stop() begins until a start() re-arms — a submit that
        # loses the race against a drain gets the typed FleetDrainError,
        # never a ticket that nothing will ever flush
        self._draining = False
        self._prewarmed: List[str] = []
        self._configured = frozenset(self.buckets)
        # tenant id → metric label, insertion-ordered admission (GL004:
        # written only under the queue lock)
        self._tenant_labels: Dict[str, str] = {}
        # tenant quota tiers (--fleet-tenant-tiers JSON → TierPolicy;
        # None = tiers off, the global per-tenant quota stands). Tiers
        # supersede tenant_qps: per-tier shared buckets, queue-share
        # slices, default deadlines, and tier-priority flush ordering.
        self.tiers = parse_tiers(tenant_tiers)
        # per-tier queued counts (GL004: mutated only under the queue
        # lock, always in step with _pending) — the queue-share input
        self._tier_pending: Dict[str, int] = {}
        # deadline-aware admission: queue-depth bound + per-tenant token
        # buckets on the injected clock (fleet/admission.py; all state
        # mutated under the queue lock). Defaults keep both gates off.
        self.admission = AdmissionController(
            max_queue_depth=max_queue_depth,
            tenant_qps=tenant_qps,
            tenant_burst=tenant_burst,
            window_s=self.window_s,
            # same bound AND same semantics as the metric-label guard:
            # 0 = unbounded (every tenant gets its own quota bucket)
            max_tenants=self.max_tenant_labels,
            tiers=self.tiers,
        )
        # chaos seam (loadgen rpc_slow): tenant_id → extra service seconds
        # folded into the demux/resolve timeline stamps — simulated RPC
        # slowness that reaches the SLIs/SLO deterministically
        self.latency_hook = latency_hook

    # -- wiring ---------------------------------------------------------------
    @classmethod
    def from_options(cls, options, **kwargs) -> "FleetCoalescer":
        """Build (and pre-warm, per ``fleet_prewarm``) a coalescer from
        AutoscalingOptions — the --fleet-* flag surface."""
        co = cls(
            buckets=options.fleet_shape_buckets,
            window_s=options.fleet_coalesce_window_ms / 1000.0,
            batch_scenarios=options.fleet_batch_scenarios,
            max_tenant_labels=options.fleet_max_tenant_labels,
            max_queue_depth=options.fleet_max_queue_depth,
            tenant_qps=options.fleet_tenant_qps,
            tenant_burst=options.fleet_tenant_burst,
            tenant_tiers=options.fleet_tenant_tiers,
            **kwargs,
        )
        if options.fleet_prewarm:
            co.prewarm()
        return co

    def tick(self, now: float) -> None:
        """Advance the ladder clock (wall in production, simulated under
        loadgen — breaker cooldowns replay byte-for-byte)."""
        self.ladder.tick(now)

    def degraded(self) -> List[str]:
        return self.ladder.degraded()

    def prewarmed(self) -> List[str]:
        with self._lock:
            return list(self._prewarmed)

    # -- admission ------------------------------------------------------------
    def submit(self, request: FleetRequest) -> FleetTicket:
        """Park one request for the next coalesced dispatch. The queue is
        the only cross-thread state; tickets are resolved outside the lock.

        Admission is deadline-aware and typed: a draining coalescer raises
        :class:`FleetDrainError` (fail over, don't wait), a full queue or
        an over-quota tenant raises :class:`FleetOverloadError` carrying
        ``retry_after_s``, and a request whose deadline budget is already
        spent raises :class:`FleetDeadlineError` — a caller NEVER gets a
        ticket that nothing will resolve.

        Trace-context capture: a request that arrived without an explicit
        origin context (the RPC path decodes one from the wire) inherits
        the ambient one — a submitter inside a traced tick (loadgen fleet
        driver, gym rollouts) gets its span linked from the shared
        fleetDispatch span for free."""
        ticket = FleetTicket()
        if not request.trace_context:
            ctx = trace.current_context()
            if ctx is not None:
                request.trace_context = ctx
        ticket.trace_context = request.trace_context
        # capture the submitter's clock domain ONCE: every later stamp —
        # including those taken on the window thread, which has no active
        # trace — reads this same clock, so the queue/service deltas are
        # real durations in one domain (synthetic under loadgen, the
        # serving tracer's wall clock on the RPC path)
        ticket.stamp_clock = trace.timeline_clock() or self._clock
        ticket.t_submit = ticket.stamp_clock()
        ticket.submitted_wall = time.perf_counter()
        tier = (
            self.tiers.tier_for(request.tenant_id)
            if self.tiers is not None else None
        )
        if tier is not None:
            ticket.tier = tier.name
            if request.deadline_s is None and tier.default_deadline_s > 0:
                # the tier's latency contract binds even clients that
                # submitted without a budget of their own
                request.deadline_s = tier.default_deadline_s
        now = self._clock()
        if request.deadline_s is not None:
            ticket.deadline_ts = now + max(float(request.deadline_s), 0.0)
        with self._lock:
            if ticket.deadline_ts is not None and now >= ticket.deadline_ts:
                # a dead-on-arrival budget: shed typed BEFORE the
                # drain/depth/quota gates — a request nobody can answer in
                # time must not burn a quota token or count twice in the
                # admission tallies
                verdict = self.admission.admit_expired(request.tenant_id)
            else:
                verdict = self.admission.admit(
                    request.tenant_id, len(self._pending), now,
                    draining=self._draining,
                    tier_depth=(
                        self._tier_pending.get(tier.name, 0)
                        if tier is not None else 0
                    ),
                )
            tenant = self._tenant_label_locked(request.tenant_id)
            if verdict.admitted:
                self._pending.append((request, ticket))
                if tier is not None:
                    self._tier_pending[tier.name] = (
                        self._tier_pending.get(tier.name, 0) + 1
                    )
                if self.metrics is not None:
                    # published under the queue lock so a concurrent
                    # flush() can't interleave its set(0) with a stale
                    # depth — the gauge and the queue move together
                    # (metric series take their own inner lock; the order
                    # is always queue → series)
                    self.metrics.fleet_queue_depth.set(
                        float(len(self._pending))
                    )
                self._cond.notify()
        if self.metrics is not None:
            # the tier label only exists when a tier policy is configured
            # (tier names are a closed small set — the cardinality bound
            # stands); tierless deployments keep the tier-free series shape
            labels = dict(outcome=verdict.outcome, tenant=tenant)
            if self.tiers is not None:
                labels["tier"] = verdict.tier
            self.metrics.fleet_admission_total.inc(**labels)
        if not verdict.admitted:
            raise self._shed_error(verdict, request.tenant_id)
        ticket.t_admit = ticket.stamp_clock()
        return ticket

    @staticmethod
    def _shed_error(verdict, tenant_id: str) -> Exception:
        """Admission verdict → the typed rejection the RPC layer maps to
        a gRPC status (errors.py documents the mapping)."""
        if verdict.outcome == SHED_DRAINING:
            return FleetDrainError(
                "fleet coalescer draining: sidecar shutting down, fail "
                "over to another endpoint"
            )
        if verdict.outcome == SHED_DEADLINE:
            return FleetDeadlineError(
                f"tenant {tenant_id} request deadline already expired at "
                "admission"
            )
        detail = (
            "coalescing queue full"
            if verdict.outcome == SHED_QUEUE_FULL
            else f"tenant {tenant_id} over quota"
        )
        return FleetOverloadError(
            f"{detail}; retry after {verdict.retry_after_s:.3f}s",
            retry_after_s=verdict.retry_after_s,
            outcome=verdict.outcome,
        )

    def _tenant_label_locked(self, tenant_id: str) -> str:
        """The cardinality bound (caller holds the queue lock): the first
        ``max_tenant_labels`` distinct tenants keep their own metric label;
        later arrivals aggregate into OVERFLOW_TENANT. First-come admission
        is deterministic under replay (submission order IS the ledger
        order). Overflow tenants are NOT memoized — once the admission set
        is full it stays full, so membership answers every later lookup
        and recording each abusive tenant id would grow this dict without
        bound (the exact attack the label bound exists to stop)."""
        label = self._tenant_labels.get(tenant_id)
        if label is not None:
            return label
        if (
            self.max_tenant_labels > 0
            and len(self._tenant_labels) >= self.max_tenant_labels
        ):
            return OVERFLOW_TENANT
        self._tenant_labels[tenant_id] = tenant_id
        return tenant_id

    def tenant_label(self, tenant_id: str) -> str:
        with self._lock:
            return self._tenant_label_locked(tenant_id)

    def tier_name(self, tenant_id: str) -> str:
        """The tenant's quota tier ("" when tiers are off) — ledger rows
        and reports key sheds on it."""
        if self.tiers is None:
            return ""
        return self.tiers.tier_for(tenant_id).name

    def admission_snapshot(self) -> Dict[str, int]:
        """Lifetime admission-outcome tallies, read under the queue lock
        (the controller itself is lock-free by contract)."""
        with self._lock:
            return self.admission.snapshot()

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- the coalescing window (RPC path) -------------------------------------
    def start(self) -> None:
        """EXPLICIT start: re-arms a drained coalescer (the one way out of
        the drain state) and runs the window thread. Per-request revival
        paths must use :meth:`ensure_running` instead — it refuses to
        un-drain."""
        with self._lock:
            self._draining = False
            if self.metrics is not None:
                self.metrics.fleet_draining.set(0.0)
        self.ensure_running()

    def ensure_running(self) -> bool:
        """Run the window thread UNLESS draining (atomic with the drain
        bit): whenever the queue is non-empty it waits one coalescing
        window (letting co-tenant requests pile in), then flushes. A
        thread that died (it should not — the loop absorbs flush errors)
        is revived, not treated as running. Returns False while draining —
        a racing RPC must NOT resurrect a stopping coalescer (its submit
        gets the typed drain rejection instead)."""
        with self._lock:
            if self._draining:
                return False
            if self._thread is not None and self._thread.is_alive():
                return True
            self._running = True
            self._thread = threading.Thread(
                target=self._window_loop, name="fleet-coalescer", daemon=True
            )
            thread = self._thread
        thread.start()
        return True

    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def stop(self) -> None:
        """The drain sequence: (1) flip the drain bit under the queue lock
        — from this instant every submit, including one racing this very
        call, gets the typed FleetDrainError instead of a ticket nothing
        will flush; (2) stop and join the window thread; (3) flush every
        in-flight ticket so the queue empties with answers, not hangs."""
        with self._lock:
            self._draining = True
            if self.metrics is not None:
                # order queue-state → series, same as the depth gauge rule
                self.metrics.fleet_draining.set(1.0)
            self._running = False
            thread = self._thread
            self._thread = None
            self._cond.notify_all()
        if thread is not None:
            thread.join(timeout=5.0)
        self.flush()  # drain stragglers so no ticket hangs

    def _window_loop(self) -> None:
        import logging

        while True:
            with self._lock:
                if not self._running:
                    return
                if not self._pending:
                    self._cond.wait(timeout=0.1)
                    continue
            self._sleep(self.window_s)
            try:
                self.flush()
            except Exception:  # noqa: BLE001 — the window thread IS the
                # service: an escaping flush error (per-batch errors already
                # resolve their tickets) must not kill it, or every later
                # request hangs until deadline for the process lifetime
                logging.getLogger("fleet").exception(
                    "fleet window flush failed; the loop continues"
                )

    # -- bucket + dispatch + demux --------------------------------------------
    def flush(self, limit: Optional[int] = None) -> int:
        """Dispatch pending requests; returns the request count served.
        Deterministic: batches form per bucket in submission order, buckets
        dispatch in sorted key order — replaying the same submission
        sequence forms the same batches.

        Expired tickets are shed FIRST, typed (FleetDeadlineError), before
        they consume batch slots — shedding runs on the injected clock so
        it replays byte-identically. ``limit`` bounds how many live
        requests this flush serves (submission order; the rest stay
        queued) — the overload bench uses it to model a service slower
        than its arrival rate; production flushes pass None.

        With tiers configured the live queue is served in
        (tier shed_priority, submission order): gold dispatches first and
        under bounded capacity the bronze tail is what stays queued (and
        eventually expires) — "shed order under queue pressure prefers low
        tiers". The sort key is a pure function of submission order plus
        the static tier table, so replays stay byte-identical."""
        now = self._clock()
        with self._lock:
            live, expired = partition_expired(self._pending, now)
            if self.tiers is not None and len(live) > 1:
                # sorted() is stable: within a tier, submission order holds
                live = sorted(
                    live,
                    key=lambda rt: self.tiers.tier_for(
                        rt[0].tenant_id
                    ).shed_priority,
                )
            if limit is not None and limit < len(live):
                drained, rest = live[:limit], live[limit:]
            else:
                drained, rest = live, []
            self._pending = rest
            if self.tiers is not None:
                counts: Dict[str, int] = {}
                for req, _ in rest:
                    name = self.tiers.tier_for(req.tenant_id).name
                    counts[name] = counts.get(name, 0) + 1
                self._tier_pending = counts
            if self.metrics is not None:
                self.metrics.fleet_queue_depth.set(float(len(rest)))
        for req, ticket in expired:
            self._shed_expired(req, ticket, now)
        if not drained:
            return 0
        by_bucket: Dict[BucketSpec, List[Tuple[FleetRequest, FleetTicket]]] = {}
        for req, ticket in drained:
            P, G, R = req.shape()
            bucket = select_bucket(self.buckets, P, G, R) or adhoc_bucket(P, G, R)
            by_bucket.setdefault(bucket, []).append((req, ticket))
        for bucket in sorted(by_bucket, key=lambda b: b.key):
            entries = by_bucket[bucket]
            for i in range(0, len(entries), self.batch_scenarios):
                self._dispatch_batch(bucket, entries[i : i + self.batch_scenarios])
        return len(drained)

    def _batch_slots(self, bucket: BucketSpec, n: int) -> int:
        """Scenario slots for one batch. Configured buckets always dispatch
        the full ``batch_scenarios`` so each holds ONE compiled shape
        (pre-warmable, cache-coherent). Ad-hoc buckets are one-off by
        definition — never pre-warmed, compile-on-arrival — so padding them
        to the full width would multiply the kernel work for nothing;
        they get the pow2 envelope of the actual request count."""
        from autoscaler_tpu_torch.fleet.buckets import pow2ceil

        if bucket in self._configured:
            return self.batch_scenarios
        return min(pow2ceil(max(n, 1)), self.batch_scenarios)

    def _batch_operands(
        self,
        bucket: BucketSpec,
        entries: Sequence[Tuple[FleetRequest, FleetTicket]],
        S: int,
    ):
        scen_req = np.zeros((S, bucket.pods, bucket.resources), np.float32)
        scen_masks = np.zeros((S, bucket.groups, bucket.pods), bool)
        scen_allocs = np.zeros((S, bucket.groups, bucket.resources), np.float32)
        scen_caps = np.zeros((S, bucket.groups), np.int32)
        for s, (req, _) in enumerate(entries):
            # the tenant's own node budget becomes a dynamic cap (min with
            # its declared caps) so the shared static carry (= bucket P)
            # reproduces the solo max_nodes semantics exactly
            caps = np.minimum(
                req.node_caps.astype(np.int64), int(req.max_nodes)
            ).astype(np.int32)
            r, m, a, c = pad_operands(
                bucket, req.pod_req, req.pod_masks, req.template_allocs, caps
            )
            scen_req[s], scen_masks[s], scen_allocs[s], scen_caps[s] = r, m, a, c
        return scen_req, scen_masks, scen_allocs, scen_caps

    def _shed_expired(self, req: FleetRequest, ticket: FleetTicket,
                      now: float) -> None:
        """Fail one past-deadline ticket typed (DEADLINE_EXCEEDED — never a
        silent hang) and charge the bad-budget event on the injected clock
        so the shed replays byte-identically. Queue expiry is a TICKET
        outcome, not an admission verdict — the ticket was already counted
        `admitted`, so only fleet_ticket_outcomes_total moves here (an
        admission_total row too would make the verdicts stop summing to
        submits)."""
        ticket.t_resolve = ticket.stamp_clock()
        if self.slo is not None:
            from autoscaler_tpu_torch.slo import SLI_FLEET_E2E

            self.slo.observe_event(SLI_FLEET_E2E, bad=True, now=now)
        delivered = ticket.fail(
            FleetDeadlineError(
                "fleet ticket deadline expired before its batch dispatched"
            )
        )
        self._count_outcome(
            TICKET_EXPIRED if delivered else TICKET_ABANDONED,
            req.tenant_id,
        )

    def _count_outcome(self, outcome: str, tenant_id: str) -> None:
        if self.metrics is not None:
            self.metrics.fleet_ticket_outcomes_total.inc(
                outcome=outcome, tenant=self.tenant_label(tenant_id)
            )

    def _dispatch_batch(
        self, bucket: BucketSpec, entries: Sequence[Tuple[FleetRequest, FleetTicket]]
    ) -> None:
        # second expiry gate (the first runs in flush): on the RPC path
        # the clock advances between flush partition and dispatch, and a
        # ticket that died waiting for earlier buckets in this same flush
        # must not consume a batch slot either
        now = self._clock()
        entries, expired = partition_expired(entries, now)
        for req, ticket in expired:
            self._shed_expired(req, ticket, now)
        if not entries:
            return
        try:
            slots = self._batch_slots(bucket, len(entries))
            scen_req, scen_masks, scen_allocs, scen_caps = self._batch_operands(
                bucket, entries, slots
            )
            waste = padding_waste(
                bucket, [req.shape() for req, _ in entries], slots
            )
            if self.metrics is not None:
                self.metrics.fleet_batch_size.observe(
                    float(len(entries)), bucket=bucket.key
                )
                self.metrics.fleet_padding_waste_ratio.observe(
                    waste, bucket=bucket.key
                )
                for req, _ in entries:
                    self.metrics.fleet_requests_total.inc(
                        bucket=bucket.key,
                        tenant=self.tenant_label(req.tenant_id),
                    )
            # the dispatch moment is shared by the batch (one walk serves
            # them all) but each ticket stamps it from its OWN captured
            # clock: bucket-wait = t_dispatch − t_admit per ticket
            dispatch_wall = time.perf_counter()
            for _, ticket in entries:
                ticket.t_dispatch = ticket.stamp_clock()
                ticket.dispatched_wall = dispatch_wall
            counts, scheduled, route = self._walk_ladder(
                bucket, scen_req, scen_masks, scen_allocs, scen_caps,
                batch=len(entries),
                # one batch, many traces: the shared fleetDispatch span
                # links every co-batched ticket's origin context
                links=[t.trace_context for _, t in entries if t.trace_context],
            )
        except Exception as e:  # noqa: BLE001 — whatever failed (operand
            # build, every rung), the batch's tickets must still resolve:
            # the RPC handlers are blocked on them, and an unresolved
            # ticket is a hang-until-deadline. The typed error rides each
            # ticket out.
            err = FleetError(f"no fleet rung served bucket {bucket.key}: {e}")
            err.__cause__ = e
            for req, ticket in entries:
                ticket.t_resolve = ticket.stamp_clock()
                if self.slo is not None:
                    # a failed batch is bad budget regardless of latency;
                    # the event timestamp rides the coalescer's injected
                    # clock (the burn windows' time base), not the
                    # timeline stamps (the latency measurement)
                    from autoscaler_tpu_torch.slo import SLI_FLEET_E2E

                    self.slo.observe_event(
                        SLI_FLEET_E2E, bad=True, now=self._clock()
                    )
                delivered = ticket.fail(err)
                self._count_outcome(
                    TICKET_FAILED if delivered else TICKET_ABANDONED,
                    req.tenant_id,
                )
            return
        if self.metrics is not None:
            self.metrics.fleet_batches_total.inc(bucket=bucket.key, route=route)
        for s, (req, ticket) in enumerate(entries):
            answer = self._demux(
                req, counts[s], scheduled[s], bucket, len(entries), waste,
                route,
            )
            # chaos seam: injected rpc_slow latency lands in the timeline
            # stamps (deterministic under the sim clock) so slow service
            # reaches the SLIs/SLO exactly as real slowness would
            extra = (
                self.latency_hook(req.tenant_id)
                if self.latency_hook is not None else 0.0
            )
            ticket.t_demux = ticket.stamp_clock() + extra
            # resolve is stamped BEFORE the event fires so a caller
            # unblocked by result() always reads a complete stamp set
            ticket.t_resolve = ticket.stamp_clock() + extra
            delivered = ticket.resolve(answer)
            if delivered:
                # lifecycle SLIs fire only for a caller that was still
                # there — an abandoned ticket's late answer must not stamp
                # exemplars/SLO good events for a departed caller
                self._observe_lifecycle(req, ticket, bucket)
                self._count_outcome(TICKET_RESOLVED, req.tenant_id)
            else:
                self._count_outcome(TICKET_ABANDONED, req.tenant_id)

    def _observe_lifecycle(
        self, req: FleetRequest, ticket: FleetTicket, bucket: BucketSpec
    ) -> None:
        """Per-ticket request-lifecycle SLIs on the timeline stamps:
        queue wait (submit→dispatch: admission + coalescing window + bucket
        queue), service (dispatch→resolve: batched kernel + demux), and
        end-to-end — per-tenant histograms with OpenMetrics exemplars
        naming the origin trace, plus one fleet_e2e SLO event."""
        queue_wait = max(ticket.t_dispatch - ticket.t_submit, 0.0)
        service = max(ticket.t_resolve - ticket.t_dispatch, 0.0)
        e2e = max(ticket.t_resolve - ticket.t_submit, 0.0)
        if self.metrics is not None:
            tenant = self.tenant_label(req.tenant_id)
            parsed = trace.parse_context(ticket.trace_context)
            # quota-tier label only when a policy is configured (closed
            # small vocabulary — the SLI cardinality bound stands)
            extra = {"tier": ticket.tier} if self.tiers is not None else {}
            rows = (
                (self.metrics.fleet_queue_wait_seconds, queue_wait),
                (self.metrics.fleet_service_seconds, service),
                (self.metrics.fleet_e2e_seconds, e2e),
            )
            for series, value in rows:
                if parsed is None:
                    series.observe(
                        value, tenant=tenant, bucket=bucket.key, **extra
                    )
                else:
                    series.observe_with_exemplar(
                        value, str(parsed[0]), tenant=tenant,
                        bucket=bucket.key, **extra,
                    )
        if self.slo is not None:
            # latency judged from the timeline stamps; the event timestamp
            # rides the coalescer's injected clock — the same time base
            # the engine's burn windows (and the breaker cooldowns) use,
            # simulated under loadgen so the ledger replays byte-for-byte
            from autoscaler_tpu_torch.slo import SLI_FLEET_E2E

            self.slo.observe(SLI_FLEET_E2E, e2e, now=self._clock())

    def _walk_ladder(
        self, bucket, scen_req, scen_masks, scen_allocs, scen_caps,
        batch: int, links: Sequence[str] = (),
    ):
        """The fleet ladder: on a card the one strict ``cuda`` rung, off it
        the batched torch loop (``torch`` breaker) then the serial oracle
        twin (``python`` breaker). Same protocol as the estimator's walk —
        begin/record per rung, one fleetDispatch span per engagement.
        ``links`` carries the co-batched tickets' origin trace contexts
        (one batch, many traces): /tracez joins the tree from either
        side."""
        from autoscaler_tpu_torch.parallel.mesh import fleet_batch_estimate

        # advance the breaker clock from the injected clock on EVERY walk:
        # the RPC serving path has no run_once to tick the ladder, and a
        # tripped batched rung must recover once cooldown_s of (wall or
        # simulated) time elapses
        self.ladder.tick(self._clock())

        M = bucket.pods  # static carry: a pod can open at most one node

        def batched():
            return fleet_batch_estimate(
                self.mesh, scen_req, scen_masks, scen_allocs, scen_caps, M,
                device=self.device,
            )

        def oracle():
            from autoscaler_tpu_torch.estimator.reference_impl import (
                scenario_binpack_reference,
            )

            return scenario_binpack_reference(
                scen_req, scen_masks, scen_allocs, M, scen_caps
            )

        on_card = self.device.type == "cuda"
        rungs = (
            ((RUNG_CUDA, ROUTE_BATCHED, batched),) if on_card else (
                (RUNG_TORCH, ROUTE_BATCHED, batched),
                (RUNG_PYTHON, ROUTE_ORACLE, oracle),
            )
        )
        last = None
        for rung, route, fn in rungs:
            span_attrs = dict(rung=rung, bucket=bucket.key, batch=batch)
            if links:
                # span links, comma-joined "<trace>:<span>" contexts in
                # submission order — deterministic under replay
                span_attrs["links"] = ",".join(links)
            with trace.span(
                metrics_mod.FLEET_DISPATCH, metrics=self.metrics,
                **span_attrs,
            ) as sp:
                engaged = self.ladder.begin(rung)
                if engaged == "breaker_open":
                    sp.set_attrs(outcome="skipped", reason="breaker_open")
                    last = FleetError(f"{rung} rung breaker open")
                    if on_card:
                        raise last
                    continue
                if engaged is not None:  # injected device-fault kind
                    sp.set_attrs(outcome="fault", reason=engaged)
                    last = FleetError(f"injected {engaged} on {rung} rung")
                    if on_card:
                        raise last
                    continue
                try:
                    counts, scheduled = self._observed_dispatch(route, fn, sp)
                except Exception as e:  # noqa: BLE001 — off the card any
                    # rung failure descends; on it the card's rung raises
                    self.ladder.record_failure(rung)
                    sp.set_attrs(outcome="fault", reason="kernel_raised")
                    if on_card:
                        raise
                    last = e
                    continue
                self.ladder.record_success(rung)
                sp.set_attrs(outcome="ok", route=route)
                return counts, scheduled, route
        raise last if last is not None else FleetError("no fleet rungs configured")

    def _observed_dispatch(self, route: str, fn, sp):
        """Run one rung under the perf observatory (when attached): the
        batched rung's kernel entry is @observed, so the observatory sees
        the concrete call — per-bucket shape signature, operand bytes,
        compile-cache verdict — exactly as estimator dispatches do."""
        obs = self.observatory
        if obs is None:
            return fn()
        from autoscaler_tpu_torch.ops.telemetry import kernel_observer

        obs.clear_pending()
        t0 = trace.timeline_now()
        with kernel_observer(obs.note_kernel):
            out = fn()
        obs.on_dispatch(route, trace.timeline_now() - t0, span=sp)
        return out

    @staticmethod
    def _demux(
        req: FleetRequest, counts, scheduled, bucket: BucketSpec,
        batch: int, waste: float, route: str,
    ) -> FleetAnswer:
        P, G, R = req.shape()
        node_counts = np.asarray(counts[:G], np.int32).copy()
        sched = np.asarray(scheduled[:G, :P], bool).copy()
        answer = FleetAnswer(
            node_counts=node_counts,
            scheduled=sched,
            bucket=bucket.key,
            batch_size=batch,
            padding_waste=round(float(waste), 6),
            route=route,
        )
        if req.prices is not None and G > 0:
            # the what-if reduction of parallel/mesh.whatif_best_options,
            # host-side over the demuxed slice: price·count plus the
            # unscheduled penalty per group
            from autoscaler_tpu_torch.parallel.mesh import UNSCHEDULED_PENALTY

            pending = P - sched.sum(axis=1)
            cost = (
                np.asarray(req.prices, np.float64) * node_counts.astype(np.float64)
                + UNSCHEDULED_PENALTY * pending.astype(np.float64)
            )
            answer.best_group = int(np.argmin(cost))
            answer.best_cost = float(cost[answer.best_group])
        return answer

    # -- pre-warm -------------------------------------------------------------
    def prewarm(self) -> List[str]:
        """Ladder-rung pre-warm: push one all-zero batch through every
        configured bucket so each (route, shape signature) is seen at
        startup — on a card that builds the kernels at first use, and the
        first real request is a compile-cache hit (the perf observatory's
        per-bucket hit/miss series proves it). Returns the bucket keys
        warmed."""
        warmed: List[str] = []
        with trace.span(
            metrics_mod.FLEET_PREWARM, metrics=self.metrics,
            buckets=len(self.buckets),
        ):
            for bucket in self.buckets:
                S = self.batch_scenarios
                self._walk_ladder(
                    bucket,
                    np.zeros((S, bucket.pods, bucket.resources), np.float32),
                    np.zeros((S, bucket.groups, bucket.pods), bool),
                    np.zeros((S, bucket.groups, bucket.resources), np.float32),
                    np.zeros((S, bucket.groups), np.int32),
                    batch=0,
                )
                warmed.append(bucket.key)
        with self._lock:
            self._prewarmed = warmed
        if self.metrics is not None:
            self.metrics.fleet_prewarmed_buckets.set(float(len(warmed)))
        return warmed
