"""Fleet scenario driver: K synthetic tenants through the coalescing
estimator service, with the solo-parity fairness certificate.

Each tick is one coalescing round:

1. every tenant generates this round's estimate request from the scenario
   RNG (keyed (seed, tenant index, round) — replays generate identical
   request streams) and submits it to the REAL FleetCoalescer;
2. the queue flushes: bucketing, batching, one sharded mesh dispatch per
   batch, demux — with the fault injector armed on the fleet ladder's
   rung seam, so ``kernel_fault``/``device_lost`` scenarios degrade the
   batched rung exactly as a real device fault would;
3. every demuxed answer is byte-compared against a SOLO dispatch of the
   same operands (parallel/mesh.fleet_solo_estimate) — the certificate
   that coalescing, padding, and batching change nothing a tenant can
   observe, even in rounds where the batch degraded to the oracle rung;
4. the round's decision record (per-tenant verdict digests, buckets,
   routes, parity bits) and perf record (the observatory's dispatch
   telemetry) are appended — both byte-identical across replays
   (two replays diff clean).

Determinism: request content comes only from the seeded RNG; batch
formation is submission order (tenant order); walls live in the score
report, never the ledgers.

The port of ``autoscaler_tpu/loadgen/fleetdrive.py``: the coalescer serves
on a one-slot mesh of ``device`` (None = the first CUDA card, where each
batch is one K1/K2 launch; ``"cpu"`` for the host), and the solo
dispatches that certify each answer run there too.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from autoscaler_tpu_torch import trace
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.fleet import FleetAdmissionError
from autoscaler_tpu_torch.slo import SLI_FLEET_E2E
from autoscaler_tpu_torch.loadgen.driver import BASE_TS, _TraceClock
from autoscaler_tpu_torch.loadgen.faults import FaultInjector
from autoscaler_tpu_torch.loadgen.spec import ScenarioSpec, SpecError, TenantSpec
from autoscaler_tpu_torch.metrics import metrics as metrics_mod
from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics
from autoscaler_tpu_torch.trace import FlightRecorder, Tracer

# the fleet decision-ledger schema tag is single-sourced in
# fleet/ledger.py beside its SCHEMA_FIELDS manifest and validate_records
# twin
from autoscaler_tpu_torch.fleet.ledger import FLEET_SCHEMA

# deterministic synthetic per-route service latency fed into the balancer
# EWMA on a successful route (seconds; health differentiation comes from
# the error inputs — failures and streaks — not latency spread)
ROUTE_LATENCY_S = 0.004


@dataclass
class FleetTenantVerdict:
    """One tenant's answer in one round — the decision-ledger row. The
    verdict digest (sha256 over counts+scheduled bytes) is the compact
    byte-equality witness; ``match_solo`` is the certificate bit."""

    tenant: str
    bucket: str
    batch_size: int
    padding_waste: float
    route: str
    node_counts: List[int]
    scheduled_pods: int
    verdict_sha256: str
    match_solo: bool
    best_group: int = -1
    # fleet HA (/3): which replica endpoint the balancer routed this
    # request to, how many dead replicas it failed over past first, and
    # the tenant's quota tier ("" when tiers are off)
    endpoint: str = ""
    failovers: int = 0
    tier: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class FleetRoundRecord:
    tick: int
    now_ts: float
    tenants: List[FleetTenantVerdict] = field(default_factory=list)
    degraded: List[str] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    # typed sheds this round, in submission order: admission/chaos
    # rejections at submit (queue full / quota / drain / sidecar outage,
    # counted under outcomes["shed"]) followed by post-admission sheds
    # (queue expiry / drain race, counted under outcomes["expired"]) —
    # so len(shed) == outcomes["shed"] + outcomes["expired"]
    shed: List[Dict[str, Any]] = field(default_factory=list)
    # terminal-outcome tally for every request posted this round; the
    # accounting identity the chaos gate asserts is
    #   posted = resolved + shed + expired + failed + unresolved
    # and `unresolved` MUST be 0 (the zero-hung-tickets audit)
    outcomes: Dict[str, int] = field(default_factory=dict)
    wall_s: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        """Ledger row: wall time stays OUT (same rule as TickRecord — the
        log is the byte-for-byte replay artifact)."""
        return {
            "schema": FLEET_SCHEMA,
            "tick": self.tick,
            "now_ts": self.now_ts,
            "tenants": [t.to_dict() for t in self.tenants],
            "degraded": self.degraded,
            "errors": self.errors,
            "shed": self.shed,
            "outcomes": {k: self.outcomes[k] for k in sorted(self.outcomes)},
        }


@dataclass
class FleetRunResult:
    spec: ScenarioSpec
    records: List[FleetRoundRecord]
    metrics: AutoscalerMetrics
    injected_faults: Dict[str, int]
    recorder: Optional[FlightRecorder] = None
    perf_records: List[Dict[str, Any]] = field(default_factory=list)
    # per-ROUND service wall (submit → last ticket resolved) — report-only
    request_walls: List[float] = field(default_factory=list)
    # per-tenant lifecycle walls off the ticket stamps, decomposed
    # (queue_wait, service, e2e) per answer: queue wait = submit→dispatch
    # (admission + coalescing window + bucket queue), service =
    # dispatch→resolve (batched kernel + demux). Report-only, never in a
    # ledger — the deterministic twin rides the timeline stamps into the
    # SLO ledger instead.
    tenant_latency: Dict[str, List[Tuple[float, float, float]]] = field(
        default_factory=dict
    )
    prewarmed: List[str] = field(default_factory=list)
    # per-round SLO window records (the fleet_e2e objective on the ticket
    # timeline stamps) — byte-identical across replays
    slo_records: List[Dict[str, Any]] = field(default_factory=list)
    # tickets that reached NO terminal state by end of their round — the
    # zero-hung-tickets acceptance gate asserts this stays 0
    unresolved: int = 0
    # lifetime admission tallies from the coalescer's controller
    # (admitted / shed_* by reason), read once at run end
    admission: Dict[str, int] = field(default_factory=dict)
    # the device the fleet served on (the report's platform)
    device: str = "cpu"

    def decision_log(self) -> List[Dict[str, Any]]:
        return [r.to_dict() for r in self.records]

    def decision_ledger_lines(self) -> str:
        from autoscaler_tpu_torch.perf import record_line

        return "".join(record_line(rec) for rec in self.decision_log())

    def perf_ledger_lines(self) -> str:
        from autoscaler_tpu_torch.perf import record_line

        return "".join(record_line(rec) for rec in self.perf_records)

    def slo_ledger_lines(self) -> str:
        from autoscaler_tpu_torch.slo import record_line

        return "".join(record_line(rec) for rec in self.slo_records)

    def all_match(self) -> bool:
        """The fairness certificate over the whole run: every answered
        request matched solo, at least one request WAS answered, and no
        round recorded a failed batch — a run where every dispatch errored
        out certifies nothing and must not read as a pass."""
        verdicts = [t for r in self.records for t in r.tenants]
        return (
            bool(verdicts)
            and all(t.match_solo for t in verdicts)
            and not any(r.errors for r in self.records)
        )


def _tenant_request(spec: ScenarioSpec, t_index: int, tenant: TenantSpec,
                    tick: int, copy: int = 0):
    """One round's request content for one tenant — a pure function of
    (seed, tenant index, round, copy). ``copy`` distinguishes a storm
    tenant's same-round submissions (requests_per_round > 1)."""
    from autoscaler_tpu_torch.fleet import FleetRequest
    from autoscaler_tpu_torch.kube.objects import CPU, MEMORY, NUM_RESOURCES, PODS

    rng = np.random.default_rng((spec.seed, t_index, tick, copy, 7919))
    P, G, R = tenant.pods, tenant.groups, NUM_RESOURCES
    req = np.zeros((P, R), np.float32)
    req[:, CPU] = rng.integers(
        1, max(int(tenant.cpu_m), 2), P
    ).astype(np.float32)
    req[:, MEMORY] = rng.integers(
        1, max(int(tenant.mem_mb), 2), P
    ).astype(np.float32) * 1024.0
    req[:, PODS] = 1.0
    masks = rng.random((G, P)) > 0.2
    allocs = np.zeros((G, R), np.float32)
    allocs[:, CPU] = rng.integers(
        int(tenant.cpu_m), int(tenant.cpu_m) * 8 + 2, G
    ).astype(np.float32)
    allocs[:, MEMORY] = rng.integers(
        int(tenant.mem_mb), int(tenant.mem_mb) * 8 + 2, G
    ).astype(np.float32) * 1024.0
    allocs[:, PODS] = rng.integers(4, 110, G).astype(np.float32)
    caps = rng.integers(1, max(tenant.max_nodes, 2), G).astype(np.int32)
    prices = (
        rng.random(G).astype(np.float32) + np.float32(0.1)
        if tenant.whatif else None
    )
    return FleetRequest(
        tenant_id=tenant.name,
        pod_req=req,
        pod_masks=masks,
        template_allocs=allocs,
        node_caps=caps,
        max_nodes=tenant.max_nodes,
        prices=prices,
        deadline_s=tenant.deadline_s if tenant.deadline_s > 0 else None,
    )


class FleetScenarioDriver:
    def __init__(self, spec: ScenarioSpec, device=None):
        if spec.fleet is None:
            raise SpecError("not a fleet scenario (no `fleet` section)")
        self.spec = spec
        self.device = resolve_device(device)
        self.injector = FaultInjector(spec.faults, spec.seed)
        try:
            opts_kw = dict(spec.options)
            # ring sizes cover the whole run so the ledgers are complete,
            # and the cost model is ON (pure function of shapes: replayable)
            opts_kw.setdefault("perf_cost_model", True)
            # +1: the prewarm sweep is its own tick (-1) and must survive
            # the ring so the ledger shows the cold compiles
            opts_kw.setdefault("perf_ring_size", spec.ticks + 1)
            self.options = AutoscalingOptions(**opts_kw)
        except TypeError as e:
            raise SpecError(f"bad scenario options: {e}") from None
        self.metrics = AutoscalerMetrics()
        self.tracer = Tracer(
            clock=_TraceClock(),
            metrics=self.metrics,
            recorder=FlightRecorder(capacity=spec.ticks + 1),
            slow_tick_threshold_s=0.0,
        )
        from autoscaler_tpu_torch.fleet import FleetCoalescer
        from autoscaler_tpu_torch.parallel.mesh import make_mesh
        from autoscaler_tpu_torch.perf import PerfObservatory

        self.observatory = PerfObservatory(
            metrics=self.metrics,
            cost_model=self.options.perf_cost_model,
            ring_capacity=self.options.perf_ring_size,
        )
        from autoscaler_tpu_torch.estimator.ladder import KernelLadder

        # the SLO engine judges every resolved ticket's e2e latency (on
        # the ticket's timeline stamps) and computes one window record per
        # round — the autoscaler_tpu.slo.window/1 ledger, byte-identical
        # across replays like the fleet decision ledger
        from autoscaler_tpu_torch.slo import SloEngine, fleet_slos

        self.slo = SloEngine(
            specs=fleet_slos(),
            ring_capacity=spec.ticks + 1,
            metrics=self.metrics,
        )
        # the coalescer reads its injected clock on every ladder walk; the
        # driver advances this per round, so breaker cooldowns run on
        # simulated time and trip→degrade→recover replays byte-for-byte
        self._sim_now = BASE_TS - spec.tick_interval_s
        self.coalescer = FleetCoalescer(
            buckets=self.options.fleet_shape_buckets,
            window_s=self.options.fleet_coalesce_window_ms / 1000.0,
            batch_scenarios=self.options.fleet_batch_scenarios,
            mesh=make_mesh([self.device]),
            metrics=self.metrics,
            observatory=self.observatory,
            clock=lambda: self._sim_now,
            slo=self.slo,
            max_tenant_labels=self.options.fleet_max_tenant_labels,
            # overload armor: queue bound + per-tenant quotas on the SAME
            # injected sim clock, so admission sheds (and their
            # retry-after hints) replay byte-identically
            max_queue_depth=self.options.fleet_max_queue_depth,
            tenant_qps=self.options.fleet_tenant_qps,
            tenant_burst=self.options.fleet_tenant_burst,
            # tenant quota tiers (fleet/tiers.py): per-tier buckets,
            # queue-share slices, default deadlines, and tier-priority
            # shed order — all judged on the same injected sim clock
            tenant_tiers=self.options.fleet_tenant_tiers,
            # chaos seam: rpc_slow folds sim-clock latency into the
            # ticket service stamps at demux
            latency_hook=self.injector.on_rpc_dispatch,
            # breaker knobs ride the same options as the estimator ladder
            ladder=KernelLadder(
                failure_threshold=self.options.kernel_breaker_failure_threshold,
                cooldown_s=self.options.kernel_breaker_cooldown_s,
            ),
        )
        # the fault seam: scripted kernel_fault/device_lost fire at the
        # fleet ladder's rung dispatch, exactly like the estimator's
        self.coalescer.ladder.fault_hook = self.injector.on_kernel_dispatch
        self.prewarmed: List[str] = []
        self._unresolved = 0
        # -- fleet HA: the serving side modeled as N replica
        # endpoints behind the health-weighted balancer. Every request is
        # routed to a balancer-picked replica first (replica_restart /
        # endpoint_flap faults down individual replicas); the chosen
        # endpoint rides the decision ledger. Clock is the sim clock and
        # the rng is scenario-seeded, so the pick sequence — and the
        # ledger's endpoint-choice column — replays byte-identically.
        from autoscaler_tpu_torch.fleet.balance import EndpointBalancer

        self.replicas = [f"replica-{i}" for i in range(spec.fleet.replicas)]
        bal_rng = np.random.default_rng((spec.seed, 3571))
        self.balancer = EndpointBalancer(
            self.replicas,
            clock=lambda: self._sim_now,
            rng=lambda: float(bal_rng.random()),
            # cooldown in sim seconds: a killed replica earns one probe
            # per elapsed tick interval once its restart window passes
            eject_cooldown_s=spec.tick_interval_s,
        )

    def _route(self) -> Tuple[str, int, Optional[str]]:
        """The client model: route one request to a live replica via the
        health-weighted balancer — pick, consult the replica's fault
        state, fail over (excluding endpoints already tried) up to the
        replica count. → (endpoint, failovers, outage_kind): a successful
        route returns its endpoint (outage_kind None); a full outage
        returns ("", tried, kind).

        Every consultation and every pick is one deterministic step on
        the seeded seams, so two replays route every request identically
        — the balancer-determinism certificate."""
        tried: List[str] = []
        outage_kind: Optional[str] = None
        for _ in range(len(self.replicas)):
            endpoint = self.balancer.pick(exclude=tried)
            if endpoint is None:
                break
            kind = self.injector.on_replica(self.replicas.index(endpoint))
            if kind is None:
                self.balancer.record_success(endpoint, ROUTE_LATENCY_S)
                self.metrics.fleet_endpoint_picks_total.inc(
                    endpoint=endpoint, outcome="ok"
                )
                return endpoint, len(tried), None
            outage_kind = kind
            self.balancer.record_failure(endpoint, unavailable=True)
            self.metrics.fleet_endpoint_picks_total.inc(
                endpoint=endpoint, outcome=kind
            )
            tried.append(endpoint)
        return "", len(tried), outage_kind or "replica_restart"

    def run(self) -> FleetRunResult:
        spec = self.spec
        fleet = spec.fleet
        records: List[FleetRoundRecord] = []
        walls: List[float] = []
        tenant_latency: Dict[str, List[Tuple[float, float, float]]] = {}
        by_tick: Dict[int, list] = {}
        for ev in spec.events:
            by_tick.setdefault(ev.at_tick, []).append(ev)
        if self.options.fleet_prewarm:
            # inside a traced tick so the prewarm's dispatch walls ride the
            # deterministic timeline clock (byte-identical perf ledger)
            self.observatory.begin_tick(-1, BASE_TS - spec.tick_interval_s)
            self.tracer.set_context(scenario=spec.name, phase="prewarm")
            with self.tracer.tick(metrics_mod.MAIN):
                self.prewarmed = self.coalescer.prewarm()
            self.observatory.end_tick()
        for tick in range(spec.ticks):
            self.injector.tick = tick
            now = BASE_TS + tick * spec.tick_interval_s
            self._sim_now = now
            for ev in by_tick.get(tick, ()):
                if ev.kind == "fault":
                    self.injector.arm(ev.fault, tick)
                elif ev.kind == "clear_faults":
                    self.injector.clear()
                else:
                    raise SpecError(
                        f"fleet scenarios support fault/clear_faults "
                        f"events only, got {ev.kind!r}"
                    )
            rec = FleetRoundRecord(tick=tick, now_ts=now)
            self.observatory.begin_tick(tick, now)
            self.tracer.set_context(scenario=spec.name, tick=tick, sim_ts=now)
            requests = [
                _tenant_request(spec, ti, tenant, tick, copy)
                for ti, tenant in enumerate(fleet.tenants)
                for copy in range(tenant.requests_per_round)
            ]
            answered = []
            outcomes = {
                "resolved": 0, "failed": 0, "expired": 0, "shed": 0,
                "unresolved": 0,
            }
            with self.tracer.tick(metrics_mod.MAIN):
                # the timed window covers ONLY the fleet service's work —
                # admission, coalesced dispatch, demux — so the report's
                # latency columns measure the service, not the driver's
                # request generation or the certification dispatches below
                t0 = time.perf_counter()
                # one fleetSubmit span per tenant request: each ticket's
                # origin context is its OWN span, so the shared
                # fleetDispatch span's links genuinely enumerate the
                # co-batched tickets (one batch, many origins — the RPC
                # path gets the same shape from each client's rpcCall span)
                submitted = []
                routes: Dict[int, Tuple[str, int]] = {}
                for r in requests:
                    tier = self.coalescer.tier_name(r.tenant_id)
                    # process-level chaos seam: an active sidecar_crash /
                    # sidecar_partition makes the submit fail typed
                    # unavailable — the client saw a dead endpoint. That
                    # IS bad budget (no answer, no backpressure hint), so
                    # the burn alert fires during the outage.
                    kind = self.injector.on_fleet_submit()
                    if kind is not None:
                        rec.shed.append({
                            "tenant": r.tenant_id,
                            "reason": kind,
                            "error": "FleetUnavailableError",
                            "retry_after_s": 0.0,
                            "tier": tier,
                        })
                        outcomes["shed"] += 1
                        self.slo.observe_event(SLI_FLEET_E2E, bad=True,
                                               now=now)
                        continue
                    # fleet HA: route to a balancer-picked live replica
                    # first; a rolling restart fails over, a FULL outage
                    # (every replica down) sheds unavailable — with >= 2
                    # replicas a single restart must be a non-event
                    endpoint, failovers, outage = self._route()
                    if outage is not None:
                        rec.shed.append({
                            "tenant": r.tenant_id,
                            "reason": outage,
                            "error": "FleetUnavailableError",
                            "retry_after_s": 0.0,
                            "tier": tier,
                        })
                        outcomes["shed"] += 1
                        self.slo.observe_event(SLI_FLEET_E2E, bad=True,
                                               now=now)
                        continue
                    try:
                        with trace.span(
                            metrics_mod.FLEET_SUBMIT, tenant=r.tenant_id
                        ):
                            ticket = self.coalescer.submit(r)
                        routes[id(ticket)] = (endpoint, failovers)
                        submitted.append((r, ticket))
                    except FleetAdmissionError as e:
                        # typed backpressure (queue full / quota /
                        # deadline-at-admission): the system working as
                        # designed — recorded with its retry hint, NOT
                        # charged against the SLO (the client was told
                        # exactly how to behave)
                        rec.shed.append({
                            "tenant": r.tenant_id,
                            "reason": e.outcome,
                            "error": type(e).__name__,
                            "retry_after_s": round(e.retry_after_s, 6),
                            "tier": tier,
                        })
                        outcomes["shed"] += 1
                self.coalescer.flush()
                for req, ticket in submitted:
                    try:
                        answered.append(
                            (req, ticket, ticket.result(timeout=0.0))
                        )
                        outcomes["resolved"] += 1
                    except TimeoutError:
                        # a ticket the flush did not terminate: the hang
                        # the overload armor exists to eliminate — counted
                        # so the acceptance gate can assert ZERO
                        outcomes["unresolved"] += 1
                        rec.errors.append(
                            f"{req.tenant_id}: ticket hung past flush"
                        )
                        continue
                    except FleetAdmissionError as e:
                        # shed after admission (deadline expired in queue,
                        # drain raced the round) — typed, with provenance
                        rec.shed.append({
                            "tenant": req.tenant_id,
                            "reason": e.outcome,
                            "error": type(e).__name__,
                            "retry_after_s": round(e.retry_after_s, 6),
                            "tier": self.coalescer.tier_name(req.tenant_id),
                        })
                        outcomes["expired"] += 1
                    except Exception as e:  # noqa: BLE001 — a failed batch
                        # is a recorded error, not a crashed run (crash-only
                        # discipline, same as the tick driver)
                        outcomes["failed"] += 1
                        rec.errors.append(f"{req.tenant_id}: {e}")
                    # per-tenant lifecycle latency off the ticket stamps,
                    # split queue-wait/service: a tenant whose bucket
                    # dispatched first in the flush both waited less AND
                    # resolved earlier, and the split shows which
                    e2e = ticket.resolved_wall - ticket.submitted_wall
                    queue_wait = (
                        ticket.dispatched_wall - ticket.submitted_wall
                        if ticket.dispatched_wall else e2e
                    )
                    service = (
                        ticket.resolved_wall - ticket.dispatched_wall
                        if ticket.dispatched_wall else 0.0
                    )
                    tenant_latency.setdefault(req.tenant_id, []).append(
                        (queue_wait, service, e2e)
                    )
                rec.wall_s = time.perf_counter() - t0
                # the round's SLO window rides the traced tick: the engine
                # consumed this round's ticket events (timeline stamps),
                # one window record per round on the sim clock
                self.slo.tick(now, tick)
            rec.outcomes = outcomes
            self._unresolved += outcomes["unresolved"]
            walls.append(rec.wall_s)
            # the fairness certificate (solo dispatches) runs OUTSIDE the
            # timed window and outside the perf tick
            self.observatory.end_tick()
            for req, ticket, answer in answered:
                endpoint, failovers = routes.get(id(ticket), ("", 0))
                rec.tenants.append(self._certify(
                    req, answer, endpoint=endpoint, failovers=failovers,
                    tier=self.coalescer.tier_name(req.tenant_id),
                ))
            rec.errors.sort()
            rec.degraded = sorted(self.coalescer.degraded())
            records.append(rec)
        return FleetRunResult(
            spec=spec,
            records=records,
            metrics=self.metrics,
            injected_faults=dict(self.injector.injected),
            recorder=self.tracer.recorder,
            perf_records=self.observatory.records(),
            request_walls=walls,
            tenant_latency=tenant_latency,
            prewarmed=list(self.prewarmed),
            slo_records=self.slo.records(),
            unresolved=self._unresolved,
            admission=self.coalescer.admission_snapshot(),
            device=str(self.device),
        )

    def _certify(
        self, req, answer, endpoint: str = "", failovers: int = 0, tier: str = "",
    ) -> FleetTenantVerdict:
        """The fairness certificate for one answer: byte-compare against a
        solo dispatch of the SAME operands (caps clamped by the tenant's
        own max_nodes on both sides — the semantics the bucket carry
        reproduces). ``endpoint``/``failovers``/``tier`` are the HA
        provenance columns the balancer-determinism gate byte-diffs."""
        from autoscaler_tpu_torch.parallel.mesh import fleet_solo_estimate

        solo_counts, solo_sched = fleet_solo_estimate(
            req.pod_req, req.pod_masks, req.template_allocs,
            req.node_caps, req.max_nodes, device=self.device,
        )
        fleet_bytes = (
            np.ascontiguousarray(answer.node_counts, "<i4").tobytes()
            + np.ascontiguousarray(answer.scheduled, np.uint8).tobytes()
        )
        solo_bytes = (
            np.ascontiguousarray(solo_counts, "<i4").tobytes()
            + np.ascontiguousarray(solo_sched, np.uint8).tobytes()
        )
        return FleetTenantVerdict(
            tenant=req.tenant_id,
            bucket=answer.bucket,
            batch_size=answer.batch_size,
            padding_waste=answer.padding_waste,
            route=answer.route,
            node_counts=[int(c) for c in answer.node_counts],
            scheduled_pods=int(np.asarray(answer.scheduled).sum()),
            verdict_sha256=hashlib.sha256(fleet_bytes).hexdigest(),
            match_solo=fleet_bytes == solo_bytes,
            best_group=answer.best_group,
            endpoint=endpoint,
            failovers=failovers,
            tier=tier,
        )


def run_fleet_scenario(spec: ScenarioSpec, device=None) -> FleetRunResult:
    return FleetScenarioDriver(spec, device=device).run()
