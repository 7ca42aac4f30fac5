"""Scenario driver: the fake-clock tick loop around the real control loop.

Each tick is one scan interval of a scripted world:

1. apply this tick's events (bursts, completions, flaps, resizes, faults);
2. ``StaticAutoscaler.run_once(now)`` — the REAL loop: snapshot, filter,
   scale-up orchestrator, clusterstate accounting, scale-down planner and
   actuator, all production wiring including the persistent incremental
   packer;
3. materialize the cloud: groups whose target exceeds their instance count
   get instances (honoring injected instance errors / stuck-CREATING);
   instances past their boot delay register ready Nodes — the kubelet
   analog;
4. bind pending pods onto ready capacity with the hinting simulator — the
   scheduler analog — so pod latency (arrival tick → bind tick) is
   measurable and completed pods free real capacity;
5. record the decision log entry.

Determinism: the only RNG is seeded from the spec (workload expansion and
fault coin-flips); the expander defaults to least-waste (the random
expander would make decisions unreplayable); intra-tick actuation
parallelism is absorbed by sorting every per-tick list in the log. Running
the same spec twice yields byte-identical decision logs; see
tests/test_torch_loadgen.py.

The port of ``autoscaler_tpu/loadgen/driver.py``: the loop, the cloud and
the scheduler analog run on ``device`` (None = the first CUDA card;
``"cpu"`` for the host), and each tick's binder pass (a fresh snapshot of
every node and pod, then the hinting simulator) is timed into the
record's ``bind_s``, a wall field the decision log leaves out as it
leaves out ``wall_s``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from autoscaler_tpu_torch.cloudprovider.interface import Instance, InstanceState
from autoscaler_tpu_torch.cloudprovider.test_provider import TestCloudProvider
from autoscaler_tpu_torch.config.options import AutoscalingOptions, OptionsError
from autoscaler_tpu_torch.core.scaledown.actuator import ScaleDownActuator
from autoscaler_tpu_torch.core.static_autoscaler import RunOnceResult, StaticAutoscaler
from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.kube.api import EvictionError, FakeClusterAPI
from autoscaler_tpu_torch.kube.objects import (
    LabelSelector,
    Node,
    OwnerRef,
    Pod,
    Resources,
    TopologySpreadConstraint,
)
from autoscaler_tpu_torch.loadgen.faults import FaultInjector
from autoscaler_tpu_torch.loadgen.spec import (
    MB,
    Event,
    NodeGroupSpec,
    ScenarioSpec,
    SpecError,
)
from autoscaler_tpu_torch.loadgen.workloads import expand_workloads
from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics
from autoscaler_tpu_torch.simulator.hinting import HintingSimulator
from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot
from autoscaler_tpu_torch.trace import FlightRecorder, Tracer

ZONE_KEY = "topology.kubernetes.io/zone"
BASE_TS = 1_000_000.0

# scenario-friendly AutoscalingOptions deltas: no multi-minute cooldowns or
# 10-minute unneeded clocks unless the scenario asks for them, and a boot
# budget in ticks, not quarter hours
_DRIVER_DEFAULTS = dict(
    expander="least-waste",
    scale_down_delay_after_add_s=0.0,
    scale_down_delay_after_failure_s=0.0,
    eviction_retry_time_s=1.0,
    max_pod_eviction_time_s=3.0,
)


class _SimClock:
    """Monotonic clock whose sleep() just advances it: the actuator's
    eviction retry pacing runs in simulated time, so a fault-heavy drain
    doesn't wall-block the run."""

    def __init__(self) -> None:
        self.t = 0.0

    def time(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += max(seconds, 0.0)


class _TraceClock:
    """Deterministic timeline clock for the tracer: advances exactly 1ms
    per reading. Two replays of the same scenario make the same span/event
    sequence, hence the same clock readings, hence byte-identical trace
    exports — while spans still nest with visible (synthetic) extent in
    Perfetto instead of collapsing to zero width on the sim clock."""

    def __init__(self) -> None:
        self.readings = 0

    def __call__(self) -> float:
        self.readings += 1
        return self.readings * 1e-3


@dataclass
class TickRecord:
    """One decision-log entry. Every list is sorted → byte-stable JSON."""

    tick: int
    now_ts: float
    pending_before: int = 0          # pending pods entering the loop
    pending_after: int = 0           # still pending after loop + bind
    scale_ups: List[Tuple[str, int]] = field(default_factory=list)
    scale_downs: List[str] = field(default_factory=list)
    evicted: List[str] = field(default_factory=list)
    backed_off: List[str] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    # kernel-ladder rungs with a tripped breaker after this tick (sorted):
    # nonempty = degraded mode, decisions flowing on a lower rung
    degraded: List[str] = field(default_factory=list)
    unneeded: int = 0
    nodes_ready: int = 0
    nodes_total: int = 0
    bound_pods: int = 0
    # capacity lower bound for the pods alive at tick end — ceil(live
    # requested cpu / biggest node cpu). The scorer's objective section
    # charges over-provisioning against this (score.build_objective), and
    # the gym's per-step reward reads the same number, so it rides the
    # decision log (pure function of the world state — byte-stable).
    demand_nodes: int = 0
    cluster_healthy: bool = True
    # preemption engine: pending pods the eviction-packing pass
    # admitted onto existing capacity, pods it actually evicted (sorted;
    # every one names its evictor in the explain ledger), pending pods
    # dropped below the expendable cutoff, and bound pods a spot_reclaim
    # fault re-pended this tick
    preempt_admitted: int = 0
    preempted: List[str] = field(default_factory=list)
    pending_expendable: int = 0
    reclaimed: int = 0
    wall_s: float = 0.0
    # host seconds of the tick's binder pass (_bind_pods): a wall field
    bind_s: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        """Decision-log entry: the wall fields (wall_s, bind_s) stay OUT —
        the log is the byte-for-byte replay artifact, and wall time is the
        one thing that legitimately differs between identical runs (it
        lives in the score report's tick_wall_s instead)."""
        doc = dataclasses.asdict(self)
        doc.pop("wall_s")
        doc.pop("bind_s")
        return doc


@dataclass
class RunResult:
    spec: ScenarioSpec
    records: List[TickRecord]
    trace: List[Dict[str, Any]]          # resolved events, per to_dict
    metrics: AutoscalerMetrics
    # pod key → (arrival_tick, bound_tick or None)
    pod_latency: Dict[str, Tuple[int, Optional[int]]]
    injected_faults: Dict[str, int]
    peak_nodes: int
    final_nodes: int
    total_requested_cpu_m: float = 0.0
    group_cpu_m: float = 0.0
    # flight recorder holding every tick's span tree (deterministic
    # timeline): recorder.chrome() is the byte-stable Perfetto export
    recorder: Optional[FlightRecorder] = None
    # per-tick perf records (perf observatory ring, sized to
    # the run): every value is timeline-clock or pure-function-of-shapes,
    # so two replays serialize to byte-identical JSONL ledgers
    perf_records: List[Dict[str, Any]] = field(default_factory=list)
    # per-tick decision records (explain ring, sized to the
    # run): pure functions of the tick's decisions and the closed reason
    # vocabularies — byte-identical across replays, same contract
    explain_records: List[Dict[str, Any]] = field(default_factory=list)
    # per-tick SLO window records (slo ring, sized to the
    # run): SLI events on the timeline seam, burn rates as plain ratios —
    # byte-identical across replays, same contract
    slo_records: List[Dict[str, Any]] = field(default_factory=list)
    # per-tick flight-journal records (journal ring, sized
    # to the run): keyframe+delta state history, every value a pure
    # function of the tick's packed state — byte-identical across replays,
    # same contract
    journal_records: List[Dict[str, Any]] = field(default_factory=list)
    # the device the loop ran on (the report's platform)
    device: str = "cpu"

    def decision_log(self) -> List[Dict[str, Any]]:
        return [r.to_dict() for r in self.records]

    def perf_ledger_lines(self) -> str:
        from autoscaler_tpu_torch.perf import record_line

        return "".join(record_line(rec) for rec in self.perf_records)

    def explain_ledger_lines(self) -> str:
        from autoscaler_tpu_torch.explain import record_line

        return "".join(record_line(rec) for rec in self.explain_records)

    def slo_ledger_lines(self) -> str:
        from autoscaler_tpu_torch.slo import record_line

        return "".join(record_line(rec) for rec in self.slo_records)

    def journal_ledger_lines(self) -> str:
        from autoscaler_tpu_torch.journal import record_line

        return "".join(record_line(rec) for rec in self.journal_records)


class _FaultyCloudProvider(TestCloudProvider):
    """TestCloudProvider whose refresh() consults the fault injector —
    refresh_error / provider_latency faults land on the loop's provider
    refresh exactly where a real cloud outage would — and whose groups'
    template_node_info consults it too (template_error faults land on the
    orchestrator's template fetch → SkipReason.NO_TEMPLATE)."""

    injector: Optional[FaultInjector] = None  # seated by the driver

    def refresh(self) -> None:
        if self.injector is not None:
            self.injector.on_refresh()
        super().refresh()

    def add_node_group(self, name, *args, **kwargs):
        group = super().add_node_group(name, *args, **kwargs)
        orig = group.template_node_info

        def faulty_template_node_info():
            if self.injector is not None:
                self.injector.on_template(name)
            return orig()

        group.template_node_info = faulty_template_node_info
        return group


class _FaultyClusterAPI(FakeClusterAPI):
    """FakeClusterAPI whose evictions and (inside run_once) listings consult
    the fault injector."""

    injector: Optional[FaultInjector] = None      # seated by the driver
    group_of_node = staticmethod(lambda name: "")  # seated by the driver
    # kube_api_error only fires on calls made by the loop under test, not
    # on the driver's own bookkeeping reads — the driver toggles this
    # around run_once
    in_run_once: bool = False

    def evict_pod(self, pod: Pod) -> None:
        if self.injector is not None and self.injector.on_evict(
            pod.key(), self.group_of_node(pod.node_name)
        ):
            raise EvictionError(f"eviction of {pod.key()} injected-rejected")
        super().evict_pod(pod)

    def list_nodes(self):
        if self.injector is not None and self.in_run_once:
            self.injector.on_kube_api("list_nodes")
        return super().list_nodes()


class ScenarioDriver:
    def __init__(self, spec: ScenarioSpec, real_sleep: bool = False, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.injector = FaultInjector(spec.faults, spec.seed, real_sleep=real_sleep)
        self.provider = _FaultyCloudProvider(on_scale_up=self.injector.on_scale_up)
        self.provider.injector = self.injector
        self.api = _FaultyClusterAPI()
        self.api.injector = self.injector
        self.api.group_of_node = (
            lambda name: self.provider.group_of_node_map().get(name, "")
        )
        self._group_spec: Dict[str, NodeGroupSpec] = {}
        self._node_seq: Dict[str, int] = {}
        self._pod_seq = 0
        # instance id → tick at which its Node registers ready
        self._boot_queue: Dict[str, Tuple[int, str]] = {}
        self._flapped: Dict[str, int] = {}   # node name → recovery tick
        self.pod_latency: Dict[str, Tuple[int, Optional[int]]] = {}
        self.total_requested_cpu_m = 0.0
        # the objective's capacity denominator (score.build_objective):
        # biggest node shape in the scripted cloud
        self._max_group_cpu = max(
            (g.cpu_m for g in spec.node_groups), default=0.0
        )
        self._build_world()
        opts_kw = dict(_DRIVER_DEFAULTS)
        # expander tie-breaks must replay: pin the chain's random fallback
        # to the scenario seed (unseeded, two runs of the same world can
        # pick different groups when least-waste scores tie exactly)
        opts_kw["expander_random_seed"] = spec.seed
        # perf observatory: cost model ON (its figures are pure functions
        # of shapes — replayable), ring sized to hold EVERY tick so the
        # perf JSONL ledger covers the whole run
        opts_kw["perf_cost_model"] = True
        opts_kw["perf_ring_size"] = max(spec.ticks, 1)
        # decision explainer: ring sized to hold EVERY tick so the explain
        # JSONL ledger covers the whole run
        opts_kw["explain_ring_size"] = max(spec.ticks, 1)
        # flight journal: same sizing, so the journal keeps every tick's
        # state record and the journal JSONL covers the whole run
        opts_kw["journal_ring_size"] = max(spec.ticks, 1)
        # two ticks of unneeded time by default: long enough that freshly
        # booted (still empty) capacity isn't reaped before the scheduler
        # analog binds pods, short enough that drain scenarios converge
        opts_kw["scale_down_unneeded_time_s"] = 2 * spec.tick_interval_s
        opts_kw.update(spec.options)
        try:
            # schema-checked BEFORE construction: an unknown key or a
            # type-mismatched value exits with the offending key named
            # (dataclasses would silently accept any value) — the contract
            # `loadgen run --set` and the gym PolicySpec seam rely on
            from autoscaler_tpu_torch.config.options import validate_overrides

            validate_overrides(spec.options)
            self.options = AutoscalingOptions(**opts_kw)
        except (OptionsError, TypeError) as e:
            raise SpecError(f"bad scenario options: {e}") from None
        # the planner gates on the per-group defaults, not the flat fields
        # (NodeGroupConfigProcessor pattern) — mirror main.py:287's sync so
        # scenario options behave like the CLI flags of the same name
        gd = self.options.node_group_defaults
        gd.scale_down_unneeded_time_s = self.options.scale_down_unneeded_time_s
        gd.scale_down_unready_time_s = self.options.scale_down_unready_time_s
        gd.scale_down_utilization_threshold = (
            self.options.scale_down_utilization_threshold
        )
        gd.max_node_provision_time_s = self.options.max_node_provision_time_s
        self.metrics = AutoscalerMetrics()
        # deterministic tracer: synthetic timeline clock (byte-identical
        # exports across replays — set_wall_attrs drops wall attributes),
        # ring sized to hold EVERY tick so the export covers the whole run,
        # slow-tick pinning off (wall-time-driven, hence not replayable)
        self.tracer = Tracer(
            clock=_TraceClock(),
            metrics=self.metrics,
            recorder=FlightRecorder(capacity=max(spec.ticks, 1)),
            slow_tick_threshold_s=0.0,
        )
        self.autoscaler = StaticAutoscaler(
            self.provider, self.api, self.options, metrics=self.metrics,
            tracer=self.tracer, device=self.device,
        )
        # re-seat the actuator on a simulated clock (same tracker wiring as
        # the ctor): eviction retry pacing must not wall-block fault runs
        clock = _SimClock()
        self.autoscaler.scale_down_actuator = ScaleDownActuator(
            self.provider,
            self.options,
            self.api,
            self.autoscaler.scale_down_planner.deletion_tracker,
            clock=clock.time,
            sleep=clock.sleep,
        )
        # arm the estimator ladder's fault hook: kernel_fault/device_lost
        # fire at the rung-dispatch seam, tripping the REAL circuit
        # breakers (whose cooldown runs on the driver's simulated clock —
        # run_once ticks the ladder with now_ts, keeping replays exact)
        ladder = self.autoscaler.kernel_ladder()
        if ladder is not None:
            ladder.fault_hook = self.injector.on_kernel_dispatch
        # arm the resident arena's fault hook the same way: arena_fault
        # fails a delta apply at the double-buffer seam (rollback +
        # next-tick reseed), replayed byte-identically on the sim clock
        arena = getattr(self.autoscaler, "_arena", None)
        if arena is not None:
            arena.fault_hook = self.injector.on_arena_apply
        self._scheduler = HintingSimulator()
        # resolved timeline: explicit events + expanded workloads, stably
        # ordered; this IS the trace a replay executes verbatim
        self.timeline: List[Event] = sorted(
            list(spec.events) + expand_workloads(spec),
            key=lambda e: e.at_tick,
        )

    # -- world construction ---------------------------------------------------
    def _build_world(self) -> None:
        for g in self.spec.node_groups:
            self._group_spec[g.name] = g
            self._node_seq[g.name] = 0
            tmpl = self._make_node(g, f"{g.name}-template")
            tmpl.provider_id = ""
            self.provider.add_node_group(
                g.name, g.min_size, g.max_size, g.initial_size, tmpl,
                price_per_hour=g.price_per_hour,
            )
            for _ in range(g.initial_size):
                node = self._make_node(g, self._next_node_name(g.name))
                self.provider.add_node(g.name, node)
                self.api.add_node(node)

    def _make_node(self, g: NodeGroupSpec, name: str) -> Node:
        labels = {"kubernetes.io/hostname": name, **g.labels}
        if g.zone:
            labels[ZONE_KEY] = g.zone
        return Node(
            name=name,
            allocatable=Resources(
                cpu_m=g.cpu_m, memory=g.mem_mb * MB, pods=g.pods
            ),
            labels=labels,
            ready=True,
            provider_id=f"test:///{name}",
        )

    def _next_node_name(self, group: str) -> str:
        i = self._node_seq[group]
        self._node_seq[group] = i + 1
        return f"{group}-{i}"

    # -- events ---------------------------------------------------------------
    def _apply_event(self, ev: Event, tick: int) -> None:
        if ev.kind == "pod_burst":
            self._burst(ev, tick)
        elif ev.kind == "pod_complete":
            self._complete(ev, tick)
        elif ev.kind == "node_flap":
            self._flap(ev, tick)
        elif ev.kind == "resize":
            self._resize(ev)
        elif ev.kind == "fault":
            self.injector.arm(ev.fault, tick)
        elif ev.kind == "clear_faults":
            self.injector.clear()

    def _burst(self, ev: Event, tick: int) -> None:
        prefix = ev.prefix or "burst"
        for _ in range(ev.count):
            name = f"{prefix}-{self._pod_seq}"
            self._pod_seq += 1
            pod = Pod(
                name=name,
                requests=Resources(cpu_m=ev.cpu_m, memory=ev.mem_mb * MB),
                labels={"app": prefix, **ev.labels},
                owner_ref=OwnerRef(kind="ReplicaSet", name=f"{prefix}-rs"),
                creation_ts=BASE_TS + tick * self.spec.tick_interval_s,
                priority=ev.priority,
                preemption_policy=ev.preemption_policy,
            )
            if ev.spread_zone_skew > 0:
                pod.topology_spread = (
                    TopologySpreadConstraint(
                        max_skew=ev.spread_zone_skew,
                        topology_key=ZONE_KEY,
                        selector=LabelSelector.from_dict({"app": prefix}),
                        when_unsatisfiable="DoNotSchedule",
                    ),
                )
            self.api.add_pod(pod)
            self.pod_latency[pod.key()] = (tick, None)
            self.total_requested_cpu_m += ev.cpu_m

    def _complete(self, ev: Event, tick: int) -> None:
        running = sorted(
            k for k, p in self.api.pods.items()
            if p.node_name and p.name.startswith(ev.prefix)
        )
        for key in running[: ev.count]:
            # latency samples survive completion: the pod was bound, and the
            # score's percentiles are over arrivals, not survivors
            self.api.pods.pop(key, None)

    def _flap(self, ev: Event, tick: int) -> None:
        def in_group(n: Node) -> bool:
            if not ev.group:
                return True
            g = self.provider.node_group_for_node(n)
            return g is not None and g.id() == ev.group

        ready = sorted(
            n.name for n in self.api.list_nodes() if n.ready and in_group(n)
        )
        for name in ready[: ev.count]:
            node = self.api.nodes[name]
            self.api.nodes[name] = dataclasses.replace(node, ready=False)
            self._flapped[name] = tick + max(ev.duration_ticks, 1)

    def _recover_flaps(self, tick: int) -> None:
        for name, until in list(self._flapped.items()):
            if tick >= until:
                node = self.api.nodes.get(name)
                if node is not None:
                    self.api.nodes[name] = dataclasses.replace(node, ready=True)
                del self._flapped[name]

    def _spot_reclaim(self, f, tick: int) -> int:
        """The cloud reclaimed spot capacity out from under low-priority
        work: bound pods with priority < the fault's cutoff on the target
        group's nodes ("" = every group) re-enter the pending queue. The
        pods' latency clocks restart — the reclaim undid the bind — and the
        sorted iteration keeps the re-pend set a pure function of state."""
        group_of = self.provider.group_of_node_map()
        n = 0
        for key in sorted(self.api.pods):
            pod = self.api.pods[key]
            if not pod.node_name or pod.priority >= f.priority_cutoff:
                continue
            if f.group and group_of.get(pod.node_name, "") != f.group:
                continue
            self.api.pods[key] = dataclasses.replace(pod, node_name="")
            self.pod_latency[key] = (tick, None)
            n += 1
        return n

    def _resize(self, ev: Event) -> None:
        for group in self.provider.node_groups():
            if group.id() == ev.group:
                group.set_target_size(
                    max(group.min_size(), min(ev.count, group.max_size()))
                )
                return
        raise SpecError(f"resize event targets unknown group {ev.group!r}")

    # -- cloud + kubelet analog -----------------------------------------------
    def _materialize_cloud(self, tick: int) -> None:
        """Close the gap between each group's target and its instances, and
        register booted instances as ready Nodes."""
        for group in self.provider.node_groups():
            gid = group.id()
            gspec = self._group_spec[gid]
            gap = group.target_size() - len(group.nodes())
            for _ in range(max(gap, 0)):
                name = self._next_node_name(gid)
                error_info, stuck = self.injector.instance_fate(gid)
                inst = Instance(
                    id=name, state=InstanceState.CREATING, error_info=error_info
                )
                self.provider.add_instance(gid, inst)
                if error_info is None and not stuck:
                    self._boot_queue[name] = (tick + gspec.provision_ticks, gid)
            if gap < 0:
                self._shrink(gid, -gap)
        groups = {g.id(): g for g in self.provider.node_groups()}
        for name, (ready_tick, gid) in sorted(self._boot_queue.items()):
            if tick < ready_tick:
                continue
            del self._boot_queue[name]
            # group.nodes() copies the list but shares the Instance objects:
            # mutating state/id here is the cloud reporting the boot
            inst = next((i for i in groups[gid].nodes() if i.id == name), None)
            if inst is None:
                continue  # deleted while booting (failed-scale-up cleanup)
            inst.state = InstanceState.RUNNING
            node = self._make_node(self._group_spec[gid], name)
            inst.id = node.provider_id  # the cloud now reports the real id
            self.provider.attach_node(gid, node)
            self.api.add_node(node)

    def _shrink(self, gid: str, count: int) -> None:
        """Out-of-band target drop: the cloud reaps newest-first, preferring
        instances that never registered."""
        group = next(g for g in self.provider.node_groups() if g.id() == gid)
        registered = {n.provider_id for n in self.api.list_nodes()}
        victims = sorted(
            group.nodes(), key=lambda i: (i.id not in registered, i.id),
            reverse=True,
        )[:count]
        for inst in victims:
            self.provider.remove_instance(gid, inst.id)
            self._boot_queue.pop(inst.id, None)
            for node in self.api.list_nodes():
                if node.provider_id == inst.id or node.name == inst.id:
                    self.api.delete_node_object(node.name)

    def _bind_pods(self, tick: int) -> int:
        """Scheduler analog: place pending pods onto ready capacity."""
        pending = sorted(
            (p for p in self.api.list_pods() if not p.node_name),
            key=lambda p: p.key(),
        )
        if not pending:
            return 0
        snapshot = ClusterSnapshot(device=self.device)
        ready = [n for n in self.api.list_nodes() if n.ready and not n.unschedulable]
        if not ready:
            return 0
        for node in ready:
            snapshot.add_node(node)
        ready_names = {n.name for n in ready}
        for pod in self.api.list_pods():
            if pod.node_name in ready_names:
                snapshot.add_pod(pod, pod.node_name)
        for pod in pending:
            snapshot.add_pod(pod)
        _, assignments = self._scheduler.try_schedule_pods(
            snapshot, pending, commit=True
        )
        for key, node_name in assignments.items():
            pod = self.api.pods.get(key)
            if pod is not None:
                self.api.pods[key] = dataclasses.replace(pod, node_name=node_name)
                arrival, _ = self.pod_latency.get(key, (tick, None))
                self.pod_latency[key] = (arrival, tick)
        return len(assignments)

    # -- the loop -------------------------------------------------------------
    # run() is the one-shot entry; begin()/tick_once()/finish() are the
    # SAME loop exposed tick-at-a-time for the policy gym's step() API
    # (gym/env.py) — the env drives the identical code path,
    # which is what makes rollout-vs-direct decision parity structural.
    def begin(self) -> None:
        """Arm the tick loop: resolve the per-tick event index and the
        running aggregates run()/finish() maintain."""
        self._records: List[TickRecord] = []
        self._peak_nodes = len(self.api.nodes)
        self._by_tick: Dict[int, List[Event]] = {}
        for ev in self.timeline:
            self._by_tick.setdefault(ev.at_tick, []).append(ev)

    def tick_once(self, tick: int) -> TickRecord:
        """One scan interval: events → run_once → cloud/kubelet analog →
        scheduler analog → decision-log record."""
        spec = self.spec
        self.injector.tick = tick
        now = BASE_TS + tick * spec.tick_interval_s
        self._recover_flaps(tick)
        for ev in self._by_tick.get(tick, ()):
            self._apply_event(ev, tick)
        reclaimed = 0
        for f in self.injector.on_spot_reclaim():
            reclaimed += self._spot_reclaim(f, tick)
        pending_before = sum(
            1 for p in self.api.list_pods() if not p.node_name
        )
        # tag this tick's trace with scenario coordinates: the span
        # tree carries sim-time, so a /tracez trace from a replay can
        # be lined up against the decision log by (scenario, tick)
        self.tracer.set_context(
            scenario=spec.name, tick=tick, sim_ts=now
        )
        t0 = time.perf_counter()
        self.api.in_run_once = True
        try:
            result = self.autoscaler.run_once(now_ts=now)
        except Exception as e:  # noqa: BLE001 — crash-only analog:
            # main.run_loop catches per-iteration crashes; the driver
            # does the same so kube_api_error scenarios certify that
            # the loop survives (the tick records the typed error)
            from autoscaler_tpu_torch.utils.errors import to_autoscaler_error

            err = to_autoscaler_error(e)
            result = RunOnceResult(
                # a crashed tick established nothing about the cluster:
                # report unhealthy, not the dataclass default
                cluster_healthy=False,
                errors=[f"run_once crashed ({err.error_type.value}): {err}"],
            )
        finally:
            self.api.in_run_once = False
        wall = time.perf_counter() - t0
        self._materialize_cloud(tick)
        t_bind = time.perf_counter()
        bound = self._bind_pods(tick)
        bind_s = time.perf_counter() - t_bind
        live_cpu = sum(p.requests.cpu_m for p in self.api.list_pods())
        rec = TickRecord(
            tick=tick,
            now_ts=now,
            pending_before=pending_before,
            pending_after=sum(
                1 for p in self.api.list_pods() if not p.node_name
            ),
            unneeded=result.unneeded_nodes,
            nodes_ready=sum(1 for n in self.api.list_nodes() if n.ready),
            nodes_total=len(self.api.nodes),
            bound_pods=bound,
            demand_nodes=(
                int(math.ceil(live_cpu / self._max_group_cpu))
                if self._max_group_cpu > 0 else 0
            ),
            cluster_healthy=result.cluster_healthy,
            errors=sorted(result.errors),
            degraded=sorted(self.autoscaler.degraded_rungs()),
            backed_off=sorted(
                g.id()
                for g in self.provider.node_groups()
                if self.autoscaler.csr.backoff.is_backed_off(g.id(), now)
            ),
            preempt_admitted=result.preempt_admitted,
            preempted=sorted(result.preempted_pods),
            pending_expendable=result.pending_expendable,
            reclaimed=reclaimed,
            wall_s=wall,
            bind_s=bind_s,
        )
        if result.scale_up is not None and result.scale_up.scaled_up:
            # the orchestrator's actual executed list (balancing can
            # hand the chosen group zero nodes)
            rec.scale_ups = sorted(
                (g, int(d)) for g, d in result.scale_up.executed if d > 0
            )
        if result.scale_up is not None and result.scale_up.error:
            rec.errors = sorted(rec.errors + [result.scale_up.error])
        if result.scale_down is not None:
            rec.scale_downs = sorted(
                result.scale_down.deleted_empty
                + result.scale_down.deleted_drain
            )
            rec.evicted = sorted(result.scale_down.evicted_pods)
        self._records.append(rec)
        self._peak_nodes = max(self._peak_nodes, len(self.api.nodes))
        return rec

    def finish(self) -> RunResult:
        return RunResult(
            spec=self.spec,
            records=self._records,
            trace=[_event_dict(e) for e in self.timeline],
            metrics=self.metrics,
            pod_latency=dict(self.pod_latency),
            injected_faults=dict(self.injector.injected),
            peak_nodes=self._peak_nodes,
            final_nodes=len(self.api.nodes),
            total_requested_cpu_m=self.total_requested_cpu_m,
            group_cpu_m=self._max_group_cpu,
            recorder=self.tracer.recorder,
            perf_records=self.autoscaler.observatory.records(),
            explain_records=self.autoscaler.explainer.records(),
            slo_records=self.autoscaler.slo.records(),
            journal_records=self.autoscaler.journal.records(),
            device=str(self.device),
        )

    def run(self) -> RunResult:
        self.begin()
        for tick in range(self.spec.ticks):
            self.tick_once(tick)
        return self.finish()


def _event_dict(ev: Event) -> Dict[str, Any]:
    from autoscaler_tpu_torch.loadgen.spec import _strip

    return _strip(dataclasses.asdict(ev))


def run_scenario(spec: ScenarioSpec, real_sleep: bool = False, device=None) -> RunResult:
    return ScenarioDriver(spec, real_sleep=real_sleep, device=device).run()
