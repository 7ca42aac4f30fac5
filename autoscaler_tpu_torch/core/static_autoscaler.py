"""StaticAutoscaler: one reconcile iteration (RunOnce) per scan interval.

Reference: cluster-autoscaler/core/static_autoscaler.go — RunOnce :288
(see SURVEY.md §3.2 for the full stack): leftover-taint cleanup :230,
node/pod listing :304, provider refresh :333, snapshot init :250, cluster
state update :376, unregistered-node cleanup / fixNodeGroupSize :413-455
:707-773, expendable filter + upcoming-node injection :471-519,
filter-out-schedulable :528, ScaleUp branch :560-580, ScaleDown branch
:582-691 with cooldown gates :628-640, soft taints :676.

The decision hot paths (predicate fit, binpacking, utilization, removal
refit, greedy packing) all run as batched device kernels; this loop is the
thin host shell around them.

The port of ``autoscaler_tpu/core/static_autoscaler.py``. Everything runs on
``device`` (None = the first CUDA card; ``"cpu"`` runs the plain versions on
the host): the incremental packer and its arena pack there, so the
snapshot, filter-out-schedulable, the planner's removal refit and the
actuator's snapshot reads follow it, and the orchestrator's estimator, its
operand arena and the journal's probe are built there.

Each tick advances the estimator's kernel ladder (``kernel_ladder()``) on
loop time, reports tripped rungs (``degraded_rungs()``) in the decision
record and the status ConfigMap, and closes one perf record in the
observatory (``self.observatory``, served by ``/perfz``): the residency of
the packer, the arena and the operand arena, the arena's per-tick stats,
and every dispatch of the tick, under a ``perfRecord`` span.

With ``preemption_enabled`` the tick plans priority-aware evictions on the
snapshot (``preempt/``, the estimator's ``torch_preempt`` route) before
scale-up and evicts, after it, the victims of the admitted pods whose
capacity the scale-up does not bring. With ``jax_profiler_dir`` (the flag
keeps the JAX package's name) each tick runs under a torch.profiler
session exported into ``<dir>/tick_<id>/`` (``trace/device.py``), keyed by
the tick's trace id.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.cloudprovider.interface import CloudProvider
from autoscaler_tpu_torch.clusterstate.registry import ClusterStateRegistry
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.core.podlistprocessor import FilterOutSchedulablePodListProcessor
from autoscaler_tpu_torch.core.scaledown.actuator import ActuationResult, ScaleDownActuator
from autoscaler_tpu_torch.core.scaledown.planner import ScaleDownPlanner
from autoscaler_tpu_torch.core.scaleup.orchestrator import ScaleUpOrchestrator, ScaleUpResult
from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.explain.reasons import (
    EVICTION_PREEMPTED_BY,
    REASON_EXPENDABLE_BELOW_CUTOFF,
    REASON_NAMES,
    REASON_NOT_CHOSEN,
    REASON_NO_VIABLE_GROUP,
    SkipReason,
)
from autoscaler_tpu_torch.kube.api import ClusterAPI, EvictionError
from autoscaler_tpu_torch.kube.objects import Node, Pod, Resources
from autoscaler_tpu_torch.metrics import metrics as metrics_mod
from autoscaler_tpu_torch.metrics.healthcheck import HealthCheck
from autoscaler_tpu_torch.preempt import PreemptionEngine
from autoscaler_tpu_torch.perf import (
    POOL_ARENA,
    POOL_SNAPSHOT,
    PerfObservatory,
    default_peak_flops,
)
from autoscaler_tpu_torch.simulator.removal import UnremovableReason
from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot
from autoscaler_tpu_torch import trace
from autoscaler_tpu_torch.utils import klogx
from autoscaler_tpu_torch.utils.errors import to_autoscaler_error


@dataclass
class RunOnceResult:
    scale_up: Optional[ScaleUpResult] = None
    scale_down: Optional[ActuationResult] = None
    scale_down_in_cooldown: bool = False
    cluster_healthy: bool = True
    pending_pods: int = 0
    filtered_schedulable: int = 0
    unneeded_nodes: int = 0
    removed_unregistered: int = 0
    # pending pods dropped below --expendable-pods-priority-cutoff this tick
    pending_expendable: int = 0
    # preemption engine (--preemption-enabled): pending pods the eviction-
    # packing pass admitted onto the existing cluster, and the victims it
    # actually evicted (sorted pod keys — ledger/driver consumers)
    preempt_admitted: int = 0
    preempted_pods: List[str] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)


class StaticAutoscaler:
    def __init__(
        self,
        provider: CloudProvider,
        api: ClusterAPI,
        options: Optional[AutoscalingOptions] = None,
        csr: Optional[ClusterStateRegistry] = None,
        scale_up_orchestrator: Optional[ScaleUpOrchestrator] = None,
        scale_down_planner: Optional[ScaleDownPlanner] = None,
        scale_down_actuator: Optional[ScaleDownActuator] = None,
        pod_list_processor: Optional[FilterOutSchedulablePodListProcessor] = None,
        metrics: Optional[metrics_mod.AutoscalerMetrics] = None,
        health_check: Optional[HealthCheck] = None,
        debugger=None,
        processors=None,
        tracer: Optional[trace.Tracer] = None,
        observatory=None,
        device=None,
    ):
        from autoscaler_tpu_torch.processors.pipeline import default_processors

        self.options = options or AutoscalingOptions()
        self.device = resolve_device(device)
        self.provider = provider
        self.api = api
        self.processors = processors or default_processors(self.options)
        self.csr = csr or ClusterStateRegistry(provider, self.options)
        self.metrics = metrics or metrics_mod.AutoscalerMetrics()
        # perf observatory (autoscaler_tpu_torch/perf): per-route compile
        # telemetry, the cost model (--perf-cost-model) and device-residency
        # accounting. One per autoscaler; served by /perfz.
        self.observatory = observatory or PerfObservatory(
            metrics=self.metrics,
            cost_model=self.options.perf_cost_model,
            ring_capacity=self.options.perf_ring_size,
            peak_flops=default_peak_flops(self.device),
        )
        # decision explainer (autoscaler_tpu/explain): per-tick
        # DecisionRecords — constraint attribution, expander scoring table,
        # skip/backoff/breaker state, plan + scale-down reasons. One per
        # autoscaler, same lifecycle as the perf observatory; served by
        # /explainz, appended to the loadgen decision ledger.
        from autoscaler_tpu_torch.explain import DecisionExplainer

        self.explainer = DecisionExplainer(
            ring_capacity=self.options.explain_ring_size
        )
        # SLO engine (autoscaler_tpu/slo): declarative targets over the
        # request-lifecycle SLIs — tick duration (the main span's timeline
        # extent), pending-pod latency (tracked from the explainer's
        # per-tick still-pending set), and the fleet serving objective.
        # One window record per tick, served by /sloz; the ring shares the
        # explain cadence/size since the pending-pod SLI reads its records.
        from autoscaler_tpu_torch.slo import SloEngine, control_loop_slos

        self.slo = SloEngine(
            # the control-loop catalog only (tick duration, pending-pod
            # latency): this process runs no fleet coalescer, and an
            # objective that can never receive events would report a
            # permanently healthy fleet — the fleet_e2e spec lives with
            # the processes that serve fleet traffic
            specs=control_loop_slos(),
            metrics=self.metrics,
            ring_capacity=self.options.explain_ring_size,
        )
        # floor for perf tick ids: normally the trace id, but a re-entrant
        # tick (tracer degrades to a child span — no trace_id attr) must
        # still get a strictly increasing id or the ledger's monotonicity
        # gate trips on a pile of tick-0 records
        self._next_perf_tick = 0
        # content-addressed resident operand cache (snapshot/arena): the
        # estimator's dispatch arrays (requests/masks/allocs) are byte-
        # identical tick over tick in steady state — a hit re-dispatches
        # against the resident device handles instead of re-uploading
        self._operand_arena = None
        if self.options.arena_enabled:
            from autoscaler_tpu_torch.snapshot.arena import OperandArena

            self._operand_arena = OperandArena(device=self.device)
        self.scale_up_orchestrator = scale_up_orchestrator or ScaleUpOrchestrator(
            provider,
            self.options,
            self.csr,
            observatory=self.observatory,
            operand_arena=self._operand_arena,
            device=self.device,
            balancing_processor=self.processors.node_group_set,
            template_provider=self.processors.template_node_info_provider,
            node_group_list_processor=self.processors.node_group_list,
            node_info_processor=self.processors.node_info,
            binpacking_limiter=self.processors.binpacking_limiter,
            metrics=self.metrics,
            # live priority-ConfigMap read (expander/priority/priority.go)
            priorities_fetch=(
                (lambda: api.read_configmap(
                    self.options.config_namespace, self.options.priority_config_map
                ))
                if self.options.priority_config_map
                else None
            ),
        )
        # preemption engine (--preemption-enabled): plans priority-aware
        # evictions against each tick's snapshot through the estimator's
        # kernel ladder (preempt/). Built only when enabled
        # AND the orchestrator exposes its estimator — a custom
        # orchestrator without one silently gets no engine (decisions then
        # match preemption-off byte-for-byte).
        self.preempt_engine = None
        if self.options.preemption_enabled:
            est = getattr(self.scale_up_orchestrator, "estimator", None)
            if est is not None:
                self.preempt_engine = PreemptionEngine(
                    est, metrics=self.metrics
                )
        self.scale_down_planner = scale_down_planner or ScaleDownPlanner(
            provider, self.options, set_processor=self.processors.scale_down_set
        )
        self.scale_down_actuator = scale_down_actuator or ScaleDownActuator(
            provider,
            self.options,
            api,
            self.scale_down_planner.deletion_tracker,
        )
        self.pod_list_processor = (
            pod_list_processor or self.processors.pod_list_processor
        )
        self.health_check = health_check or HealthCheck(
            self.options.max_inactivity_s, self.options.max_failing_time_s
        )
        self.debugger = debugger
        # one trace (span tree) per run_once, kept in a bounded flight
        # recorder served by /tracez; the loadgen driver passes its own
        # tracer (injected deterministic clock) so replays export
        # byte-identical traces
        self.tracer = tracer or trace.Tracer(
            metrics=self.metrics,
            recorder=trace.FlightRecorder(capacity=self.options.trace_ring_size),
            slow_tick_threshold_s=self.options.trace_slow_tick_threshold_s,
        )
        self.last_scale_up_ts: Optional[float] = None
        self.last_scale_down_delete_ts: Optional[float] = None
        self.last_scale_down_fail_ts: Optional[float] = None
        self._initialized = False
        # Packed tensors persist across loops: each loop's fresh snapshot
        # shares this packer, so tensors() costs O(listing delta), not
        # O(world) — the DeltaClusterSnapshot intent (delta.go:26-42).
        # With --arena-enabled the tensors additionally stay DEVICE-
        # resident: the packer emits delta programs (row scatters) against
        # a double-buffered arena instead of re-uploading dense tensors,
        # and a startup walk of the bucket ladder allocates its shapes.
        from autoscaler_tpu_torch.snapshot.incremental import IncrementalPacker

        self._arena = None
        if self.options.arena_enabled:
            from autoscaler_tpu_torch.kube.objects import NUM_RESOURCES
            from autoscaler_tpu_torch.snapshot.arena import DeviceArena

            self._arena = DeviceArena(
                buckets=self.options.arena_buckets,
                observatory=self.observatory,
                metrics=self.metrics,
                device=self.device,
                # the tracer's timeline clock, so prewarm walls — recorded
                # before any tick trace exists — replay like every other
                # perf figure
                clock=self.tracer.clock,
            )
            self._arena.prewarm(R=NUM_RESOURCES)
        self._packer = IncrementalPacker(arena=self._arena, device=self.device)
        # flight journal (autoscaler_tpu/journal): the black-box recorder.
        # Always on (bounded ring) — journal_enabled gates /journalz only,
        # journal_path additionally appends to disk. The packer sink
        # captures each tick's FIRST materialization (the decision-input
        # state: ClusterSnapshot caches tensors per version and revert()
        # restores the fork-time version, so that first materialization is
        # exactly what the estimator/expander/preemption pass read);
        # record_tick then pins it to the tick's decision record by hash.
        from autoscaler_tpu_torch.journal import JournalRecorder

        self.journal = JournalRecorder(
            ring_capacity=self.options.journal_ring_size,
            keyframe_interval=self.options.journal_keyframe_interval,
            path=self.options.journal_path,
            options_doc=dataclasses.asdict(self.options),
            metrics=self.metrics,
            device=self.device,
        )
        self._packer.journal_sink = self.journal.observe_update

    # -- one reconcile iteration (reference :288) ----------------------------
    def run_once(self, now_ts: float) -> RunOnceResult:
        """Instrumented wrapper: the tick's span tree (whose span durations
        feed the per-phase duration metrics through one choke point),
        counters, liveness, and the on-demand debugging capture (reference
        metrics.go:399 + static_autoscaler.go:334,380,540,626,661)."""
        # advance the kernel ladder's breaker clock on loop time (a
        # synthetic clock in replays — what makes breaker cooldowns
        # replayable)
        ladder = self.kernel_ladder()
        if ladder is not None:
            ladder.tick(now_ts)
        with self.tracer.tick(metrics_mod.MAIN, now_ts=now_ts) as root:
            # open this tick's perf record: dispatches recorded between
            # begin_tick and end_tick are stamped with this tick id — the
            # trace id when the tracer issued one (/perfz, /explainz,
            # /journalz and /tracez line up by construction), else the
            # monotonic floor (re-entrant ticks have no trace_id and must
            # not all collapse to 0)
            raw_id = root.attrs.get("trace_id")
            tick_id = max(
                int(raw_id) if raw_id is not None else 0,
                self._next_perf_tick,
            )
            self._next_perf_tick = tick_id + 1
            self.observatory.begin_tick(tick_id, now_ts)
            self.explainer.begin_tick(tick_id, now_ts)
            # the journal line shares it too: /journalz drills down into
            # the same tick the other rings describe
            self.journal.begin_tick(tick_id)
            # the tick-duration SLI measures on the timeline seam: a
            # synthetic clock makes the measured duration (and every burn
            # rate derived from it) replay byte-identically
            slo_t0 = trace.timeline_now()
            try:
                result = self._run_once_traced(now_ts, root)
            finally:
                # finalize even when the tick crashed (the crash-only loop
                # catches outside): the ledgers stay gap-free, and the
                # residency snapshot reflects whatever the tick left live
                self._close_perf_record()
                # a crashed tick leaves a PARTIAL decision record — the
                # sections noted before the crash are exactly the
                # decisions that were made
                with trace.span(metrics_mod.EXPLAIN_RECORD):
                    explain_rec = self.explainer.end_tick()
                # journal the tick's state AFTER the decision record closes:
                # the journal line carries the explain line's hash, pinning
                # state history to decision history byte-for-byte
                with trace.span(metrics_mod.JOURNAL_RECORD):
                    self.journal.record_tick(explain_rec)
                    probe_every = self.options.journal_probe_interval
                    if probe_every > 0 and tick_id % probe_every == 0:
                        verdict = self.journal.probe()
                        if verdict.get("drift"):
                            # a silently wrong forensic answer becomes an
                            # alarm: counted, and stamped on the tick trace
                            self.metrics.journal_probe_drift_total.inc()
                            trace.add_event(
                                "journal.probe_drift",
                                tick=int(verdict.get("tick", -1)),
                                fields=",".join(verdict.get("fields", ())),
                                fit_drift=bool(verdict.get("fit_drift")),
                            )
                # SLO window: judge this tick's SLIs and compute burn
                # rates — crash paths included, so a crashing loop still
                # burns budget instead of going silent
                with trace.span(metrics_mod.SLO_WINDOW):
                    from autoscaler_tpu_torch.slo import SLI_TICK_DURATION

                    self.slo.observe(
                        SLI_TICK_DURATION,
                        trace.timeline_now() - slo_t0,
                        now=now_ts,
                    )
                    self.slo.observe_explain(explain_rec)
                    self.slo.tick(now_ts, tick_id)
            root.set_attrs(
                pending=result.pending_pods,
                healthy=result.cluster_healthy,
                errors=len(result.errors),
            )
            return result

    def _run_once_traced(self, now_ts: float, root) -> RunOnceResult:
        m = self.metrics
        # optional device-timeline capture keyed by the host trace's tick id
        # (--jax-profiler-dir): the profiler session directory and the
        # flight-recorder trace share the id, so "why was tick 8124 slow"
        # has both the host span tree and the device profile
        profiling = False
        tick_id = int(root.attrs.get("trace_id", 0))
        if self.options.jax_profiler_dir:
            from autoscaler_tpu_torch.trace.device import start_profiler_session

            profiling = start_profiler_session(
                self.options.jax_profiler_dir, tick_id
            )
        try:
            if profiling:
                # mark the tick as one profiler "step": profiler UIs group
                # the captured device activity per tick
                from autoscaler_tpu_torch.trace.device import step_annotation

                with step_annotation("run_once", tick_id):
                    result = self._run_once_inner(now_ts)
            else:
                result = self._run_once_inner(now_ts)
        finally:
            if profiling:
                from autoscaler_tpu_torch.trace.device import stop_profiler_session

                stop_profiler_session()
            # status ConfigMap write mirrors the reference's defer
            # (static_autoscaler.go:387-393 + clusterstate.go:701): it must
            # run on EVERY exit path — unhealthy-cluster and error returns
            # included — or operators would read a stale 'Healthy' status
            # exactly while the autoscaler is degraded.
            if self.options.write_status_configmap:
                try:
                    from autoscaler_tpu_torch.clusterstate.status import build_status

                    self.api.write_configmap(
                        self.options.config_namespace,
                        self.options.status_config_map_name,
                        {
                            "status": build_status(
                                self.csr, now_ts, self.options.cluster_name,
                                degraded_rungs=self.degraded_rungs(),
                                # most recent COMPLETED record (this tick's
                                # is still open here — it closes in
                                # run_once's finally, after this write)
                                last_decision=self.explainer.last_decision_summary(),
                            ).render()
                        },
                    )
                    trace.add_event("status.configmap_write")
                except Exception as e:
                    # best-effort observability, never loop-fatal — but the
                    # failure is typed, counted, and on the tick's trace
                    err = to_autoscaler_error(e)
                    m.errors_total.inc(type=err.error_type.value)
                    trace.add_event(
                        "status.configmap_write_failed", error=str(err)
                    )
        # last_activity per activity label (metrics.go UpdateLastTime): the
        # main label every loop; scaleUp/scaleDown in their branches below
        m.last_activity.set(now_ts, activity=metrics_mod.MAIN)
        m.unschedulable_pods_count.set(result.pending_pods)
        m.unneeded_nodes_count.set(result.unneeded_nodes)
        m.node_groups_count.set(len(self.provider.node_groups()))
        m.cluster_safe_to_autoscale.set(1.0 if result.cluster_healthy else 0.0)

        # cluster-size gauges (metrics.go:112-200)
        t = self.csr.total_readiness()
        m.nodes_count.set(t.ready, state="ready")
        m.nodes_count.set(t.unready, state="unready")
        m.nodes_count.set(t.not_started, state="notStarted")
        m.nodes_count.set(t.long_unregistered, state="longUnregistered")
        m.nodes_count.set(t.unregistered, state="unregistered")
        m.max_nodes_count.set(self.options.max_nodes_total)
        # the registry holds the node list this iteration ran against — no
        # extra LIST against the control plane just for gauges
        nodes_now = self.csr.registered_nodes()
        m.cluster_cpu_current_cores.set(
            sum(n.allocatable.cpu_m for n in nodes_now) / 1000.0
        )
        m.cluster_memory_current_bytes.set(
            sum(n.allocatable.memory for n in nodes_now)
        )
        m.cpu_limits_cores.set(self.options.min_cores_total / 1000.0, direction="minimum")
        m.cpu_limits_cores.set(self.options.max_cores_total / 1000.0, direction="maximum")
        m.memory_limits_bytes.set(
            self.options.min_memory_total * 1024 * 1024, direction="minimum"
        )
        m.memory_limits_bytes.set(
            self.options.max_memory_total_mib * 1024 * 1024, direction="maximum"
        )
        if self.options.record_per_node_group_metrics:
            for g in self.provider.node_groups():
                m.node_group_min_count.set(g.min_size(), node_group=g.id())
                m.node_group_max_count.set(g.max_size(), node_group=g.id())
        m.nap_enabled.set(1.0 if self.options.node_autoprovisioning_enabled else 0.0)

        if result.scale_up is not None and result.scale_up.scaled_up:
            m.scaled_up_nodes_total.inc(result.scale_up.new_nodes)
            if self._group_has_accelerator(result.scale_up.chosen_group):
                m.scaled_up_gpu_nodes_total.inc(result.scale_up.new_nodes)
        if result.scale_up is not None and result.scale_up.error:
            m.failed_scale_ups_total.inc()
        if result.scale_down is not None:
            m.scaled_down_nodes_total.inc(
                len(result.scale_down.deleted_empty), reason="empty"
            )
            m.scaled_down_nodes_total.inc(
                len(result.scale_down.deleted_drain), reason="underutilized"
            )
            m.evicted_pods_total.inc(len(result.scale_down.evicted_pods))
        m.scale_down_in_cooldown.set(1.0 if result.scale_down_in_cooldown else 0.0)
        # reset every reason each loop so a reason that stops occurring
        # reports 0 instead of its last nonzero value
        by_reason: Dict[str, int] = {r.value: 0 for r in UnremovableReason}
        for u in self.scale_down_planner.last_unremovable():
            by_reason[u.reason.value] = by_reason.get(u.reason.value, 0) + 1
        for reason, count in by_reason.items():
            m.unremovable_nodes_count.set(count, reason=reason)
        # scale-up skip accounting mirrors the scale-down gauge above:
        # every closed SkipReason reset each loop so a reason that stops
        # occurring reports 0 (CA parity: skipped_scale_events_count)
        skip_counts: Dict[str, int] = {r.value: 0 for r in SkipReason}
        if result.scale_up is not None:
            for skip in result.scale_up.skipped_groups.values():
                skip_counts[skip.value] += 1
        for reason, count in skip_counts.items():
            m.scaleup_skipped_groups_total.set(count, reason=reason)
        if result.removed_unregistered:
            m.old_unregistered_nodes_removed_count.inc(result.removed_unregistered)
        tracker = self.scale_down_planner.deletion_tracker
        m.pending_node_deletions.set(
            tracker.deletions_count(drain=True) + tracker.deletions_count(drain=False)
        )
        for err in result.errors:
            m.errors_total.inc(type="internal")
        if result.errors:
            self.health_check.update_last_activity()
        else:
            self.health_check.update_last_success()
        self.processors.scale_down_status.process(result.scale_down)
        self.processors.autoscaling_status.process(result, now_ts)
        return result

    def _run_once_inner(self, now_ts: float) -> RunOnceResult:
        result = RunOnceResult()

        # startup: clean leftover taints from a crashed predecessor (:230)
        if not self._initialized:
            self.scale_down_actuator.clean_up_to_be_deleted_taints(self.api.list_nodes())
            self._initialized = True

        # 1. observe the world (:304) and refresh cloud caches (:333)
        with trace.span(metrics_mod.POLL) as sp:
            try:
                self.provider.refresh()
            except Exception as e:
                # typed routing; errors_total accounting rides the
                # result.errors loop at the end of _run_once_traced
                err = to_autoscaler_error(e)
                sp.set_attrs(error="refresh_failed")
                result.errors.append(f"provider refresh failed: {err}")
                return result
            all_nodes = self.api.list_nodes()
            all_pods = self.api.list_pods()
            pdbs = self.api.list_pdbs()
            sp.set_attrs(nodes=len(all_nodes), pods=len(all_pods))

        # actionable-cluster gate (reference processors/actionablecluster)
        if not self.processors.actionable_cluster.should_autoscale(all_nodes, now_ts):
            result.errors.append("cluster not actionable this iteration")
            # OnEmptyCluster → ResetUnneededNodes (actionable_cluster_
            # processor.go:68 via processors/callbacks): stale unneeded
            # clocks must not fire deletions the moment the cluster resumes
            self.scale_down_planner.unneeded.reset()
            return result

        # accelerator nodes still attaching devices count as unready
        # (processors/customresources, reference gpu_processor.go)
        _, accel_not_ready = self.processors.custom_resources.filter_out_nodes_with_unready_resources(
            all_nodes
        )
        if accel_not_ready:
            initializing = {n.name for n in accel_not_ready}
            all_nodes = [
                dataclasses.replace(n, ready=False) if n.name in initializing else n
                for n in all_nodes
            ]

        # 2. cluster state accounting (:376); nodes mid-deletion count in the
        # `deleted` readiness bucket, not as ready capacity
        with trace.span(metrics_mod.UPDATE_STATE):
            self.csr.register_deleted_nodes(
                self.scale_down_planner.deletion_tracker.in_flight_names()
            )
            self.csr.update_nodes(all_nodes, now_ts)
        result.cluster_healthy = self.csr.is_cluster_healthy()
        if not result.cluster_healthy:
            result.errors.append("cluster unhealthy: too many unready nodes")
            return result

        # 3. stuck-provision recovery (:413-455, :707-773)
        result.removed_unregistered = self._remove_old_unregistered(now_ts)
        self._delete_created_nodes_with_errors()

        # 4. build the snapshot (:250-354)
        with trace.span(metrics_mod.SNAPSHOT_BUILD) as sp_snap:
            snapshot = ClusterSnapshot(packer=self._packer)
            scheduled, pending = self._split_pods(all_pods)
            for node in all_nodes:
                snapshot.add_node(node)
            for pod in scheduled:
                if snapshot.get_node(pod.node_name) is not None:
                    snapshot.add_pod(pod, pod.node_name)
            for pod in pending:
                snapshot.add_pod(pod)

            # legacy TPU-request sanitizer (:459-466, utils/tpu/tpu.go:57)
            from autoscaler_tpu_torch.utils.tpu import clear_tpu_requests

            pending = clear_tpu_requests(pending)

            # expendable filter (:471) + young-pod filter (:832). Dropped
            # pods are counted and ledgered (expendable_below_cutoff), not
            # silently vanished: a pod parked below the cutoff forever is a
            # config decision operators must be able to see on /explainz.
            cutoff = self.options.expendable_pods_priority_cutoff
            expendable = [p for p in pending if p.priority < cutoff]
            pending = [p for p in pending if p.priority >= cutoff]
            if expendable:
                self.metrics.pending_expendable_total.inc(len(expendable))
            if self.options.new_pod_scale_up_delay_s > 0:
                pending = [
                    p
                    for p in pending
                    if now_ts - p.creation_ts >= self.options.new_pod_scale_up_delay_s
                ]

            # pending-DaemonSet charge shared by upcoming-node injection and
            # the scale-up templates (--force-ds): lazily fetched at most
            # once per loop — idle iterations (nothing pending, nothing
            # upcoming) issue no LIST at all
            ds_memo: List = []

            def pending_ds():
                if not self.options.force_daemonsets:
                    return ()
                if not ds_memo:
                    ds_memo.append(self.api.list_daemonsets())
                return ds_memo[0]

            # upcoming (requested-not-yet-registered) nodes join the
            # simulation as virtual template nodes (:484-519)
            upcoming_names = self._inject_upcoming_nodes(
                snapshot, now_ts, pending_ds
            )
            sp_snap.set_attrs(
                scheduled=len(scheduled), pending=len(pending),
                upcoming=len(upcoming_names),
            )

        # 5. filter-out-schedulable (:528) — device-packed onto a fork
        with trace.span(metrics_mod.FILTER_OUT_SCHEDULABLE) as sp_filter:
            snapshot.fork()
            pending, filtered = self.pod_list_processor.process(snapshot, pending)
            snapshot.revert()
            sp_filter.set_attrs(absorbed=len(filtered), still_pending=len(pending))
        # quota-bounded per-pod verbosity (static_autoscaler.go:528 area +
        # utils/klogx defaults: 20 lines, 1000 at -v>=5)
        pod_quota = klogx.pods_logging_quota()
        for pod in pending:
            klogx.v(4).up_to(pod_quota).info("Pod %s is unschedulable", pod.key())
        klogx.v(4).over(pod_quota).info(
            "%d other unschedulable pods not logged", -pod_quota.left
        )
        result.filtered_schedulable = len(filtered)
        result.pending_pods = len(pending)

        # decision provenance: the tick's pending split and the breaker/
        # backoff state every later section is conditioned on
        result.pending_expendable = len(expendable)
        self.explainer.note(
            "pending",
            {
                "arrived": len(pending) + len(filtered),
                "filtered_schedulable": len(filtered),
                "pending": len(pending),
                "expendable": len(expendable),
            },
        )
        # dropped-pod provenance: the expendable verdicts are the tick's
        # baseline pods section; _note_scale_up_explain merges the
        # scale-up pass's reasons on top (no scale-up this tick — nothing
        # pending — still leaves these visible)
        expendable_doc = {
            p.key(): REASON_EXPENDABLE_BELOW_CUTOFF for p in expendable
        }
        if expendable_doc:
            self.explainer.note("pods", dict(expendable_doc))
        self.explainer.note("degraded_rungs", sorted(self.degraded_rungs()))
        self.explainer.note(
            "backoff",
            sorted(
                g.id()
                for g in self.provider.node_groups()
                if self.csr.backoff.is_backed_off(g.id(), now_ts)
            ),
        )

        # 5b. preemption planning (--preemption-enabled): which pending pods
        # the EXISTING cluster could admit by displacing strictly-lower-
        # priority residents (preempt/ via ops/preempt.py).
        # Planned before scale-up so the expander can penalize options that
        # leave evictions standing; actuated after it so pods whose
        # capacity is already coming evict nobody.
        preempt_plan = None
        preempt_doc = None
        if self.preempt_engine is not None and pending:
            preempt_plan = self.preempt_engine.plan(
                snapshot, eligible={p.key() for p in pending}
            )
            # journal the eligible set: `journal replay` re-runs this exact
            # pass on reconstructed state, and eligibility is a function of
            # Pod objects the state tensors do not carry
            self.journal.note(
                "preempt_eligible", sorted(p.key() for p in pending)
            )
            preempt_doc = {
                "route": preempt_plan.route,
                "admitted": preempt_plan.admitted,
                "evictions": [
                    {
                        "pod": victim,
                        "reason": EVICTION_PREEMPTED_BY,
                        "by": preempt_plan.victims[victim],
                        "node": preempt_plan.victim_pods[victim].node_name,
                    }
                    for victim in sorted(preempt_plan.victims)
                ],
            }
            self.explainer.note("preemption", dict(preempt_doc))
            result.preempt_admitted = len(preempt_plan.admitted)

        # 6. scale-up (:560-580)
        if pending:
            with trace.span(metrics_mod.SCALE_UP) as sp_up:
                up = self.scale_up_orchestrator.scale_up(
                    pending, all_nodes, now_ts,
                    # new nodes boot the group's daemonsets: their observed
                    # overhead on the template's source node is charged
                    # against template capacity (simulator/nodes.go:38)
                    pods_of_node=snapshot.pods_on_node,
                    # --force-ds additionally charges suitable-but-not-yet-
                    # running DaemonSets (simulator/nodes.go:56)
                    pending_daemonsets=pending_ds(),
                    # eviction-churn score column (expander/core.py): how
                    # many planned evictions an option leaves standing
                    preemption_churn=(
                        preempt_plan.churn if preempt_plan is not None
                        else None
                    ),
                )
                self._note_scale_up_explain(up, base_pods=expendable_doc)
                sp_up.set_attrs(
                    scaled_up=up.scaled_up,
                    group=up.chosen_group or "",
                    new_nodes=up.new_nodes,
                    skipped_groups=len(up.skipped_groups),
                    remain_unschedulable=len(up.pods_remain_unschedulable),
                )
            self.metrics.last_activity.set(now_ts, activity=metrics_mod.SCALE_UP)
            result.scale_up = up
            self.processors.scale_up_status.process(up)
            if up.scaled_up:
                self.last_scale_up_ts = now_ts
        min_size_ups = self.scale_up_orchestrator.scale_up_to_node_group_min_size(now_ts)
        if min_size_ups:
            self.last_scale_up_ts = now_ts

        # 6b. actuate planned evictions — only for admitted pods whose
        # capacity is NOT already coming from this tick's scale-up
        # (pods_triggered): preemption bridges the gap for the rest.
        # Victims evicted in sorted order (replay determinism); a typed
        # eviction failure is recorded and the loop continues — the victim
        # stays resident and next tick replans.
        if preempt_plan is not None and preempt_plan.victims:
            covered = set()
            if result.scale_up is not None:
                covered = {
                    p.key() for p in result.scale_up.pods_triggered
                }
            evicted: List[str] = []
            evict_failed: List[str] = []
            for victim in sorted(preempt_plan.victims):
                if preempt_plan.victims[victim] in covered:
                    continue
                try:
                    self.api.evict_pod(preempt_plan.victim_pods[victim])
                except EvictionError as e:
                    result.errors.append(
                        f"preemption eviction of {victim} failed: {e}"
                    )
                    evict_failed.append(victim)
                else:
                    evicted.append(victim)
            if evicted:
                self.metrics.preempted_pods_total.inc(len(evicted))
                self.metrics.evicted_pods_total.inc(len(evicted))
                self.metrics.last_activity.set(
                    now_ts, activity=metrics_mod.PREEMPT_PLAN
                )
            result.preempted_pods = evicted
            preempt_doc = dict(preempt_doc)
            preempt_doc["evicted"] = evicted
            self.explainer.note("preemption", preempt_doc)
            # journal the actuation context: the evicted list is victims
            # minus scale-up-covered evictors minus API failures — the
            # coverage set and the failures are environment/decision state
            # `journal replay` cannot re-derive from tensors alone
            self.journal.note("preempt_covered", sorted(covered))
            self.journal.note("preempt_evict_failed", evict_failed)

        # 7. scale-down branch (:582-691)
        if self.options.node_autoprovisioning_enabled:
            # NAP cleanup: drop empty autoprovisioned groups (:650)
            self.processors.node_group_manager.remove_unneeded_node_groups(
                self.provider, self.metrics
            )
        if self.options.scale_down_enabled:
            with trace.span(metrics_mod.SCALE_DOWN) as sp_down:
                with trace.span(metrics_mod.FIND_UNNEEDED):
                    candidates = self.processors.scale_down_candidates_sorting.sort(
                        self.processors.scale_down_node.get_scale_down_candidates(
                            self._scale_down_candidates(all_nodes, upcoming_names),
                            all_nodes,
                        )
                    )
                    self.scale_down_planner.update_cluster_state(
                        snapshot, candidates, pdbs, now_ts
                    )
                self.metrics.last_activity.set(
                    now_ts, activity=metrics_mod.SCALE_DOWN
                )
                result.unneeded_nodes = len(self.scale_down_planner.unneeded_names())
                self.processors.notify_scale_down_candidates(
                    self.scale_down_planner.unneeded_names()
                )
                in_cooldown = self._scale_down_in_cooldown(now_ts)
                result.scale_down_in_cooldown = in_cooldown
                sp_down.set_attrs(
                    unneeded=result.unneeded_nodes, in_cooldown=in_cooldown
                )
                if not in_cooldown:
                    plan = self.scale_down_planner.nodes_to_delete(snapshot, now_ts)
                    if plan.empty or plan.drain:
                        down = self.scale_down_actuator.start_deletion(plan, now_ts)
                        result.scale_down = down
                        sp_down.set_attrs(
                            deleted_empty=len(down.deleted_empty),
                            deleted_drain=len(down.deleted_drain),
                        )
                        if down.deleted_empty or down.deleted_drain:
                            self.last_scale_down_delete_ts = now_ts
                            # per-node registration widens the group's
                            # acceptable range while the cloud deletion is in
                            # flight (clusterstate.go RegisterScaleDown)
                            deleted = set(down.deleted_empty + down.deleted_drain)
                            registered_any = False
                            for r in plan.empty + plan.drain:
                                if r.node.name in deleted:
                                    g = self.provider.node_group_for_node(r.node)
                                    self.csr.register_scale_down(
                                        now_ts, g.id() if g else "", r.node.name
                                    )
                                    registered_any = True
                            if not registered_any:
                                self.csr.register_scale_down(now_ts)
                            # destinations of the deleted nodes' simulated
                            # pods restart their unneeded clocks
                            # (simulator/tracker.go)
                            for name in down.deleted_empty + down.deleted_drain:
                                self.scale_down_planner.node_deleted(name, now_ts)
                            gpu_deleted = sum(
                                1
                                for r in plan.empty + plan.drain
                                if r.node.name in deleted
                                and (
                                    r.node.allocatable.gpu > 0
                                    or r.node.allocatable.tpu > 0
                                )
                            )
                            if gpu_deleted:
                                self.metrics.scaled_down_gpu_nodes_total.inc(
                                    gpu_deleted
                                )
                        if down.failed:
                            self.last_scale_down_fail_ts = now_ts
                # keep soft taints in sync either way (:676)
                self.scale_down_actuator.update_soft_deletion_taints(
                    self.api.list_nodes(), self.scale_down_planner.unneeded_names()
                )
                # decision provenance: what scale-down spared and why
                unremovable: Dict[str, int] = {}
                for u in self.scale_down_planner.last_unremovable():
                    unremovable[u.reason.value] = (
                        unremovable.get(u.reason.value, 0) + 1
                    )
                down = result.scale_down
                self.explainer.note(
                    "scale_down",
                    {
                        "unneeded": sorted(
                            self.scale_down_planner.unneeded_names()
                        ),
                        "unremovable": {
                            k: unremovable[k] for k in sorted(unremovable)
                        },
                        "in_cooldown": in_cooldown,
                        "deleted": sorted(
                            (down.deleted_empty + down.deleted_drain)
                            if down is not None else []
                        ),
                    },
                )
        if self.debugger is not None and self.debugger.is_data_collection_allowed():
            self.debugger.capture(
                self, snapshot, pending, result, filtered_pods=filtered,
                now=now_ts,
            )
        return result

    # -- helpers -------------------------------------------------------------
    def _note_scale_up_explain(
        self, up: ScaleUpResult, base_pods: Optional[Dict[str, str]] = None
    ) -> None:
        """Assemble the scale-up sections of this tick's DecisionRecord
        from the orchestrator result: the estimator's constraint
        attribution, the expander's full scoring table, the closed skip
        reasons, the executed plan, and one reason per pod that stayed
        pending (a pod the estimator could place SOMEWHERE but the chosen
        option did not cover reads 'not_chosen'; a pod that never reached
        estimation reads 'no_viable_group'). ``base_pods`` carries verdicts
        settled before scale-up (expendable_below_cutoff) that the pods
        section must keep."""
        ex = self.explainer
        explain = up.estimator_explain or {}
        ex.note("estimator", {"groups": explain.get("groups", {})})
        ex.note(
            "expander",
            {
                "options": list(up.expander_table),
                "chosen": up.chosen_group or "",
                "score": up.chosen_score,
            },
        )
        ex.note(
            "skipped_groups",
            {g: r.value for g, r in sorted(up.skipped_groups.items())},
        )
        # the orchestrator's actual executed list, not a reconstruction
        # from chosen_group (balancing can hand the chosen group zero
        # nodes while a similar group scales)
        executed = sorted([g, int(d)] for g, d in up.executed if d > 0)
        ex.note(
            "scale_up",
            {
                "executed": executed,
                "error": up.error,
                "remain_unschedulable": len(up.pods_remain_unschedulable),
                "pods_triggered": sorted(p.key() for p in up.pods_triggered),
            },
        )
        pod_reasons = explain.get("pod_reasons", {})
        pods_doc = dict(base_pods or {})
        for p in up.pods_remain_unschedulable:
            reason = pod_reasons.get(p.key())
            if reason is None:
                reason = REASON_NO_VIABLE_GROUP
            elif reason == REASON_NAMES[0]:
                # schedulable somewhere, but the winning option (or a
                # failed/capped execution) did not cover this pod
                reason = REASON_NOT_CHOSEN
            pods_doc[p.key()] = reason
        ex.note("pods", pods_doc)

    def _close_perf_record(self) -> None:
        """The tick's perf record: the packer's, the arena's and the
        operand arena's device bytes, the arena's per-tick stats (delta
        rows, full uploads, promotions, rollbacks), then ``end_tick``."""
        obs = self.observatory
        with trace.span(metrics_mod.PERF_RECORD) as sp_perf:
            obs.residency.set(POOL_SNAPSHOT, "packer", self._packer.device_bytes())
            if self._arena is not None:
                obs.residency.set(POOL_ARENA, "snapshot", self._arena.device_bytes())
                if self._operand_arena is not None:
                    obs.residency.set(
                        POOL_ARENA, "operands", self._operand_arena.device_bytes()
                    )
                stats = self._arena.take_stats()
                obs.note_arena(stats)
                sp_perf.set_attrs(
                    arena_delta_rows=stats.get("delta_rows", 0),
                    arena_full_uploads=stats.get("full_uploads", 0),
                    arena_promotions=stats.get("promotions", 0),
                    arena_rollbacks=stats.get("rollbacks", 0),
                )
            obs.end_tick()

    def kernel_ladder(self):
        """The estimator's circuit-broken kernel ladder, when wired (the
        default orchestrator always wires one; a custom estimator may not)."""
        est = getattr(self.scale_up_orchestrator, "estimator", None)
        return getattr(est, "ladder", None)

    def degraded_rungs(self) -> List[str]:
        """Kernel rungs whose breaker is not closed. Nonempty = degraded
        mode: decisions still flow, on a lower (slower) rung — surfaced on
        /health-check, /status, and the status ConfigMap."""
        ladder = self.kernel_ladder()
        return ladder.degraded() if ladder is not None else []

    def _group_has_accelerator(self, group_id: Optional[str]) -> bool:
        if not group_id:
            return False
        for g in self.provider.node_groups():
            if g.id() == group_id:
                try:
                    tmpl = g.template_node_info()
                except Exception as e:
                    err = to_autoscaler_error(e)
                    self.metrics.errors_total.inc(type=err.error_type.value)
                    return False
                return tmpl.allocatable.gpu > 0 or tmpl.allocatable.tpu > 0
        return False

    def _split_pods(self, pods: Sequence[Pod]) -> Tuple[List[Pod], List[Pod]]:
        scheduled, pending = [], []
        for pod in pods:
            (scheduled if pod.node_name else pending).append(pod)
        return scheduled, pending

    def _inject_upcoming_nodes(
        self, snapshot: ClusterSnapshot, now_ts: float, pending_ds=lambda: ()
    ) -> List[str]:
        """Virtual nodes for capacity that was requested but hasn't
        registered (:484-519) so we don't double scale-up.

        Routed through the template provider so the virtual node carries the
        group's daemon overhead: an upcoming node boots its daemonsets, and
        crediting it with full allocatable would let filter-out-schedulable
        over-absorb pending pods, under-provisioning by one boot cycle per
        loop. The virtual allocatable IS the packing capacity; resource
        limits are unaffected (they count real provider nodes)."""
        injected: List[str] = []
        upcoming = self.csr.get_upcoming_nodes()
        groups = {g.id(): g for g in self.provider.node_groups()}
        tmpl_provider = self.processors.template_node_info_provider
        nodes_by_group: Dict[str, List[Node]] = {}
        if tmpl_provider is not None and upcoming:
            for node in snapshot.nodes():
                g = self.provider.node_group_for_node(node)
                if g is not None:
                    nodes_by_group.setdefault(g.id(), []).append(node)
        for gid, count in upcoming.items():
            group = groups.get(gid)
            if group is None:
                continue
            template = None
            if tmpl_provider is not None:
                template = tmpl_provider.template_for(
                    group, nodes_by_group.get(gid, []), now_ts,
                    pods_of_node=snapshot.pods_on_node,
                    pending_daemonsets=pending_ds(),
                )
            if template is None:
                try:
                    template = group.template_node_info()
                except Exception as e:
                    err = to_autoscaler_error(e)
                    self.metrics.errors_total.inc(type=err.error_type.value)
                    continue
            if template is None:
                continue
            cap = template.packing_capacity()
            for i in range(count):
                virtual = dataclasses.replace(
                    template,
                    name=f"upcoming-{gid}-{i}",
                    allocatable=cap,
                    daemon_overhead=Resources(),
                    taints=list(template.taints),
                    labels=dict(template.labels),
                )
                snapshot.add_node(virtual)
                injected.append(virtual.name)
        return injected

    def _scale_down_candidates(
        self, all_nodes: Sequence[Node], upcoming_names: Sequence[str]
    ) -> List[Node]:
        upcoming = set(upcoming_names)
        out = []
        for node in all_nodes:
            if node.name in upcoming:
                continue
            if self.scale_down_planner.deletion_tracker.is_being_deleted(node.name):
                continue
            out.append(node)
        return out

    def _scale_down_in_cooldown(self, now_ts: float) -> bool:
        """reference :628-640."""
        o = self.options
        if (
            self.last_scale_up_ts is not None
            and now_ts - self.last_scale_up_ts < o.scale_down_delay_after_add_s
        ):
            return True
        delay_after_delete = o.scale_down_delay_after_delete_s or o.scan_interval_s
        if (
            self.last_scale_down_delete_ts is not None
            and now_ts - self.last_scale_down_delete_ts < delay_after_delete
        ):
            return True
        if (
            self.last_scale_down_fail_ts is not None
            and now_ts - self.last_scale_down_fail_ts < o.scale_down_delay_after_failure_s
        ):
            return True
        return False

    def _remove_old_unregistered(self, now_ts: float) -> int:
        """Instances stuck creating past the provision timeout are deleted
        (:732). The registry tracks per-instance first-seen timestamps, so a
        freshly booting instance survives an autoscaler restart — only
        long-unregistered ones (past max_node_provision_time) are removed."""
        removed = 0
        groups = {g.id(): g for g in self.provider.node_groups()}
        for gid, instances in self.csr.long_unregistered_instances().items():
            group = groups.get(gid)
            if group is None:
                continue
            stuck = [Node(name=i.id, provider_id=i.id) for i in instances]
            try:
                group.delete_nodes(stuck)
                removed += len(stuck)
            except Exception as e:
                err = to_autoscaler_error(e)
                self.metrics.errors_total.inc(type=err.error_type.value)
        return removed

    def _delete_created_nodes_with_errors(self) -> None:
        """Instances that failed creation are deleted so the target shrinks
        and a different group can be tried (:773)."""
        errored = self.csr.instances_with_errors()
        groups = {g.id(): g for g in self.provider.node_groups()}
        for gid, instances in errored.items():
            group = groups.get(gid)
            if group is None:
                continue
            try:
                group.delete_nodes(
                    [Node(name=i.id, provider_id=i.id) for i in instances]
                )
            except Exception as e:
                err = to_autoscaler_error(e)
                self.metrics.errors_total.inc(type=err.error_type.value)
                try:
                    group.decrease_target_size(len(instances))
                except Exception as e2:
                    err2 = to_autoscaler_error(e2)
                    self.metrics.errors_total.inc(
                        type=err2.error_type.value
                    )
