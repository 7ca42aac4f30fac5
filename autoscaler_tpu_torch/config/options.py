"""Autoscaling configuration.

Reference: cluster-autoscaler/config/autoscaling_options.go:78 (the ~80-field
AutoscalingOptions struct every layer reads) and the flag defaults of
cluster-autoscaler/main.go:92-227. Field names are pythonized; defaults match
the reference's flag defaults. Per-node-group overrides mirror
NodeGroupAutoscalingOptions (autoscaling_options.go:37-66), resolved through
the NodeGroupConfigProcessor pattern (processors/nodegroupconfig/).

The port's copy of ``autoscaler_tpu/config/options.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from autoscaler_tpu_torch.fleet.buckets import (
    DEFAULT_ARENA_BUCKETS as _DEFAULT_ARENA_BUCKETS,
    DEFAULT_BUCKETS as _DEFAULT_FLEET_BUCKETS,
)


class OptionsError(ValueError):
    """An AutoscalingOptions override that doesn't describe a real knob:
    unknown field name, or a value whose type can't mean what the field
    means. Raised BEFORE construction so the offending key is named —
    loadgen --set and the gym PolicySpec seam both route through this."""


@dataclass
class NodeGroupAutoscalingOptions:
    """Per-node-group overridable knobs
    (reference: config/autoscaling_options.go:37-66)."""

    scale_down_utilization_threshold: float = 0.5
    scale_down_gpu_utilization_threshold: float = 0.5
    scale_down_unneeded_time_s: float = 600.0     # 10m
    scale_down_unready_time_s: float = 1200.0     # 20m
    max_node_provision_time_s: float = 900.0      # 15m


@dataclass
class NodeGroupDifferenceRatios:
    """Similarity tolerances for balancing similar node groups
    (reference: config/autoscaling_options.go:49-66 and
    processors/nodegroupset/compare_nodegroups.go:84,103)."""

    max_allocatable_difference_ratio: float = 0.05
    max_capacity_memory_difference_ratio: float = 0.015
    max_free_difference_ratio: float = 0.05


@dataclass
class AutoscalingOptions:
    # -- global node-group defaults -----------------------------------------
    node_group_defaults: NodeGroupAutoscalingOptions = field(
        default_factory=NodeGroupAutoscalingOptions
    )
    node_group_overrides: Dict[str, NodeGroupAutoscalingOptions] = field(
        default_factory=dict
    )

    # -- loop / process ------------------------------------------------------
    scan_interval_s: float = 10.0
    max_inactivity_s: float = 600.0               # health-check auto-restart
    max_failing_time_s: float = 900.0
    # crash-only loop: run_loop catches per-iteration exceptions and keeps
    # going; after this many CONSECUTIVE run_once failures it hard-exits
    # (abnormally, so a supervisor restarts the process). 0 = never — the
    # HealthCheck max_failing_time deadline remains the restart authority.
    max_consecutive_run_once_failures: int = 0
    # watchdog soft deadline for one run_once tick: exceeded → all-thread
    # stack dump via utils/pprof (evidence before the liveness probe kills
    # a wedged process). 0 = auto: max(4 x scan_interval, 60s).
    run_once_soft_deadline_s: float = 0.0
    # default deadline for sidecar RPCs that don't carry their own timeout
    # (rpc/service.TpuSimulationClient): a wedged sidecar must fail the
    # call, not hang run_once forever
    rpc_default_deadline_s: float = 30.0
    # estimator kernel-ladder circuit breakers (utils/circuit.py wrapped
    # around each rung — Pallas / XLA scan / native FFD / python oracle):
    # consecutive failures to trip a rung OPEN, and the cooldown before a
    # half-open probe re-tests it
    kernel_breaker_failure_threshold: int = 3
    kernel_breaker_cooldown_s: float = 120.0

    # -- tick tracing (autoscaler_tpu/trace) ---------------------------------
    # gates /tracez, like debugging_snapshot_enabled gates /snapshotz; the
    # tracer itself always runs (bounded memory, negligible overhead) so
    # the flight recorder has history the moment the endpoint is enabled
    tracing_enabled: bool = True
    # flight recorder: how many recent tick traces the in-memory ring keeps
    trace_ring_size: int = 64
    # always-on slow-tick dump: a tick whose WALL time exceeds this gets its
    # full span tree logged and the trace pinned in the ring (survives ring
    # eviction). 0 disables.
    trace_slow_tick_threshold_s: float = 2.0
    # when set, each tick captures a jax profiler session into
    # <dir>/tick_<id> — device timeline keyed by the same tick id as the
    # host trace (--jax-profiler-dir; debug tool, off by default)
    jax_profiler_dir: str = ""

    # -- perf observatory (autoscaler_tpu/perf) ------------------------------
    # gates /perfz, like tracing_enabled gates /tracez; the observatory
    # itself always runs (bounded ring, negligible overhead) so the ring
    # has history the moment the endpoint is enabled
    perf_enabled: bool = True
    # capture the XLA cost model (lowered.compile().cost_analysis() /
    # memory_analysis()) per new (kernel route, shape signature): one extra
    # AOT lower+compile per new signature, process-cached. Loadgen turns
    # this on (replayable — cost figures are pure functions of shapes).
    perf_cost_model: bool = False
    # how many recent per-tick perf records the in-memory ring keeps
    perf_ring_size: int = 64

    # -- decision provenance (autoscaler_tpu/explain) -------------------------
    # gates /explainz, like perf_enabled gates /perfz; the explainer itself
    # always assembles records (bounded ring, negligible overhead) so the
    # ring has history the moment the endpoint is enabled
    explain_enabled: bool = True
    # how many recent per-tick decision records the in-memory ring keeps
    explain_ring_size: int = 64

    # -- flight journal (autoscaler_tpu/journal) -----------------------------
    # gates /journalz, like explain_enabled gates /explainz; the recorder
    # itself always runs (bounded ring of keyframe+delta state records,
    # negligible overhead) so time-travel history exists the moment the
    # endpoint is enabled
    journal_enabled: bool = True
    # how many recent per-tick state records the in-memory ring keeps
    journal_ring_size: int = 64
    # write a full keyframe every K ticks even without a packer reseed or
    # shape change: bounds how many deltas a reconstruction replays and how
    # much history a ring eviction can strand behind a lost keyframe
    journal_keyframe_interval: int = 16
    # every N ticks, reconstruct the newest journaled tick and bit-compare
    # it (plus its fit-kernel verdicts) against the live packer state —
    # drift becomes a metric + trace event instead of a silently wrong
    # forensic answer. 0 disables the probe.
    journal_probe_interval: int = 0
    # append the journal (the same strict record_line bytes as the ring) to
    # this JSONL file for post-mortem reconstruct/diff/replay ("" = off)
    journal_path: str = ""

    # -- resident device arena (autoscaler_tpu/snapshot/arena) ---------------
    # keep the packed snapshot tensors device-resident across ticks and ship
    # only delta scatters for dirtied rows (ROADMAP item 2); off = the cold
    # per-field re-upload path
    arena_enabled: bool = False
    # comma-separated PxNxR power-of-two prewarm buckets for the arena's
    # apply-kernel ladder (same grammar as the fleet buckets; R is a cap).
    # The default ladder lives with fleet/buckets.py — ONE source.
    arena_buckets: str = _DEFAULT_ARENA_BUCKETS
    # persistent XLA compilation cache directory ("" = disabled): together
    # with the arena prewarm this makes the first real tick compile-free
    # across process restarts (ROADMAP item 5); main.py applies it before
    # backend init, deploy/ mounts a volume for it
    compile_cache_dir: str = ""

    # -- preemption engine (autoscaler_tpu/preempt) --------------------------
    # run the priority-aware eviction-packing pass each tick (ops/preempt.py
    # via the estimator ladder): pending pods that fit the EXISTING cluster
    # only by displacing strictly-lower-priority residents get planned
    # evictions, ledgered with provenance (preempted_by). Off = today's
    # decisions, byte for byte (hack/verify.sh preemption gate).
    preemption_enabled: bool = False
    # expander churn penalty: each eviction a scale-up option leaves
    # standing (its evictor not covered by the option's pods) costs this
    # much score. 0 = churn-blind ranking (the filter disengages entirely);
    # tuned by the gym's preemption suite under storm load.
    preemption_churn_weight: float = 0.0

    # -- fleet serving (autoscaler_tpu/fleet) --------------------------------
    # how long the coalescer waits after the first queued request before
    # dispatching the batch — the latency/coalescing trade (ms because the
    # useful range is single-digit milliseconds)
    fleet_coalesce_window_ms: float = 5.0
    # comma-separated PxGxR power-of-two shape buckets requests pad into;
    # the closed compile-cache key set of the service. The default ladder
    # lives with the safety argument in fleet/buckets.py — ONE source.
    fleet_shape_buckets: str = _DEFAULT_FLEET_BUCKETS
    # compile every configured bucket at startup so the first real request
    # never compiles (ladder-rung pre-warm, ROADMAP item 5)
    fleet_prewarm: bool = True
    # scenario slots per coalesced batch (the kernel's leading S axis);
    # overflow chunks into further batches in the same window
    fleet_batch_scenarios: int = 8
    # tenant-label cardinality bound on the per-tenant fleet SLI series
    # (fleet_queue_wait/service/e2e_seconds, fleet_requests_total): the
    # first N distinct tenants keep their own label, later arrivals
    # aggregate into "__overflow__" so a misbehaving fleet cannot explode
    # /metrics exposition. 0 = unbounded (trusted closed fleets only).
    fleet_max_tenant_labels: int = 64
    # -- fleet overload armor (fleet/admission.py) ---------------------------
    # admission bound on the coalescing queue: submits past this depth are
    # shed typed (FleetOverloadError → RESOURCE_EXHAUSTED + retry-after)
    # instead of queueing unboundedly. 0 = unbounded (the pre-armor
    # behavior; trusted closed fleets only).
    fleet_max_queue_depth: int = 0
    # per-tenant token-bucket quota: sustained requests/second each tenant
    # may submit (0 = no quotas) and the bucket's burst capacity (0 =
    # max(qps, 1)). Over-quota submits shed typed with the seconds-until-
    # next-token as the retry-after hint.
    fleet_tenant_qps: float = 0.0
    fleet_tenant_burst: float = 0.0
    # tenant quota tiers (fleet/tiers.py), JSON: tier name → {qps, burst,
    # queue_share, default_deadline_s, shed_priority, tenants}; must
    # include a "default" catch-all tier. Supersedes the global
    # fleet_tenant_qps with per-TIER budgets, queue-share slices, tier
    # default deadlines, and tier-priority flush/shed ordering. "" = off.
    fleet_tenant_tiers: str = ""
    # sidecar drain: how long server.stop() waits for in-flight RPCs after
    # the drain sequence stopped admission and flushed the coalescer
    # (SIGTERM → UNAVAILABLE+drain detail → flush → stop(grace))
    fleet_drain_grace_s: float = 5.0
    # client failover (rpc/service.TpuSimulationClient): the sidecar
    # endpoint list (--rpc-address, repeatable). More than one endpoint
    # arms failover — the client advances on UNAVAILABLE/drain with
    # jittered bounded backoff, budgeted inside the caller's deadline.
    rpc_addresses: List[str] = field(default_factory=list)
    # client hedging: hedge idempotent Estimate/BatchEstimate against the
    # next endpoint when the primary hasn't answered after a p99-derived
    # delay (first answer wins, loser cancelled; never past the caller's
    # deadline). Off by default — hedging doubles worst-case load.
    rpc_hedge: bool = False

    # -- SLO engine (autoscaler_tpu/slo) -------------------------------------
    # gates /sloz, like perf_enabled gates /perfz; the engine itself always
    # runs (bounded ring, negligible overhead) so burn-rate history exists
    # the moment the endpoint is enabled. The window-record ring shares
    # explain_ring_size (the SLO windows are computed per tick, the same
    # cadence as the decision records the pending-pod SLI reads).
    slo_enabled: bool = True

    # -- policy gym (autoscaler_tpu/gym) -------------------------------------
    # concurrent candidate rollouts per tuning stage: the population axis
    # of the gym tuner. Rollouts share one fleet coalescer, so estimator
    # calls from parallel rollouts batch into shared mesh dispatches
    # (Podracer-style: the population rides the scenario axis).
    gym_rollout_workers: int = 4
    # objective weights for the scorer's deterministic scalar, as
    # "slo=1,cost=6,churn=0.5" ("" = the scorer's defaults). One number:
    # the gym's reward and the human-facing report read the same section.
    gym_objective_weights: str = ""
    # route gym rollout estimator dispatches through the shared fleet
    # coalescer (off = every rollout pays its own solo dispatches; the
    # score is certified identical either way)
    gym_fleet_coalesce: bool = True

    # -- cluster-wide resource limits (main.go:113-118) ----------------------
    max_nodes_total: int = 0                      # 0 = unlimited
    min_cores_total: float = 0.0
    max_cores_total: float = 320_000.0 * 1000     # millicores
    min_memory_total: float = 0.0
    max_memory_total_mib: float = 6_400_000.0 * 1024
    gpu_total: Dict[str, tuple] = field(default_factory=dict)  # name -> (min,max)

    # -- scale-up ------------------------------------------------------------
    estimator: str = "binpacking"
    expander: str = "random"                      # reference default (main.go:145)
    # priority-expander tiers: static dict, and/or a hot-reloaded config file
    # (the reference's live ConfigMap, expander/priority/priority.go)
    expander_priorities: Dict[int, List[str]] = field(default_factory=dict)
    priority_config_file: str = ""
    # name of the live priority ConfigMap in config_namespace ("" = off);
    # the reference's default is cluster-autoscaler-priority-expander
    priority_config_map: str = ""
    # external gRPC expander target (reference --grpc-expander-url) for the
    # "grpc" entry of the expander chain
    grpc_expander_url: str = ""
    # seed for the expander chain's random fallback (tie-breaks and the
    # "random" strategy). None = entropy, the reference behavior; scenario
    # replay (loadgen) pins it so the same world makes the same choice.
    expander_random_seed: Optional[int] = None
    max_nodes_per_scaleup: int = 1000             # main.go:215
    max_nodegroup_binpacking_duration_s: float = 10.0  # main.go:216
    node_info_cache_expire_time_s: float = 60.0  # template NodeInfo TTL
    # --force-ds: charge suitable pending DaemonSets onto new-node capacity
    force_daemonsets: bool = False
    debugging_snapshot_enabled: bool = True      # serve /snapshotz
    balance_similar_node_groups: bool = False
    balancing_label_keys: List[str] = field(default_factory=list)
    node_group_difference_ratios: NodeGroupDifferenceRatios = field(
        default_factory=NodeGroupDifferenceRatios
    )
    scale_up_from_zero: bool = True
    enforce_node_group_min_size: bool = False
    max_node_provision_time_s: float = 900.0
    new_pod_scale_up_delay_s: float = 0.0         # young-pod filter (main.go:204)
    expendable_pods_priority_cutoff: int = -10

    # -- cluster health (clusterstate gates) ---------------------------------
    max_total_unready_percentage: float = 45.0    # main.go:148
    ok_total_unready_count: int = 3               # main.go:149

    # -- per-nodegroup backoff (utils/backoff/exponential_backoff.go) --------
    initial_node_group_backoff_duration_s: float = 300.0   # 5m
    max_node_group_backoff_duration_s: float = 1800.0      # 30m
    node_group_backoff_reset_timeout_s: float = 10800.0    # 3h

    # -- scale-down ----------------------------------------------------------
    scale_down_enabled: bool = True
    scale_down_delay_after_add_s: float = 600.0   # 10m
    scale_down_delay_after_delete_s: float = 0.0  # defaults to scan interval
    scale_down_delay_after_failure_s: float = 180.0  # 3m
    scale_down_unneeded_time_s: float = 600.0
    scale_down_unready_time_s: float = 1200.0
    scale_down_utilization_threshold: float = 0.5
    scale_down_non_empty_candidates_count: int = 30   # main.go:119
    scale_down_candidates_pool_ratio: float = 0.1     # main.go:124
    scale_down_candidates_pool_min_count: int = 50    # main.go:129
    scale_down_simulation_timeout_s: float = 30.0
    max_scale_down_parallelism: int = 10
    max_drain_parallelism: int = 1
    max_empty_bulk_delete: int = 10
    max_graceful_termination_s: float = 600.0
    # eviction pacing (reference actuation/drain.go constants: EvictionRetryTime,
    # MaxPodEvictionTime, PodEvictionHeadroom)
    eviction_retry_time_s: float = 10.0
    max_pod_eviction_time_s: float = 120.0
    pod_eviction_headroom_s: float = 30.0
    max_bulk_soft_taint_count: int = 10
    max_bulk_soft_taint_time_s: float = 3.0
    unremovable_node_recheck_timeout_s: float = 300.0
    node_deletion_batcher_interval_s: float = 0.0
    skip_nodes_with_system_pods: bool = True
    skip_nodes_with_local_storage: bool = True
    skip_nodes_with_custom_controller_pods: bool = True
    min_replica_count: int = 0
    # unready nodes may be scale-down candidates (ScaleDownUnreadyEnabled,
    # --scale-down-unready-enabled, default true)
    scale_down_unready_enabled: bool = True
    # pacing between tainting a node and deleting it
    # (NodeDeleteDelayAfterTaint). DIVERGENCE: the reference defaults this
    # to 5s *inside its async deletion goroutine* (actuator.go:234); this
    # framework's actuation wave is synchronous by design (the loop joins
    # it), so a nonzero delay extends the control loop directly — default
    # off, opt in if your scheduler lags taint observation. The pause is
    # paid inside the per-node workers, so drain waves overlap it with
    # eviction work. (The reference's NodeDeletionDelayTimeout is not
    # modeled: deletion confirmation here is the synchronous batcher
    # result, not a polled wait.)
    node_delete_delay_after_taint_s: float = 0.0

    # -- misc ---------------------------------------------------------------
    cloud_provider: str = "test"
    cluster_name: str = ""                        # --cluster-name (status header)
    # HTTP User-Agent; consumed by KubeRestClient — deploy sites pass it when
    # constructing their client (no CLI flag: main.py's test provider makes
    # no API calls)
    user_agent: str = "tpu-autoscaler"
    config_namespace: str = "kube-system"         # --namespace
    status_config_map_name: str = "cluster-autoscaler-status"
    write_status_configmap: bool = True
    # startup/ignored taints stripped from templates before comparison and
    # simulation (--ignore-taint; taints.go ignored-taints handling)
    ignored_taints: List[str] = field(default_factory=list)
    # extra labels excluded from node-group similarity comparison, on top of
    # the built-in ignore list (--balancing-ignore-label)
    balancing_extra_ignored_labels: List[str] = field(default_factory=list)
    # node-group auto-discovery specs, parsed by the cloud provider
    # (--node-group-auto-discovery, e.g. "label:k1=v1,k2=v2" or provider
    # MIG/ASG prefix specs)
    node_group_auto_discovery: List[str] = field(default_factory=list)
    # per-nodegroup gauges are opt-in for cardinality, like the reference's
    # --record-node-group-metrics flag (main.go:201)
    record_per_node_group_metrics: bool = False
    node_autoprovisioning_enabled: bool = False
    max_autoprovisioned_node_group_count: int = 15
    cordon_node_before_terminating: bool = False
    ignore_daemonsets_utilization: bool = False
    ignore_mirror_pods_utilization: bool = False
    # DaemonSet pods are gracefully evicted (best-effort, never PDB-simulated
    # — the eviction API enforces PDBs server-side) from nodes being removed.
    # Defaults mirror the reference flags (main.go:198-199): opt-in for empty
    # nodes, on for drained ones.
    daemonset_eviction_for_empty_nodes: bool = False
    daemonset_eviction_for_occupied_nodes: bool = True

    def group_options(self, group_name: str) -> NodeGroupAutoscalingOptions:
        """Resolve per-group options with fallback to defaults (the
        NodeGroupConfigProcessor / NodeGroup.GetOptions path,
        reference cloud_provider.go:230)."""
        return self.node_group_overrides.get(group_name, self.node_group_defaults)


@functools.lru_cache(maxsize=1)
def _field_types() -> Dict[str, Any]:
    """Resolved (PEP 563) annotation per AutoscalingOptions field."""
    hints = typing.get_type_hints(AutoscalingOptions)
    return {f.name: hints[f.name] for f in dataclasses.fields(AutoscalingOptions)}


def _type_ok(expected: Any, value: Any) -> bool:
    """Conservative runtime check of one override value against a field
    annotation. bool is NOT an int/float here (JSON true leaking into a
    numeric knob is exactly the silent corruption this exists to catch);
    ints promote to float fields, matching what JSON round-trips produce."""
    origin = typing.get_origin(expected)
    if origin is typing.Union:  # Optional[X] and friends
        return any(_type_ok(arg, value) for arg in typing.get_args(expected))
    if expected is type(None):
        return value is None
    if origin in (dict, Dict):
        return isinstance(value, dict)
    if origin in (list, List):
        return isinstance(value, list)
    if origin in (tuple,):
        return isinstance(value, (list, tuple))
    if expected is bool:
        return isinstance(value, bool)
    if expected is int:
        return isinstance(value, int) and not isinstance(value, bool)
    if expected is float:
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if expected is str:
        return isinstance(value, str)
    if isinstance(expected, type):
        return isinstance(value, expected)
    return True  # unparameterized/exotic annotation: don't guess


def validate_overrides(overrides: Dict[str, Any]) -> None:
    """Validate a {field name → value} override set against the
    AutoscalingOptions schema BEFORE construction. An unknown key or a
    type-mismatched value raises :class:`OptionsError` naming the offending
    key — dataclasses accept any value silently, so without this gate a
    typo'd ``--set scale_down_unneded_time_s=0`` or a string where a float
    belongs would corrupt a run instead of exiting 2."""
    fields = _field_types()
    for key in sorted(overrides):
        if key not in fields:
            known = ", ".join(sorted(fields)[:6])
            raise OptionsError(
                f"unknown AutoscalingOptions key {key!r} "
                f"(fields are e.g. {known}, ...)"
            )
        expected = fields[key]
        value = overrides[key]
        if not _type_ok(expected, value):
            raise OptionsError(
                f"AutoscalingOptions key {key!r} wants "
                f"{_render_type(expected)}, got "
                f"{type(value).__name__} ({value!r})"
            )


def _render_type(expected: Any) -> str:
    origin = typing.get_origin(expected)
    if origin is typing.Union:
        return " | ".join(_render_type(a) for a in typing.get_args(expected))
    if origin is not None:
        return getattr(origin, "__name__", str(origin))
    return getattr(expected, "__name__", str(expected))
