"""Metrics registry: counters, gauges, duration summaries, Prometheus text
exposition — dependency-free.

Reference: cluster-autoscaler/metrics/metrics.go — ~40 series :112-358, the
FunctionLabel step taxonomy :42,94-107, UpdateDurationFromStart :399 wrapping
every RunOnce phase, RegisterAll :361. Series names keep the reference's
`cluster_autoscaler_` prefix so dashboards port over.

The port's copy of ``autoscaler_tpu/metrics/metrics.py``.
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

# FunctionLabel taxonomy (metrics.go:94-107). These double as SPAN NAMES in
# autoscaler_tpu/trace: one vocabulary for metrics and traces, and span
# durations feed function_duration_seconds through observe_duration_value,
# so the two surfaces can never disagree on what a phase is called.
MAIN = "main"
POLL = "poll"
RECONFIGURE = "reconfigure"
AUTOSCALING = "autoscaling"
SCALE_UP = "scaleUp"
SCALE_DOWN = "scaleDown"
FIND_UNNEEDED = "findUnneeded"
UPDATE_STATE = "updateClusterState"
FILTER_OUT_SCHEDULABLE = "filterOutSchedulable"
SNAPSHOT_BUILD = "buildSnapshot"
DEVICE_DISPATCH = "deviceDispatch"  # TPU-specific: kernel round trips
ESTIMATE = "estimate"  # batched binpacking dispatch (threshold_based_limiter envelope)
KUBE_REQUEST = "kubeRequest"  # one control-plane HTTP request (incl. retries)
RPC_CALL = "rpcCall"  # one sidecar RPC (incl. the single reconnect-resend)
PERF_RECORD = "perfRecord"  # per-tick perf-ledger assembly (autoscaler_tpu/perf)
EXPLAIN_RECORD = "explainRecord"  # per-tick decision-record assembly (autoscaler_tpu/explain)
JOURNAL_RECORD = "journalRecord"  # per-tick state-journal assembly (autoscaler_tpu/journal)
FLEET_DISPATCH = "fleetDispatch"  # one coalesced multi-tenant batch dispatch (autoscaler_tpu/fleet)
FLEET_SUBMIT = "fleetSubmit"  # one tenant's admission into the coalescing queue (per-ticket origin span)
FLEET_PREWARM = "fleetPrewarm"  # startup bucket pre-warm sweep (autoscaler_tpu/fleet)
RPC_SERVE = "rpcServe"  # sidecar-side serving span per RPC; adopts the caller's trace context (rpc/service)
SLO_WINDOW = "sloWindow"  # per-tick SLO burn-rate window computation (autoscaler_tpu/slo)
PREEMPT_PLAN = "preemptPlan"  # per-tick eviction-packing pass (autoscaler_tpu/preempt)
GYM_ROLLOUT = "gymRollout"  # one policy-gym candidate episode (autoscaler_tpu/gym)
GYM_GENERATION = "gymGeneration"  # one tuner generation: sample + evaluate + prune (autoscaler_tpu/gym)

# function_duration_seconds bucket ladder. The reference's histogram starts
# at 0.01s (metrics.go:209-218) — every sub-millisecond device dispatch
# piles into the bottom bucket. Extended DOWN to 1e-4 s so warm kernel
# dispatches (tens to hundreds of microseconds) resolve; pinned by
# tests (a silent ladder change would corrupt dashboard history).
DURATION_BUCKETS = (
    1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


class _Series:
    """``_lock`` serializes label-key insertion against the /metrics
    renderer: the exposition runs on HTTP server threads while the control
    loop observes, and the first observation of a new label key resizes
    the dict a concurrent ``expose()`` would be iterating."""

    def __init__(self, name: str, help_: str, kind: str):
        self.name = name
        self.help = help_
        self.kind = kind
        self.values: Dict[Tuple[Tuple[str, str], ...], float] = defaultdict(float)
        self._lock = threading.Lock()

    def _key(self, labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted((labels or {}).items()))


class Counter(_Series):
    def inc(self, value: float = 1.0, **labels: str) -> None:
        with self._lock:
            self.values[self._key(labels)] += value

    def get(self, **labels: str) -> float:
        return self.values.get(self._key(labels), 0.0)


class Gauge(_Series):
    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self.values[self._key(labels)] = value

    def get(self, **labels: str) -> float:
        return self.values.get(self._key(labels), 0.0)


# sliding-window size for summary quantiles
WINDOW = 512


@dataclass
class _SummaryState:
    count: int = 0
    total: float = 0.0
    maximum: float = 0.0
    # deque(maxlen=...): O(1) eviction once the window fills — the previous
    # list + pop(0) was O(n) per observe at steady state
    recent: "deque[float]" = field(
        default_factory=lambda: deque(maxlen=WINDOW)
    )


def _quantile_of(sorted_data: List[float], q: float) -> float:
    if not sorted_data:
        return 0.0
    idx = min(int(q * len(sorted_data)), len(sorted_data) - 1)
    return sorted_data[idx]


class Summary(_Series):
    """Duration summary with approximate quantiles over a sliding window.

    The series lock additionally covers the window deque: the control loop
    observes while HTTP server threads render /metrics, and iterating a
    deque mid-append raises ``deque mutated during iteration`` (the old
    list + pop(0) merely returned a torn read)."""

    WINDOW = WINDOW

    def __init__(self, name: str, help_: str):
        super().__init__(name, help_, "summary")
        self.states: Dict[Tuple[Tuple[str, str], ...], _SummaryState] = defaultdict(
            _SummaryState
        )

    def _observe_locked(self, key, value: float) -> _SummaryState:
        """The one observation bookkeeping path (caller holds the lock):
        Histogram layers its bucket counters on top of exactly this, so a
        change to the window/max/total semantics reaches both kinds."""
        s = self.states[key]
        s.count += 1
        s.total += value
        s.maximum = max(s.maximum, value)
        s.recent.append(value)  # maxlen evicts the oldest
        return s

    def observe(self, value: float, **labels: str) -> None:
        with self._lock:
            self._observe_locked(self._key(labels), value)

    def quantile(self, q: float, **labels: str) -> float:
        with self._lock:
            s = self.states.get(self._key(labels))
            if not s or not s.recent:
                return 0.0
            data = sorted(s.recent)
        return _quantile_of(data, q)

    def snapshot(self) -> List[Tuple[Tuple[Tuple[str, str], ...], int, float, List[float]]]:
        """(label key, count, total, sorted window) rows — one consistent
        read for renderers, taken under the series lock."""
        with self._lock:
            return [
                (key, s.count, s.total, sorted(s.recent))
                for key, s in self.states.items()
            ]

    def count(self, **labels: str) -> int:
        s = self.states.get(self._key(labels))
        return s.count if s else 0


class Histogram(Summary):
    """A Summary that ALSO exposes a Prometheus histogram: cumulative
    ``_bucket{le=...}`` counters over a fixed bucket ladder, plus the
    Summary's window quantiles for Python-side consumers (the scorer's
    p50/p99 columns read ``quantile()``/``states`` and must keep working).

    Bucket counts are lifetime cumulative (never windowed) — the one
    pathological observation a long run exists to surface must survive
    window eviction, same rationale as ``_SummaryState.maximum``."""

    def __init__(
        self,
        name: str,
        help_: str,
        buckets: Tuple[float, ...] = DURATION_BUCKETS,
    ):
        super().__init__(name, help_)
        self.kind = "histogram"
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self._bucket_counts: Dict[Tuple[Tuple[str, str], ...], List[int]] = {}
        # OpenMetrics exemplars: per (label key, bucket index) the LAST
        # exemplified observation — (trace_id, value). Bucket index -1 is
        # the +Inf bucket. Rendered by expose() as
        # `..._bucket{le="x"} N # {trace_id="t"} v` so a tail latency in
        # /metrics links straight to its tick trace in the flight recorder.
        self._exemplars: Dict[
            Tuple[Tuple[Tuple[str, str], ...], int], Tuple[str, float]
        ] = {}

    def _observe_bucketed_locked(self, key, value: float) -> int:
        """Shared bucket bookkeeping (caller holds the lock); returns the
        index of the smallest bucket admitting the value (-1 = +Inf)."""
        self._observe_locked(key, value)
        counts = self._bucket_counts.get(key)
        if counts is None:
            counts = self._bucket_counts[key] = [0] * len(self.buckets)
        # cumulative le-semantics: one observation ticks EVERY bucket
        # whose upper bound admits it (bisect, then suffix increment)
        first = bisect.bisect_left(self.buckets, value)
        for i in range(first, len(counts)):
            counts[i] += 1
        return first if first < len(self.buckets) else -1

    def observe(self, value: float, **labels: str) -> None:
        with self._lock:
            self._observe_bucketed_locked(self._key(labels), value)

    def observe_with_exemplar(
        self, value: float, trace_id: str, **labels: str
    ) -> None:
        """Observe and seat an exemplar on the admitting bucket: the
        observation's trace id rides the exposition so an operator can jump
        from a tail bucket to the exact request's span tree."""
        with self._lock:
            key = self._key(labels)
            idx = self._observe_bucketed_locked(key, value)
            self._exemplars[(key, idx)] = (str(trace_id), float(value))

    def exemplar(self, bucket_index: int, **labels: str):
        """(trace_id, value) seated on one bucket (-1 = +Inf), or None."""
        with self._lock:
            return self._exemplars.get((self._key(labels), bucket_index))

    def bucket_counts(self, **labels: str) -> List[int]:
        with self._lock:
            return list(self._bucket_counts.get(self._key(labels), ()))

    def bucket_rows(
        self,
    ) -> List[Tuple[Tuple[Tuple[str, str], ...], List[int], int, float]]:
        """(label key, cumulative bucket counts, count, sum) rows — one
        consistent read for the exposition renderer, under the series
        lock."""
        with self._lock:
            return [
                (
                    key,
                    list(self._bucket_counts.get(key, [0] * len(self.buckets))),
                    s.count,
                    s.total,
                )
                for key, s in self.states.items()
            ]

    def exemplar_rows(
        self,
    ) -> Dict[Tuple[Tuple[Tuple[str, str], ...], int], Tuple[str, float]]:
        """Snapshot of the seated exemplars, for the exposition renderer."""
        with self._lock:
            return dict(self._exemplars)


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Series] = {}

    def counter(self, name: str, help_: str = "") -> Counter:
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = Counter(name, help_, "counter")
            return self._metrics[name]  # type: ignore[return-value]

    def gauge(self, name: str, help_: str = "") -> Gauge:
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = Gauge(name, help_, "gauge")
            return self._metrics[name]  # type: ignore[return-value]

    def summary(self, name: str, help_: str = "") -> Summary:
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = Summary(name, help_)
            return self._metrics[name]  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        help_: str = "",
        buckets: Tuple[float, ...] = DURATION_BUCKETS,
    ) -> Histogram:
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = Histogram(name, help_, buckets)
            return self._metrics[name]  # type: ignore[return-value]

    def expose(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition format. Each series is snapshotted
        under its own lock before rendering — a concurrent first-observation
        of a new label key must not resize a dict mid-iteration.

        ``openmetrics`` renders the OpenMetrics dialect: exemplar suffixes
        on histogram buckets (`# {trace_id="..."} v`) plus the mandatory
        `# EOF` terminator. Exemplars are ONLY legal there — the classic
        0.0.4 text parser treats the first ``#`` after a sample value as a
        parse error, so the default exposition must stay exemplar-free or
        one exemplified observation would take down every scrape."""
        lines: List[str] = []
        with self._lock:
            series = list(self._metrics.values())
        for m in series:
            family = m.name
            sample_name = m.name
            if openmetrics and m.kind == "counter":
                # OpenMetrics counter naming: samples are `<family>_total`,
                # and the TYPE/HELP lines name the FAMILY. Our registry
                # names counters by their sample name (`..._total`), so the
                # family is the name with the suffix stripped; the few
                # counters not ending in `_total` keep their name as the
                # family and gain the suffix on the sample — either way a
                # strict OM parser (Prometheus's openmetrics textparse)
                # accepts the scrape instead of rejecting every metric.
                if family.endswith("_total"):
                    family = family[: -len("_total")]
                else:
                    sample_name = family + "_total"
            lines.append(f"# HELP {family} {m.help}")
            lines.append(f"# TYPE {family} {m.kind if m.kind != 'summary' else 'summary'}")
            if isinstance(m, Histogram):
                # Prometheus histogram exposition: cumulative le-buckets
                # (incl. the mandatory +Inf == _count), then sum and count.
                # Buckets with a seated exemplar append the OpenMetrics
                # `# {trace_id="..."} value` suffix — tail observations
                # link to their tick trace in the flight recorder.
                exemplars = m.exemplar_rows() if openmetrics else {}
                for key, counts, count, total in m.bucket_rows():
                    base = dict(key)
                    for i, (bound, c) in enumerate(zip(m.buckets, counts)):
                        bl = _fmt_labels({**base, "le": f"{bound:g}"})
                        lines.append(
                            f"{m.name}_bucket{bl} {c}"
                            + _fmt_exemplar(exemplars.get((key, i)))
                        )
                    inf = _fmt_labels({**base, "le": "+Inf"})
                    lines.append(
                        f"{m.name}_bucket{inf} {count}"
                        + _fmt_exemplar(exemplars.get((key, -1)))
                    )
                    lbl = _fmt_labels(base)
                    lines.append(f"{m.name}_sum{lbl} {total:.9g}")
                    lines.append(f"{m.name}_count{lbl} {count}")
            elif isinstance(m, Summary):
                for key, count, total, data in m.snapshot():
                    lbl = _fmt_labels(dict(key))
                    lines.append(f"{m.name}_count{lbl} {count}")
                    lines.append(f"{m.name}_sum{lbl} {total:.9g}")
                    for q in (0.5, 0.9, 0.99):
                        ql = _fmt_labels({**dict(key), "quantile": str(q)})
                        lines.append(f"{m.name}{ql} {_quantile_of(data, q):.9g}")
            else:
                with m._lock:
                    items = list(m.values.items())
                for key, v in items:
                    lines.append(
                        f"{sample_name}{_fmt_labels(dict(key))} {v:.9g}"
                    )
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


def _escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double-quote
    and newline must be escaped or the exposition line is corrupted (a pod
    name with a quote would truncate the label set mid-line)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_exemplar(ex: Optional[Tuple[str, float]]) -> str:
    """OpenMetrics exemplar suffix for one bucket line ("" when none)."""
    if ex is None:
        return ""
    trace_id, value = ex
    return f' # {{trace_id="{_escape_label_value(trace_id)}"}} {value:.9g}'


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class AutoscalerMetrics:
    """The reference's series set (metrics.go:112-358), wired for RunOnce."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        r = registry or MetricsRegistry()
        self.registry = r
        p = "cluster_autoscaler_"
        self.errors_total = r.counter(p + "errors_total", "autoscaler errors")
        self.scaled_up_nodes_total = r.counter(
            p + "scaled_up_nodes_total", "nodes added"
        )
        self.scaled_down_nodes_total = r.counter(
            p + "scaled_down_nodes_total", "nodes removed"
        )
        self.evicted_pods_total = r.counter(p + "evicted_pods_total", "pods evicted")
        self.failed_scale_ups_total = r.counter(
            p + "failed_scale_ups_total", "failed scale-ups"
        )
        self.unschedulable_pods_count = r.gauge(
            p + "unschedulable_pods_count", "pending pods"
        )
        self.nodes_count = r.gauge(p + "nodes_count", "nodes by state")
        self.unneeded_nodes_count = r.gauge(
            p + "unneeded_nodes_count", "scale-down candidates"
        )
        self.node_groups_count = r.gauge(p + "node_groups_count", "node groups")
        self.cluster_safe_to_autoscale = r.gauge(
            p + "cluster_safe_to_autoscale", "health gate"
        )
        self.last_activity = r.gauge(p + "last_activity", "ts of last loop by activity")
        # histogram (bucket ladder down to 1e-4 s — sub-millisecond device
        # dispatches resolve instead of piling into the bottom bucket) that
        # still answers the Summary quantile API for Python-side consumers
        self.function_duration = r.histogram(
            p + "function_duration_seconds", "per-step durations"
        )
        # the reference registers the durations twice — a histogram and a
        # quantile summary (metrics.go:209-226); both names exist here so
        # dashboards keyed on either port over
        self.function_duration_quantile = r.summary(
            p + "function_duration_quantile_seconds",
            "per-step duration quantiles",
        )
        self.device_dispatches_total = r.counter(
            p + "device_dispatches_total", "TPU kernel dispatches"
        )
        # Which kernel served each estimator dispatch and, when the VMEM
        # fast path was NOT taken, why (r4 verdict weak #6: a workload past
        # the VMEM byte-model gate silently rode the ~50x-slower XLA scan;
        # the cliff must be observable). labels: route=pallas_affinity|
        # pallas|xla_scan|xla_runs|xla_single|native|python_ref,
        # reason=ok|vmem|spread_width|not_tpu|kernel_fault|device_lost|
        # breaker_open|dedup|single_template (the last from the
        # single-template estimate() entry point). native/python_ref routes
        # mean the degradation ladder descended past the device rungs.
        self.estimator_kernel_route_total = r.counter(
            p + "estimator_kernel_route_total",
            "estimator dispatches by kernel route and fallback reason",
        )
        # -- degradation-ladder observability (utils/circuit + estimator/
        # ladder): which rung each dispatch engaged and how it resolved
        # (outcome=ok|fault|unavailable|skipped), the breaker state per rung
        # (0 closed, 1 half-open, 2 open), and every breaker transition.
        self.estimator_kernel_rung_attempts_total = r.counter(
            p + "estimator_kernel_rung_attempts_total",
            "kernel-ladder rung engagements by outcome",
        )
        self.estimator_kernel_breaker_state = r.gauge(
            p + "estimator_kernel_breaker_state",
            "kernel-rung circuit breaker state (0 closed, 1 half-open, 2 open)",
        )
        self.estimator_breaker_transitions_total = r.counter(
            p + "estimator_breaker_transitions_total",
            "kernel-rung circuit breaker state transitions",
        )
        # -- remaining reference catalog (metrics.go:112-358) -----------------
        self.max_nodes_count = r.gauge(p + "max_nodes_count", "configured node cap")
        self.cluster_cpu_current_cores = r.gauge(
            p + "cluster_cpu_current_cores", "sum of node allocatable cores"
        )
        self.cluster_memory_current_bytes = r.gauge(
            p + "cluster_memory_current_bytes", "sum of node allocatable memory"
        )
        self.cpu_limits_cores = r.gauge(
            p + "cpu_limits_cores", "cluster cpu floor/cap (label direction)"
        )
        self.memory_limits_bytes = r.gauge(
            p + "memory_limits_bytes", "cluster memory floor/cap (label direction)"
        )
        self.node_group_min_count = r.gauge(
            p + "node_group_min_count", "per-group min size (opt-in)"
        )
        self.node_group_max_count = r.gauge(
            p + "node_group_max_count", "per-group max size (opt-in)"
        )
        self.scaled_up_gpu_nodes_total = r.counter(
            p + "scaled_up_gpu_nodes_total", "accelerator nodes added"
        )
        self.scaled_down_gpu_nodes_total = r.counter(
            p + "scaled_down_gpu_nodes_total", "accelerator nodes removed"
        )
        self.unremovable_nodes_count = r.gauge(
            p + "unremovable_nodes_count", "scale-down rejections by reason"
        )
        self.scale_down_in_cooldown = r.gauge(
            p + "scale_down_in_cooldown", "1 while scale-down is in cooldown"
        )
        self.old_unregistered_nodes_removed_count = r.counter(
            p + "old_unregistered_nodes_removed_count",
            "stuck unregistered instances deleted",
        )
        self.overflowing_controllers_count = r.gauge(
            p + "overflowing_controllers_count",
            "controllers with too many pods for equivalence grouping",
        )
        self.skipped_scale_events_count = r.counter(
            p + "skipped_scale_events_count",
            "scale events skipped (labels direction, reason)",
        )
        # node groups excluded from THIS loop's estimation, by closed
        # SkipReason (explain/reasons.py; CA parity skipped_scale_events_
        # count). A gauge reset every loop — like unremovable_nodes_count —
        # so a reason that stops occurring reports 0, not its last value.
        self.scaleup_skipped_groups_total = r.gauge(
            p + "scaleup_skipped_groups_total",
            "node groups skipped by this loop's scale-up, by reason",
        )
        self.nap_enabled = r.gauge(p + "nap_enabled", "node autoprovisioning on")
        self.created_node_groups_total = r.counter(
            p + "created_node_groups_total", "NAP groups created"
        )
        self.deleted_node_groups_total = r.counter(
            p + "deleted_node_groups_total", "NAP groups deleted"
        )
        self.pending_node_deletions = r.gauge(
            p + "pending_node_deletions", "deletions currently in flight"
        )
        # -- perf observatory (autoscaler_tpu/perf): compile telemetry, the
        # XLA cost model, and device-buffer residency. Series share the
        # trace/metric taxonomy discipline: route label values are the
        # estimator's kernel-route vocabulary, pool label values are the
        # residency-ledger pools (snapshot | kernel_operands |
        # scenario_batches).
        self.kernel_compile_seconds = r.histogram(
            p + "kernel_compile_seconds",
            "cold kernel dispatch wall (trace+compile+execute) by route",
        )
        self.kernel_execute_seconds = r.histogram(
            p + "kernel_execute_seconds",
            "warm kernel dispatch wall by route",
        )
        self.kernel_compile_cache_total = r.counter(
            p + "kernel_compile_cache_total",
            "kernel dispatches by route and compile-cache outcome (hit|miss)",
        )
        self.kernel_model_utilization = r.gauge(
            p + "kernel_model_utilization",
            "achieved model-FLOP/s over nominal peak per route (last warm "
            "dispatch)",
        )
        self.device_resident_bytes = r.gauge(
            p + "device_resident_bytes",
            "live device buffer bytes by residency pool",
        )
        # -- resident device arena (autoscaler_tpu/snapshot/arena): delta
        # uploads vs full re-seeds. Steady state is delta_rows trickling
        # and full_uploads FLAT — a climbing full-upload counter without
        # bucket promotions is the flatten-per-tick tax coming back.
        self.arena_delta_rows_total = r.counter(
            p + "arena_delta_rows_total",
            "snapshot rows shipped to the device as delta scatters",
        )
        self.arena_full_uploads_total = r.counter(
            p + "arena_full_uploads_total",
            "full tensor re-seeds of the device arena (init, bucket "
            "promotion, schema change, fault rollback)",
        )
        # -- flight journal (autoscaler_tpu/journal): the black-box state
        # recorder. records/keyframes count journal volume; probe_drift is
        # the alarm — a reconstructed tick that does not bit-match the live
        # packer state (or flips a fit verdict) is a codec, shadow, or
        # arena bug surfacing, never an acceptable steady state
        self.journal_records_total = r.counter(
            p + "journal_records_total",
            "flight-journal records appended (keyframes + deltas)",
        )
        self.journal_keyframes_total = r.counter(
            p + "journal_keyframes_total",
            "full keyframes journaled (init, packer reseed, shape/options "
            "change, every-K interval)",
        )
        self.journal_probe_drift_total = r.counter(
            p + "journal_probe_drift_total",
            "divergence-probe failures: reconstructed state or its fit "
            "verdicts not bit-identical to the live packer",
        )
        # -- preemption engine (autoscaler_tpu/preempt) -----------------------
        # pending pods silently dropped by the expendable cutoff used to
        # vanish without a trace (static_autoscaler.go:471 parity); now
        # counted AND ledgered (reason expendable_below_cutoff)
        self.pending_expendable_total = r.counter(
            p + "pending_expendable_total",
            "pending pods dropped below --expendable-pods-priority-cutoff",
        )
        # evictions the CURRENT plan would perform — a per-tick gauge (like
        # unneeded_nodes_count), distinct from evicted_pods_total which
        # counts actuated evictions
        self.preemption_planned_evictions = r.gauge(
            p + "preemption_planned_evictions",
            "evictions planned by this tick's preemption pass",
        )
        self.preempted_pods_total = r.counter(
            p + "preempted_pods_total",
            "pods actually evicted by the preemption engine",
        )
        self.estimation_over_budget_total = r.counter(
            p + "estimation_over_budget_total",
            "batched binpacking dispatches exceeding the per-group duration "
            "budget x group count (--max-nodegroup-binpacking-duration)",
        )
        # -- fleet serving (autoscaler_tpu/fleet): the coalescing multi-
        # tenant estimator service. Batch-size and padding-waste ladders are
        # fleet-shaped, not duration-shaped; per-bucket compile cache
        # hit/miss rides kernel_compile_cache_total via the observatory
        # (each bucket is one (route, shape-signature) key).
        self.fleet_queue_depth = r.gauge(
            p + "fleet_queue_depth",
            "estimate requests waiting in the coalescing window",
        )
        self.fleet_batch_size = r.histogram(
            p + "fleet_batch_size",
            "real (non-padding) requests per coalesced batch, by bucket",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0),
        )
        self.fleet_padding_waste_ratio = r.histogram(
            p + "fleet_padding_waste_ratio",
            "padded-cell fraction of each coalesced batch, by bucket",
            buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99),
        )
        self.fleet_requests_total = r.counter(
            p + "fleet_requests_total",
            "admitted fleet estimate requests by bucket and tenant",
        )
        self.fleet_batches_total = r.counter(
            p + "fleet_batches_total",
            "coalesced batch dispatches by bucket and serving route",
        )
        self.fleet_prewarmed_buckets = r.gauge(
            p + "fleet_prewarmed_buckets",
            "shape buckets pre-warmed at startup",
        )
        # -- fleet overload armor (autoscaler_tpu/fleet/admission): the
        # deadline-aware admission gate and per-ticket terminal outcomes.
        # Outcome vocabularies are closed (fleet/errors.py); tenant labels
        # ride the same cardinality bound as the SLI series.
        self.fleet_admission_total = r.counter(
            p + "fleet_admission_total",
            "fleet admission verdicts by outcome (admitted|shed_queue_full"
            "|shed_quota|shed_draining|shed_deadline) and tenant; carries "
            "a quota-tier label when --fleet-tenant-tiers is configured "
            "(tier names are a closed small set — inside the cardinality "
            "bound)",
        )
        self.fleet_ticket_outcomes_total = r.counter(
            p + "fleet_ticket_outcomes_total",
            "terminal fleet ticket outcomes (resolved|failed|expired|"
            "abandoned) by tenant — every admitted ticket ends in exactly "
            "one; `abandoned` means the caller departed before the answer",
        )
        self.fleet_draining = r.gauge(
            p + "fleet_draining",
            "1 while the fleet coalescer is draining (admission closed, "
            "readiness bit down, in-flight buckets flushing)",
        )
        self.fleet_endpoint_picks_total = r.counter(
            p + "fleet_endpoint_picks_total",
            "health-weighted balancer routing attempts by endpoint and "
            "outcome (ok|replica_restart|endpoint_flap) — the fleet-HA "
            "rebalancing evidence (a restarting replica's ok count must "
            "flatline while its peers absorb the traffic)",
        )
        # -- fleet request-lifecycle SLIs (autoscaler_tpu/fleet + slo): the
        # per-ticket queue/service decomposition on the tracer timeline
        # seam. tenant label cardinality is bounded by the coalescer
        # (--fleet-max-tenant-labels → __overflow__); tail buckets carry
        # OpenMetrics exemplars pairing the observation to its trace id.
        # With --fleet-tenant-tiers configured each series additionally
        # carries the quota-tier label (closed small vocabulary — the
        # cardinality bound stands): per-tier latency IS the tier SLO
        # surface.
        self.fleet_queue_wait_seconds = r.histogram(
            p + "fleet_queue_wait_seconds",
            "fleet ticket admission→dispatch wait (coalescing window + "
            "bucket queue) by tenant and bucket",
        )
        self.fleet_service_seconds = r.histogram(
            p + "fleet_service_seconds",
            "fleet ticket dispatch→resolve service time (batched kernel + "
            "demux) by tenant and bucket",
        )
        self.fleet_e2e_seconds = r.histogram(
            p + "fleet_e2e_seconds",
            "fleet ticket submit→resolve end-to-end latency by tenant and "
            "bucket",
        )
        # -- SLO engine (autoscaler_tpu/slo): declarative targets over the
        # request-lifecycle SLIs, multi-window burn rates on the timeline
        # clock. Served in detail by /sloz; these series are the alerting
        # surface.
        self.slo_events_total = r.counter(
            p + "slo_events_total",
            "SLI events judged against their SLO threshold, by slo and "
            "verdict (good|bad)",
        )
        self.slo_burn_rate = r.gauge(
            p + "slo_burn_rate",
            "error-budget burn rate per SLO and window (1.0 = burning "
            "exactly the budget; page on sustained multi-window burn)",
        )
        # -- policy gym (autoscaler_tpu/gym): the tuning workload. Rollout
        # and generation spans ride the shared FunctionLabel taxonomy
        # (gymRollout / gymGeneration); these series carry the search's
        # own progress.
        self.gym_rollouts_total = r.counter(
            p + "gym_rollouts_total",
            "policy-gym candidate episodes completed, by scenario",
        )
        self.gym_generation_best_score = r.gauge(
            p + "gym_generation_best_score",
            "best-so-far candidate score (reward; non-decreasing by "
            "elitism) after each tuner generation",
        )
        self.gym_candidates_pruned_total = r.counter(
            p + "gym_candidates_pruned_total",
            "candidates eliminated by successive halving before the full "
            "suite",
        )

    def observe_duration_value(self, label: str, elapsed: float) -> float:
        """THE duration choke point: every span end (autoscaler_tpu/trace)
        and every legacy observe_duration call records through here, so the
        trace vocabulary and the function_duration series can never
        disagree on names or counts."""
        self.function_duration.observe(elapsed, function=label)
        self.function_duration_quantile.observe(elapsed, function=label)
        return elapsed

    def observe_duration(self, label: str, start_ts: float) -> float:
        """UpdateDurationFromStart analog (metrics.go:399)."""
        return self.observe_duration_value(label, time.monotonic() - start_ts)


_default = AutoscalerMetrics()


def default_metrics() -> AutoscalerMetrics:
    return _default
