"""Scorer: a RunResult → one JSON report.

The report answers the questions a policy PR must improve on:

- ``pending_pod_latency_s`` — arrival→bind latency percentiles (p50/p90/
  p99/max) in scenario seconds, plus how many pods never bound;
- ``nodes`` — peak/final provisioned vs a capacity lower bound
  (ceil(total requested cpu / biggest node cpu)) — the overprovisioning
  headline, same spirit as KIS-S's utilization-vs-SLO frontier;
- ``decisions`` — scale-up/scale-down/backoff/error counts over the run;
- ``tick_wall_s`` — per-tick wall time of the REAL loop (p50/max), the
  number the churn bench tracks at scale;
- ``kernel_routes`` / ``function_duration`` — the same observability the
  production loop exports, so scenario runs slot into existing dashboards.

Like the JAX package's captures, the report is a flat JSON
object with a ``metric`` name and a ``platform`` field (``gpu`` on a CUDA
card, ``cpu`` off it: ``platform_of``).

The port of ``autoscaler_tpu/loadgen/score.py``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from autoscaler_tpu_torch.loadgen.driver import RunResult, TickRecord


def platform_of(device) -> str:
    """The report's ``platform``: ``gpu`` for a run on a CUDA card, else
    the device's type (``cpu``), as the JAX package reports its backend."""
    import torch

    kind = torch.device(device).type
    return "gpu" if kind == "cuda" else kind


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


@dataclass(frozen=True)
class ObjectiveWeights:
    """Weights of the scorer's one deterministic scalar — the number the
    policy gym minimizes and the report prints, so humans and the tuner
    read the SAME objective. Units: w_slo per pending-pod-tick,
    w_cost per over-provisioned node-hour, w_churn per node added/removed."""

    w_slo: float = 1.0
    w_cost: float = 8.0
    w_churn: float = 0.25

    @classmethod
    def parse(cls, text: str) -> "ObjectiveWeights":
        """``"slo=1,cost=8,churn=0.25"`` (any subset; "" = defaults)."""
        kw: Dict[str, float] = {}
        for part in str(text or "").split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, raw = part.partition("=")
            field = f"w_{key.strip()}"
            if not sep or field not in {f.name for f in dataclasses.fields(cls)}:
                raise ValueError(
                    f"objective weights want slo=/cost=/churn= entries, "
                    f"got {part!r}"
                )
            kw[field] = float(raw)
        return cls(**kw)

    def to_dict(self) -> Dict[str, float]:
        return {"slo": self.w_slo, "cost": self.w_cost, "churn": self.w_churn}


DEFAULT_WEIGHTS = ObjectiveWeights()


def tick_objective(
    rec: TickRecord, tick_interval_s: float,
    weights: ObjectiveWeights = DEFAULT_WEIGHTS,
) -> float:
    """One tick's objective contribution — the gym env's per-step cost
    (reward = its negation). Summing this over a run's records equals
    build_objective's weighted total up to float association, so per-step
    rewards and the report's scalar can never tell different stories."""
    over = max(rec.nodes_total - rec.demand_nodes, 0)
    churn = sum(d for _, d in rec.scale_ups) + len(rec.scale_downs)
    return (
        weights.w_slo * rec.pending_after
        + weights.w_cost * over * tick_interval_s / 3600.0
        + weights.w_churn * churn
    )


def build_objective(
    records: List[TickRecord], tick_interval_s: float,
    weights: ObjectiveWeights = DEFAULT_WEIGHTS,
) -> Dict[str, Any]:
    """The deterministic scalar a policy answers for, decomposed:

    - ``pending_pod_ticks`` — Σ pods still pending after each tick (every
      tick a pod waits is SLO pain, the KIS-S latency axis);
    - ``over_provisioned_node_hours`` — Σ max(nodes − demand bound, 0)
      node-hours, demand being each tick's ceil(live cpu / biggest node)
      (TickRecord.demand_nodes — the cost axis);
    - ``scale_churn`` — nodes added + removed over the run (thrash);
    - ``weighted_total`` = w_slo·slo + w_cost·cost + w_churn·churn.

    Pure function of the decision log → byte-identical across replays."""
    pending_ticks = sum(r.pending_after for r in records)
    over_hours = sum(
        max(r.nodes_total - r.demand_nodes, 0) for r in records
    ) * tick_interval_s / 3600.0
    churn = sum(
        sum(d for _, d in r.scale_ups) + len(r.scale_downs) for r in records
    )
    total = (
        weights.w_slo * pending_ticks
        + weights.w_cost * over_hours
        + weights.w_churn * churn
    )
    return {
        "pending_pod_ticks": int(pending_ticks),
        "over_provisioned_node_hours": round(over_hours, 6),
        "scale_churn": int(churn),
        "weights": weights.to_dict(),
        "weighted_total": round(total, 6),
    }


def build_report(
    result: RunResult, weights: Optional[ObjectiveWeights] = None
) -> Dict[str, Any]:
    spec = result.spec
    interval = spec.tick_interval_s
    latencies = sorted(
        (bound - arrival) * interval
        for arrival, bound in result.pod_latency.values()
        if bound is not None
    )
    unbound = sum(1 for _, b in result.pod_latency.values() if b is None)
    walls = sorted(r.wall_s for r in result.records)
    scale_up_nodes = sum(d for r in result.records for _, d in r.scale_ups)
    scale_up_events = sum(1 for r in result.records if r.scale_ups)
    scale_down_nodes = sum(len(r.scale_downs) for r in result.records)
    backoff_ticks = sum(1 for r in result.records if r.backed_off)
    error_ticks = sum(1 for r in result.records if r.errors)
    # capacity lower bound: total requested cpu over the run, packed into
    # the largest node shape with nothing wasted. Unreachable in general
    # (bursts decay, shapes fragment) but a stable denominator across
    # policies on the SAME scenario.
    optimal_nodes = (
        int(math.ceil(result.total_requested_cpu_m / result.group_cpu_m))
        if result.group_cpu_m > 0
        else 0
    )
    # per-phase latency breakdown over EVERY span name the run produced
    # (the trace/metrics shared vocabulary: main, buildSnapshot, estimate,
    # deviceDispatch, scaleDown, ... — traces and this table can't disagree
    # because both come from the same observe_duration_value choke point)
    fd = result.metrics.function_duration
    phases = {}
    for key, state in sorted(fd.states.items()):
        labels = dict(key)
        phase = labels.get("function", "")
        if not phase or not state.count:
            continue
        phases[phase] = {
            "count": state.count,
            "p50_s": round(fd.quantile(0.5, **labels), 4),
            "p99_s": round(fd.quantile(0.99, **labels), 4),
            # lifetime maximum, not the window's: the one pathological tick
            # a long run exists to surface must survive window eviction
            "max_s": round(state.maximum, 4),
        }
    routes = {
        "/".join(f"{lk}={lv}" for lk, lv in k): int(v)
        for k, v in result.metrics.estimator_kernel_route_total.values.items()
    }
    report: Dict[str, Any] = {
        "metric": f"loadgen_scenario_{spec.name}",
        "platform": platform_of(result.device),
        "scenario": spec.name,
        "seed": spec.seed,
        "ticks": spec.ticks,
        "tick_interval_s": interval,
        "pods_arrived": len(result.pod_latency),
        "pending_pod_latency_s": {
            "p50": round(_percentile(latencies, 0.50), 3),
            "p90": round(_percentile(latencies, 0.90), 3),
            "p99": round(_percentile(latencies, 0.99), 3),
            "max": round(_percentile(latencies, 1.0), 3),
            "bound": len(latencies),
            "never_bound": unbound,
        },
        "nodes": {
            "initial": sum(g.initial_size for g in spec.node_groups),
            "peak": result.peak_nodes,
            "final": result.final_nodes,
            "optimal_lower_bound": optimal_nodes,
        },
        "decisions": {
            "scale_up_events": scale_up_events,
            "scale_up_nodes": scale_up_nodes,
            "scale_down_nodes": scale_down_nodes,
            "ticks_with_backoff": backoff_ticks,
            "ticks_with_errors": error_ticks,
        },
        "tick_wall_s": {
            "p50": round(_percentile(walls, 0.5), 4),
            "max": round(_percentile(walls, 1.0), 4),
            "total": round(sum(walls), 3),
        },
        # THE number a policy answers for (and the gym minimizes): one
        # deterministic scalar over the decision log, decomposed so the
        # SLO/cost/churn trade is readable
        "objective": build_objective(
            result.records, interval, weights or DEFAULT_WEIGHTS
        ),
        "injected_faults": result.injected_faults,
    }
    if phases:
        report["function_duration"] = phases
    if routes:
        report["kernel_routes"] = routes
    perf = _perf_section(result)
    if perf:
        report["perf"] = perf
    explain = _explain_section(result)
    if explain:
        report["explain"] = explain
    evictions = _evictions_section(result)
    if evictions:
        report["evictions"] = evictions
    slo = _slo_section(result)
    if slo:
        report["slo"] = slo
    journal = _journal_section(result)
    if journal:
        report["journal"] = journal
    return report


def _evictions_section(result: RunResult) -> Dict[str, Any]:
    """Preemption columns: what the eviction-packing engine
    admitted onto existing capacity, how many pods it actually evicted,
    the expendable-cutoff drops, and spot_reclaim re-pends. Zero-suppressed
    so priority-flat scenarios keep their existing reports byte-for-byte."""
    admitted = sum(r.preempt_admitted for r in result.records)
    preempted = sum(len(r.preempted) for r in result.records)
    expendable = sum(r.pending_expendable for r in result.records)
    reclaimed = sum(r.reclaimed for r in result.records)
    if not (admitted or preempted or expendable or reclaimed):
        return {}
    return {
        "preempt_admitted": admitted,
        "preempted_pods": preempted,
        "ticks_with_evictions": sum(
            1 for r in result.records if r.preempted
        ),
        "pending_expendable": expendable,
        "spot_reclaimed": reclaimed,
    }


def _perf_section(result: RunResult) -> Dict[str, Any]:
    """Perf-ledger columns alongside the per-span report: per kernel route
    the compile/execute wall split, dispatch/compile counts and the last
    utilization sample (ledger.summarize), plus resident-bytes p50/p99/peak
    per residency pool over the run's tick records."""
    if not result.perf_records:
        return {}
    from autoscaler_tpu_torch.perf import summarize

    agg = summarize(result.perf_records)
    routes: Dict[str, Any] = {}
    for route, r in agg["routes"].items():
        row = {
            "dispatches": r["dispatches"],
            "compiles": r["compiles"],
            "compile_s": r["compile_s"],
            "execute_s": r["execute_s"],
            "signatures": r["signatures"],
        }
        if "utilization" in r:
            row["utilization"] = r["utilization"]
        routes[route] = row
    pools: Dict[str, Any] = {}
    series: Dict[str, List[int]] = {}
    for rec in result.perf_records:
        for pool, nbytes in rec.get("resident_bytes", {}).items():
            series.setdefault(pool, []).append(int(nbytes))
    # peak comes from summarize — one aggregation to agree with the perf
    # ledger report; only the percentiles need the raw series
    peaks = agg.get("resident_bytes_peak", {})
    for pool in sorted(series):
        vals = sorted(series[pool])
        pools[pool] = {
            "p50": _percentile(vals, 0.50),
            "p99": _percentile(vals, 0.99),
            "peak": peaks.get(pool, vals[-1]),
        }
    return {
        "ticks": agg["ticks"],
        "routes": routes,
        "resident_bytes": pools,
    }


def build_fleet_report(result) -> Dict[str, Any]:
    """FleetRunResult → one JSON report: the coalescing efficiency columns
    (batch-size histogram, padding waste), per-tenant request latency
    (wall — report-only), the fairness certificate (per-tenant fleet
    answers byte-identical to solo), and the perf-observatory columns
    (per-bucket compile cache hits ride the (route, signature) keys)."""
    spec = result.spec
    verdicts = [t for r in result.records for t in r.tenants]
    batch_hist: Dict[str, int] = {}
    waste = []
    by_route: Dict[str, int] = {}
    mismatches = []
    for v in verdicts:
        batch_hist[str(v.batch_size)] = batch_hist.get(str(v.batch_size), 0) + 1
        waste.append(v.padding_waste)
        by_route[v.route] = by_route.get(v.route, 0) + 1
        if not v.match_solo:
            mismatches.append(v.tenant)
    walls = sorted(result.request_walls)
    waste_sorted = sorted(waste)
    # per-tenant lifecycle latency from the ticket stamps, decomposed:
    # queue wait (submit→dispatch: admission + coalescing window + bucket
    # queue) and service (dispatch→resolve: batched kernel + demux) next
    # to the e2e columns — a tenant whose bucket dispatched first in the
    # flush both waited less AND resolved earlier, and the split shows
    # which side a regression lives on
    per_tenant: Dict[str, Dict[str, float]] = {}
    for tenant in sorted(result.tenant_latency):
        samples = result.tenant_latency[tenant]
        qw = sorted(s[0] for s in samples)
        sv = sorted(s[1] for s in samples)
        e2e = sorted(s[2] for s in samples)
        per_tenant[tenant] = {
            "queue_wait_p50_s": round(_percentile(qw, 0.50), 5),
            "queue_wait_p99_s": round(_percentile(qw, 0.99), 5),
            "service_p50_s": round(_percentile(sv, 0.50), 5),
            "service_p99_s": round(_percentile(sv, 0.99), 5),
            "p50_s": round(_percentile(e2e, 0.50), 5),
            "p99_s": round(_percentile(e2e, 0.99), 5),
        }
    report: Dict[str, Any] = {
        "metric": f"loadgen_fleet_{spec.name}",
        "platform": platform_of(result.device),
        "scenario": spec.name,
        "seed": spec.seed,
        "rounds": spec.ticks,
        "tenants": len(spec.fleet.tenants) if spec.fleet else 0,
        "answers": len(verdicts),
        "fleet": {
            "batch_size_hist": dict(sorted(batch_hist.items())),
            "padding_waste": {
                "mean": round(sum(waste) / len(waste), 4) if waste else 0.0,
                "p99": round(_percentile(waste_sorted, 0.99), 4),
                "max": round(_percentile(waste_sorted, 1.0), 4),
            },
            "routes": dict(sorted(by_route.items())),
            "per_tenant_latency_s": per_tenant,
            "prewarmed_buckets": result.prewarmed,
        },
        "parity": {
            "certified": not mismatches and bool(verdicts),
            "mismatched_tenants": sorted(set(mismatches)),
        },
        "round_wall_s": {
            "p50": round(_percentile(walls, 0.5), 4),
            "max": round(_percentile(walls, 1.0), 4),
            "total": round(sum(walls), 3),
        },
        "degraded_rounds": sum(1 for r in result.records if r.degraded),
        "error_rounds": sum(1 for r in result.records if r.errors),
        "injected_faults": result.injected_faults,
    }
    # overload-armor columns: typed sheds by reason, terminal-outcome
    # tallies, and the zero-hung-tickets audit (a chaos
    # gate asserts unresolved == 0 and every shed row is typed)
    shed_by_reason: Dict[str, int] = {}
    outcome_totals: Dict[str, int] = {}
    for r in result.records:
        for row in r.shed:
            shed_by_reason[row["reason"]] = (
                shed_by_reason.get(row["reason"], 0) + 1
            )
        for key in sorted(r.outcomes):
            outcome_totals[key] = outcome_totals.get(key, 0) + r.outcomes[key]
    report["overload"] = {
        "shed_by_reason": dict(sorted(shed_by_reason.items())),
        "outcomes": dict(sorted(outcome_totals.items())),
        "admission": dict(sorted(getattr(result, "admission", {}).items())),
        "unresolved": int(getattr(result, "unresolved", 0)),
    }
    # fleet-HA columns: where the balancer actually sent traffic, how
    # often it had to fail over past a dead replica, and the typed sheds
    # broken out by quota tier (the "bronze sheds first, gold stays in
    # SLO" evidence a rolling-restart gate reads)
    endpoint_counts: Dict[str, int] = {}
    failovers_total = 0
    sheds_by_tier: Dict[str, int] = {}
    for r in result.records:
        for v in r.tenants:
            if v.endpoint:
                endpoint_counts[v.endpoint] = (
                    endpoint_counts.get(v.endpoint, 0) + 1
                )
            failovers_total += v.failovers
        for row in r.shed:
            tier = row.get("tier", "")
            sheds_by_tier[tier] = sheds_by_tier.get(tier, 0) + 1
    report["ha"] = {
        "endpoint_requests": dict(sorted(endpoint_counts.items())),
        "failovers_total": failovers_total,
        "sheds_by_tier": dict(sorted(sheds_by_tier.items())),
    }
    perf = _perf_section(result)
    if perf:
        report["perf"] = perf
    slo = _slo_section(result)
    if slo:
        report["slo"] = slo
    return report


def _slo_section(result) -> Dict[str, Any]:
    """SLO columns (slo ledger.summarize): final event
    totals, worst multi-window burn per objective, alerting ticks — the
    run's error-budget story next to its latency percentiles."""
    records = getattr(result, "slo_records", None)
    if not records:
        return {}
    from autoscaler_tpu_torch.slo import summarize

    return summarize(records)


def _journal_section(result: RunResult) -> Dict[str, Any]:
    """Flight-journal columns (journal ledger.summarize):
    how the run's state history encoded — keyframe/delta split, promotion
    reasons, delta-op volume and payload bytes. Zero-suppressed like the
    other observability sections."""
    records = getattr(result, "journal_records", None)
    if not records:
        return {}
    from autoscaler_tpu_torch.journal import summarize

    return summarize(records)


def _explain_section(result: RunResult) -> Dict[str, Any]:
    """Decision-provenance columns (explain ledger.summarize):
    rejection-reason histograms (per-pod dominant and per-group estimator
    verdicts), expander win counts per group, and the closed skip-reason
    counts — the run's "why" next to the "what" of the decisions table."""
    if not result.explain_records:
        return {}
    from autoscaler_tpu_torch.explain import summarize

    agg = summarize(result.explain_records)
    return {
        "ticks": agg["ticks"],
        "pod_reasons": agg["pod_reasons"],
        "group_reasons": agg["group_reasons"],
        "expander_wins": agg["expander_wins"],
        "skip_reasons": agg["skip_reasons"],
    }
