"""The scenario engine on the card: chip_smoke's 3w (Cluster Autoscaler's
scalability drill at full size), 3x (the fleet drill), 4r (the drill at a
tenth, card against CPU), 4s (the policy gym's tune at 4r's size, card
against CPU) and 5e (a cuda-rung fault and its recovery on 4r's drill).

    python3 -m autoscaler_tpu_torch.tools.drill_probe               # one card
    python3 -m autoscaler_tpu_torch.tools.drill_probe --device cpu --tenth

The drill follows the reference's kubemark scalability test
(``proposals/scalability_tests.md``: 30 pods a node on 1 000 nodes, all
scheduled; then 300 empty nodes of 1 000 removed): one node group of the
spec's default node (4 000 m, 16 384 MiB, 110 pods; min 0, max 1 000,
initial 10), pods of 130 m / 512 MiB (30 fit a node), 21 000 ``drill-a``
pods at tick 0 and 9 000 ``drill-b`` at tick 1, and at ``COMPLETE_TICK``
(all bound by then) the 9 000 ``drill-b`` pods complete. The binder binds
pending pods sorted by key, so the pods that stay carry the prefix that
sorts first and fill the first 700 nodes. A tick is a minute; the
options are the defaults but the driver's (10 minutes of unneeded time,
10 empty nodes a tick at most), so the emptied nodes go 10 a tick from
tick ``COMPLETE_TICK`` + 10 on: ``drill_ticks`` ticks in all.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter
from typing import Dict

from autoscaler_tpu_torch.device import resolve_device

DRILL_NODES = 1000
PODS_PER_NODE = 30
KEEP, DROP = "drill-a", "drill-b"   # KEEP sorts first: the binder binds it first
COMPLETE_TICK = 4
UNNEEDED_S = 600.0
TICK_S = 60.0
EMPTY_BULK = 10
MIXED_PODS = 64   # pods of distinct sizes in a burst that takes K2
PROFILE_TICKS = (1, 3)  # 3y's profiled ticks: a scale-up, a scale-down


def drill_sizes(tenth: bool = False) -> dict:
    k = 10 if tenth else 1
    nodes = DRILL_NODES // k
    drop_nodes = 3 * nodes // 10
    return {"nodes": nodes, "initial": max(10 // k, 1),
            "keep": (nodes - drop_nodes) * PODS_PER_NODE, "drop": drop_nodes * PODS_PER_NODE,
            "drop_nodes": drop_nodes}


def drill_ticks(tenth: bool = False) -> int:
    """Ticks until the emptied nodes are gone: unneeded from the completion
    tick, deletable UNNEEDED_S later, EMPTY_BULK a tick, and one to spare."""
    sz = drill_sizes(tenth)
    return COMPLETE_TICK + int(UNNEEDED_S // TICK_S) + -(-sz["drop_nodes"] // EMPTY_BULK) + 1


def drill_doc(tenth: bool = False, name: str = "", seed: int = 0, ticks: int = 0) -> dict:
    """The scalability drill as a scenario document (either package's
    ``ScenarioSpec.from_dict`` takes it)."""
    sz = drill_sizes(tenth)
    return {
        "name": name or ("ca_scale_drill_tenth" if tenth else "ca_scale_drill"),
        "seed": seed,
        "ticks": ticks or drill_ticks(tenth),
        "tick_interval_s": TICK_S,
        "node_groups": [{"name": "pool", "min_size": 0, "max_size": sz["nodes"],
                         "initial_size": sz["initial"]}],
        "events": [
            {"at_tick": 0, "kind": "pod_burst", "count": sz["keep"], "cpu_m": 130.0,
             "mem_mb": 512.0, "prefix": KEEP},
            {"at_tick": 1, "kind": "pod_burst", "count": sz["drop"], "cpu_m": 130.0,
             "mem_mb": 512.0, "prefix": DROP},
            {"at_tick": COMPLETE_TICK, "kind": "pod_complete", "count": sz["drop"],
             "prefix": DROP},
        ],
        "options": {"scale_down_unneeded_time_s": UNNEEDED_S,
                    "max_empty_bulk_delete": EMPTY_BULK},
    }


def mixed_burst(at_tick: int, n: int = MIXED_PODS, prefix: str = "mix") -> list:
    """``n`` pods of distinct sizes arriving at ``at_tick``, one event each.
    The drill's pods are all alike, so its estimates take the dedup route
    (the torch loop over runs, as the JAX package's take its XLA runs scan);
    pods that do not dedup take the cuda rung's K2."""
    return [{"at_tick": at_tick, "kind": "pod_burst", "count": 1,
             "cpu_m": 100.0 + 13.0 * i, "mem_mb": 256.0 + 32.0 * i, "prefix": prefix}
            for i in range(n)]


def profile_doc(tenth: bool = False, seed: int = 0) -> dict:
    """3y: the drill's world standing at tick 0 (its 1 000 nodes up, its
    30 000 pods arriving and bound at once, so the snapshot is packed at
    full size from its first build: past the dense mask's cell limit it is
    factored); at ``PROFILE_TICKS[0]`` a burst of pods of distinct sizes
    arrives while every node is full (the scale-up tick: one K2 launch,
    since they do not dedup); the ``drill-b`` pods complete at the next
    tick, and a tick of unneeded time later, at ``PROFILE_TICKS[1]``, up to
    10 emptied nodes go (the scale-down tick). One pod that no node holds
    stays pending throughout, so ``run_drill``'s debugger, armed on the
    profiled ticks, checks the pending pods' fit on each of them
    (``fits_any_node``: K4 and its rows entry on the factored snapshot).
    The journal's probe runs every tick too, after the tick's session has
    closed. ``tenth`` is the same at 4r's size (a dense mask there: no
    K4)."""
    up, down = PROFILE_TICKS
    sz = drill_sizes(tenth)
    doc = drill_doc(tenth=tenth, name="profiled_drill", seed=seed, ticks=down + 1)
    doc["node_groups"][0].update(initial_size=sz["nodes"], max_size=sz["nodes"] + MIXED_PODS)
    doc["events"] = [dict(e, at_tick=0) for e in doc["events"][:2]] + [
        {"at_tick": 0, "kind": "pod_burst", "count": 1, "cpu_m": 6000.0, "mem_mb": 512.0,
         "prefix": "giant"},
    ] + mixed_burst(up) + [
        {"at_tick": up + 1, "kind": "pod_complete", "count": sz["drop"], "prefix": DROP}]
    doc["options"] = {"scale_down_unneeded_time_s": TICK_S, "journal_probe_interval": 1,
                      "max_empty_bulk_delete": EMPTY_BULK}
    return doc


def fault_doc(seed: int = 0) -> dict:
    """5e: 4r's node group with a ``kernel_fault`` armed on the cuda rung at
    tick 0 for two ticks, each of which brings pods of distinct sizes (so
    the estimate takes the cuda rung, not the dedup route), then
    ``clear_faults`` at tick 2, and a third burst at tick 3. On a card each
    faulted tick's run_once raises (the driver records the typed error);
    the breaker opens at the first fault, and once its cooldown (a tick)
    has passed a half-open probe on the cuda rung closes it and the
    decisions flow again."""
    doc = drill_doc(tenth=True, name="drill_fault", seed=seed, ticks=5)
    doc["events"] = mixed_burst(0) + mixed_burst(1, prefix="mix1") + [
        {"at_tick": 0, "kind": "fault",
         "fault": {"kind": "kernel_fault", "rung": "cuda", "end_tick": 2}},
        {"at_tick": 2, "kind": "clear_faults"},
    ] + mixed_burst(3, prefix="mix3")
    doc["options"] = {"kernel_breaker_failure_threshold": 1,
                      "kernel_breaker_cooldown_s": TICK_S}
    return doc


def fleet_doc(seed: int = 7, ticks: int = 8) -> dict:
    """3x: the shape of the JAX package's canned ``fleet_tenants`` scenario
    (six tenants from 3 to 120 pods, two with what-if prices), without its
    batched-rung fault window (on a card that fault fails the batch's
    tickets: 5e and ``fleet_probe``'s 5d hold that)."""
    tenants = [
        ("edge-small", 9, 3, 12, 400.0, 384.0, False),
        ("batch-medium", 30, 6, 24, 750.0, 1024.0, False),
        ("spot-whatif", 24, 8, 32, 500.0, 512.0, True),
        ("ml-wide", 64, 4, 48, 2000.0, 8192.0, False),
        ("web-large", 120, 12, 64, 300.0, 256.0, False),
        ("spiky-tiny", 3, 2, 4, 900.0, 2048.0, True),
    ]
    return {
        "name": "fleet_tenants", "seed": seed, "ticks": ticks, "tick_interval_s": 10.0,
        "fleet": {"tenants": [
            {"name": n, "pods": p, "groups": g, "max_nodes": m, "cpu_m": c, "mem_mb": mem,
             "whatif": w} for n, p, g, m, c, mem, w in tenants]},
        "options": {"kernel_breaker_cooldown_s": 20.0},
    }


def gym_suite_doc(seed: int = 0) -> dict:
    """4s: two scenarios at 4r's size — the drill itself, and a burst of
    the drill's pods at twice the rate with completions — shortened to the
    ticks that scale up and bind."""
    drill = drill_doc(tenth=True, name="gym_drill", seed=seed, ticks=6)
    churn = drill_doc(tenth=True, name="gym_churn", seed=seed + 1, ticks=6)
    churn["events"] = [e for e in churn["events"] if e["prefix"] == KEEP] + [
        {"at_tick": 2, "kind": "pod_complete", "count": 600, "prefix": KEEP},
        {"at_tick": 3, "kind": "pod_burst", "count": 900, "cpu_m": 260.0, "mem_mb": 1024.0,
         "prefix": "drill-c"},
    ]
    return {"name": "gym_drill_suite", "scenarios": [drill, churn]}


def launch_counts() -> Dict[str, int]:
    """Every hand kernel's launches so far, by kernel (the wrappers'
    ``LAUNCHES``)."""
    from autoscaler_tpu_torch.ops import ffd_scan, ffd_scan_affinity, fit_reduce, histogram

    return {**ffd_scan.LAUNCHES, **ffd_scan_affinity.LAUNCHES, **fit_reduce.LAUNCHES,
            **histogram.LAUNCHES}


def served_routes(metrics) -> Dict[str, int]:
    """The estimator's served routes so far, as {"route:reason": n}."""
    return {f"{dict(k)['route']}:{dict(k)['reason']}": int(v)
            for k, v in metrics.estimator_kernel_route_total.values.items()}


def count_delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def run_drill(doc: dict, device=None, profiler_dir: str = "", profile_ticks=(),
              tick_log=None):
    """One run of the scenario ``doc`` on ``device`` through the port's
    scenario driver (``run_scenario``'s loop, tick by tick) → (RunResult,
    seconds). On the ticks in ``profile_ticks`` a ``DebuggingSnapshotter``
    is armed (its capture ends the tick), and with ``profiler_dir`` they
    run with ``jax_profiler_dir`` set: a torch.profiler session each. With
    a list for ``tick_log`` each tick appends {"tick", "launches",
    "served", "errors", "degraded"}: its kernel launches and the
    estimator's routes served on it (``launch_counts``,
    ``served_routes``), its errors and its tripped rungs."""
    from autoscaler_tpu_torch.debugging import DebuggingSnapshotter
    from autoscaler_tpu_torch.loadgen.driver import ScenarioDriver
    from autoscaler_tpu_torch.loadgen.spec import ScenarioSpec

    spec = ScenarioSpec.from_dict(json.loads(json.dumps(doc)))
    t0 = time.perf_counter()
    driver = ScenarioDriver(spec, device=resolve_device(device))
    driver.begin()
    if profile_ticks:
        driver.autoscaler.debugger = DebuggingSnapshotter()
    for tick in range(spec.ticks):
        if tick in profile_ticks:
            driver.autoscaler.debugger.request()
        if profiler_dir:
            driver.autoscaler.options.jax_profiler_dir = (
                profiler_dir if tick in profile_ticks else "")
        if tick_log is None:
            driver.tick_once(tick)
            continue
        launches, served = launch_counts(), served_routes(driver.autoscaler.metrics)
        rec = driver.tick_once(tick)
        tick_log.append({
            "tick": tick, "launches": count_delta(launch_counts(), launches),
            "served": count_delta(served_routes(driver.autoscaler.metrics), served),
            "errors": list(rec.errors), "degraded": list(rec.degraded)})
    result = driver.finish()
    return result, time.perf_counter() - t0


# the routes on which a card serves the plain per-pod dispatches (K1/K2,
# K3), and the route and reason on which the CPU, whose cuda rung is
# not_cuda, serves them: the torch loop past that rung
CARD_KERNEL_ROUTES = ("cuda", "cuda_affinity")
CPU_KERNEL_ROUTE = ("torch_scan", "not_cuda")
# the fleet's batched route: K1/K2 on a card, the torch rung on the CPU
FLEET_BATCHED_ROUTE = "fleet_batched"


def comparable(result) -> dict:
    """What a card's and the CPU's run of one spec (a plain scenario's
    RunResult or a fleet's FleetRunResult) must agree on → {"log": the
    decision log (a fleet's round ledger) as JSON lines, "report": the
    score report in ``report_view``'s terms, as {section: JSON text}}."""
    from autoscaler_tpu_torch.loadgen.score import build_fleet_report, build_report

    if hasattr(result, "decision_ledger_lines"):
        log = result.decision_ledger_lines().splitlines()
        report = build_fleet_report(result)
    else:
        log = [json.dumps(rec, sort_keys=True) for rec in result.decision_log()]
        report = build_report(result)
    return {"log": log, "report": {k: json.dumps(v, sort_keys=True)
                                   for k, v in sorted(report_view(report).items())}}


def report_view(report: dict) -> dict:
    """A score report as a card's and the CPU's runs must agree on it:
    without its walls (``tick_wall_s``, ``round_wall_s``, the phases'
    seconds in ``function_duration``, a fleet's per-tenant latencies), its
    platform and the cost model's utilization (a ratio to the device's own
    peak rate), and with the serving rung named as the CPU names it. Each
    estimate served on the card's K1/K2 or K3 (``CARD_KERNEL_ROUTES``,
    reason ``ok``) is one the CPU serves on ``CPU_KERNEL_ROUTE``: those
    counts join that route's in ``kernel_routes`` and their dispatches its
    row of the perf section (which keeps its dispatches alone: its shape
    signatures and compile split are the serving kernel's, as they are
    of the fleet's batched route, whose row keeps its dispatches alone
    too), and
    ``deviceDispatch`` counts one rung engagement less for each of the
    CPU's estimates on that route (the CPU engages the cuda rung it lacks
    first). Every other route stays as it is: a torch loop that served a
    card's estimate keeps its own route and reason, and differs."""
    report = json.loads(json.dumps(report))
    for key in ("tick_wall_s", "round_wall_s", "platform"):
        report.pop(key, None)
    cpu_route, cpu_reason = CPU_KERNEL_ROUTE
    cpu_key = f"reason={cpu_reason}/route={cpu_route}"
    routes = report.get("kernel_routes", {})
    lacking = routes.get(cpu_key, 0)
    for route in CARD_KERNEL_ROUTES:
        n = routes.pop(f"reason=ok/route={route}", 0)
        if n:
            routes[cpu_key] = routes.get(cpu_key, 0) + n
    if routes:
        report["kernel_routes"] = dict(sorted(routes.items()))
    if "function_duration" in report:
        report["function_duration"] = {
            phase: row["count"] for phase, row in report["function_duration"].items()}
        if "deviceDispatch" in report["function_duration"]:
            report["function_duration"]["deviceDispatch"] -= lacking
    perf_routes = report.get("perf", {}).get("routes")
    if perf_routes is not None:
        for row in perf_routes.values():
            row.pop("utilization", None)
        mapped = sum(perf_routes.pop(route, {}).get("dispatches", 0)
                     for route in CARD_KERNEL_ROUTES + (cpu_route,))
        if mapped:
            perf_routes[cpu_route] = {"dispatches": mapped}
        if FLEET_BATCHED_ROUTE in perf_routes:
            perf_routes[FLEET_BATCHED_ROUTE] = {
                "dispatches": perf_routes[FLEET_BATCHED_ROUTE]["dispatches"]}
        report["perf"]["routes"] = dict(sorted(perf_routes.items()))
    if isinstance(report.get("fleet"), dict):
        report["fleet"].pop("per_tenant_latency_s", None)
    return report


def view_differences(a: dict, b: dict) -> list:
    """Where two ``comparable`` views differ: the first line of the log that
    differs, and each report section that differs with both sides."""
    out = []
    if a["log"] != b["log"]:
        first = next((k for k, (x, y) in enumerate(zip(a["log"], b["log"])) if x != y),
                     min(len(a["log"]), len(b["log"])))
        out.append(f"the decision log differs from line {first}")
    ra, rb = a["report"], b["report"]
    out += [f"report {k}: {ra.get(k)} against {rb.get(k)}"
            for k in sorted(set(ra) | set(rb)) if ra.get(k) != rb.get(k)]
    return out


def drill_summary(result, seconds: float) -> dict:
    """3w's line: latency percentiles, node counts, deletions, the ticks'
    wall times and binder times, and the kernel routes."""
    from autoscaler_tpu_torch.loadgen.score import build_report

    report = build_report(result)
    walls = sorted(r.wall_s for r in result.records)
    binds = sorted(r.bind_s for r in result.records)
    deleted = sum(len(r.scale_downs) for r in result.records)
    return {
        "seconds": round(seconds, 3),
        "ticks": len(result.records),
        "pods_arrived": report["pods_arrived"],
        "bound": report["pending_pod_latency_s"]["bound"],
        "never_bound": report["pending_pod_latency_s"]["never_bound"],
        "latency_s": {k: report["pending_pod_latency_s"][k] for k in ("p50", "p90", "p99", "max")},
        "nodes": report["nodes"],
        "deleted": deleted,
        "tick_wall_s": {"median": walls[len(walls) // 2], "max": walls[-1],
                        "total": round(sum(walls), 3)},
        "bind_s": {"median": binds[len(binds) // 2], "max": binds[-1],
                   "total": round(sum(binds), 3)},
        "kernel_routes": report.get("kernel_routes", {}),
        "scale_ups": [(r.tick, r.scale_ups) for r in result.records if r.scale_ups],
        "errors": [(r.tick, r.errors) for r in result.records if r.errors],
    }


def drill_problems(result, tenth: bool = False) -> list:
    """3w's checks: every pod bound at the group's full size, and at least
    all but ten of the emptied nodes deleted."""
    sz = drill_sizes(tenth)
    out = []
    unbound = sum(1 for _, b in result.pod_latency.values() if b is None)
    if unbound:
        out.append(f"{unbound} pods never bound")
    if result.peak_nodes != sz["nodes"]:
        out.append(f"peak {result.peak_nodes} nodes, not {sz['nodes']}")
    deleted = sum(len(r.scale_downs) for r in result.records)
    if deleted < sz["drop_nodes"] - EMPTY_BULK // (10 if tenth else 1):
        out.append(f"{deleted} empty nodes deleted, fewer than {sz['drop_nodes']} - "
                   f"{EMPTY_BULK // (10 if tenth else 1)}")
    errors = [(r.tick, r.errors) for r in result.records if r.errors]
    if errors:
        out.append(f"errors {errors[:3]}")
    return out


def kernels_by_tick(result) -> list:
    """The kernel routes each tick's perf record dispatched, as
    (tick, {route: dispatches})."""
    out = []
    for rec in result.perf_records:
        routes = Counter(d["route"] for d in rec.get("dispatches", []))
        if routes:
            out.append((rec["tick"], dict(sorted(routes.items()))))
    return out


def fault_problems(result, card: bool) -> list:
    """5e's checks: on a card each faulted tick records the typed error and
    no estimate served below the cuda rung; off it the ladder descends;
    after the clear a half-open probe closes the breaker and the decisions
    flow (tick 3's burst scales up, no rung tripped at the end)."""
    out = []
    faulted = [r for r in result.records if r.tick < 2]
    if card:
        for r in faulted:
            if not any("run_once crashed" in e for e in r.errors):
                out.append(f"tick {r.tick}: no typed error recorded ({r.errors})")
        routes = result.metrics.estimator_kernel_route_total.values
        below = {dict(k).get("route"): v for k, v in routes.items()
                 if dict(k).get("route") not in ("cuda", "cuda_affinity")}
        if below:
            out.append(f"estimates served below the cuda rung: {below}")
    late = [r for r in result.records if r.tick >= 3]
    if not any(r.scale_ups for r in late):
        out.append("no scale-up after the clear")
    if result.records[-1].degraded:
        out.append(f"rungs still tripped at the end: {result.records[-1].degraded}")
    transitions = result.metrics.estimator_breaker_transitions_total
    if transitions.get(rung="cuda" if card else "torch", from_state="half_open",
                       to_state="closed") < (1 if card else 0):
        out.append("no half-open probe closed the cuda rung's breaker")
    return out


def run_fleet(doc: dict, device=None):
    """3x: the fleet drill on ``device`` → (FleetRunResult, seconds)."""
    from autoscaler_tpu_torch.loadgen.fleetdrive import run_fleet_scenario
    from autoscaler_tpu_torch.loadgen.spec import ScenarioSpec

    t0 = time.perf_counter()
    result = run_fleet_scenario(ScenarioSpec.from_dict(json.loads(json.dumps(doc))),
                                device=resolve_device(device))
    return result, time.perf_counter() - t0


def fleet_summary(result, seconds: float) -> dict:
    """3x's line: rounds, answers, routes, batch sizes, the rounds' walls
    and the certificate."""
    from autoscaler_tpu_torch.loadgen.score import build_fleet_report

    report = build_fleet_report(result)
    return {"seconds": round(seconds, 3), "rounds": report["rounds"],
            "answers": report["answers"], "routes": report["fleet"]["routes"],
            "batch_size_hist": report["fleet"]["batch_size_hist"],
            "round_wall_s": report["round_wall_s"], "certified": report["parity"]["certified"],
            "all_match": result.all_match(), "errors": report["error_rounds"]}


# the ranges a profiled tick names: each kernel wrapper's (trace/device.py's
# device_annotation at its launch) and the estimator's cuda rung
KERNEL_RANGES = ("ffd_scan_swar", "ffd_scan_f32", "ffd_scan_aff", "fit_reduce", "fit_reduce_rows")
ESTIMATOR_RANGE = "autoscaler/estimator/cuda"


def session_view(path: str, step: str) -> dict:
    """One tick's exported Chrome trace → which ranges it names, its device
    kernels, and for each kernel range how many kernels ran whose launch
    (the runtime or driver call with the kernel's correlation id) lies
    inside one of the range's spans."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") in KERNEL_RANGES + (ESTIMATOR_RANGE, step):
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e.get("dur", 0)))
    launch_ts = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launch_ts[corr] = e["ts"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    under = {}
    for name in KERNEL_RANGES:
        under[name] = sum(
            1 for k in kernels
            if any(lo <= launch_ts.get((k.get("args") or {}).get("correlation"), -1) <= hi
                   for lo, hi in spans.get(name, ())))
    return {
        "bytes": os.path.getsize(path),
        "ranges": {n: len(v) for n, v in sorted(spans.items())},
        "kernels": len(kernels),
        "kernel_names": sorted({k["name"].split("(")[0][:60] for k in kernels}),
        "uncorrelated_kernels": sum(
            1 for k in kernels
            if (k.get("args") or {}).get("correlation") not in launch_ts),
        "kernels_under_range": {n: c for n, c in under.items() if c},
    }


def profile_sessions(result, base_dir: str, profile_ticks=PROFILE_TICKS) -> list:
    """Each profiled tick's session (``<base_dir>/tick_<trace id>``) →
    [{"tick", "trace_id", "scale_up", "scale_down", **session_view}]."""
    from autoscaler_tpu_torch.trace.device import TRACE_FILE, session_dir

    out = []
    for rec, tr in zip(result.records, result.recorder.traces()):
        if rec.tick not in profile_ticks:
            continue
        step = f"ProfilerStep#{tr.trace_id}"
        path = os.path.join(session_dir(base_dir, tr.trace_id), TRACE_FILE)
        view = session_view(path, step) if os.path.exists(path) else {"missing": path}
        out.append({"tick": rec.tick, "trace_id": tr.trace_id, "step": step,
                    "scale_up": bool(rec.scale_ups), "scale_down": bool(rec.scale_downs),
                    **view})
    return out


def session_problems(sessions: list) -> list:
    """3y's checks: every tick's session names its step; the scale-up tick
    names K2's range, K4's and the estimator's cuda range; the scale-down
    tick names K4's."""
    out = []
    for s in sessions:
        if "missing" in s:
            out.append(f"tick {s['tick']}: no session at {s['missing']}")
            continue
        want = [s["step"], "fit_reduce"]
        if s["scale_up"]:
            want += ["ffd_scan_swar", ESTIMATOR_RANGE]
        missing = [n for n in want if not s["ranges"].get(n)]
        if missing:
            out.append(f"tick {s['tick']}: the session names no {missing}")
    if not any(s.get("scale_up") for s in sessions) or not any(
            s.get("scale_down") for s in sessions):
        out.append("the profiled ticks hold no scale-up or no scale-down")
    return out


def tune_ledger(suite_doc: dict, device=None, workers: int = 2, generations: int = 1,
                population: int = 2, seed: int = 0) -> str:
    """4s: ``python -m autoscaler_tpu_torch.gym tune`` over ``suite_doc`` on
    ``device``, in process → the tuning ledger's text."""
    import os
    import tempfile

    from autoscaler_tpu_torch.gym.cli import main as gym_main

    with tempfile.TemporaryDirectory() as d:
        suite = os.path.join(d, "suite.json")
        ledger = os.path.join(d, "tune.jsonl")
        with open(suite, "w") as f:
            json.dump(suite_doc, f)
        rc = gym_main(["tune", suite, "--generations", str(generations), "--population",
                       str(population), "--seed", str(seed), "--workers", str(workers),
                       "--ledger", ledger, "--device", str(resolve_device(device))])
        if rc != 0:
            raise RuntimeError(f"gym tune exited {rc}")
        with open(ledger) as f:
            return f.read()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--tenth", action="store_true", help="4r's size: 100 nodes, 3 000 pods")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    result, seconds = run_drill(drill_doc(args.tenth), dev)
    print(json.dumps(drill_summary(result, seconds), sort_keys=True), flush=True)
    problems = drill_problems(result, args.tenth)
    fleet, fleet_s = run_fleet(fleet_doc(), dev)
    print(json.dumps({"fleet_s": round(fleet_s, 3), "all_match": fleet.all_match()}), flush=True)
    if not fleet.all_match():
        problems.append("fleet drill: not every answer matched its solo dispatch")
    for p in problems:
        print(f"FAIL: {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
