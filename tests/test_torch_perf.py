"""The port's perf observatory (autoscaler_tpu_torch/perf/) against the
JAX package's, on the CPU.

The cases of tests/test_perf.py — shape signatures, operand bytes, the
residency ledger, the ledger's schema, validation and summary, the
observatory's cold/warm split, pending-call hygiene, ring and queries, and
run_once's per-tick record — run on both packages with the cost model
off: every record, line and value equal. The port's cost model is checked
on its own: a pure function of the call's shapes, its bytes the operands'
plus the outputs'. Two replays of the same ticks under a synthetic clock
write byte-identical perf ledgers, equal to the JAX package's under the
route name map.
"""
import json

import numpy as np
import pytest
import torch

import autoscaler_tpu.metrics.metrics as jmetrics
import autoscaler_tpu.perf as jperf
import autoscaler_tpu_torch.metrics.metrics as tmetrics
import autoscaler_tpu_torch.perf as tperf
from autoscaler_tpu_torch.ops import ffd_scan
from autoscaler_tpu_torch.ops.binpack import ffd_binpack_groups, ffd_binpack_groups_affinity
from test_torch_static_autoscaler import JAX, TORCH, CLOCK, build_world, tick
from torch_parity import port_label

PKGS = pytest.mark.parametrize("perf", [jperf, tperf], ids=["jax", "torch"])
GB = 1024**3


class FakeSpan:
    def __init__(self):
        self.attrs = {}

    def set_attrs(self, **kw):
        self.attrs.update(kw)


def kernel(*args, **kwargs):
    return None


def dispatch(obs, args, route="xla_scan", wall=0.01, span=None):
    obs.clear_pending()
    obs.note_kernel(kernel, args, {})
    obs.on_dispatch(route, wall, span=span)


def both(fn):
    """``fn(perf, metrics module)`` on each package → (jax, torch)."""
    return fn(jperf, jmetrics), fn(tperf, tmetrics)


# -- signatures, operand bytes, residency


def test_shape_signature_matches_jax_on_numpy_and_torch():
    a = np.zeros((8, 6), np.float32)
    b = np.zeros((1, 8), bool)
    for args, kwargs in (((a, b), {"max_nodes": 16, "caps": a}),
                         ((a, (b, None)), {"spread": (a, b), "flag": True, "name": "x"}),
                         ((np.zeros((), np.int32),), {})):
        ref = jperf.shape_signature(args, kwargs)
        assert tperf.shape_signature(args, kwargs) == ref
        as_torch = tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in args)
        assert tperf.shape_signature(as_torch, kwargs) == ref
    assert "8x6:float32" in ref or "scalar:int32" in ref
    s1 = tperf.shape_signature((a, b), {"max_nodes": 16, "caps": a})
    assert s1 == tperf.shape_signature((a, b), {"caps": a, "max_nodes": 16})
    assert s1 != tperf.shape_signature((a, b), {"caps": a, "max_nodes": 32})


def test_operand_bytes_counts_nested_leaves():
    a = np.zeros((4, 4), np.float32)   # 64 B
    b = np.zeros((8,), np.int32)       # 32 B
    args, kwargs = (a, (b, b)), {"k": a, "s": 3}
    assert tperf.operand_bytes(args, kwargs) == jperf.operand_bytes(args, kwargs) == 192
    assert tperf.operand_bytes((torch.zeros(4, 4),), {"k": torch.zeros(8, dtype=torch.int32)}) == 96


@PKGS
def test_residency_set_drop_and_pool_sums(perf):
    led = perf.ResidencyLedger()
    led.set("snapshot", "packer", 720)
    led.set("snapshot", "extra", 80)
    led.set("kernel_operands", "dispatch", 228)
    assert led.pool_bytes("snapshot") == 800
    led.drop("snapshot", "extra")
    assert led.snapshot() == {"kernel_operands": 228, "snapshot": 720}


def test_residency_gauge_feed_matches_jax():
    def run(perf, metrics_mod):
        m = metrics_mod.AutoscalerMetrics()
        led = perf.ResidencyLedger(metrics=m)
        led.set(perf.POOL_SNAPSHOT, "packer", 1024)
        up = m.device_resident_bytes.get(pool=perf.POOL_SNAPSHOT)
        led.drop(perf.POOL_SNAPSHOT, "packer")
        return up, m.registry.expose()
    ref, out = both(run)
    assert out == ref and out[0] == 1024.0
    assert (tperf.POOL_SNAPSHOT, tperf.POOL_KERNEL_OPERANDS, tperf.POOL_SCENARIO_BATCHES,
            tperf.POOL_ARENA) == (jperf.POOL_SNAPSHOT, jperf.POOL_KERNEL_OPERANDS,
                                  jperf.POOL_SCENARIO_BATCHES, jperf.POOL_ARENA)


@PKGS
def test_array_bytes_nested(perf):
    a = np.zeros((4,), np.float32)
    assert perf.array_bytes([a, {"x": a}, (a,)]) == 48
    assert perf.array_bytes(None) == 0


# -- the ledger


def tick_rec(perf, tick, dispatches=()):
    return {"schema": perf.SCHEMA, "tick": tick, "now_ts": 1000.0 + tick,
            "dispatches": list(dispatches), "resident_bytes": {"snapshot": 720}}


def disp(route="xla_scan", sig="8x6:f32", cache="hit", s=0.001):
    return {"route": route, "sig": sig, "cache": cache, "cold": cache == "miss",
            "dispatch_s": s, "operand_bytes": 128}


LEDGERS = {
    "valid": lambda p: [tick_rec(p, 0, [disp(cache="miss")]), tick_rec(p, 1, [disp()])],
    "schema-and-order": lambda p: [tick_rec(p, 3), {**tick_rec(p, 3), "schema": "nope"}],
    "steady-state-miss": lambda p: [tick_rec(p, 0, [disp(cache="miss")]),
                                    tick_rec(p, 1, [disp()]),
                                    tick_rec(p, 2, [disp(cache="miss")])],
    "truncated": lambda p: [tick_rec(p, 5, [disp()])],
    "distinct-sigs": lambda p: [tick_rec(p, 0, [disp(sig="a", cache="miss")]),
                                tick_rec(p, 1, [disp(sig="b", cache="miss")])],
    "cold-disagrees": lambda p: [tick_rec(p, 0, [{**disp(cache="miss"), "cold": False}])],
    "arena": lambda p: [{**tick_rec(p, 0), "arena": {"full_uploads": 3}},
                        {**tick_rec(p, 1), "arena": {"full_uploads": 2, "delta_rows": 4}},
                        {**tick_rec(p, 2), "arena": {"bogus": 1}}],
    "split": lambda p: [tick_rec(p, 0, [disp(cache="miss", s=0.5)]),
                        tick_rec(p, 1, [disp(s=0.001),
                                        disp(route="native", sig="", cache="miss", s=0.002)])],
}


@pytest.mark.parametrize("ledger", sorted(LEDGERS))
def test_ledger_validation_and_summary_match_jax(ledger, tmp_path):
    recs = LEDGERS[ledger](tperf)
    assert tperf.SCHEMA == jperf.SCHEMA
    assert tperf.validate_records(recs) == jperf.validate_records(recs)
    assert tperf.summarize(recs) == jperf.summarize(recs)
    for rec in recs:
        assert tperf.record_line(rec) == jperf.record_line(rec)
    path = tmp_path / "perf.jsonl"
    assert tperf.dump_jsonl(recs, str(path)) == len(recs)
    assert tperf.load_jsonl(str(path)) == jperf.load_jsonl(str(path)) == json.loads(
        "[" + ",".join(path.read_text().splitlines()) + "]")
    if ledger == "valid":
        assert tperf.validate_records(recs) == []
    if ledger == "steady-state-miss":
        assert "compile-on-steady-state-tick" in tperf.validate_records(recs)[0]


# -- the observatory


def test_cold_then_warm_split_and_span_attrs():
    def run(perf, metrics_mod):
        m = metrics_mod.AutoscalerMetrics()
        obs = perf.PerfObservatory(metrics=m)
        obs.begin_tick(0, 1000.0)
        args = (np.zeros((8, 6), np.float32),)
        spans = FakeSpan(), FakeSpan()
        dispatch(obs, args, wall=0.5, span=spans[0])
        dispatch(obs, args, wall=0.01, span=spans[1])
        rec = obs.end_tick()
        return rec, [s.attrs for s in spans], m.registry.expose()
    ref, out = both(run)
    assert out == ref
    rec, (cold, warm), _ = out
    assert cold["cache"] == "miss" and cold["shape_sig"] == "8x6:float32"
    assert warm["execute_est_s"] == 0.01 and warm["compile_est_s"] == pytest.approx(0.49)
    assert rec["resident_bytes"][tperf.POOL_KERNEL_OPERANDS] == 192


OBS_CASES = {
    # each: (perf) -> records and observations; mirrors a TestObservatory case
    "cold-per-signature": lambda p, o: (
        o.begin_tick(0, 0.0),
        dispatch(o, (np.zeros((8, 6), np.float32),)),
        dispatch(o, (np.zeros((16, 6), np.float32),)),
        o.end_tick()),
    "stale-pending": lambda p, o: (
        o.begin_tick(0, 0.0),
        o.note_kernel(kernel, (np.zeros((8, 6), np.float32),), {}),
        o.clear_pending(),
        o.on_dispatch("native", 0.001),
        o.end_tick()),
    "clear-keeps-served": lambda p, o: (
        o.begin_tick(0, 0.0),
        dispatch(o, (np.zeros((8, 6), np.float32),)),
        o.clear_pending(),
        o.end_tick()),
    "idle-tick": lambda p, o: (
        o.begin_tick(0, 0.0),
        dispatch(o, (np.zeros((8, 6), np.float32),)),
        o.end_tick(),
        o.begin_tick(1, 1.0),
        o.end_tick()),
    "no-open-tick": lambda p, o: (
        o.end_tick(), o.last_record(),
        dispatch(o, (np.zeros((2,), np.float32),)),
        o.records(),
        o.begin_tick(0, 0.0),
        dispatch(o, (np.zeros((2,), np.float32),)),
        o.end_tick()),
    "arena-stats": lambda p, o: (
        o.note_arena({"delta_rows": 3}),
        o.begin_tick(0, 0.0),
        o.note_arena({"delta_rows": 3, "full_uploads": 0}),
        o.note_arena({"delta_rows": 2, "promotions": 1}),
        o.note_arena({"applies": 0}),
        o.end_tick()),
}


@pytest.mark.parametrize("case", sorted(OBS_CASES))
def test_observatory_cases_match_jax(case):
    def run(perf, metrics_mod):
        m = metrics_mod.AutoscalerMetrics()
        obs = perf.PerfObservatory(metrics=m)
        steps = OBS_CASES[case](perf, obs)
        return steps, obs.records(), obs.list_json(), m.registry.expose()
    ref, out = both(run)
    assert out == ref
    records = out[1]
    if case == "stale-pending":
        assert records[0]["dispatches"][0]["sig"] == ""
        assert tperf.POOL_KERNEL_OPERANDS not in records[0]["resident_bytes"]
    if case == "idle-tick":
        assert tperf.POOL_KERNEL_OPERANDS not in records[1]["resident_bytes"]
    if case == "no-open-tick":
        assert records[0]["dispatches"][0]["cache"] == "hit"


def test_ring_bounded_and_queries():
    def run(perf, metrics_mod):
        obs = perf.PerfObservatory(ring_capacity=2)
        for i in range(4):
            obs.begin_tick(i, float(i))
            obs.end_tick()
        return ([r["tick"] for r in obs.records()], obs.list_json(), obs.detail_json(3),
                obs.detail_json(0), obs.summaries())
    ref, out = both(run)
    assert out == ref and out[0] == [2, 3] and out[3] is None


# -- the cost model (the port's own: no AOT compile to ask)


def plain_call(P=64, G=3, R=6, M=16):
    rng = np.random.default_rng(P + G)
    req = torch.tensor(rng.integers(1, 9, (P, R)).astype(np.float32))
    masks = torch.tensor(rng.random((G, P)) > 0.2)
    allocs = torch.full((G, R), 64.0)
    caps = torch.full((G,), M, dtype=torch.int32)
    return (req, masks, allocs), {"max_nodes": M, "node_caps": caps}


def test_cost_model_is_a_pure_function_of_the_shapes():
    args, kwargs = plain_call()
    first = tperf.analyze_cost("torch_scan", args, kwargs)
    other = (torch.rand_like(args[0]) * 100, ~args[1], args[2] * 3)
    assert tperf.analyze_cost("torch_scan", other, kwargs) == first
    bigger = tperf.analyze_cost("torch_scan", *plain_call(P=128))
    assert bigger["flops"] == 2 * first["flops"]


def test_cost_model_bytes_are_the_operands_plus_the_outputs():
    args, kwargs = plain_call(P=64, G=3, R=6, M=16)
    cost = tperf.analyze_cost("torch_scan", args, kwargs)
    outputs = 3 * 4 + 3 * 64 + 3 * 16 * 6 * 4    # node_count, scheduled, node_used
    assert cost["bytes_accessed"] == tperf.operand_bytes(args, kwargs) + outputs
    assert cost["flops"] == 3 * 64 * 16 * 6       # every fit test × R compares
    res = ffd_binpack_groups(*args, **kwargs)
    assert sum(t.nbytes for t in res) == outputs


def test_cost_model_on_each_route():
    args, kwargs = plain_call(P=64, G=3, R=6, M=16)
    plan = ffd_scan.plan_scan(args[0], args[2])
    swar = tperf.analyze_cost("cuda", args, {**kwargs, "scan_plan": plan})
    assert plan.plan is not None
    assert swar["flops"] == 3 * 64 * 16 * plan.planes * 4
    f32_plan = plan._replace(plan=None)
    assert tperf.analyze_cost("cuda", args, {**kwargs, "scan_plan": f32_plan})["flops"] == (
        3 * 64 * 16 * len(plan.keep))
    T, S = 40, 5
    aff_kw = {**kwargs, "match": torch.zeros(T, 64, dtype=torch.bool),
              "aff_of": torch.zeros(T, 64, dtype=torch.bool),
              "anti_of": torch.zeros(T, 64, dtype=torch.bool),
              "node_level": torch.zeros(T, dtype=torch.bool),
              "has_label": torch.zeros(3, T, dtype=torch.bool),
              "spread": (torch.zeros(64, S, dtype=torch.bool),)}
    for route in ("cuda_affinity", "torch_scan"):
        cost = tperf.analyze_cost(route, args, aff_kw)
        assert cost["flops"] == 3 * 64 * 16 * (6 + 2 + S)
    single = tperf.analyze_cost("torch_single", (args[0], args[1][0], args[2][0]),
                                {"max_nodes": 16, "node_cap": torch.tensor(4)})
    assert single["flops"] == 64 * 16 * 6
    for route in ("torch_runs", "native", "python_ref", "arena_rows"):
        assert tperf.analyze_cost(route, args, kwargs) is None
    assert tperf.analyze_cost("cuda_affinity", args, kwargs) is None
    assert ffd_binpack_groups_affinity.__wrapped__.__name__ == "ffd_binpack_groups_affinity"


def test_default_peak_flops_names_the_card():
    assert tperf.default_peak_flops("cuda:0") == 67e12
    assert tperf.default_peak_flops("cpu") == tperf.costmodel.NOMINAL_CPU_PEAK_OPS_PER_S > 0


def test_cost_model_feeds_the_records_and_the_utilization():
    obs = tperf.PerfObservatory(cost_model=True, peak_flops=1e9)
    args, kwargs = plain_call()
    obs.begin_tick(0, 0.0)
    for wall in (0.5, 0.01):
        obs.clear_pending()
        obs.note_kernel(ffd_binpack_groups, args, kwargs)
        obs.on_dispatch("torch_scan", wall, span=FakeSpan())
    rec = obs.end_tick()
    cost = tperf.analyze_cost("torch_scan", args, kwargs)
    assert rec["dispatches"][0]["cost"] == dict(sorted(cost.items()))
    assert rec["dispatches"][1]["utilization"] == round(cost["flops"] / (0.01 * 1e9), 9)
    assert tperf.validate_records([rec]) == []


# -- run_once: one record a tick, byte-identical replays


def perf_world(k, **opt_kw):
    pods = [k.tu.build_test_pod(f"p{i}", cpu_m=600 + i, mem=GB) for i in range(4)]
    return build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 1}, pods, **opt_kw)


def perf_ledger(k, **opt_kw):
    """Three ticks under the synthetic clock → the perf ledger's lines (the
    JAX package's routes under the name map)."""
    w = perf_world(k, **opt_kw)
    for now in (0.0, 10.0, 20.0):
        tick(w, now)
    lines = []
    for rec in w.sa.observatory.records():
        rec = json.loads(json.dumps(rec))
        if k is JAX:
            for d in rec["dispatches"]:
                d["route"] = port_label("route", d["route"])
        lines.append(tperf.record_line(rec))
    return w, lines


@pytest.mark.parametrize("arena", [False, True], ids=["cold", "arena"])
def test_two_replays_write_byte_identical_perf_ledgers(arena):
    w1, first = perf_ledger(TORCH, arena_enabled=arena)
    _, second = perf_ledger(TORCH, arena_enabled=arena)
    _, ref = perf_ledger(JAX, arena_enabled=arena)
    assert first == second == ref
    records = w1.sa.observatory.records()
    assert len(records) == 3 and tperf.validate_records(records) == []
    # the arena holds the snapshot's tensors when it is on
    pool = tperf.POOL_ARENA if arena else tperf.POOL_SNAPSHOT
    assert records[0]["dispatches"] and records[0]["resident_bytes"][pool] > 0


def test_crashed_tick_still_closes_its_record(monkeypatch):
    w = perf_world(TORCH)

    def boom(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(w.sa, "_run_once_traced", boom)
    CLOCK["now"] = 0.0
    with pytest.raises(RuntimeError):
        w.sa.run_once(now_ts=0.0)
    assert w.sa.observatory.last_record() is not None


def test_tick_record_carries_the_dispatch_telemetry():
    """tests/test_perf.py's run_once case with the cost model on: the
    scale-up tick's record holds its dispatch (cold, signed, with the
    model's figures), the snapshot's bytes, and the deviceDispatch span
    its telemetry; the perfRecord span is in the tick's tree."""
    w = perf_world(TORCH, perf_cost_model=True)
    tick(w, 0.0)
    rec = w.sa.observatory.last_record()
    d = rec["dispatches"][0]
    assert d["route"] == "torch_scan" and d["cache"] == "miss" and d["sig"]
    assert d["cost"]["flops"] > 0 and d["cost"]["bytes_accessed"] > d["operand_bytes"] > 0
    spans = [s for t in w.sa.tracer.recorder.traces() for s in t.spans]
    served = [s for s in spans if s.name == "deviceDispatch" and s.attrs.get("outcome") == "ok"]
    assert served and all("cache" in s.attrs for s in served)
    assert any("model_flops" in s.attrs for s in served)
    assert "perfRecord" in {s.name for s in spans}
