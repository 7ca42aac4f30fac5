"""The port's resident arena (``snapshot/arena.py``, ``ops/arena_apply.py``)
against the JAX package's, on the CPU.

The three scatters against ``autoscaler_tpu/ops/arena_apply.py`` on padded
batches; ``DeviceArena`` driven by both packages' incremental packers over
the same updates (its stats after every update and the served tensors
equal); the idle tick, promotions, an injected fault with its cold tick,
reseed and aux resend; the copy-on-write rule under a caller that holds a
served tensor or a view of one; the delta ladder, the bucket grammar and
prewarm's call count; and ``OperandArena`` on its own and under the
estimator and the orchestrator. Tolerance 0 throughout.
"""
import numpy as np
import pytest
import torch

import autoscaler_tpu.ops.arena_apply as jaa
import autoscaler_tpu.snapshot.arena as jarena
import autoscaler_tpu_torch.cloudprovider.test_provider as tprov
import autoscaler_tpu_torch.clusterstate.registry as treg
import autoscaler_tpu_torch.config.options as topts
import autoscaler_tpu_torch.core.scaleup.orchestrator as torch_orch
import autoscaler_tpu_torch.ops.arena_apply as taa
import autoscaler_tpu_torch.snapshot.arena as tarena
import autoscaler_tpu_torch.utils.test_utils as ttu
from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
from autoscaler_tpu_torch.fleet.buckets import BucketError
from test_torch_incremental import SIDES, TwinWorld, scripted
from torch_parity import assert_bits_equal, canon, port_world

GB, MB = ttu.GB, ttu.MB


def _padded(rng, n, k, real):
    """A batch of k indices into an axis of n: ``real`` unique real ones,
    sorted, then padding (index n)."""
    idx = np.full(k, n, np.int32)
    idx[:real] = np.sort(rng.choice(n, real, replace=False))
    return idx


@pytest.mark.parametrize("kind", ["rows_f32", "vec_bool", "vec_i32", "cols_bool", "cols_i32"])
def test_scatters_match_jax_on_padded_batches(kind):
    rng = np.random.default_rng(len(kind))
    n, k, real = 40, 16, 11
    if kind == "rows_f32":
        buf = rng.standard_normal((n, 6)).astype(np.float32)
        idx, payload = _padded(rng, n, k, real), rng.standard_normal((k, 6)).astype(np.float32)
        jfn, tfn = jaa.arena_scatter_rows, taa.arena_scatter_rows
    elif kind.startswith("vec"):
        dt = bool if kind == "vec_bool" else np.int32
        buf = rng.integers(0, 2 if dt is bool else 99, n).astype(dt)
        idx, payload = _padded(rng, n, k, real), rng.integers(0, 2 if dt is bool else 99, k).astype(dt)
        jfn, tfn = jaa.arena_scatter_vec, taa.arena_scatter_vec
    else:
        dt = bool if kind == "cols_bool" else np.int32
        buf = rng.integers(0, 2 if dt is bool else 99, (7, n)).astype(dt)
        idx = _padded(rng, n, k, real)
        payload = rng.integers(0, 2 if dt is bool else 99, (7, k)).astype(dt)
        jfn, tfn = jaa.arena_scatter_cols, taa.arena_scatter_cols
    want = np.asarray(jfn(np.array(buf), idx, payload))
    t = torch.tensor(buf)
    got = tfn(t, idx, payload)
    assert got is t                                      # written in place
    assert_bits_equal(want, got)
    # the same batch as torch tensors (int32 indices on the host) agrees too
    t2 = torch.tensor(buf)
    assert_bits_equal(want, tfn(t2, torch.tensor(idx), torch.tensor(payload)))


def test_kernel_contracts_match_jax():
    assert taa.KERNEL_CONTRACTS == jaa.KERNEL_CONTRACTS


def test_delta_ladder_and_bucket_grammar_match_jax():
    for k in (0, 1, 7, 8, 9, 63, 64, 65, 511, 512, 513, 40_000):
        assert tarena.delta_bucket(k) == jarena.delta_bucket(k), k
    for axis in (1, 8, 9, 64, 100, 16_384, 262_144):
        assert tarena.delta_ladder(axis) == jarena.delta_ladder(axis), axis
    for spec in ("64x16x8,1024x256x8", "8x8x8"):
        assert [b.key for b in tarena.parse_arena_buckets(spec)] == [
            b.key for b in jarena.parse_arena_buckets(spec)]
    for bad in ("63x16x8", "64x16", ""):
        with pytest.raises(BucketError, match="--arena-buckets"):
            tarena.parse_arena_buckets(bad)


@pytest.mark.parametrize("dense", [None, False])
def test_prewarm_walks_the_jax_ladder(dense):
    spec = "64x16x8,128x32x8"
    want = jarena.DeviceArena(buckets=spec).prewarm(6, dense=dense)
    arena = tarena.DeviceArena(buckets=spec, device="cpu")
    assert arena.prewarm(6, dense=dense) == want
    assert arena.take_stats() == tarena._zero_stats()    # prewarm is no apply


def _stats_equal(w):
    def compare(_out):
        jstats = w.packers["jax"].arena.take_stats()
        tstats = w.packers["torch"].arena.take_stats()
        assert tstats == jstats, (w.checks, tstats, jstats)
        w.stats.append(tstats)
    w.stats = []
    w.on_check = compare


@pytest.mark.parametrize("dense", [True, False])
def test_arena_stats_and_tensors_match_jax(dense):
    """Both packages' packers with an arena each over the fourteen scripted
    updates (seeds, scatters, aux uploads, promotions at the schema change
    and the bucket growth): served tensors equal row for row after every
    update, stats equal update for update."""
    w = TwinWorld(dense=dense, arena=True)
    _stats_equal(w)
    scripted(w)
    stats = w.stats
    assert len(stats) == 14
    assert [s["promotions"] for s in stats].count(1) == 3
    # promotion (the packer's full rebuild) is the only full upload
    assert [s["full_uploads"] > 0 for s in stats] == [s["promotions"] > 0 for s in stats]
    assert sum(s["rollbacks"] for s in stats) == 0
    assert sum(s["delta_rows"] for s in stats) > 0
    if not dense:
        assert sum(s["aux_uploads"] for s in stats) > 0


@pytest.mark.parametrize("dense", [True, False])
def test_fault_serves_cold_then_reseeds_as_jax(dense):
    """An injected fault on one apply: that tick is served from a cold
    upload on the packer's own device, equal to the JAX twin; the next
    apply reseeds (a rollback, full uploads) and resends every aux field."""
    w = TwinWorld(dense=dense, arena=True)
    _stats_equal(w)
    for i in range(4):
        w.node(f"n{i}", cpu_m=4000, mem=8 * GB)
    for i in range(12):
        w.pod(f"p{i}", f"n{i % 4}" if i % 3 else "", cpu_m=100, mem=128 * MB)
    w.check()
    w.pod("p1", "n2", cpu_m=700, mem=GB)
    w.check()
    shots = {"jax": ["boom"], "torch": ["boom"]}
    for s in SIDES:
        w.packers[s.name].arena.fault_hook = lambda name=s.name: (
            shots[name].pop() if shots[name] else None)
    w.pod("p2", "n3", cpu_m=900, mem=GB)
    faulted, _ = w.check()
    assert faulted.pod_req.device.type == "cpu"
    w.pod("p3", "", cpu_m=300, mem=GB)
    w.check()
    w.check()
    fault, recovery, idle = w.stats[2], w.stats[3], w.stats[4]
    assert fault["rollbacks"] == 1 and fault["full_uploads"] == 0
    assert recovery["rollbacks"] == 1 and recovery["full_uploads"] > 0
    assert recovery["aux_uploads"] == (0 if dense else 6)
    assert idle == {**tarena._zero_stats(), "applies": 1}


def test_idle_update_serves_the_same_tensors():
    w = TwinWorld(dense=False, arena=True)
    for i in range(3):
        w.node(f"n{i}", cpu_m=4000, mem=8 * GB)
    for i in range(6):
        w.pod(f"p{i}", f"n{i % 3}", cpu_m=100, mem=128 * MB)
    w.check()
    w.pod("p0", "n1", cpu_m=200, mem=128 * MB)
    t1, _ = w.check()
    w.check()                           # replays the pending op on the lagging side
    t3, _ = w.check()                   # nothing changed anywhere: idle
    t4, _ = w.check()
    assert t4.pod_req is t3.pod_req and t4.class_mask is t3.class_mask
    assert w.packers["torch"].arena.take_stats()["applies"] == 4 + 1


def _arena_with(n=8):
    arena = tarena.DeviceArena(device="cpu")
    host = {"pod_req": np.zeros((n, 2), np.float32)}
    arena.apply(tarena.DeltaProgram(host=host, reseed=True))
    return arena, host


def _step(arena, host, row, value):
    host["pod_req"][row] = value
    op = tarena.DeltaOp("pod_req", 0, np.array([row], np.int32), host["pod_req"][[row]])
    return arena.apply(tarena.DeltaProgram(host=host, ops=[op]))["pod_req"]


@pytest.mark.parametrize("hold", ["nothing", "tensor", "view", "numpy"])
def test_held_served_tensor_keeps_its_values(hold):
    """The sole-owner rule: a generation's buffer is written in place only
    when nothing outside the arena holds it. A caller holding a served
    tensor, a view of it or a numpy alias across two applies still reads
    the values it was served; with nothing held the scatter reuses the
    buffer (no clone)."""
    arena, host = _arena_with()
    _step(arena, host, 1, 1.0)
    _step(arena, host, 2, 2.0)          # both generations owe nothing now
    served = _step(arena, host, 3, 3.0)
    ptr = served.data_ptr()
    held = {"nothing": None, "tensor": served, "view": served[2:5],
            "numpy": served.numpy()}[hold]
    expect = None if held is None else torch.as_tensor(held).clone()
    del served
    _step(arena, host, 4, 4.0)
    again = _step(arena, host, 5, 5.0)  # the generation served three applies ago
    if hold == "nothing":
        assert arena.clones == 0 and again.data_ptr() == ptr
    else:
        assert arena.clones == 1 and again.data_ptr() != ptr
        assert torch.equal(torch.as_tensor(held), expect)
    assert again[:, 0].tolist() == [0, 1, 2, 3, 4, 5, 0, 0]


def test_unported_arena_options_raise():
    """Nothing of the arena is refused since the perf observatory was
    ported: ``observatory=`` is taken, and prewarm's scatters reach it as
    the JAX package's do — the same routes, signatures, cache verdicts and
    compile-cache counts, at 0 s of wall under one synthetic clock."""
    import autoscaler_tpu.metrics.metrics as jmetrics
    import autoscaler_tpu.perf as jperf
    import autoscaler_tpu_torch.metrics.metrics as tmetrics
    import autoscaler_tpu_torch.perf as tperf

    metrics = tmetrics.AutoscalerMetrics()
    assert tarena.DeviceArena(device="cpu", metrics=metrics).metrics is metrics
    lines = []
    for arena_mod, perf_mod, metrics_mod, kw in (
        (jarena, jperf, jmetrics, {}), (tarena, tperf, tmetrics, {"device": "cpu"}),
    ):
        m = metrics_mod.AutoscalerMetrics()
        obs = perf_mod.PerfObservatory(metrics=m)
        arena = arena_mod.DeviceArena(buckets="16x8x8", observatory=obs, metrics=m,
                                      clock=lambda: 0.0, **kw)
        obs.begin_tick(0, 0.0)
        calls = arena.prewarm(R=6)
        rec = obs.end_tick()
        assert arena.observatory is obs
        lines.append((calls, [(d["route"], d["sig"], d["cache"], d["operand_bytes"])
                              for d in rec["dispatches"]],
                      sorted(m.kernel_compile_cache_total.values.items())))
    assert lines[0] == lines[1] and lines[1][0] > 0


def test_operand_arena_hits_by_content_and_device():
    oa = tarena.OperandArena(max_entries=2, device="cpu")
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    first = oa.resident(a)
    assert oa.resident(a.copy()) is first                       # same bytes: a hit
    assert oa.resident(a.astype(np.float64)) is not first       # another dtype
    meta = oa.resident(a, device="meta")                         # another device
    assert meta.device.type == "meta" and first.device.type == "cpu"
    assert oa.stats() == {"hits": 1, "misses": 3, "entries": 2}
    a[0, 0] = 99.0                                               # a copy, not an alias
    assert float(first[0, 0]) == 0.0
    # the LRU of two keeps the f64 copy and the meta one; the first is out
    assert oa.device_bytes() == 6 * 8 + meta.nbytes


def test_estimator_with_an_operand_arena_gives_the_same_estimates():
    pods, templates = port_world(ttu, 120, ports=2)
    plain = BinpackingNodeEstimator(device="cpu").estimate_many(pods, templates)
    oa = tarena.OperandArena(device="cpu")
    est = BinpackingNodeEstimator(device="cpu", operand_arena=oa)
    first = est.estimate_many(pods, templates)
    misses = oa.stats()["misses"]
    second = est.estimate_many(pods, templates)
    assert canon(first) == canon(plain) == canon(second)
    assert misses > 0 and oa.stats()["misses"] == misses and oa.stats()["hits"] >= misses


def test_orchestrator_threads_the_operand_arena():
    provider = tprov.TestCloudProvider()
    provider.add_node_group("g", 0, 5, 0, ttu.build_test_node("t", cpu_m=1000, mem=2 * GB))
    opts = topts.AutoscalingOptions()
    oa = tarena.OperandArena(device="cpu")
    orch = torch_orch.ScaleUpOrchestrator(provider, opts, treg.ClusterStateRegistry(provider, opts),
                                          device="cpu", operand_arena=oa)
    assert orch.estimator.operand_arena is oa
    pods = [ttu.build_test_pod(f"p{i}", cpu_m=400 + 10 * i) for i in range(5)]
    res = orch.scale_up(pods, [], 1.0)
    assert res.scaled_up and res.chosen_group == "g" and res.new_nodes == 3
    assert oa.stats()["misses"] > 0
