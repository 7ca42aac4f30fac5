"""The port's greedy scheduler and spread schedule context
(autoscaler_tpu_torch/ops/schedule.py, snapshot/affinity.py) against the
JAX package's, on the same worlds: each package builds its own objects
from one numpy-seeded generator, packs them (dense mask, or factored with
``packer.DENSE_MASK_CELL_LIMIT`` lowered at call time) and runs
``greedy_schedule`` (an XLA scan on the JAX side, a torch loop here) on
the same pod slots and hints. Tolerance 0: placements, destinations and
every context array are compared bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.ops.schedule as jsch
import autoscaler_tpu.snapshot.affinity as jaff
import autoscaler_tpu.snapshot.packer as jpack
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.ops.schedule as tsch
import autoscaler_tpu_torch.snapshot.affinity as taff
import autoscaler_tpu_torch.snapshot.packer as tpack
import autoscaler_tpu_torch.snapshot.tensors as ttens
import autoscaler_tpu_torch.utils.test_utils as ttu
from torch_parity import assert_bits_equal, mask_world, to_np

JAX = (jtu, jobj)
TORCH = (ttu, tobj)
K_SLOTS = 32          # every world's slot list is padded to this (one XLA shape)
HOSTNAME = "kubernetes.io/hostname"


def spread_world(pkg, seed):
    """mask_world with DoNotSchedule spread on pending pods: over "zone"
    (maxSkew 1, some with minDomains 4 > the 3 zones, some Honor-ing
    taints, some ignoring node affinity, some with matchLabelKeys) and
    over the hostname; one node has no zone label (domain -1)."""
    tu, obj = pkg
    nodes, pods, _ = mask_world(tu, obj, seed)
    del nodes[-1].labels["zone"]
    for i, pod in enumerate(pods):
        if pod.node_name or i % 3 == 2:
            continue
        key = "zone" if i % 2 == 0 else HOSTNAME
        kw = {}
        if i % 7 == 0:
            kw["min_domains"] = 4
        if i % 5 == 1:
            kw["node_taints_policy"] = "Honor"
        if i % 11 == 3:
            kw["node_affinity_policy"] = "Ignore"
        if i % 13 == 4:
            kw["match_label_keys"] = ("app",)
        pod.topology_spread = (obj.TopologySpreadConstraint(
            max_skew=1, topology_key=key,
            selector=obj.LabelSelector.from_dict({"app": pod.labels["app"]}), **kw,
        ),)
    return nodes, pods


def world(name, pkg):
    if name.startswith("spread"):
        return spread_world(pkg, int(name[6:]))
    nodes, pods, _ = mask_world(*pkg, int(name[4:]))
    return nodes, pods


def packed(name, form, monkeypatch):
    """Both packages' (tensors, meta) of a world; "factored" lowers both
    packers' dense-cell limit so the default pack goes factored."""
    if form == "factored":
        monkeypatch.setattr(jpack, "DENSE_MASK_CELL_LIMIT", 64)
        monkeypatch.setattr(tpack, "DENSE_MASK_CELL_LIMIT", 64)
    jn, jp = world(name, JAX)
    tn, tp = world(name, TORCH)
    jt, jm = jpack.pack(jn, jp)
    tt, tm = tpack.pack(tn, tp, device="cpu")
    assert (tt.sched_mask is None) == (form == "factored")
    return (jt, jm), (tt, tm)


def slots_and_hints(meta, tensors, kind, seed=0):
    """The pending pods' rows, in a seeded order, with two -1 padding slots
    inside and the rest at the end (K_SLOTS in all), and hints: none, or a
    mix of -1, real nodes (some stale: the pod no longer fits there) and
    padded node columns."""
    rng = np.random.default_rng(seed)
    rows = [meta.pod_index[p.key()] for p in meta.pods if not p.node_name]
    rows = [rows[i] for i in rng.permutation(len(rows))]
    rows = rows[:3] + [-1] + rows[3:7] + [-1] + rows[7:]
    assert len(rows) <= K_SLOTS
    slots = np.full(K_SLOTS, -1, np.int32)
    slots[: len(rows)] = rows
    hints = np.full(K_SLOTS, -1, np.int32)
    if kind == "hints":
        n_real, n_pad = meta.num_nodes, int(tensors.node_valid.shape[0])
        hints = np.where(rng.random(K_SLOTS) < 0.7, rng.integers(0, n_real, K_SLOTS),
                         rng.integers(n_real, n_pad, K_SLOTS)).astype(np.int32)
        hints[rng.random(K_SLOTS) < 0.2] = -1
    return slots, hints


def pending_of(meta):
    return [p for p in meta.pods if not p.node_name]


def run_both(jt, tt, slots, hints, jctx=None, tctx=None):
    jr = jsch.greedy_schedule(jt, jnp.asarray(slots), jnp.asarray(hints), spread=jctx)
    tr = tsch.greedy_schedule(tt, torch.tensor(slots), torch.tensor(hints), spread=tctx)
    assert tr.placed.dtype == torch.bool and tr.dest.dtype == torch.int32
    assert_bits_equal(jr.placed, tr.placed)
    assert_bits_equal(jr.dest, tr.dest)
    return jr, tr


FORMS = ["dense", "factored"]


@pytest.mark.parametrize("kind", ["no-hints", "hints"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", ["mask0", "mask1", "mask2", "mask3"])
def test_greedy_schedule_matches_jax(name, form, kind, monkeypatch):
    (jt, jm), (tt, tm) = packed(name, form, monkeypatch)
    slots, hints = slots_and_hints(tm, tt, kind, seed=int(name[4:]))
    jr, _ = run_both(jt, tt, slots, hints)
    placed = np.asarray(jr.placed)
    assert placed.any() and not placed.all()   # the world binds somewhere
    assert not placed[slots < 0].any()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", ["spread0", "spread1", "spread2"])
def test_spread_schedule_context_matches_jax(name, form, monkeypatch):
    """build_spread_context_from_meta's nine arrays (interning order,
    first-seen domain ids, S and D buckets, padded node columns -1 and
    ineligible, bincount static counts), then the gated schedule."""
    (jt, jm), (tt, tm) = packed(name, form, monkeypatch)
    jctx = jaff.build_spread_context_from_meta(pending_of(jm), jm, jt)
    tctx = taff.build_spread_context_from_meta(pending_of(tm), tm, tt)
    assert len(tctx) == len(taff.SCHEDULE_CONTEXT_DTYPES) == 9
    for (fname, dtype), a, b in zip(taff.SCHEDULE_CONTEXT_DTYPES, jctx, tctx):
        assert to_np(b).dtype == np.dtype(dtype), fname
        assert b.device.type == "cpu"
        assert_bits_equal(a, b)
    node_dom, sp_elig, static_counts = (to_np(tctx[i]) for i in (2, 3, 5))
    S = node_dom.shape[0]
    assert S >= 4 and static_counts.shape[1] >= 8
    assert (node_dom[:, tm.num_nodes:] == -1).all() and not sp_elig[:, tm.num_nodes:].any()
    assert (node_dom[:, -1] == -1).any() or tm.num_nodes < node_dom.shape[1]
    assert static_counts.sum() > 0
    slots, hints = slots_and_hints(tm, tt, "hints", seed=int(name[6:]))
    run_both(jt, tt, slots, hints, jctx, tctx)


def test_spread_context_is_none_without_hard_spread(monkeypatch):
    (_, _), (tt, tm) = packed("mask0", "dense", monkeypatch)
    assert taff.build_spread_context_from_meta(pending_of(tm), tm, tt) is None


@pytest.mark.parametrize("form", FORMS)
def test_spread_context_from_numpy_replays_jax_operands(form, monkeypatch):
    """JAX's nine arrays, as numpy, through spread_context_from_numpy: the
    port's loop on the JAX package's own context gives JAX's schedule."""
    (jt, jm), (tt, tm) = packed("spread1", form, monkeypatch)
    jctx = jaff.build_spread_context_from_meta(pending_of(jm), jm, jt)
    tctx = taff.spread_context_from_numpy([np.asarray(a) for a in jctx], device="cpu")
    slots, hints = slots_and_hints(tm, tt, "no-hints", seed=4)
    run_both(jt, tt, slots, hints, jctx, tctx)
    with pytest.raises(ValueError, match="9 arrays"):
        taff.spread_context_from_numpy([np.asarray(a) for a in jctx[:8]], device="cpu")


def test_within_wave_spread_worlds_match_jax():
    """tests/test_overpack_bound.py::TestSpreadWithinWaveExact's worlds
    (two zones, an empty one and one pre-loaded with two matching pods),
    packed and scheduled through both packages."""
    for preload in (0, 2):
        built = {}
        for pkg, name in ((JAX, "jax"), (TORCH, "torch")):
            tu, obj = pkg
            nodes = []
            for z in "ab":
                n = tu.build_test_node(f"n-{z}", cpu_m=10_000)
                n.labels["topology.kubernetes.io/zone"] = f"zone-{z}"
                nodes.append(n)
            pre = [tu.build_test_pod(f"pre{k}", cpu_m=100, labels={"app": "web"},
                                     node_name="n-a") for k in range(preload)]
            pending = []
            for i in range(8):
                p = tu.build_test_pod(f"p{i}", cpu_m=100, labels={"app": "web"})
                p.topology_spread = (obj.TopologySpreadConstraint(
                    max_skew=1, topology_key="topology.kubernetes.io/zone",
                    selector=obj.LabelSelector.from_dict({"app": "web"}),
                ),)
                pending.append(p)
            built[name] = (nodes, pre + pending, pending)
        jn, jpods, jpend = built["jax"]
        tn, tpods, tpend = built["torch"]
        jt, jm = jpack.pack(jn, jpods)
        tt, tm = tpack.pack(tn, tpods, device="cpu")
        jctx = jaff.build_spread_context_from_meta(jpend, jm, jt)
        tctx = taff.build_spread_context_from_meta(tpend, tm, tt)
        for a, b in zip(jctx, tctx):
            assert_bits_equal(a, b)
        slots = np.array([tm.pod_index[p.key()] for p in tpend], np.int32)
        hints = np.full(len(slots), -1, np.int32)
        _, tr = run_both(jt, tt, slots, hints, jctx, tctx)
        assert int(tr.placed.sum()) == (8 if preload == 0 else 3)


# -- one test a trap -------------------------------------------------------


def model_greedy(free, req, rows, node_valid, slots, hints):
    """The XLA scan's step in numpy (dense rows): → (placed, dest, free)."""
    free = free.copy()
    placed, dest = [], []
    for pod_idx, hint in zip(slots, hints):
        safe = max(pod_idx, 0)
        ok = (req[safe][None, :] <= free).all(-1) & rows[safe] & node_valid
        hint_ok = hint >= 0 and ok[max(hint, 0)]
        d = hint if hint_ok else (int(np.argmax(ok)) if ok.any() else -1)
        place = pod_idx >= 0 and d >= 0
        t = max(d, 0)
        free[t] = free[t] + np.where(place, -req[safe], np.float32(0.0))
        placed.append(place)
        dest.append(d if place else -1)
    return np.array(placed), np.array(dest, np.int32), free


def signed_zero_world():
    """4 pods × 3 nodes as numpy fields: allocatable -0.0 in the unused
    resource columns, so free starts at -0.0 there; pod 1 requests 0 cpu
    (-req is -0.0) and the padding slot's target takes a +0.0 add."""
    R = 6
    alloc = np.full((3, R), -0.0, np.float32)
    alloc[:, 0] = [1000.0, 2000.0, 500.0]
    alloc[:, 5] = 4.0
    req = np.zeros((4, R), np.float32)
    req[:, 0] = [600.0, 0.0, 700.0, 400.0]
    req[:, 5] = 1.0
    return {
        "node_alloc": alloc, "node_used": np.zeros((3, R), np.float32),
        "node_valid": np.array([True, True, True]),
        "node_group": np.full(3, -1, np.int32), "pod_req": req,
        "pod_valid": np.ones(4, bool), "pod_node": np.full(4, -1, np.int32),
        "sched_mask": np.array([[1, 1, 1], [1, 1, 0], [0, 1, 1], [1, 1, 1]], bool),
    }


def test_trap3_free_update_keeps_the_scan_form(monkeypatch):
    """free[target] += where(place, -req, 0) at target = max(dest, 0) every
    step, padding slots and unplaced pods too: the final free capacity,
    signed zeros included, equals the step in numpy."""
    arrays = signed_zero_world()
    tt = ttens.tensors_from_numpy(arrays, device="cpu")
    loops = []

    class Spy(tsch._Loop):
        def __init__(self, *args):
            super().__init__(*args)
            loops.append(self)

    monkeypatch.setattr(tsch, "_Loop", Spy)
    slots = np.array([1, -1, 0, 2, 3, 3], np.int32)
    hints = np.array([-1, -1, 2, -1, 1, -1], np.int32)
    tr = tsch.greedy_schedule(tt, torch.tensor(slots), torch.tensor(hints))
    free0 = np.where(arrays["node_valid"][:, None], arrays["node_alloc"] - arrays["node_used"],
                     np.float32(0.0)).astype(np.float32)
    placed, dest, free = model_greedy(free0, arrays["pod_req"], arrays["sched_mask"],
                                      arrays["node_valid"], slots, hints)
    assert_bits_equal(placed, tr.placed)
    assert_bits_equal(dest, tr.dest)
    assert len(loops) == 1          # the carry, [R, N], after the last step
    assert_bits_equal(free, loops[0].free.T)
    # both signs of zero survive in the final carry
    bits = free.view(np.uint32)
    assert (bits == 0x80000000).any() and (free == 0).any() and (bits == 0).any()
    jt = jpack.SnapshotTensors(**{k: jnp.asarray(v) for k, v in arrays.items()})
    run_both(jt, tt, slots, hints)


def test_trap1_first_fit_is_the_first_true():
    """argmax on bool in JAX is the first True; the port casts to uint8.
    Every node fits every pod here, so each unhinted pod lands on the
    first node with room."""
    rng = np.random.default_rng(3)
    for n in (1, 7, 64):
        ok = rng.random((50, n)) < 0.3
        ok[:, -1] |= rng.random(50) < 0.5
        got = torch.tensor(ok).to(torch.uint8).argmax(dim=1).numpy()
        np.testing.assert_array_equal(got, np.argmax(ok, axis=1))
    arrays = signed_zero_world()
    arrays["sched_mask"][:] = True
    arrays["node_alloc"][:, 0] = 1000.0
    tt = ttens.tensors_from_numpy(arrays, device="cpu")
    jt = jpack.SnapshotTensors(**{k: jnp.asarray(v) for k, v in arrays.items()})
    slots = np.array([0, 1, 2, 3, 0, 2], np.int32)
    _, tr = run_both(jt, tt, slots, np.full(6, -1, np.int32))
    assert tr.dest.tolist() == [0, 0, 1, 0, 2, -1]


_SYNCS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@pytest.mark.parametrize("form", FORMS)
def test_trap2_no_host_sync_in_the_loop(form, monkeypatch):
    """No step reads a device value back: every way a tensor reaches the
    host (item, tolist, numpy, bool/int/float/index, nonzero) raises during
    the loop, with the factored mask and the spread gate in play. (On the
    card the gpu tests run the loop under set_sync_debug_mode("error").)"""
    (_, _), (tt, tm) = packed("spread0", form, monkeypatch)
    tctx = taff.build_spread_context_from_meta(pending_of(tm), tm, tt)
    slots, hints = slots_and_hints(tm, tt, "hints")
    slots_t, hints_t = torch.tensor(slots), torch.tensor(hints)
    want = tsch.greedy_schedule(tt, slots_t, hints_t, spread=tctx)

    def refuse(*args, **kwargs):
        raise AssertionError("the greedy loop read a tensor back to the host")

    with monkeypatch.context() as m:
        for name in _SYNCS:
            m.setattr(torch.Tensor, name, refuse)
        m.setattr(torch, "nonzero", refuse)
        m.setattr(torch.Tensor, "nonzero", refuse)
        got = tsch.greedy_schedule(tt, slots_t, hints_t, spread=tctx)
    assert_bits_equal(want.placed, got.placed)
    assert_bits_equal(want.dest, got.dest)


def test_trap4_dtypes_and_indices():
    """Indices into index_select/gather are int64; the outputs and the
    spread counts stay int32 (dest, counts) and bool (placed, gates),
    whatever integer dtype the slots and hints arrive in."""
    arrays = signed_zero_world()
    tt = ttens.tensors_from_numpy(arrays, device="cpu")
    for dt in (torch.int32, torch.int64):
        res = tsch.greedy_schedule(tt, torch.tensor([0, 1, -1], dtype=dt),
                                   torch.tensor([2, -1, 0], dtype=dt))
        assert res.placed.dtype == torch.bool and res.dest.dtype == torch.int32
    sp8, counts, _ = _random_gate_operands(np.random.default_rng(0))
    sp8 = tuple(torch.tensor(a) for a in sp8)
    node_ok, m = tsch.spread_gate(sp8, torch.tensor(counts), torch.tensor([1]))
    assert node_ok.dtype == torch.bool and m.dtype == torch.bool
    out = tsch.spread_commit(sp8, torch.tensor(counts), m, torch.tensor([True]),
                             torch.tensor([3]))
    assert out.dtype == torch.int32


def _random_gate_operands(rng, S=6, N=10, D=8, P=5):
    """Random 8-array gate operands and counts: rows with no valid domain
    (minimum BIG_I32), minDomains above the domain count (minimum 0),
    unlabelled nodes (domain -1)."""
    node_dom = rng.integers(-1, 4, (S, N)).astype(np.int32)
    dom_valid = rng.random((S, D)) < 0.6
    dom_valid[0] = False
    sp8 = (
        rng.random((P, S)) < 0.6, rng.random((P, S)) < 0.5, node_dom,
        rng.random((S, N)) < 0.8, dom_valid,
        rng.integers(1, 3, S).astype(np.int32),
        np.where(np.arange(S) % 3 == 1, 9, 1).astype(np.int32),
        dom_valid.sum(1).astype(np.int32),
    )
    counts = rng.integers(0, 4, (S, D)).astype(np.int32)
    return sp8, counts, P


@pytest.mark.parametrize("seed", range(6))
def test_trap5_spread_gate_and_commit_match_jax(seed):
    """spread_gate's minimum (BIG_I32 where no domain is valid, 0 where
    minDomains exceeds the domain count) and spread_commit's scatter-add
    (one index a row, at max(dom, 0)) against JAX's on random operands."""
    rng = np.random.default_rng(seed)
    sp8, counts, P = _random_gate_operands(rng)
    t8 = tuple(torch.tensor(a) for a in sp8)
    j8 = tuple(jnp.asarray(a) for a in sp8)
    N = sp8[2].shape[1]
    for pod in range(P):
        jok, jm = jsch.spread_gate(j8, jnp.asarray(counts), jnp.int32(pod))
        tok, tm_ = tsch.spread_gate(t8, torch.tensor(counts), torch.tensor([pod]))
        assert_bits_equal(jok, tok)
        assert_bits_equal(jm, tm_)
        for place in (True, False):
            for target in (0, pod % N, N - 1):
                jc = jsch.spread_commit(j8, jnp.asarray(counts), jm, jnp.bool_(place),
                                        jnp.int32(target))
                tc = tsch.spread_commit(t8, torch.tensor(counts), tm_,
                                        torch.tensor([place]), torch.tensor([target]))
                assert_bits_equal(jc, tc)
    assert tsch.BIG_I32 == int(jsch.BIG_I32) == 2**30


def test_trap6_spread_none_and_the_static_counts_carry(monkeypatch):
    """spread=None schedules without a gate (JAX carries a dummy (1, 1)
    count); with a context, its static counts seed the carry and the
    caller's tensor is left as it was."""
    (jt, jm), (tt, tm) = packed("spread2", "dense", monkeypatch)
    slots, hints = slots_and_hints(tm, tt, "no-hints")
    run_both(jt, tt, slots, hints)
    jctx = jaff.build_spread_context_from_meta(pending_of(jm), jm, jt)
    tctx = taff.build_spread_context_from_meta(pending_of(tm), tm, tt)
    before = tctx[5].clone()
    assert int(before.sum()) > 0
    _, gated = run_both(jt, tt, slots, hints, jctx, tctx)
    assert torch.equal(tctx[5], before)
    ungated = tsch.greedy_schedule(tt, torch.tensor(slots), torch.tensor(hints))
    assert not torch.equal(gated.placed, ungated.placed)


@pytest.mark.parametrize("form", FORMS)
def test_trap7_sched_row_takes_a_device_index(form, monkeypatch):
    """sched_row on a [1] index tensor (as the loop hands it) gives the
    JAX package's row, in both mask forms, padding rows included."""
    (jt, _), (tt, _) = packed("mask2", form, monkeypatch)
    jd = to_np(jt.dense_sched())
    for i in range(tt.num_pods):
        row = tt.sched_row(torch.tensor([i]))
        assert row.shape == (tt.num_nodes,) and row.dtype == torch.bool
        np.testing.assert_array_equal(to_np(row), jd[i])
        np.testing.assert_array_equal(to_np(jt.sched_row(jnp.int32(i))), jd[i])


def test_empty_slot_list():
    arrays = signed_zero_world()
    tt = ttens.tensors_from_numpy(arrays, device="cpu")
    res = tsch.greedy_schedule(tt, torch.zeros(0, dtype=torch.int32),
                               torch.zeros(0, dtype=torch.int32))
    assert res.placed.shape == (0,) and res.dest.shape == (0,)
    assert res.dest.dtype == torch.int32


@pytest.mark.parametrize("chunk", [1, 5, 32, 1000])
@pytest.mark.parametrize("form", FORMS)
def test_chunked_loop_matches_jax(chunk, form, monkeypatch):
    """The loop gathers its read-only operands CHUNK steps at a time; any
    chunk size (a partial last chunk, one step a chunk, one chunk for all)
    gives the XLA scan's schedule, with the spread gate in play."""
    monkeypatch.setattr(tsch, "CHUNK", chunk)
    (jt, jm), (tt, tm) = packed("spread1", form, monkeypatch)
    jctx = jaff.build_spread_context_from_meta(pending_of(jm), jm, jt)
    tctx = taff.build_spread_context_from_meta(pending_of(tm), tm, tt)
    slots, hints = slots_and_hints(tm, tt, "hints", seed=9)
    run_both(jt, tt, slots, hints, jctx, tctx)
    run_both(jt, tt, slots, hints)
