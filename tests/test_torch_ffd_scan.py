"""The port's scan entry ``ffd_binpack_groups_cuda`` (autoscaler_tpu_torch/
ops/ffd_scan.py) on CPU tensors — its glue plus the plain versions of the
kernels K1/K2 — against the JAX package's ``ffd_binpack_groups_pallas``
run in interpret mode, bit for bit. Every world of
tests/test_pallas_binpack.py runs on both routes: integral requests (the
SWAR kernel K2) and decimal memory (the f32 kernel K1).

The worlds share one shape (STD: 100 pods in 32-pod chunks, so a tail
chunk; 5 groups in 8-group blocks, so a padded group; a 32-node carry):
interpret mode compiles the Pallas kernel once for each shape and SWAR
plan, and that compile is nearly all of these tests' time."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoscaler_tpu.ops import pallas_binpack as jpb
from autoscaler_tpu_torch.ops import ffd_scan
from torch_parity import (
    CPU,
    GPU,
    MEMORY,
    PODS,
    assert_bits_equal,
    assert_results_equal,
    key_max_f32,
    rand_case,
)

ROUTES = ["swar", "f32"]
STD = dict(P=100, G=5)
M = 32
CHUNK = 32


def on_route(req, route):
    """Integral worlds take K2; adding half a MiB to every memory request
    makes them fractional, which refuses the SWAR plan and takes K1."""
    req = req.copy()
    if route == "f32":
        req[:, MEMORY] += 0.5
    return req


def cpu_operands(req, masks, allocs, caps=None):
    return ffd_scan.operands_from_numpy(req, masks, allocs, caps, device="cpu")


def assert_parity(req, masks, allocs, max_nodes, caps=None, route=None, **kw):
    ref = jpb.ffd_binpack_groups_pallas(
        req, masks, allocs, max_nodes=max_nodes, node_caps=caps,
        interpret=True, **kw,
    )
    t_req, t_masks, t_allocs, t_caps = cpu_operands(req, masks, allocs, caps)
    before = dict(ffd_scan.LAUNCHES)
    out = ffd_scan.ffd_binpack_groups_cuda(
        t_req, t_masks, t_allocs, max_nodes=max_nodes, node_caps=t_caps
    )
    assert ffd_scan.LAUNCHES == before  # CPU tensors never launch a kernel
    assert_results_equal(ref, out)
    if route is not None:
        ops = ffd_scan.prepare_scan(t_req, t_masks, t_allocs, max_nodes, t_caps)
        assert (ops.plan is not None) == (route == "swar")
    return out


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_random_parity(seed, route):
    req, masks, allocs = rand_case(seed, **STD)
    assert_parity(on_route(req, route), masks, allocs, max_nodes=M, chunk=CHUNK, route=route)


@pytest.mark.parametrize("route", ROUTES)
def test_tail_chunk_and_group_padding(route):
    req, masks, allocs = rand_case(3, **STD)
    assert_parity(
        on_route(req, route), masks, allocs, max_nodes=M, chunk=CHUNK,
        group_block=8, route=route,
    )


@pytest.mark.parametrize("route", ROUTES)
def test_per_group_caps(route):
    req, masks, allocs = rand_case(4, **STD)
    caps = np.array([1, 4, 16, 32, 0], np.int32)
    assert_parity(
        on_route(req, route), masks, allocs, max_nodes=M, caps=caps, chunk=CHUNK, route=route
    )


@pytest.mark.parametrize("route", ROUTES)
def test_oversized_pods_and_dead_groups(route):
    req, masks, allocs = rand_case(5, **STD)
    req[::7, CPU] = 10_000_000.0  # never fits anything
    masks[1, :] = False           # group schedules nothing
    out = assert_parity(on_route(req, route), masks, allocs, max_nodes=M, chunk=CHUNK, route=route)
    assert int(out.node_count[1]) == 0


@pytest.mark.parametrize("route", ROUTES)
def test_padded_group_shape_places_nothing(route):
    """A group with cap 0 and alloc 0 (the shape the TPU kernel pads its
    group axis with) places nothing and opens nothing."""
    req, masks, allocs = rand_case(9, **STD)
    allocs[3, :] = 0.0
    caps = np.array([8, 8, 8, 0, 8], np.int32)
    out = assert_parity(
        on_route(req, route), masks, allocs, max_nodes=M, caps=caps, chunk=CHUNK, route=route
    )
    assert int(out.node_count[3]) == 0 and not bool(out.scheduled[3].any())


@pytest.mark.parametrize("route", ROUTES)
def test_multi_chunk_carry(route):
    P = STD["P"]
    req = np.zeros((P, 6), np.float32)
    req[:, CPU] = 500.0
    req[:, PODS] = 1.0
    req[:, MEMORY] = 0.0 if route == "swar" else 0.5
    masks = np.ones((2, P), bool)
    allocs = np.zeros((2, 6), np.float32)
    allocs[:, CPU] = 2000.0
    allocs[:, MEMORY] = 64.0
    allocs[:, PODS] = 110.0
    out = assert_parity(req, masks, allocs, max_nodes=M, chunk=CHUNK, route=route)
    assert int(out.node_count[0]) == 25  # 4 per node, filled across 4 chunks


@pytest.mark.parametrize("route", ROUTES)
def test_zero_score_pods(route):
    req, masks, allocs = rand_case(6, **STD)
    req[::3, CPU] = 0.0
    req[::3, MEMORY] = 0.0
    req[1::3, CPU] = 500.0
    req[1::3, MEMORY] = 1000.0
    assert_parity(on_route(req, route), masks, allocs, max_nodes=M, chunk=CHUNK, route=route)


@pytest.mark.parametrize("route", ROUTES)
def test_gpu_axis(route):
    req, masks, allocs = rand_case(11, **STD)
    rng = np.random.default_rng(12)
    gpu_pods = rng.random(len(req)) < 0.3
    req[gpu_pods, GPU] = rng.integers(1, 4, int(gpu_pods.sum()))
    allocs[:, GPU] = 8.0
    assert_parity(on_route(req, route), masks, allocs, max_nodes=M, chunk=CHUNK, route=route)


@pytest.mark.parametrize("route", ROUTES)
def test_inf_alloc_clamps(route):
    """+inf allocs (unlimited CSI attach planes) clamp to a finite
    always-fits power of two after scoring; integral worlds still pack."""
    req, masks, allocs = rand_case(21, **STD)
    allocs = np.concatenate([allocs, np.full((len(allocs), 1), np.inf, np.float32)], axis=1)
    req = np.concatenate([req, np.ones((len(req), 1), np.float32)], axis=1)
    assert_parity(on_route(req, route), masks, allocs, max_nodes=M, chunk=CHUNK, route=route)


def test_boundary_widths_stay_exact():
    rng = np.random.default_rng(3)
    P, G = STD["P"], STD["G"]
    req = np.zeros((P, 6), np.float32)
    req[:, CPU] = rng.integers(1, 2**16, P)
    req[:, CPU][0] = 2**16 - 1
    req[:, MEMORY] = rng.integers(1, 2**17, P)
    req[:, MEMORY][1] = 2**17 - 1
    req[:, PODS] = 1.0
    allocs = np.zeros((G, 6), np.float32)
    allocs[:, CPU] = 2**16 - 1
    allocs[:, MEMORY] = 2**17 - 1
    allocs[:, PODS] = 110.0
    masks = rng.random((G, P)) > 0.2
    assert_parity(req, masks, allocs, max_nodes=M, chunk=CHUNK, route="swar")


def test_headline_workload_matches_bench_generator():
    """The port's copy of the headline generator gives bench.py's arrays."""
    import bench
    from autoscaler_tpu_torch.utils.workload import build_workload

    for a, b in zip(bench.build_workload(P=500, G=7, seed=3), build_workload(500, 7, seed=3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_headline_shape_slice_parity():
    """A slice of the headline workload (100 of its pods, 5 groups): the
    plain route packs it into SWAR planes like the full shape."""
    from autoscaler_tpu_torch.utils.workload import build_workload

    req, masks, allocs, caps = build_workload(P=STD["P"], G=STD["G"], seed=0)
    assert_parity(req, masks, allocs, max_nodes=M, caps=caps, chunk=CHUNK, route="swar")


# -- SWAR helpers against the JAX package's ---------------------------------


@pytest.mark.parametrize(
    "max_vals",
    [[32000, 65536, 8, 110], [2**31, 10], [2**29, 2**29], [1, 1, 1], [5], [2**30, 3, 3]],
)
def test_swar_plan_matches_jax(max_vals):
    assert ffd_scan._swar_plan(max_vals) == jpb._swar_plan(max_vals)
    plan = ffd_scan._swar_plan(max_vals)
    if plan is not None:
        assert ffd_scan._swar_masks(plan) == jpb._swar_masks(plan)


def test_swar_plan_packs_bench_shape():
    plan = ffd_scan._swar_plan([32000, 65536, 8, 110])
    assert plan is not None and len(plan) == 2
    assert sorted(r for fields in plan for r, _, _ in fields) == [0, 1, 2, 3]
    for fields in plan:
        assert sum(w for _, _, w in fields) <= 31


def test_swar_pack_unpack_match_jax():
    rng = np.random.default_rng(0)
    vals = np.stack(
        [rng.integers(0, hi, 40) for hi in (32000, 65536, 8, 110)], axis=1
    ).astype(np.float32)
    plan = ffd_scan._swar_plan([32000, 65536, 8, 110])
    ref = jpb._swar_pack_cols(jnp.asarray(vals), plan)
    out = ffd_scan._swar_pack_cols(torch.tensor(vals), plan)
    for a, b in zip(ref, out):
        assert b.dtype == torch.int32
        assert_bits_equal(a, b)
    planes = torch.stack(out)[:, :, None]                 # [NP, 40, 1]
    ref_back = jpb._swar_unpack_free(jnp.stack(ref)[:, :, None], plan, 4)
    back = ffd_scan._swar_unpack_free(planes, plan, 4)
    assert_bits_equal(ref_back, back)
    np.testing.assert_array_equal(back[:, :, 0].numpy(), vals.T)


def test_clamp_inf_allocs():
    """Finite allocs pass through bit for bit; +inf ones become the power of
    two at or above max(2 × the axis total, 2^23), exactly. (The JAX
    version computes it as exp2(ceil(log2(x))), which XLA on the CPU
    rounds to a value a few ulps off the power of two: it is compared
    after rounding to the nearest power of two.)"""
    req, _, allocs = rand_case(2, P=50, G=3)
    req[:, 4] = 2.0**23   # a total above the 2^23 floor
    allocs[:, 2] = np.inf
    allocs[1, 4] = np.inf
    ref = np.asarray(jpb.clamp_inf_allocs(jnp.asarray(req), jnp.asarray(allocs)))
    out = ffd_scan.clamp_inf_allocs(torch.tensor(req), torch.tensor(allocs)).numpy()
    finite = np.isfinite(allocs)
    assert_bits_equal(ref[finite], out[finite])
    total = req.sum(axis=0, dtype=np.float64)
    for g, r in zip(*np.nonzero(~finite)):
        big = out[g, r]
        assert big == 2.0 ** np.ceil(np.log2(max(2 * total[r], 2.0**23)))
        assert big == 2.0 ** np.round(np.log2(ref[g, r]))


def test_compression_drops_unused_axes():
    """Axes no pod requests (ephemeral, gpu, tpu here) leave the kernel's
    operands and come back as zero columns of node_used."""
    req, masks, allocs = rand_case(1, **STD)
    allocs[:, GPU] = 8.0
    ops = ffd_scan.prepare_scan(*cpu_operands(req, masks, allocs)[:3], max_nodes=M)
    assert ops.keep == [CPU, MEMORY, PODS]
    assert ops.plan is not None and ops.stream.shape[2] == len(ops.plan) < 3
    out = assert_parity(req, masks, allocs, max_nodes=M, chunk=CHUNK)
    assert not out.node_used[:, :, [2, 3, 4]].any()


def test_operands_from_numpy_copies():
    req, masks, allocs = rand_case(0, P=16, G=2)
    caps = np.array([3, 4], np.int32)
    t_req, t_masks, t_allocs, t_caps = cpu_operands(req, masks, allocs, caps)
    assert (t_req.dtype, t_masks.dtype, t_allocs.dtype, t_caps.dtype) == (
        torch.float32, torch.bool, torch.float32, torch.int32
    )
    keep = [x.clone() for x in (t_req, t_masks, t_allocs, t_caps)]
    req[:] = -1.0
    masks[:] = ~masks
    allocs[:] = -1.0
    caps[:] = 0
    for a, b in zip(keep, (t_req, t_masks, t_allocs, t_caps)):
        assert torch.equal(a, b)


def test_kernel_plain_versions_match_pallas_kernels():
    """K1's and K2's plain versions on the kernels' own operands equal the
    Pallas kernels run in interpret mode on the same operands (layouts
    transposed: [G, P, NP] here, [NP, P, G] there)."""
    for route in ROUTES:
        req, masks, allocs = rand_case(13, P=STD["P"], G=8)
        req = on_route(req, route)
        caps = np.array([2, 4, 8, 16, 32, 32, 1, 0], np.int32)
        t_req, t_masks, t_allocs, t_caps = cpu_operands(req, masks, allocs, caps)
        ops = ffd_scan.prepare_scan(t_req, t_masks, t_allocs, M, t_caps)
        free, opened, placed = ffd_scan.run_scan(ops)
        guards = None if ops.plan is None else tuple(int(g) for g in ops.guards)
        r_free, r_opened, r_placed = jpb._pallas_scan_all(
            jnp.asarray(ops.stream.numpy().transpose(2, 1, 0)),
            jnp.asarray(ops.allocs.numpy().T),
            jnp.asarray(ops.caps.numpy()[None, :]),
            max_nodes=M, chunk=CHUNK, group_block=8, interpret=True, guards=guards,
        )
        assert_bits_equal(np.asarray(r_free).transpose(2, 0, 1)[:, :, :M], free)
        assert_bits_equal(np.asarray(r_opened)[0], opened)
        assert_bits_equal(np.asarray(r_placed).T, placed)


def test_work_count_of_plain_scan():
    """node_tests counts the fit tests the data needs: nodes 0..first for a
    pod that fits, the open nodes plus one closed node otherwise, none for
    masked pods."""
    req = np.zeros((3, 6), np.float32)
    req[:, CPU] = [600.0, 600.0, 600.0]
    req[:, PODS] = 1.0
    masks = np.array([[True, True, False]])
    allocs = np.zeros((1, 6), np.float32)
    allocs[0, CPU] = 1000.0
    allocs[0, PODS] = 110.0
    ops = ffd_scan.prepare_scan(*cpu_operands(req, masks, allocs)[:3], max_nodes=4)
    stats = {}
    ffd_scan._scan_plain_swar(ops.stream, ops.allocs, ops.caps, ops.guards, 4, stats)
    # pod 0 opens node 0 (1 test); pod 1 misses node 0, opens node 1 (2)
    assert stats["node_tests"] == 3


def test_wrapper_on_a_non_cpu_tensor_never_runs_the_plain_version():
    """Only CPU tensors take the plain version: any other device goes to
    the kernel path, which refuses what is not a CUDA tensor."""
    stream = torch.zeros((1, 32, 2), dtype=torch.int32, device="meta")
    allocs = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    caps = torch.zeros((1,), dtype=torch.int32, device="meta")
    guards = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ffd_scan.ffd_scan_swar(stream, allocs, caps, guards, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ffd_scan.ffd_scan_f32(stream.float(), allocs.float(), caps, 4)


def test_operand_checks():
    req, masks, allocs = rand_case(0, P=16, G=2)
    t_req, t_masks, t_allocs, _ = cpu_operands(req, masks, allocs)
    with pytest.raises(ValueError):
        ffd_scan.ffd_binpack_groups_cuda(t_req.double(), t_masks, t_allocs, max_nodes=4)
    with pytest.raises(ValueError):
        ffd_scan.ffd_binpack_groups_cuda(t_req, t_masks[:, :8], t_allocs, max_nodes=4)
    with pytest.raises(ValueError):
        ffd_scan.ffd_binpack_groups_cuda(
            t_req, t_masks, t_allocs, max_nodes=4,
            node_caps=torch.ones(2, dtype=torch.int64),
        )


# -- a step-level model of the kernels' search ------------------------------
#
# K1/K2 search each step in rounds: the blocks 0..lim/32 are tested against
# their block summaries (the max free capacity of the block's nodes below
# the cap, per plane or per packed field) in passes of 32, and the blocks
# that pass are searched GROUP_WARPS at a time, warp w taking the w-th, the
# round's hit being the lowest of the warps' hits. The model below runs
# that search in numpy, as the kernel runs it, checks its `first` against
# the lowest fitting node at every step, and counts the work the way
# `_scan_plain`'s stats do.

NO_NODE = 2**31 - 1


def _plan_field_masks(plan):
    """Each packed plane's field masks, from the SWAR plan's shifts and
    widths (the kernel reads the same fields off the guard bits)."""
    return [[((1 << w) - 1) << shift for _, shift, w in fields] for fields in plan]


def model_scan(stream, allocs, caps, M, guards=None, plan=None, bound="max",
               refresh_every=1, W=ffd_scan.GROUP_WARPS):
    """The kernels' search on numpy operands → (free [G, NP, M], opened
    [G], placed [G, P_pad], counts, the counts of each group). ``bound`` is the block summary: "max"
    (the kernel's: the f32 key max, or the SWAR max per field) or "or"
    (the OR of the words). ``refresh_every`` = k refreshes the hit block's
    summary on every k-th placement of a group (0: never, so summaries go
    stale). Raises AssertionError on any step whose search misses the
    lowest fitting node."""
    stream, allocs, caps = (np.asarray(x) for x in (stream, allocs, caps))
    G, P_pad, NP = stream.shape
    NB = -(-M // 32)
    swar = guards is not None
    if swar:
        gcol = np.asarray(guards, np.int64)[:, None]
        masks = _plan_field_masks(plan)

    def fits(free, req):                       # [NP, n] vs [NP] → [n]
        if swar:
            z = (free.astype(np.int64) | gcol) - req.astype(np.int64)[:, None]
            return ((z & gcol) == gcol).all(axis=0)
        return (req[:, None] <= free).all(axis=0)

    def block_max(vals, valid):                # [NP, 32], [32] → [NP]
        if bound == "or":
            x = np.where(valid, vals.view(np.uint32), 0)
            return np.bitwise_or.reduce(x, axis=1).astype(np.uint32).view(vals.dtype)
        if not swar:
            return key_max_f32(vals, valid[None, :])
        x = np.where(valid, vals, 0).astype(np.int64)
        return np.array([sum(int((x[p] & fm).max()) for fm in masks[p])
                         for p in range(NP)], np.int32)

    counts = dict(summary_tests=0, candidate_blocks=0, rounds=0, placements=0)
    per_group = []
    free_out = np.empty((G, NP, M), stream.dtype)
    opened_out = np.zeros(G, np.int32)
    placed = np.zeros((G, P_pad), bool)
    for g in range(G):
        free = np.repeat(allocs[g][:, None], M, axis=1)
        summ = np.repeat(allocs[g][:, None], NB, axis=1)
        span = min(M, max(int(caps[g]), 0))
        opened = n_placed = 0
        for s in range(P_pad):
            req = stream[g, s]
            lim = min(opened, span - 1)
            nblk = lim // 32 + 1 if lim >= 0 else 0
            counts["summary_tests"] += nblk
            first = NO_NODE
            for q0 in range(0, nblk, 32):
                blocks = np.arange(q0, min(q0 + 32, nblk))
                cand = list(blocks[fits(summ[:, blocks], req)])
                while cand and first == NO_NODE:
                    slots = []
                    for w in range(W):
                        if w >= len(cand):
                            slots.append(NO_NODE)
                            continue
                        nodes = cand[w] * 32 + np.arange(32)
                        ok = (nodes <= lim) & fits(free[:, np.minimum(nodes, lim)], req)
                        slots.append(int(nodes[ok][0]) if ok.any() else NO_NODE)
                    counts["rounds"] += 1
                    counts["candidate_blocks"] += min(W, len(cand))
                    first = min(slots)
                    cand = cand[W:]
                if first != NO_NODE:
                    break
            hits = np.nonzero(fits(free[:, :lim + 1], req))[0] if lim >= 0 else []
            assert first == (int(hits[0]) if len(hits) else NO_NODE), (g, s, first)
            if first == NO_NODE:
                continue
            free[:, first] = free[:, first] - req
            opened = max(opened, first + 1)
            placed[g, s] = True
            n_placed += 1
            counts["placements"] += 1
            if refresh_every and n_placed % refresh_every == 0:
                nodes = first // 32 * 32 + np.arange(32)
                summ[:, first // 32] = block_max(
                    free[:, np.minimum(nodes, M - 1)], nodes < span
                )
        free_out[g], opened_out[g] = free, opened
        per_group.append(dict(counts))
        if g:
            for key in counts:
                per_group[g][key] -= sum(c[key] for c in per_group[:g])
    return free_out, opened_out, placed, counts, per_group


def _model_world(name, route):
    """(req, masks, allocs, caps, max_nodes) of the model's worlds."""
    if name.startswith("std"):
        req, masks, allocs = rand_case(int(name[-1]), **STD)
        return on_route(req, route), masks, allocs, None, M
    rng = np.random.default_rng(len(name))
    if name in ("m1000", "m1100"):
        # pods of half a node to a whole node: the groups reach their caps,
        # 1000 (a partial last block), 700 or 1100 (35 blocks: two passes)
        P, caps, max_nodes = (1100, [1000, 700], 1000) if name == "m1000" else (1200, [1100], 1100)
        req = np.zeros((P, 6), np.float32)
        req[:, CPU] = rng.integers(500, 1001, P)
        req[:, MEMORY] = rng.integers(64, 2048, P)
        req[:, PODS] = 1.0
        allocs = np.zeros((len(caps), 6), np.float32)
        allocs[:, CPU] = 1000.0
        allocs[:, MEMORY] = 4096.0
        allocs[:, PODS] = 110.0
        return (on_route(req, route), np.ones((len(caps), P), bool), allocs,
                np.array(caps, np.int32), max_nodes)
    if name == "masked":
        req, masks, allocs = rand_case(7, **STD)
        masks[2, :] = False
        masks[4, ::2] = False
        return on_route(req, route), masks, allocs, None, M
    if name == "caps01":
        req, masks, allocs = rand_case(8, **STD)
        return on_route(req, route), masks, allocs, np.array([0, 1, 1, 0, 32], np.int32), M
    # "zero-equal": requests equal to the alloc (free drops to exactly 0),
    # zero requests (integral route) and halves
    P = STD["P"]
    half = 0.5 if route == "f32" else 0.0
    req = np.zeros((P, 6), np.float32)
    req[:, CPU] = np.tile([1000.0, 0.0, 500.0], P)[:P]
    req[:, MEMORY] = np.tile([1000.0 + half, half, 500.0 + half], P)[:P]
    req[:, PODS] = np.tile([1.0, 0.0, 1.0], P)[:P]
    allocs = np.zeros((3, 6), np.float32)
    allocs[:, CPU] = 1000.0
    allocs[:, MEMORY] = 1000.0 + half
    allocs[:, PODS] = 110.0
    return req, rng.random((3, P)) > 0.2, allocs, np.array([32, 5, 2], np.int32), M


MODEL_WORLDS = ["std0", "std1", "std2", "m1000", "m1100", "masked", "caps01", "zero-equal"]


def _model_operands(name, route):
    req, masks, allocs, caps, max_nodes = _model_world(name, route)
    t_caps = None if caps is None else torch.tensor(caps)
    ops = ffd_scan.prepare_scan(
        torch.tensor(req), torch.tensor(masks), torch.tensor(allocs), max_nodes, t_caps
    )
    assert (ops.plan is not None) == (route == "swar")
    return ops


def _plain(ops, stats=None):
    if ops.plan is not None:
        return ffd_scan._scan_plain_swar(
            ops.stream, ops.allocs, ops.caps, ops.guards, ops.max_nodes, stats
        )
    return ffd_scan._scan_plain_f32(ops.stream, ops.allocs, ops.caps, ops.max_nodes, stats)


def _model(ops, **kw):
    guards = None if ops.plan is None else ops.guards.numpy()
    return model_scan(ops.stream.numpy(), ops.allocs.numpy(), ops.caps.numpy(),
                      ops.max_nodes, guards, ops.plan, **kw)


@pytest.mark.parametrize("world", MODEL_WORLDS)
@pytest.mark.parametrize("route", ROUTES)
def test_search_model_matches_plain_version(route, world):
    """The kernels' search (W warps, interleaved candidate blocks, exact
    block summaries refreshed on every placement) finds the lowest fitting
    node at every step and ends with the plain version's free, opened and
    placed, bit for bit; the plain version's search counts are the
    model's."""
    ops = _model_operands(world, route)
    stats = {}
    want = _plain(ops, stats)
    free, opened, placed, counts, per_group = _model(ops)
    assert_bits_equal(want[0], free)
    assert_bits_equal(want[1], opened)
    assert_bits_equal(want[2], placed)
    for key, n in counts.items():
        assert stats[key] == n, key
    assert stats["candidate_blocks"] <= stats["summary_tests"]
    for key in ("candidate_blocks", "rounds", "placements"):
        assert stats[f"max_group_{key}"] == max(c[key] for c in per_group), key


@pytest.mark.parametrize("refresh_every", [0, 3])
@pytest.mark.parametrize("world", ["std0", "m1000", "zero-equal"])
@pytest.mark.parametrize("route", ROUTES)
def test_search_model_exact_with_stale_summaries(route, world, refresh_every):
    """A summary that is never, or only sometimes, refreshed stays an upper
    bound (free capacity only falls), so the search stays exact; it only
    prunes less."""
    ops = _model_operands(world, route)
    want = _plain(ops)
    free, opened, placed, counts, _ = _model(ops, refresh_every=refresh_every)
    fresh = _model(ops)[3]
    for a, b in zip(want, (free, opened, placed)):
        assert_bits_equal(a, b)
    assert counts["candidate_blocks"] >= fresh["candidate_blocks"]


@pytest.mark.parametrize("W", [1, 3, 16])
@pytest.mark.parametrize("world", ["std2", "m1100", "caps01"])
@pytest.mark.parametrize("route", ROUTES)
def test_search_model_exact_for_any_round_width(route, world, W):
    """However many candidate blocks a round searches, the lowest hit of
    the round is `first`: the search is exact for every width, and wider
    rounds take fewer of them."""
    ops = _model_operands(world, route)
    want = _plain(ops)
    free, opened, placed, counts, _ = _model(ops, W=W)
    for a, b in zip(want, (free, opened, placed)):
        assert_bits_equal(a, b)
    assert counts["rounds"] >= _model(ops, W=W + 1)[3]["rounds"]


@pytest.mark.parametrize("world", ["std1", "m1000", "m1100"])
def test_swar_or_summary_is_exact_but_looser(world):
    """On packed planes the OR of the words bounds every field (the fields
    are disjoint and their guard bits clear): exact, but it passes at least
    as many blocks as the field-wise max the kernel keeps."""
    ops = _model_operands(world, "swar")
    want = _plain(ops)
    free, opened, placed, counts, _ = _model(ops, bound="or")
    exact = _model(ops)[3]
    for a, b in zip(want, (free, opened, placed)):
        assert_bits_equal(a, b)
    assert counts["candidate_blocks"] >= exact["candidate_blocks"]


def test_f32_or_summary_is_rejected():
    """The OR of f32 bit patterns is no bound: 2.0 | 1.5 is 0x7fc00000, a
    NaN, and `req <= NaN` is false, so a pod that fits node 0 would be
    pruned. The model catches the missed node; the key max keeps it."""
    inf = np.float32(np.inf)
    stream = np.full((1, 32, 1), inf, np.float32)
    stream[0, :3, 0] = [2.0, 2.5, 1.0]   # node 0 keeps 2.0, node 1 keeps 1.5
    allocs = np.array([[4.0]], np.float32)
    caps = np.array([4], np.int32)
    assert np.array([2.0, 1.5], np.float32).view(np.uint32)[0] | np.array(
        [1.5], np.float32).view(np.uint32)[0] == 0x7FC00000
    with pytest.raises(AssertionError):
        model_scan(stream, allocs, caps, 4, bound="or")
    free, opened, placed = model_scan(stream, allocs, caps, 4)[:3]
    want = ffd_scan._scan_plain_f32(
        torch.tensor(stream), torch.tensor(allocs), torch.tensor(caps), 4
    )
    for a, b in zip(want, (free, opened, placed)):
        assert_bits_equal(a, b)
    assert placed[0, :3].all() and free[0, 0, 0] == 1.0


def test_f32_key_max_orders_like_the_values():
    """The key max equals the float max on signed zeros, negatives, inf and
    denormals, ignores NaN, and gives a NaN for no valid lane; the plain
    version's block summaries agree (a summary of +0.0 or -0.0 passes the
    same requests)."""
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(64, 32)).astype(np.float32) * np.float32(1e3)
    vals[0, :] = -0.0
    vals[1, :4] = [np.inf, -np.inf, np.nan, 1e-45]
    vals[2, :] = np.nan
    vals[2, 7] = -3.0
    valid = rng.random((64, 32)) > 0.2
    valid[3, :] = False
    got = key_max_f32(vals, valid)
    ref = np.where(valid & ~np.isnan(vals), vals, -np.inf).max(axis=1)
    live = valid.any(axis=1) & (valid & ~np.isnan(vals)).any(axis=1)
    np.testing.assert_array_equal(got[live], ref[live])
    assert np.isnan(got[3])
    twin = ffd_scan._f32_block_max(torch.tensor(vals)[:, None, :], torch.tensor(valid)[:, None, :])
    np.testing.assert_array_equal(got, twin[:, 0, 0].numpy())
