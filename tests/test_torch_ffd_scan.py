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
from torch_parity import CPU, GPU, MEMORY, PODS, assert_bits_equal, assert_results_equal, rand_case

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
