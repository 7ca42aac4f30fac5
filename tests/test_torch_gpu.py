"""The hand-written kernels K1, K2, K3 and K4 on the card, against their plain
PyTorch versions on the same card tensors, and the port's entry points on
the card against the same calls on the CPU. Marked ``gpu``: without a card
every test skips. On the card (the JAX package is not installed there, so
the repo's conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from autoscaler_tpu_torch.ops import ffd_scan, ffd_scan_affinity, fit_reduce
from torch_parity import (
    AFF_SEARCH_WORLDS,
    CPU,
    MEMORY,
    PODS,
    aff_search_world,
    assert_results_equal,
    fit_case,
    hostname_skew_pods,
    rand_case,
    rand_spread,
    rand_world,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _world(seed, route, P=300, G=8):
    req, masks, allocs = rand_case(seed, P=P, G=G)
    if route == "f32":
        req[:, MEMORY] += 0.5
    caps = np.arange(1, G + 1, dtype=np.int32) * 8
    caps[-1] = 0
    return req, masks, allocs, caps


@pytest.mark.parametrize("route", ["swar", "f32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain_version(cuda, seed, route):
    req, masks, allocs, caps = _world(seed, route)
    ops = ffd_scan.prepare_scan(
        *ffd_scan.operands_from_numpy(req, masks, allocs, caps, cuda)[:3], 64,
        torch.tensor(caps, device=cuda),
    )
    assert (ops.plan is not None) == (route == "swar")
    name = "ffd_scan_swar" if route == "swar" else "ffd_scan_f32"
    before = ffd_scan.LAUNCHES[name]
    got = ffd_scan.run_scan(ops)
    torch.cuda.synchronize()
    assert ffd_scan.LAUNCHES[name] == before + 1
    if ops.plan is not None:
        want = ffd_scan._scan_plain_swar(ops.stream, ops.allocs, ops.caps, ops.guards, 64)
    else:
        want = ffd_scan._scan_plain_f32(ops.stream, ops.allocs, ops.caps, 64)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("route", ["swar", "f32"])
def test_entry_on_card_equals_cpu(cuda, route):
    req, masks, allocs, caps = _world(5, route, P=500, G=6)
    req[::9, CPU] = 1e7                                    # never fits
    outs = []
    for dev in (cuda, "cpu"):
        ops = ffd_scan.operands_from_numpy(req, masks, allocs, caps, dev)
        outs.append(ffd_scan.ffd_binpack_groups_cuda(*ops[:3], max_nodes=128, node_caps=ops[3]))
    assert_results_equal(outs[1], outs[0])


def test_wide_carry_needs_opt_in_shared_memory(cuda):
    """17 resource planes × 1024 nodes is 68 KB of carry: above the 48 KB
    default, so the launch must opt in to more shared memory."""
    rng = np.random.default_rng(3)
    P, G, R = 64, 3, 17
    req = (rng.integers(1, 40, (P, R)) + 0.5).astype(np.float32)
    masks = rng.random((G, P)) > 0.1
    allocs = np.full((G, R), 100.0, np.float32)
    outs = []
    for dev in (cuda, "cpu"):
        ops = ffd_scan.operands_from_numpy(req, masks, allocs, None, dev)
        outs.append(ffd_scan.ffd_binpack_groups_cuda(*ops[:3], max_nodes=1024))
    assert_results_equal(outs[1], outs[0])


def _hold_scan_kernel(cuda, req, masks, allocs, caps, max_nodes):
    """K1 or K2 (by the route the operands take) against its plain version
    on the same card tensors, exactly, with its launch counted once."""
    t_caps = None if caps is None else torch.tensor(caps, device=cuda)
    ops = ffd_scan.prepare_scan(
        *ffd_scan.operands_from_numpy(req, masks, allocs, None, cuda)[:3], max_nodes, t_caps
    )
    name = "ffd_scan_swar" if ops.plan is not None else "ffd_scan_f32"
    before = ffd_scan.LAUNCHES[name]
    got = ffd_scan.run_scan(ops)
    torch.cuda.synchronize()
    assert ffd_scan.LAUNCHES[name] == before + 1
    if ops.plan is not None:
        want = ffd_scan._scan_plain_swar(ops.stream, ops.allocs, ops.caps, ops.guards, max_nodes)
    else:
        want = ffd_scan._scan_plain_f32(ops.stream, ops.allocs, ops.caps, max_nodes)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return ops, got


def _scan_world(name, route):
    """(req, masks, allocs, caps, max_nodes) of the search's edge worlds."""
    rng = np.random.default_rng(len(name))
    if name == "partial-last-block":
        # half-node to whole-node pods: one group reaches its cap of 1000
        # (nodes 992..999 make a partial last block), one its cap of 700,
        # and the pods after each cap fit nowhere
        P, G = 1500, 2
        req = np.zeros((P, 6), np.float32)
        req[:, CPU] = rng.integers(500, 1001, P)
        req[:, MEMORY] = rng.integers(64, 2048, P)
        req[:, PODS] = 1.0
        allocs = np.zeros((G, 6), np.float32)
        allocs[:, CPU] = 1000.0
        allocs[:, MEMORY] = 4096.0
        allocs[:, PODS] = 110.0
        caps, M = np.array([1000, 700], np.int32), 1000
        masks = np.ones((G, P), bool)
    elif name == "wide-1024":
        # 17 resource planes x 1024 nodes, the groups capped at 1024 and 40
        P, G, R = 5000, 2, 17
        req = rng.integers(1, 40, (P, R)).astype(np.float32)
        masks = rng.random((G, P)) > 0.1
        allocs = np.full((G, R), 100.0, np.float32)
        caps, M = np.array([1024, 40], np.int32), 1024
    elif name == "unplaceable-after-cap":
        req, masks, allocs = rand_case(21, P=2000, G=4)
        caps, M = np.array([3, 31, 32, 40], np.int32), 64
    elif name == "masked-group":
        req, masks, allocs = rand_case(22, P=400, G=3)
        masks[1, :] = False
        caps, M = np.array([64, 64, 64], np.int32), 64
    elif name == "caps-0-1":
        req, masks, allocs = rand_case(23, P=400, G=4)
        caps, M = np.array([0, 1, 0, 1], np.int32), 64
    elif name == "last-node-of-block":
        # 31 whole-node pods fill nodes 0..30; a 600 pod opens node 31, the
        # last of block 0; the 400 pod after it lands on node 31 as well
        req = np.zeros((33, 6), np.float32)
        req[:, CPU] = [1000.0] * 31 + [600.0, 400.0]
        req[:, MEMORY] = req[:, CPU]
        req[:, PODS] = 1.0
        allocs = np.zeros((1, 6), np.float32)
        allocs[:, CPU] = allocs[:, MEMORY] = 1000.0
        allocs[:, PODS] = 110.0
        masks, caps, M = np.ones((1, 33), bool), None, 64
    else:  # "many-request-blocks": 5000 small pods, 157 staged blocks
        req, masks, allocs = rand_case(24, P=5000, G=3)
        req[:, CPU] //= 8
        caps, M = None, 256
    if route == "f32":
        req = req.copy()
        req[:, MEMORY] += 0.5
        if name == "last-node-of-block":
            allocs[:, MEMORY] += 1.0
    return req, masks, allocs, caps, M


SCAN_WORLDS = ["partial-last-block", "wide-1024", "unplaceable-after-cap", "masked-group",
               "caps-0-1", "last-node-of-block", "many-request-blocks"]


@pytest.mark.parametrize("world", SCAN_WORLDS)
@pytest.mark.parametrize("route", ["swar", "f32"])
def test_scan_kernel_search_edges(cuda, route, world):
    """K1 and K2 against their plain versions where the search's rounds,
    block summaries and staged requests meet their edges."""
    ops, (free, opened, placed) = _hold_scan_kernel(cuda, *_scan_world(world, route))
    assert (ops.plan is not None) == (route == "swar")
    if world == "partial-last-block":
        assert opened.tolist() == [1000, 700] and not placed[:, -100:].any()
    elif world == "masked-group":
        assert int(opened[1]) == 0 and not placed[1].any()
    elif world == "caps-0-1":
        assert opened.tolist() == [0, 1, 0, 1]
    elif world == "last-node-of-block":
        assert int(opened[0]) == 32 and placed[0, :33].all()
        if route == "f32":
            assert float(free[0, 0, 31]) == 0.0      # the CPU plane of node 31


@pytest.mark.parametrize("route", ["swar", "f32"])
def test_scan_kernel_empty_stream(cuda, route):
    """An empty request stream stages no requests and places nothing: K1
    and K2 return the allocs as the carry, as their plain versions do."""
    req, masks, allocs, caps = _world(2, route, P=40, G=4)
    ops = ffd_scan.prepare_scan(
        *ffd_scan.operands_from_numpy(req, masks, allocs, caps, cuda)[:3], 64,
        torch.tensor(caps, device=cuda),
    )
    assert (ops.plan is not None) == (route == "swar")
    stream = ops.stream[:, :0].contiguous()
    if ops.plan is not None:
        args = (stream, ops.allocs, ops.caps, ops.guards, 64)
        kernel, plain = ffd_scan.ffd_scan_swar, ffd_scan._scan_plain_swar
    else:
        args = (stream, ops.allocs, ops.caps, 64)
        kernel, plain = ffd_scan.ffd_scan_f32, ffd_scan._scan_plain_f32
    got = kernel(*args)
    torch.cuda.synchronize()
    for a, b in zip(plain(*args), got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[2].shape == (4, 0) and not got[1].any()


def test_scan_launch_geometry(cuda):
    """The shared memory of the headline launch, whose hit slots pin the
    warps a group that the plain version's search counts assume."""
    for NP in (2, 4, 17):
        M = 1000
        words = NP * M + NP * 32 + 2 * 32 * NP + NP + 2 * ffd_scan.GROUP_WARPS
        assert ffd_scan.smem_bytes(NP, M) == 4 * words


def test_estimator_on_card_equals_cpu(cuda):
    from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
    from autoscaler_tpu_torch.utils.test_utils import build_test_node, build_test_pod

    rng = np.random.default_rng(7)
    pods = [
        build_test_pod(f"p{i}", cpu_m=float(rng.integers(50, 2000)),
                       mem=float(rng.integers(64, 4096)) * 2**20)
        for i in range(400)
    ]
    templates = {
        f"ng-{j}": build_test_node(f"t{j}", cpu_m=4000.0 * (1 + j % 3), mem=8 * 2**30)
        for j in range(5)
    }
    before = dict(ffd_scan.LAUNCHES)
    on_card = BinpackingNodeEstimator().estimate_many(pods, templates)
    assert ffd_scan.LAUNCHES["ffd_scan_swar"] == before["ffd_scan_swar"] + 1
    on_cpu = BinpackingNodeEstimator(device="cpu").estimate_many(pods, templates)
    for g in templates:
        assert on_card[g][0] == on_cpu[g][0]
        assert [p.name for p in on_card[g][1]] == [p.name for p in on_cpu[g][1]]


@pytest.mark.parametrize("S", [0, 4, 32])
@pytest.mark.parametrize("T", [5, 40])
def test_affinity_kernel_matches_plain_version(cuda, T, S):
    """K3 against its plain version on the same card tensors, with and
    without spread, one and two term planes."""
    P, G, M = 300, 8, 64
    req, masks, allocs, match, aff, anti, nl, hl, caps = rand_world(T, P=P, G=G, T=T, max_nodes=M)
    spread = rand_spread(np.random.default_rng(S), P, G, S) if S else None
    ops = ffd_scan_affinity.prepare_scan_aff(**ffd_scan_affinity.affinity_operands_from_numpy(
        req, masks, allocs, match, aff, anti, nl, hl, caps, spread, cuda
    ), max_nodes=M)
    before = ffd_scan_affinity.LAUNCHES["ffd_scan_aff"]
    got = ffd_scan_affinity.ffd_scan_aff(ops)
    torch.cuda.synchronize()
    assert ffd_scan_affinity.LAUNCHES["ffd_scan_aff"] == before + 1
    want = ffd_scan_affinity._scan_plain_aff(
        ops.stream, ops.bits, ops.allocs, ops.caps, ops.nl, ops.hl, ops.spstat,
        ops.num_planes, ops.num_spread, M,
    )
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_affinity_kernel_hostname_gate_binds(cuda):
    """A world where the hostname spread gate redirects placements (first
    fit alone would pile the small pods onto node 0): K3 against its plain
    version, and the small pods spread evenly over the open nodes."""
    import autoscaler_tpu_torch.kube.objects as tobj
    import autoscaler_tpu_torch.utils.test_utils as ttu
    from autoscaler_tpu_torch.estimator.binpacking import _spread_tuple
    from autoscaler_tpu_torch.snapshot.affinity import build_spread_terms

    pods = hostname_skew_pods(ttu, tobj)
    templates = [ttu.build_test_node(f"t{g}", cpu_m=4000) for g in range(2)]
    P, G, M, T = len(pods), len(templates), 16, 4
    req = np.zeros((P, 6), np.float32)
    req[:, CPU] = [p.requests.cpu_m for p in pods]
    req[:, PODS] = 1.0
    allocs = np.zeros((G, 6), np.float32)
    allocs[:, CPU] = 4000.0
    allocs[:, PODS] = 110.0
    z = np.zeros((T, P), bool)
    spread = _spread_tuple(build_spread_terms(pods, templates, pad_pods=P, bucket_terms=True))
    ops = ffd_scan_affinity.prepare_scan_aff(**ffd_scan_affinity.affinity_operands_from_numpy(
        req, np.ones((G, P), bool), allocs, z, z, z, np.zeros(T, bool),
        np.zeros((G, T), bool), np.full(G, M, np.int32), spread, cuda,
    ), max_nodes=M)
    got = ffd_scan_affinity.ffd_scan_aff(ops)
    want = ffd_scan_affinity._scan_plain_aff(
        ops.stream, ops.bits, ops.allocs, ops.caps, ops.nl, ops.hl, ops.spstat,
        ops.num_planes, ops.num_spread, M,
    )
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    used = (ops.allocs[0, CPU] - got[0][0, CPU, :4]).tolist()
    assert int(got[1][0]) == 4 and max(used) - min(used) <= 100


def test_affinity_entry_on_card_equals_cpu(cuda):
    P, G, M = 500, 6, 128
    req, masks, allocs, match, aff, anti, nl, hl, caps = rand_world(9, P=P, G=G, T=12, max_nodes=M)
    spread = rand_spread(np.random.default_rng(9), P, G, 8)
    outs = []
    for dev in (cuda, "cpu"):
        ops = ffd_scan_affinity.affinity_operands_from_numpy(
            req, masks, allocs, match, aff, anti, nl, hl, caps, spread, dev
        )
        outs.append(ffd_scan_affinity.ffd_binpack_groups_affinity_cuda(**ops, max_nodes=M))
    assert_results_equal(outs[1], outs[0])


def test_affinity_smem_bytes_from_the_kernel_library(cuda):
    """The C side's formula, as the launch and the estimator's gate read
    it: (R + 2 TP + S) M words of carry, the capacity summaries [R,
    ceil(M / 32)], two staged blocks of 32 steps, the group scalars and
    two rounds' hit slots of GROUP_WARPS warps."""
    for R, TP, S, M in ((6, 1, 32, 1024), (6, 2, 0, 1000), (17, 1, 4, 64)):
        BP = 3 * TP + (2 if S else 0)
        words = ((R + 2 * TP + S) * M + R * -(-M // 32) + 2 * 32 * (R + BP) + 4 * TP
                 + 9 * S + 2 * ffd_scan_affinity.GROUP_WARPS)
        assert ffd_scan_affinity.affinity_smem_bytes(R, TP, S, M) == 4 * words
    assert ffd_scan_affinity.affinity_smem_bytes(6, 1, 0, 1024) < 48 * 1024


def _plain_aff(ops):
    return ffd_scan_affinity._scan_plain_aff(
        ops.stream, ops.bits, ops.allocs, ops.caps, ops.nl, ops.hl, ops.spstat,
        ops.num_planes, ops.num_spread, ops.max_nodes,
    )


@pytest.mark.parametrize("world", AFF_SEARCH_WORLDS)
def test_affinity_kernel_search_edges(cuda, world):
    """K3 against its plain version where the search's rounds, capacity
    summaries, gates and staged steps meet their edges (the worlds of the
    search model in tests/test_torch_ffd_scan_affinity.py): M = 1000 with a
    partial last block, caps 0, 1 and inside a block, a placement on the
    last node of a block, gates that reject capacity hits over several
    rounds, a group-level term that blocks steps, S = 32, ~94 staged
    blocks of 32 steps, masked groups."""
    (req, masks, allocs, match, aff, anti, nl, hl, caps, spread,
     M) = aff_search_world(world)
    ops = ffd_scan_affinity.prepare_scan_aff(**ffd_scan_affinity.affinity_operands_from_numpy(
        req, masks, allocs, match, aff, anti, nl, hl, caps, spread, cuda
    ), max_nodes=M)
    before = ffd_scan_affinity.LAUNCHES["ffd_scan_aff"]
    free, opened, placed = got = ffd_scan_affinity.ffd_scan_aff(ops)
    torch.cuda.synchronize()
    assert ffd_scan_affinity.LAUNCHES["ffd_scan_aff"] == before + 1
    for a, b in zip(_plain_aff(ops), got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if world == "m1000":
        assert opened.tolist() == [1000, 700] and not placed[:, -100:].any()
    elif world == "cap-in-block":
        assert opened.tolist() == [40, 70, 3]
    elif world == "caps-0-1":
        assert opened.tolist() == [0, 1, 0, 1]
    elif world == "last-node-of-block":
        assert int(opened[0]) == 32 and placed[0, :33].all() and float(free[0, CPU, 31]) == 0.0
    elif world == "masked":
        assert int(opened[1]) == 0 and not placed[1].any()
    elif world == "s32":
        assert ops.num_spread == 32


def test_affinity_kernel_empty_stream(cuda):
    """An empty stream stages nothing and places nothing: K3 returns the
    allocs as the carry, as its plain version does."""
    (req, masks, allocs, match, aff, anti, nl, hl, caps, spread,
     M) = aff_search_world("rand")
    ops = ffd_scan_affinity.prepare_scan_aff(**ffd_scan_affinity.affinity_operands_from_numpy(
        req, masks, allocs, match, aff, anti, nl, hl, caps, spread, cuda
    ), max_nodes=M)
    ops = ops._replace(stream=ops.stream[:, :0].contiguous(), bits=ops.bits[:, :0].contiguous())
    got = ffd_scan_affinity.ffd_scan_aff(ops)
    torch.cuda.synchronize()
    for a, b in zip(_plain_aff(ops), got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[2].shape == (4, 0) and not got[1].any()


def test_estimator_dynamic_route_on_card_equals_cpu(cuda):
    from autoscaler_tpu_torch.estimator import binpacking
    from autoscaler_tpu_torch.utils.workload import build_spread_world

    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics

    pods, templates = build_spread_world(600, 4, 6, seed=3)
    metrics = AutoscalerMetrics()
    launches = ffd_scan_affinity.LAUNCHES["ffd_scan_aff"]
    on_card = binpacking.BinpackingNodeEstimator(metrics=metrics).estimate_many(pods, templates)
    assert metrics.estimator_kernel_route_total.values == {
        (("reason", "ok"), ("route", "cuda_affinity")): 1.0}
    assert ffd_scan_affinity.LAUNCHES["ffd_scan_aff"] == launches + 1
    on_cpu = binpacking.BinpackingNodeEstimator(device="cpu").estimate_many(pods, templates)
    for g in templates:
        assert on_card[g][0] == on_cpu[g][0]
        assert [p.name for p in on_card[g][1]] == [p.name for p in on_cpu[g][1]]


@pytest.mark.parametrize(
    "P,N,R,CP,CN",
    [(64, 64, 6, 4, 3), (1000, 1500, 6, 40, 24), (300, 700, 11, 4, 3),
     (70, 130, 1, 8, 8), (517, 2049, 8, 200, 200),
     # ragged: N < 32, P past one block, R = 9, CN = 32 / 33, CP = 64 / 65
     (513, 20, 6, 8, 8), (700, 300, 9, 65, 33), (300, 400, 8, 64, 32),
     (260, 255, 6, 65, 33), (130, 519, 1, 8, 8), (1025, 768, 8, 64, 33)],
)
def test_fit_reduce_kernel_matches_plain_version(cuda, P, N, R, CP, CN):
    """K4 against its plain version on the same card tensors: ragged
    sizes, R from 1 to 11 (the generic-R path above 8), a class mask too
    large for shared memory (200 x 200), and the launch count."""
    ops = tuple(torch.tensor(a, device=cuda) for a in fit_case(P + N, P, N, R, CP, CN))
    before = fit_reduce.LAUNCHES["fit_reduce"]
    got = fit_reduce.fit_reduce_cuda(*ops)
    torch.cuda.synchronize()
    assert fit_reduce.LAUNCHES["fit_reduce"] == before + 1
    want = fit_reduce._fit_reduce_plain(*ops)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ref = fit_reduce.reference_fit_reduce(*fit_case(P + N, P, N, R, CP, CN))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b.cpu().numpy())


def test_fit_reduce_kernel_at_fit_bench_shape(cuda):
    from autoscaler_tpu_torch.utils.workload import build_fit_workload

    ops = tuple(torch.tensor(a, device=cuda) for a in build_fit_workload())
    got = fit_reduce.fit_reduce_cuda(*ops)
    want = fit_reduce._fit_reduce_plain(*ops)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_fit_reduce_exact_on_card_equals_cpu(cuda):
    """The snapshot path on the card (pack, K4, the exact patch) against
    the same calls on the CPU, on a factored world with exception rows and
    single-cell overrides."""
    import autoscaler_tpu_torch.kube.objects as tobj
    import autoscaler_tpu_torch.utils.test_utils as ttu
    from autoscaler_tpu_torch.snapshot.packer import pack
    from torch_parity import mask_world

    nodes, pods, _ = mask_world(ttu, tobj, 0, P=300, N=40)
    outs = []
    for dev in (cuda, "cpu"):
        t, _ = pack(nodes, pods, dense_mask=False, device=dev)
        outs.append(fit_reduce.fit_reduce_exact(t))
    assert (t.pod_exc >= 0).any() and (t.cell_pod >= 0).any()
    for a, b in zip(outs[1], outs[0]):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("S,N,R", [(5, 20, 6), (515, 528, 6), (40, 261, 9), (33, 64, 1),
                                   (700, 1000, 8)])
def test_fit_reduce_rows_kernel_matches_plain_version(cuda, S, N, R):
    """K4's rows entry against its plain version on the same card tensors:
    rows staged by the aligned path (N a multiple of 16) and byte by byte,
    the generic path (R = 9), and the launch count."""
    from torch_parity import rows_case

    ops = tuple(torch.tensor(a, device=cuda) for a in rows_case(S + N, S, N, R))
    before = fit_reduce.LAUNCHES["fit_reduce_rows"]
    got = fit_reduce.fit_reduce_rows(*ops)
    torch.cuda.synchronize()
    assert fit_reduce.LAUNCHES["fit_reduce_rows"] == before + 1
    want = fit_reduce._fit_reduce_rows_plain(*ops)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("S,N,R", [(3 * 512 + 7, 528, 6), (700, 261, 9), (40, 64, 1)])
def test_fit_reduce_rows_kernel_skips_padding_slots(cuda, S, N, R):
    """The rows entry told the slots: padding rows (a negative slot, here
    with requests of NaN, which would keep every resource live) count
    nothing, a block of them leaves at once, and the rest equal the plain
    version; the compacting kernel, the generic path and the aligned and
    byte-by-byte staging."""
    from torch_parity import rows_case

    req, free, rows, slots = rows_case(S + N, S, N, R, padding=0.2)
    slots[512:1024] = -1
    req[slots < 0] = np.nan
    ops = tuple(torch.tensor(a, device=cuda) for a in (req, free, rows, slots))
    got = fit_reduce.fit_reduce_rows(*ops)
    want = fit_reduce._fit_reduce_rows_plain(*ops)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not got.fit_count[ops[3] < 0].any() and got.fit_count.any()


def test_fit_reduce_waits_on_no_host_value(cuda):
    """K4's launch and the factored snapshot's exact reduction run under
    the sync debug mode "error": any wait on the card raises."""
    import autoscaler_tpu_torch.kube.objects as tobj
    import autoscaler_tpu_torch.utils.test_utils as ttu
    from autoscaler_tpu_torch.snapshot.packer import pack
    from torch_parity import mask_world

    nodes, pods, _ = mask_world(ttu, tobj, 0, P=300, N=40)
    t, _ = pack(nodes, pods, dense_mask=False, device=cuda)
    ops = tuple(torch.tensor(a, device=cuda) for a in fit_case(3, 600, 700))
    want = (fit_reduce.fit_reduce_cuda(*ops), fit_reduce.fit_reduce_exact(t))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = (fit_reduce.fit_reduce_cuda(*ops), fit_reduce.fit_reduce_exact(t))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(want, got):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("ports,route", [(4, ("torch_scan", "smem")), (3, ("cuda", "ok"))])
def test_plain_route_gate_on_card(cuda, ports, route):
    """At a scan cap of 8192, 7 f32 planes ask for more shared memory than
    a block may use: the cuda rung's gate answers smem and the torch loop
    serves, equal to the CPU estimate; one plane fewer launches K1."""
    from autoscaler_tpu_torch.estimator import binpacking
    from autoscaler_tpu_torch.estimator.limiter import ThresholdBasedEstimationLimiter
    from autoscaler_tpu_torch.utils import test_utils as ttu
    from torch_parity import port_world

    pods, templates = port_world(ttu, 300, ports=ports)
    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics

    limiter = ThresholdBasedEstimationLimiter(max_nodes=5000)
    metrics = AutoscalerMetrics()
    launches = dict(ffd_scan.LAUNCHES)
    on_card = binpacking.BinpackingNodeEstimator(limiter, metrics=metrics).estimate_many(
        pods, templates)
    torch.cuda.synchronize()
    assert metrics.estimator_kernel_route_total.values == {
        (("reason", route[1]), ("route", route[0])): 1.0}
    assert ffd_scan.LAUNCHES["ffd_scan_f32"] == launches["ffd_scan_f32"] + int(route[0] == "cuda")
    assert ffd_scan.LAUNCHES["ffd_scan_swar"] == launches["ffd_scan_swar"]
    on_cpu = binpacking.BinpackingNodeEstimator(limiter, device="cpu").estimate_many(pods, templates)
    assert any(n > 0 for n, _ in on_card.values())
    for g in templates:
        assert on_card[g][0] == on_cpu[g][0]
        assert [p.name for p in on_card[g][1]] == [p.name for p in on_cpu[g][1]]


@pytest.mark.parametrize("P,N,R,CN,rows", [(100_000, 15_000, 6, 24, False),
                                           (131_072, 16_384, 6, 16, False),
                                           (5_143, 16_384, 6, 0, True), (300, 700, 11, 3, False)])
def test_fit_reduce_launch_geometry(cuda, P, N, R, CN, rows):
    """The launch geometry the kernel library reports is the numpy model's
    split (tests/test_torch_fit_reduce_model.py) at the card's
    multiprocessor count and the kernel's resident blocks."""
    from test_torch_fit_reduce_model import geometry

    gx, gy, per_sm = fit_reduce.launch_geometry(P, N, R, 40, CN, rows=rows)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert per_sm >= 1
    assert (gx, gy) == geometry(P, N, sms, per_sm)[:2]


def _tick(spread, device, metrics=None):
    """The scale-up half of tests/torch_parity.tick_world's tick on
    ``device``: fork, filter-out, revert, scale_up (least-waste, seeded),
    the estimator's routes counted on ``metrics``."""
    import autoscaler_tpu_torch.cloudprovider.test_provider as tprov
    import autoscaler_tpu_torch.kube.objects as tobj
    import autoscaler_tpu_torch.snapshot.cluster_snapshot as tcs
    import autoscaler_tpu_torch.utils.test_utils as ttu
    from autoscaler_tpu_torch.clusterstate.registry import ClusterStateRegistry
    from autoscaler_tpu_torch.config.options import AutoscalingOptions
    from autoscaler_tpu_torch.core.podlistprocessor import FilterOutSchedulablePodListProcessor
    from autoscaler_tpu_torch.core.scaleup.orchestrator import ScaleUpOrchestrator
    from torch_parity import canon, tick_world

    snap, pending, provider = tick_world(ttu, tobj, tprov, tcs, spread, device=device)
    snap.fork()
    still, filtered = FilterOutSchedulablePodListProcessor().process(snap, pending)
    snap.revert()
    opts = AutoscalingOptions(expander="least-waste", expander_random_seed=0)
    orch = ScaleUpOrchestrator(provider, opts, ClusterStateRegistry(provider, opts),
                               device=device, metrics=metrics)
    res = orch.scale_up(still, snap.nodes(), 5.0, pods_of_node=snap.pods_on_node)
    return ([p.key() for p in filtered], [p.key() for p in still], canon(res),
            [(g.id(), g.target_size()) for g in provider.node_groups()])


@pytest.mark.parametrize("spread,route,kernel", [(False, "cuda", "ffd_scan_swar"),
                                                 (True, "cuda_affinity", "ffd_scan_aff")])
@pytest.mark.parametrize("factored", [False, True], ids=["dense", "factored"])
def test_scale_up_tick_on_card_equals_cpu(cuda, spread, route, kernel, factored, monkeypatch):
    """The tick's filter-out loop runs on the card and its estimate
    launches the kernel its route names; every filtered key, the whole
    ScaleUpResult and the provider afterwards equal the tick on the CPU."""
    from autoscaler_tpu_torch.ops import schedule
    from autoscaler_tpu_torch.snapshot import packer

    if factored:
        monkeypatch.setattr(packer, "DENSE_MASK_CELL_LIMIT", 16)
    devices = []
    real = schedule.greedy_schedule

    def spy(snap, *args, **kwargs):
        out = real(snap, *args, **kwargs)
        devices.append((snap.sched_mask is None, out.placed.device.type, out.dest.device.type))
        return out

    monkeypatch.setattr(schedule, "greedy_schedule", spy)
    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics

    metrics = AutoscalerMetrics()
    launches = {**ffd_scan.LAUNCHES, **ffd_scan_affinity.LAUNCHES}
    on_card = _tick(spread, cuda, metrics)
    torch.cuda.synchronize()
    assert devices == [(factored, "cuda", "cuda")]
    assert metrics.estimator_kernel_route_total.get(route=route, reason="ok") == 1
    now = {**ffd_scan.LAUNCHES, **ffd_scan_affinity.LAUNCHES}
    assert now[kernel] == launches[kernel] + 1
    assert _tick(spread, "cpu") == on_card
    assert on_card[0] and on_card[1]


def test_greedy_schedule_waits_on_no_host_value(cuda, monkeypatch):
    """The greedy loop on a factored snapshot with the spread gate in play
    runs under the sync debug mode "error" (no step makes the host wait),
    and equals the loop on the CPU."""
    import autoscaler_tpu_torch.kube.objects as tobj
    import autoscaler_tpu_torch.utils.test_utils as ttu
    from autoscaler_tpu_torch.ops.schedule import greedy_schedule
    from autoscaler_tpu_torch.snapshot.affinity import build_spread_context_from_meta
    from autoscaler_tpu_torch.snapshot.packer import pack
    from torch_parity import mask_world

    nodes, pods, _ = mask_world(ttu, tobj, 2, P=300, N=40)
    for i, p in enumerate(pods):
        if not p.node_name and i % 3 == 0:
            p.topology_spread = (tobj.TopologySpreadConstraint(
                max_skew=1, topology_key="zone",
                selector=tobj.LabelSelector.from_dict({"app": p.labels["app"]}),
            ),)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        t, meta = pack(nodes, pods, dense_mask=False, device=dev)
        pending = [p for p in meta.pods if not p.node_name]
        ctx = build_spread_context_from_meta(pending, meta, t)
        slots = torch.tensor([meta.pod_index[p.key()] for p in pending] + [-1],
                             dtype=torch.int32, device=dev)
        hints = torch.full_like(slots, -1)
        hints[::4] = 3
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            res = greedy_schedule(t, slots, hints, spread=ctx)
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        out[dev.type] = (res.placed.cpu(), res.dest.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert out["cpu"][0].any()


def _packer_world(seed=4):
    import autoscaler_tpu_torch.kube.objects as tobj
    import autoscaler_tpu_torch.utils.test_utils as ttu
    from torch_parity import mask_world

    return mask_world(ttu, tobj, seed, P=200, N=30)


def _listing(nodes, pods, device, packer):
    from autoscaler_tpu_torch.tools.tick_probe import listing_snapshot

    return listing_snapshot(nodes, pods, device, packer).tensors()


@pytest.mark.parametrize("factored", [False, True], ids=["dense", "factored"])
def test_arena_on_card_serves_the_cpu_packers_tensors(cuda, factored):
    """A packer with a DeviceArena on the card over three listings (a seed,
    then deltas: pods rebound, removed and added, a node gone) serves
    tensors equal bit for bit to a CPU packer's over the same listings; no
    full upload after the seed, no rollback, nothing left on the host."""
    import copy

    from autoscaler_tpu_torch.snapshot.arena import DeviceArena
    from autoscaler_tpu_torch.snapshot.incremental import IncrementalPacker
    from autoscaler_tpu_torch.tools.tick_probe import fields_differing

    nodes, pods, _ = _packer_world()
    dense = not factored
    arena = DeviceArena(device=cuda)
    card = IncrementalPacker(dense_mask=dense, arena=arena, device=cuda)
    cpu = IncrementalPacker(dense_mask=dense, device="cpu")
    listings = [(nodes, pods)]
    moved = [copy.copy(p) for p in pods[:20]]
    for p in moved:
        p.node_name = nodes[3].name
    listings.append((nodes, moved + pods[20:-10]))
    listings.append((nodes[:-1], moved[5:] + pods[20:-10] + pods[-4:]))
    for k, (n, p) in enumerate(listings):
        on_card, meta_card = _listing(n, p, cuda, card)
        torch.cuda.synchronize()
        on_cpu, meta_cpu = _listing(n, p, "cpu", cpu)
        assert on_card.pod_req.device.type == "cuda"
        assert meta_card.pod_index == meta_cpu.pod_index
        assert fields_differing(
            type(on_card)(**{f: (None if v is None else v.cpu())
                             for f, v in vars(on_card).items()}), on_cpu) == []
        stats = arena.take_stats()
        assert stats["rollbacks"] == 0
        assert (stats["full_uploads"] > 0) == (k == 0)


@pytest.mark.parametrize("hold", ["nothing", "view"])
def test_arena_writes_in_place_unless_a_view_is_held_on_card(cuda, hold):
    import numpy as np

    from autoscaler_tpu_torch.snapshot import arena as tarena

    arena = tarena.DeviceArena(device=cuda)
    host = {"pod_req": np.zeros((64, 6), np.float32)}
    arena.apply(tarena.DeltaProgram(host=host, reseed=True))

    def step(row, value):
        host["pod_req"][row] = value
        op = tarena.DeltaOp("pod_req", 0, np.array([row], np.int32), host["pod_req"][[row]])
        return arena.apply(tarena.DeltaProgram(host=host, ops=[op]))["pod_req"]

    step(1, 1.0)
    step(2, 2.0)
    served = step(3, 3.0)
    ptr = served.data_ptr()
    view = served[2:5] if hold == "view" else None
    del served
    step(4, 4.0)
    again = step(5, 5.0)
    torch.cuda.synchronize()
    assert again[:6, 0].tolist() == [0, 1, 2, 3, 4, 5]
    if view is None:
        assert arena.clones == 0 and again.data_ptr() == ptr
    else:
        assert arena.clones == 1 and view[:, 0].tolist() == [2.0, 3.0, 0.0]


def test_arena_scatter_drops_padding_of_device_indices(cuda):
    """A padded batch whose indices already live on the card: the padding
    (index == axis length) is selected away there, never handed to the
    scatter, and the result equals the same batch on the CPU."""
    import numpy as np

    from autoscaler_tpu_torch.ops.arena_apply import arena_scatter_cols, arena_scatter_rows

    rng = np.random.default_rng(3)
    buf = rng.standard_normal((50, 6)).astype(np.float32)
    idx = np.array([3, 7, 20, 49, 50, 50, 50, 50], np.int32)
    rows = rng.standard_normal((8, 6)).astype(np.float32)
    want = arena_scatter_rows(torch.tensor(buf), idx, rows)
    got = arena_scatter_rows(torch.tensor(buf, device=cuda), torch.tensor(idx, device=cuda),
                             torch.tensor(rows, device=cuda))
    assert torch.equal(got.cpu(), want)
    mask = rng.random((9, 50)) < 0.5
    cols = rng.random((9, 8)) < 0.5
    want = arena_scatter_cols(torch.tensor(mask), idx, cols)
    got = arena_scatter_cols(torch.tensor(mask, device=cuda), torch.tensor(idx, device=cuda),
                             torch.tensor(cols, device=cuda))
    assert torch.equal(got.cpu(), want)


def test_operand_arena_keys_by_device_on_card(cuda):
    import numpy as np

    import autoscaler_tpu_torch.utils.test_utils as ttu
    from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
    from autoscaler_tpu_torch.snapshot.arena import OperandArena
    from torch_parity import canon, port_world

    oa = OperandArena(device=cuda)
    a = np.arange(12, dtype=np.float32)
    on_card = oa.resident(a)
    on_cpu = oa.resident(a, device="cpu")
    assert on_card.device.type == "cuda" and on_cpu.device.type == "cpu"
    assert oa.resident(a) is on_card and oa.stats()["misses"] == 2
    pods, templates = port_world(ttu, 150, ports=2)
    est = BinpackingNodeEstimator(device=cuda, operand_arena=OperandArena(device=cuda))
    first, second = est.estimate_many(pods, templates), est.estimate_many(pods, templates)
    plain = BinpackingNodeEstimator(device="cpu").estimate_many(pods, templates)
    assert canon(first) == canon(second) == canon(plain)
    assert est.operand_arena.stats()["hits"] > 0


def test_tick_sequence_on_card_equals_cpu(cuda):
    """tests/torch_parity.tick_world's cluster over three ticks through a
    packer carried across them, on the card and on the CPU: every tick's
    result equal, ticks 2 and 3 incremental on both."""
    import autoscaler_tpu_torch.cloudprovider.test_provider as tprov
    import autoscaler_tpu_torch.kube.objects as tobj
    import autoscaler_tpu_torch.snapshot.cluster_snapshot as tcs
    import autoscaler_tpu_torch.utils.test_utils as ttu
    from autoscaler_tpu_torch.snapshot.incremental import IncrementalPacker
    from autoscaler_tpu_torch.tools import tick_probe
    from torch_parity import tick_world

    snap, _pending, provider = tick_world(ttu, tobj, tprov, tcs, False, device="cpu")
    templates = {g.id(): g.template_node_info() for g in provider.node_groups()}
    nodes = snap.nodes() + [ttu.build_test_node(f"spare-{k}", cpu_m=500) for k in range(5)]
    churns = ({"seed": 1, "remove_share": 0.2, "arrive": 6, "grow": True},
              {"seed": 2, "remove": 2, "arrive": 3, "grow": False})
    card = tick_probe.run_sequence(nodes, snap.pods(), templates, cuda,
                                   IncrementalPacker(device=cuda), churns=churns)
    for nodes_k, pods_k, _c, rec in card:
        cpu = tick_probe.run_tick(nodes_k, pods_k, (), templates, "cpu")
        assert tick_probe.tick_differences(rec["out"], cpu["out"]) == []
    assert [rec["packer"]["incremental_updates"] for *_, rec in card] == [0, 1, 2]


def _removal_operands(dev, seed, factored, spread, C=10):
    """The world of tests/torch_parity.removal_arrays on ``dev``: the
    operands of a per-candidate and a joint removal pass (with a random
    spread context when ``spread``)."""
    from autoscaler_tpu_torch.snapshot.affinity import spread_context_from_numpy
    from autoscaler_tpu_torch.snapshot.tensors import tensors_from_numpy
    from torch_parity import lanes_of, removal_arrays, removal_spread_context

    arrays = removal_arrays(seed, factored=factored)
    arrays["node_alloc"][0, CPU] = 9000
    cand, slots, blocked, excluded = lanes_of(arrays, C=C, seed=seed)
    t = tensors_from_numpy(arrays, device=dev)
    lanes = [torch.tensor(a, device=dev) for a in (cand, slots, blocked, excluded)]
    extra = ()
    if spread:
        ctx, sub = removal_spread_context(arrays, C, seed)
        t9 = spread_context_from_numpy(ctx, device=dev)
        extra = (t9[:5] + t9[6:], t9[5], torch.tensor(sub, device=dev))
    return t, lanes, extra


def _removal_passes(dev, seed, factored, spread):
    from autoscaler_tpu_torch.ops import scaledown as sd

    t, (cand, slots, blocked, excluded), extra = _removal_operands(dev, seed, factored, spread)
    if spread:
        per = sd.removal_feasibility_spread(t, cand, slots, blocked, *extra)
        joint = sd.joint_removal_feasibility_spread(t, cand, slots, excluded, *extra)
    else:
        per = sd.removal_feasibility(t, cand, slots, blocked)
        joint = sd.joint_removal_feasibility(t, cand, slots, excluded)
    return [x.cpu() for x in per + joint]


@pytest.mark.parametrize("spread", [False, True], ids=["plain", "spread"])
@pytest.mark.parametrize("factored", [False, True], ids=["dense", "factored"])
def test_removal_passes_on_card_equal_cpu(cuda, factored, spread, monkeypatch):
    """The per-candidate and the joint removal passes on the card against
    the same calls on the CPU, with C = 10 lanes in chunks of 3 (a ragged
    last chunk) on the card and one chunk on the CPU."""
    from autoscaler_tpu_torch.ops import scaledown as sd

    cpu = _removal_passes("cpu", 3, factored, spread)
    t, _, extra = _removal_operands(cuda, 3, factored, spread)
    terms = 0 if not spread else int(extra[1].shape[0])
    monkeypatch.setattr(sd, "LANE_BYTES", 3 * sd.lane_bytes(t, terms))
    assert sd.lane_chunk(t, terms) == 3
    card = _removal_passes(cuda, 3, factored, spread)
    for a, b in zip(cpu, card):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert cpu[0].any() and not cpu[0].all()


def test_removal_slot_loop_waits_on_no_host_value(cuda):
    """The slot loop of a chunk of lanes, spread counts and the factored
    mask in play, runs under the sync debug mode "error": no step makes the
    host wait; it equals the loop on the CPU."""
    from autoscaler_tpu_torch.ops import scaledown as sd
    from autoscaler_tpu_torch.ops.schedule import _spread_static

    out = {}
    for dev in (cuda, torch.device("cpu")):
        t, (cand, slots, _blocked, excluded), (sp8, counts, sub) = _removal_operands(
            dev, 4, True, True)
        steps = sd.filled_slots(slots)
        nodes = cand.long()
        free = t.free().T.contiguous().expand(nodes.shape[0], -1, -1).contiguous()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            flat = sd._start_counts(sp8, counts, nodes, sub)
            lanes = sd._Lanes(t, free, exclude_node=nodes, spread=(sp8, _spread_static(sp8)),
                              counts_flat=flat)
            res = lanes.run(slots[:, :steps].long())
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        out[dev.type] = [x.cpu() for x in res]
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("label", ["3m", "3n"])
def test_scale_down_on_card_equals_cpu(cuda, label):
    """chip_smoke's 3m and 3n at a small size (tests/test_torch_scaledown's
    scale-in world): both loops and the actuation on the card, field for
    field equal to the CPU; the dispatches ran on the card."""
    from autoscaler_tpu_torch.tools import scaledown_probe
    from autoscaler_tpu_torch.utils.workload import build_snapshot_world

    nodes, pods = build_snapshot_world(N=160, P=1200, port_nodes=50, apps=30)
    spread, kw = (0, {}) if label == "3m" else (8, scaledown_probe.WIDE_REFIT)
    nodes, pods = scaledown_probe.scale_in_listing(nodes, pods, removed_apps=10,
                                                   spread_apps=spread)
    card = scaledown_probe.run_scale_down(nodes, pods, cuda, kw, timed=True)
    cpu = scaledown_probe.run_scale_down(nodes, pods, "cpu", kw)
    assert scaledown_probe.scaledown_differences(card["out"], cpu["out"]) == []
    ops = card["loops"][-1]["dispatch_ops"]
    assert ops[1][0].device.type == "cuda"
    assert card["loops"][-1]["dispatch_span_ms"] > 0
    assert card["out"]["actuation"]["deleted_empty"]


@pytest.mark.parametrize("R", [6, 9])
def test_attribution_on_card_waits_on_no_host_value(cuda, R):
    """The estimator's constraint attribution on card tensors: no step
    waits on the host (the host fetches its two small outputs after it),
    and the reasons, histograms and dominant reasons equal the CPU's."""
    from autoscaler_tpu_torch.ops import binpack

    rng = np.random.default_rng(R)
    P, G = 300, 7
    req = rng.integers(0, 8, (P, R)).astype(np.float32)
    req[:, CPU] = rng.integers(100, 4000, P)
    req[:, MEMORY] = rng.integers(64, 8192, P)
    req[:, PODS] = 1.0
    allocs = rng.integers(0, 8, (G, R)).astype(np.float32)
    allocs[:, CPU] = rng.integers(1000, 4000, G)
    allocs[:, MEMORY] = rng.integers(2048, 8192, G)
    allocs[:, PODS] = rng.integers(0, 2, G)
    on_cpu = [torch.tensor(a) for a in (req, rng.random((G, P)) > 0.2, allocs,
                                        rng.random((G, P)) > 0.7, rng.random(P) > 0.6)]
    weights = torch.tensor(rng.integers(0, 4, (G, P)).astype(np.int32))
    on_card = [t.to(cuda) for t in on_cpu]
    w_card = weights.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        reasons = binpack.attribute_unschedulable(*on_card)
        hist, dom = binpack.attribution_summary(reasons, w_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = binpack.attribute_unschedulable(*on_cpu)
    ref_hist, ref_dom = binpack.attribution_summary(ref, weights)
    assert reasons.device.type == "cuda" and torch.equal(reasons.cpu(), ref)
    assert torch.equal(hist.cpu(), ref_hist) and torch.equal(dom.cpu(), ref_dom)


def test_loop_on_card_equals_cpu(cuda):
    """tools/loop_probe's three ticks of StaticAutoscaler.run_once on a
    small scale-in world, on the card and again on the CPU: every tick's
    RunOnceResult, provider, API, decision, journal and SLO lines equal,
    the journal's probe (K4 on factored snapshots) finding no drift, the
    third tick's estimate on the dynamic route."""
    from autoscaler_tpu_torch.tools import loop_probe
    from autoscaler_tpu_torch.utils.workload import build_snapshot_world

    nodes, pods = loop_probe.scale_in_listing(*build_snapshot_world(N=300, P=2000, port_nodes=100))
    templates, burst = loop_probe.burst_operands()
    groups = loop_probe.zoned_templates(templates)
    card = loop_probe.run_loop_ticks(nodes, pods, burst[:600], groups, cuda, arrive=100,
                                     replayable=True)
    routes = card["autoscaler"].metrics.estimator_kernel_route_total
    cpu = loop_probe.run_loop_ticks(nodes, pods, burst[:600], groups, "cpu", arrive=100,
                                    replayable=True)
    for a, b in zip(card["ticks"], cpu["ticks"]):
        assert loop_probe.state_differences(a["state"], b["state"]) == []
        assert a["probe"]["checked"] and not a["probe"]["drift"]
    assert card["autoscaler"]._packer.device.type == "cuda"
    assert routes.get(route="cuda", reason="ok") >= 1
    assert routes.get(route="cuda_affinity", reason="ok") == 1
    assert card["autoscaler"].degraded_rungs() == []


@pytest.mark.parametrize("kind", ["plain", "dynamic"])
def test_failed_kernel_build_is_a_fault_on_card(cuda, kind, monkeypatch, tmp_path, caplog):
    """On a CUDA card, a kernel source that does not build is a fault of
    the cuda rung, never an unavailability, and it has no fallback: each
    estimate raises, the fault is counted with outcome fault and logged at
    WARNING, the breaker trips after its threshold, and past it the open
    breaker raises too; no lower rung serves."""
    from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
    from autoscaler_tpu_torch.estimator.ladder import KernelLadder
    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics
    from autoscaler_tpu_torch.ops import _build
    from autoscaler_tpu_torch.utils.errors import AutoscalerError
    from autoscaler_tpu_torch.utils.workload import build_spread_world
    from autoscaler_tpu_torch.utils import test_utils as ttu
    from torch_parity import port_world

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    if kind == "plain":
        pods, templates = port_world(ttu, 200, ports=2)
    else:
        pods, templates = build_spread_world(600, 4, 6, seed=3)
    metrics = AutoscalerMetrics()
    ladder = KernelLadder(failure_threshold=2, cooldown_s=60.0)
    est = BinpackingNodeEstimator(metrics=metrics, ladder=ladder)
    with caplog.at_level("WARNING", logger="estimator"):
        for now, raised in ((0.0, RuntimeError), (1.0, RuntimeError), (2.0, AutoscalerError)):
            ladder.tick(now)
            with pytest.raises(raised):
                est.estimate_many(pods, templates)
    attempts = metrics.estimator_kernel_rung_attempts_total
    assert attempts.get(rung="cuda", outcome="fault") == 2
    assert attempts.get(rung="cuda", outcome="skipped") == 1
    assert attempts.get(rung="cuda", outcome="unavailable") == 0
    assert sum(attempts.get(rung=r, outcome="ok") for r in ("torch", "native", "python")) == 0
    assert sum(metrics.estimator_kernel_route_total.values.values()) == 0
    assert ladder.degraded() == ["cuda"]
    assert any(r.levelname == "WARNING" for r in caplog.records if r.name == "estimator")


def test_ladder_fault_walk_on_card(cuda):
    """Three faults armed on the cuda rung: on the card each faulted
    estimate raises and launches nothing (the kernels have no fallback),
    the breaker opens at the third and the estimate past it raises too;
    past the cooldown one half-open probe on the cuda rung launches the
    kernel, serves the first decisions and closes it."""
    from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
    from autoscaler_tpu_torch.estimator.ladder import KernelLadder
    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics
    from autoscaler_tpu_torch.utils.errors import AutoscalerError
    from autoscaler_tpu_torch.utils import test_utils as ttu
    from torch_parity import port_world

    pods, templates = port_world(ttu, 200, ports=2)
    metrics = AutoscalerMetrics()
    ladder = KernelLadder(failure_threshold=3, cooldown_s=30.0)
    est = BinpackingNodeEstimator(metrics=metrics, ladder=ladder)
    armed = {"left": 0}

    def hook(rung):
        if rung == "cuda" and armed["left"]:
            armed["left"] -= 1
            return "kernel_fault"
        return None

    ladder.fault_hook = hook
    first = None
    for i, now in enumerate((0.0, 1.0, 2.0, 3.0, 4.0, 40.0)):
        ladder.tick(now)
        armed["left"] += 3 * (i == 1)
        launches = sum(ffd_scan.LAUNCHES.values())
        if 0 < i < 5:                  # three faults, then the open breaker
            with pytest.raises(AutoscalerError):
                est.estimate_many(pods, templates)
        else:
            out = est.estimate_many(pods, templates)
            out = {g: (c, [p.name for p in s]) for g, (c, s) in out.items()}
            first = first or out
            assert out == first
        assert (sum(ffd_scan.LAUNCHES.values()) - launches) == int(i in (0, 5))
        assert ladder.degraded() == (["cuda"] if i in (3, 4) else [])
    assert ladder.degraded() == []
    routes = metrics.estimator_kernel_route_total
    assert routes.get(route="cuda", reason="ok") == 2 == sum(routes.values.values())
    attempts = metrics.estimator_kernel_rung_attempts_total
    assert attempts.get(rung="cuda", outcome="fault") == 3
    assert attempts.get(rung="cuda", outcome="skipped") == 1


@pytest.mark.parametrize("kind", ["dedup", "single"])
def test_torch_rung_fault_walk_on_card(cuda, kind):
    """Two faults armed on the torch rung, which serves a card's dedup
    dispatches (route torch_runs) and single-template estimates
    (torch_single): each faulted estimate raises, the breaker opens at the
    second and the estimate past it raises too, and no host rung serves;
    past the cooldown one half-open probe on the torch rung serves the
    first decisions and closes it."""
    import dataclasses

    from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
    from autoscaler_tpu_torch.estimator.ladder import KernelLadder
    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics
    from autoscaler_tpu_torch.utils.errors import AutoscalerError
    from autoscaler_tpu_torch.utils import test_utils as ttu

    # replicas of one controller: one equivalence group, so the dedup route
    pods = [ttu.build_test_pod(f"alike{i}", cpu_m=500.0, mem=512 * 2**20) for i in range(60)]
    pods = [dataclasses.replace(p, owner_ref=dataclasses.replace(p.owner_ref, name="alike-rs"))
            for p in pods]
    templates = {f"ng-{j}": ttu.build_test_node(f"t{j}", cpu_m=4000.0 * (1 + j), mem=8 * 2**30)
                 for j in range(3)}
    label = "torch_runs" if kind == "dedup" else "torch_single"
    metrics = AutoscalerMetrics()
    ladder = KernelLadder(failure_threshold=2, cooldown_s=30.0)
    est = BinpackingNodeEstimator(metrics=metrics, ladder=ladder)
    armed = {"left": 2}

    def hook(rung):
        if rung == "torch" and armed["left"]:
            armed["left"] -= 1
            return "kernel_fault"
        return None

    def estimate():
        if kind == "dedup":
            out = est.estimate_many(pods, templates)
        else:
            out = {"ng-0": est.estimate(pods, templates["ng-0"], max_size_headroom=3)}
        return {g: (c, [p.name for p in s]) for g, (c, s) in out.items()}

    ladder.fault_hook = hook
    for i, now in enumerate((0.0, 1.0, 2.0)):
        ladder.tick(now)
        with pytest.raises(AutoscalerError):
            estimate()
        assert ladder.degraded() == (["torch"] if i else [])
    ladder.tick(40.0)
    first = estimate()
    assert any(c > 0 for c, _ in first.values())
    assert ladder.degraded() == []
    routes = metrics.estimator_kernel_route_total
    assert sum(routes.values.values()) == 1
    assert sum(v for k, v in routes.values.items() if dict(k)["route"] == label) == 1
    assert metrics.estimator_breaker_transitions_total.get(
        rung="torch", from_state="half_open", to_state="closed") == 1
    attempts = metrics.estimator_kernel_rung_attempts_total
    assert attempts.get(rung="torch", outcome="fault") == 2
    assert attempts.get(rung="torch", outcome="skipped") == 1
    assert sum(attempts.get(rung=r, outcome="ok") for r in ("native", "python")) == 0


def test_bound_tick_on_card_equals_cpu(cuda, monkeypatch):
    """tools/bound_loop's ticks over HTTP (the fake Kubernetes API in a
    child process, the watch caches, the clusterapi provider, Lease
    election) on a small scale-in world, on the card and again on the CPU:
    K2 and K4 launch on the card (the dense-mask limit lowered so that the
    small world packs factored and the journal's probe takes K4), and every
    tick's RunOnceResult, target sizes and recorded writes equal the
    CPU's."""
    from autoscaler_tpu_torch.snapshot import incremental, packer
    from autoscaler_tpu_torch.tools import bound_loop, loop_probe
    from autoscaler_tpu_torch.utils.workload import build_snapshot_world

    # the incremental packer holds its own binding of the limit
    for mod in (packer, incremental):
        monkeypatch.setattr(mod, "DENSE_MASK_CELL_LIMIT", 1 << 10)

    nodes, pods = loop_probe.scale_in_listing(*build_snapshot_world(N=300, P=2000, port_nodes=100))
    templates, burst = loop_probe.burst_operands()
    groups = loop_probe.zoned_templates(templates)
    before = {**ffd_scan.LAUNCHES, **fit_reduce.LAUNCHES}
    card = bound_loop.run_bound_ticks(nodes, pods, burst[:600], groups, cuda, arrive=100,
                                      replayable=True)
    launched = {k: v - before[k] for k, v in {**ffd_scan.LAUNCHES, **fit_reduce.LAUNCHES}.items()}
    cpu = bound_loop.run_bound_ticks(nodes, pods, burst[:600], groups, "cpu", arrive=100,
                                     replayable=True)
    assert launched["ffd_scan_swar"] >= 1 and launched["fit_reduce"] >= 3, launched
    for a, b in zip(card["ticks"], cpu["ticks"]):
        assert loop_probe.result_canon(a["result"]) == loop_probe.result_canon(b["result"])
        assert a["targets"] == b["targets"] and not a["decisions"]["errors"]
        assert bound_loop.write_canon(a["writes"]) == bound_loop.write_canon(b["writes"])
    assert card["autoscaler"]._packer.device.type == "cuda"


# -- the preemption pass (ops/preempt.py): no hand kernel, the torch loop on
# the card (a CUDA graph a chunk) against its plain version, the oracle and
# the CPU


@pytest.mark.parametrize("chunk", [3, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_preempt_main_loop_matches_plain_on_the_card(cuda, seed, chunk, monkeypatch):
    """The main loop on the card, chunks replayed as CUDA graphs (a chunk of
    3 crosses many chunk edges), against its plain version on the card, the
    serial oracle and the main loop on the CPU, field for field."""
    from autoscaler_tpu_torch.ops import preempt
    from autoscaler_tpu_torch.tools import preempt_probe

    monkeypatch.setattr(preempt, "CHUNK", chunk)
    worlds = preempt_probe.storm_worlds(2) + [preempt_probe.byte_world(
        np.random.default_rng((1616, seed)), P=160, N=24, pending=40)]
    held = preempt_probe.hold_plain(worlds, cuda)
    assert all(h["equal"] for h in held), held
    for w in worlds:
        cpu = preempt.ffd_binpack_preempt(**{k: torch.tensor(w[k])
                                             for k in preempt_probe.OPERANDS})
        card = preempt.ffd_binpack_preempt(**{k: torch.tensor(w[k], device=cuda)
                                              for k in preempt_probe.OPERANDS})
        for a, b in zip(cpu, card):
            assert torch.equal(a, b.cpu())


def test_preempt_estimate_serves_on_the_card_and_faults_raise(cuda):
    """estimate_preemption on the card is served by the torch loop there
    (route torch_preempt, the cuda rung's ``unsupported`` skip); a fault
    armed on the torch rung raises instead of descending to the host."""
    from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
    from autoscaler_tpu_torch.preempt import PreemptionEngine
    from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot
    from autoscaler_tpu_torch.utils.errors import AutoscalerError
    from autoscaler_tpu_torch.utils.test_utils import build_test_node, build_test_pod

    snap = ClusterSnapshot(device=cuda)
    snap.add_node(build_test_node("n0", cpu_m=4000))
    snap.add_pod(build_test_pod("low", cpu_m=4000, node_name="n0", priority=5), "n0")
    snap.add_pod(build_test_pod("high", cpu_m=4000, priority=100))
    est = BinpackingNodeEstimator(device=cuda)
    for eligible in (None, {"default/high"}):
        plan = PreemptionEngine(est).plan(snap, eligible)
        assert plan.route == "torch_preempt" and plan.victims == {"default/low": "default/high"}
    assert PreemptionEngine(est).plan(snap, set()).victims == {}
    est.ladder.fault_hook = lambda rung: "kernel_fault" if rung == "torch" else None
    with pytest.raises(AutoscalerError):
        PreemptionEngine(est).plan(snap)


# -- scenario batching: one K1/K2 launch for a batch of scenarios ------------


@pytest.mark.parametrize("route", ["swar", "f32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_batched_launch_matches_plain_version(cuda, seed, route):
    """A batch of 4 scenarios (the last a padded zero slot, one cap-0
    group) in one launch over S·G groups: the kernel's outputs equal its
    plain version's on the same stream (the node each pod took too), the
    answers the torch loop's (node_used summed in pod order, as the XLA
    scan sums it) and each scenario's solo launch (node_used there is
    alloc - free, equal to the sum where the requests are integers)."""
    from autoscaler_tpu_torch.ops.binpack import ffd_binpack_scenarios

    worlds = [_world(seed * 10 + s, route, P=120, G=6) for s in range(3)]
    req = np.stack([w[0] for w in worlds] + [np.zeros_like(worlds[0][0])])
    masks = np.stack([w[1] for w in worlds] + [np.zeros_like(worlds[0][1])])
    allocs = np.stack([w[2] for w in worlds] + [np.zeros_like(worlds[0][2])])
    caps = np.stack([w[3] for w in worlds] + [np.zeros_like(worlds[0][3])])
    args = [torch.tensor(a, device=cuda) for a in (req, masks, allocs, caps)]
    ops = ffd_scan.prepare_scenarios(*args[:3], 64, args[3])
    assert (ops.plan is not None) == (route == "swar")
    name = "ffd_scan_swar" if route == "swar" else "ffd_scan_f32"
    before = ffd_scan.LAUNCHES[name]
    got = ffd_scan.run_scan(ops)
    torch.cuda.synchronize()
    assert ffd_scan.LAUNCHES[name] == before + 1
    plain = (ffd_scan._scan_plain_swar(ops.stream, ops.allocs, ops.caps, ops.guards, 64)
             if ops.plan is not None else
             ffd_scan._scan_plain_f32(ops.stream, ops.allocs, ops.caps, 64))
    for a, b in zip(plain, got):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    got = ffd_scan.run_scan(ops, node_of=True)
    plain = (ffd_scan._scan_plain_swar(ops.stream, ops.allocs, ops.caps, ops.guards, 64,
                                       node_of=True)
             if ops.plan is not None else
             ffd_scan._scan_plain_f32(ops.stream, ops.allocs, ops.caps, 64, node_of=True))
    assert len(got) == len(plain) == 4
    for a, b in zip(plain, got):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    res = ffd_scan.ffd_binpack_scenarios_cuda(*args[:3], 64, args[3])
    loop = ffd_binpack_scenarios(*args[:3], max_nodes=64, scen_caps=args[3])
    assert_results_equal(loop, res)
    for s in range(4):
        solo = ffd_scan.ffd_binpack_groups_cuda(args[0][s], args[1][s], args[2][s], 64, args[3][s])
        assert torch.equal(solo.node_count, res.node_count[s])
        assert torch.equal(solo.scheduled, res.scheduled[s])
        if route == "swar":
            assert torch.equal(solo.node_used, res.node_used[s])


def test_fleet_serves_each_batch_in_one_launch(cuda):
    """A coalescer on the card: every ticket on rung cuda's route, one
    K1/K2 launch a batch, each answer byte-equal to its solo dispatch."""
    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics
    from autoscaler_tpu_torch.parallel.mesh import FLEET_ROUTES
    from autoscaler_tpu_torch.tools import fleet_probe

    reqs = fleet_probe.fleet_tenants(0, 6, pods=(20, 60), groups=(2, 8), adhoc=(90, 10))
    co = fleet_probe.coalescer(cuda, buckets="64x8x8", batch=4, metrics=AutoscalerMetrics())
    before = dict(ffd_scan.LAUNCHES), dict(FLEET_ROUTES)
    answers, admitted = fleet_probe.submit_flush(co, reqs)
    launched = sum(ffd_scan.LAUNCHES[k] - before[0][k] for k in ffd_scan.LAUNCHES)
    batches = int(sum(co.metrics.fleet_batches_total.values.values()))
    assert batches == 3 and launched == batches == FLEET_ROUTES["cuda"] - before[1]["cuda"]
    record = fleet_probe.round_record(co, reqs, answers, admitted,
                                      lambda r: fleet_probe.solo(r, cuda))
    assert [a.route for a in answers] == ["fleet_batched"] * len(reqs)
    assert all(row["match_solo"] for row in record["tenants"])


# -- the scenario engine and the profiler on the card --------------------------------


def test_scale_drill_at_a_tenth_on_the_card(cuda):
    """4r: the drill at a tenth (100 nodes, 3 000 pods) through
    run_scenario on the card binds every pod and deletes every emptied
    node, with the decision log and report (walls aside) of the CPU's run."""
    from autoscaler_tpu_torch.tools import drill_probe

    doc = drill_probe.drill_doc(tenth=True)
    card, _ = drill_probe.run_drill(doc, cuda)
    cpu, _ = drill_probe.run_drill(doc, "cpu")
    assert drill_probe.drill_problems(card, tenth=True) == []
    assert drill_probe.comparable(card) == drill_probe.comparable(cpu)


def test_profiled_drill_names_its_kernels_on_the_card(cuda, tmp_path):
    """3y: each profiled tick's session names its step and K4's range, the
    scale-up tick K2's and the estimator's cuda range, and the decisions
    equal the unprofiled run's."""
    from autoscaler_tpu_torch.tools import drill_probe
    from autoscaler_tpu_torch.trace import device as tdev

    tdev._sessions_broken = False
    doc = drill_probe.profile_doc()
    plain, _ = drill_probe.run_drill(doc, cuda, profile_ticks=drill_probe.PROFILE_TICKS)
    profiled, _ = drill_probe.run_drill(doc, cuda, profiler_dir=str(tmp_path),
                                        profile_ticks=drill_probe.PROFILE_TICKS)
    assert drill_probe.comparable(profiled) == drill_probe.comparable(plain)
    assert drill_probe.session_problems(drill_probe.profile_sessions(profiled, str(tmp_path))) == []


def test_fault_drill_raises_and_recovers_on_the_card(cuda):
    """5e: the faulted ticks record the typed error, nothing serves below
    the cuda rung, and after the clear the breaker closes."""
    from autoscaler_tpu_torch.tools import drill_probe

    faulted, _ = drill_probe.run_drill(drill_probe.fault_doc(), cuda)
    assert drill_probe.fault_problems(faulted, card=True) == []


def test_gym_tune_on_the_card_equals_the_cpu(cuda):
    """4s: the gym's tune over a two-scenario suite at 4r's size, its
    rollouts in two threads on one card sharing one coalescer (the greedy
    loop captures its CUDA graphs while the other thread runs), writes the
    CPU's tuning ledger."""
    from autoscaler_tpu_torch.tools import drill_probe

    doc = drill_probe.gym_suite_doc()
    assert drill_probe.tune_ledger(doc, cuda) == drill_probe.tune_ledger(doc, "cpu")


# -- the VPA's histogram bank and K5 ---------------------------------------------------


@pytest.mark.parametrize("N,K,dup", [(50, 200_000, "heavy"), (176 * 300, 192_000, "runs"),
                                     (1000, 1, "one"), (4096, 4000, "none"),
                                     (3, 50_000, "one_cell"), (300, 600_000, "series"),
                                     (176 * 300, 200_000, "signed"), (64, 4000, "subnormal"),
                                     (176 * 300, 200_000, "int64_pads")])
def test_ordered_scatter_add_matches_plain_version(cuda, N, K, dup):
    """K5 against its plain version on the CPU bit for bit: cells with
    thousands of samples, long runs, one sample, no duplicate, one cell
    taking every pair (past a block's shared memory), 300 series of 2 000
    strided samples (a block's sort), the memory bank's signed
    replacements, runs whose partial sums cross below 2^-126, int64 pads
    past 2^31 and below 0; indices outside the target dropped."""
    from autoscaler_tpu_torch.ops import histogram as ops_histogram

    rng = np.random.default_rng(K)
    target = (rng.standard_normal(N) * 10.0 ** rng.uniform(-3, 3, N)).astype(np.float32)
    values = (rng.standard_normal(K) * 10.0 ** rng.uniform(-4, 4, K)).astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    if dup == "none":
        index = rng.permutation(N)[:K]
    elif dup == "runs":
        index = np.repeat(rng.integers(0, N, K // 192), 192)
    elif dup == "one_cell":
        index = np.full(K, 1)
    elif dup == "series":
        index = np.tile(np.arange(N), K // N)
    elif dup == "signed":
        index = rng.integers(0, N, K)
        values = (2.0 ** rng.uniform(-3, 0, K)).astype(np.float32)
        swap = rng.random(K) < 0.4
        values[swap] *= -1
        index[1:][swap[1:]] = index[:-1][swap[1:]]
    elif dup == "subnormal":
        index = rng.integers(0, N, K)
        values = (rng.integers(-6, 7, K) * 0.5 * tiny).astype(np.float32)
        values[rng.random(K) < 0.05] *= 8
        target = (rng.integers(-2, 3, N) * 0.5 * tiny).astype(np.float32)
    elif dup == "int64_pads":
        index = rng.integers(0, N, K)
        pads = rng.random(K) < 0.01
        index[pads] = rng.choice([2**31, 2**31 + N, 2**40, -1, -(2**33)], int(pads.sum()))
    else:
        index = rng.integers(0, N, K)
    index[:: max(1, K // 7)][1:] = N   # out of range: dropped
    cpu_dtype = np.int64 if dup == "int64_pads" else np.int32
    want = ops_histogram.ordered_scatter_add(
        torch.from_numpy(target.copy()), torch.from_numpy(index.astype(cpu_dtype)),
        torch.from_numpy(values))
    before = ops_histogram.LAUNCHES["ordered_scatter_add"]
    got = ops_histogram.ordered_scatter_add(
        torch.from_numpy(target).to(cuda), torch.from_numpy(index.astype(np.int64)).to(cuda),
        torch.from_numpy(values).to(cuda))
    torch.cuda.synchronize()
    assert ops_histogram.LAUNCHES["ordered_scatter_add"] == before + 1
    assert torch.equal(want.view(torch.int32), got.cpu().view(torch.int32))


def test_vpa_bank_on_the_card_equals_the_cpu(cuda):
    """Two banks of each resource, one on the card and one on the CPU, fed
    the same seeded batches at real epochs (the re-reference branch, a
    peak replaced, one more ten half-lives on), restored from the same
    checkpoints: weights, totals and six percentiles bit for bit."""
    from autoscaler_tpu_torch.vpa import histogram as th

    rng = np.random.default_rng(4)
    T0, DAY, C = 1.7e9, 86400.0, 300
    for spec, base in ((th.CPU_SPEC, 0.4), (th.MEMORY_SPEC, 6e8)):
        banks = [th.HistogramBank(64, spec, device=d) for d in (cuda, "cpu")]
        for t_end, span, K in ((T0, 8 * DAY, 400_000), (T0 + 60.0, 60.0, 100_000),
                               (T0 + 12 * DAY, 60.0, 100_000)):
            series = np.minimum(rng.zipf(1.3, K) - 1, C - 1)
            values = base * rng.lognormal(0.0, 0.3, K)
            weights = np.where(rng.random(K) < 0.1, -1.0, 1.0)
            ts = t_end - rng.uniform(0.0, span, K)
            for bank in banks:
                bank.grow_to(C)
                bank.add_samples(series, values, weights, ts)
            assert banks[0].ref_ts == banks[1].ref_ts
            for a, b in ((banks[0].weights, banks[1].weights), (banks[0].total, banks[1].total)):
                assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
            for p in (0.5, 0.9, 0.95):
                assert torch.equal(banks[0].percentile(p).cpu(), banks[1].percentile(p))
        ckpts = [banks[1].checkpoint(s) for s in range(C)]
        assert ckpts == [banks[0].checkpoint(s) for s in range(C)]
        fresh = [th.HistogramBank(C, spec, device=d) for d in (cuda, "cpu")]
        for bank in fresh:
            for s, ckpt in enumerate(ckpts):
                bank.restore(s, ckpt)
        assert torch.equal(fresh[0].weights.cpu(), fresh[1].weights)
        assert torch.equal(fresh[0].percentile(0.9).cpu(), fresh[1].percentile(0.9))


def test_vpa_runner_on_the_card_equals_the_cpu(cuda):
    """tools/vpa_probe's warm start and two passes on a small world, on the
    card and on the CPU: every output equal; K5 launched in every feed."""
    from autoscaler_tpu_torch.ops import histogram as ops_histogram
    from autoscaler_tpu_torch.tools import vpa_probe

    world = vpa_probe.vpa_world(**vpa_probe.SMALL)
    before = ops_histogram.LAUNCHES["ordered_scatter_add"]
    card = vpa_probe.run_vpa(world, cuda, passes=2)
    assert ops_histogram.LAUNCHES["ordered_scatter_add"] - before >= 8
    assert not vpa_probe.problems(card)
    assert vpa_probe.comparable(card) == vpa_probe.comparable(vpa_probe.run_vpa(world, "cpu",
                                                                               passes=2))


def test_cold_build_then_a_load_that_compiles_nothing(cuda, tmp_path, monkeypatch):
    """The start's preload (main on a card) into an empty directory builds
    the loop's libraries, one nvcc each, and a second start from the same
    directory loads them with no compiler; a K4 launch through the loaded
    library agrees with the plain version."""
    from autoscaler_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_LIBS", {})
    with _build.build_dir(tmp_path):
        before = _build.COMPILERS_STARTED
        secs, compilers = _build.preload(*_build.LOOP_SOURCES)
        assert compilers == len(_build.LOOP_SOURCES) == _build.COMPILERS_STARTED - before
        assert sorted(p.name.split("-")[0] for p in tmp_path.glob("*.so")) == sorted(
            _build.LOOP_SOURCES)
        monkeypatch.setattr(_build, "_LIBS", {})
        secs, compilers = _build.preload(*_build.LOOP_SOURCES)
        assert compilers == 0 and _build.COMPILERS_STARTED - before == len(_build.LOOP_SOURCES)
        assert set(_build._LIBS) == set(_build.LOOP_SOURCES)
        ops = tuple(torch.tensor(a, device=cuda) for a in fit_case(3, 600, 700))
        want = fit_reduce.fit_reduce_cuda(*(t.cpu() for t in ops))
        got = fit_reduce.fit_reduce_cuda(*ops)
        torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_sidecar_launcher_loads_the_kernels_before_it_serves(cuda, tmp_path):
    """``python -m autoscaler_tpu_torch.rpc`` on the card with an empty
    ``--compile-cache-dir``: the loop's libraries are built there, one nvcc
    each, and loaded before the port is bound; SIGTERM drains it."""
    import os
    import select
    import signal
    import subprocess
    import sys
    import time
    from pathlib import Path

    from autoscaler_tpu_torch.ops import _build
    from autoscaler_tpu_torch.tools import install_probe

    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "autoscaler_tpu_torch.rpc", "--address", "127.0.0.1:0",
         "--health-port", "0", "--fleet-prewarm", "false", "--compile-cache-dir", str(tmp_path)],
        cwd=str(repo), env={**os.environ, "PYTHONPATH": str(repo)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out, t_end = "", time.monotonic() + 300
        while time.monotonic() < t_end and "serving on port" not in out:
            ready, _, _ = select.select([proc.stdout], [], [], 1.0)
            if ready:
                line = proc.stdout.readline()
                if not line:
                    break
                out += line
        assert "serving on port" in out, proc.stderr.read() if proc.poll() is not None else out
        start = install_probe.START_LINE.search(out)
        assert start and start.group("dir") == str(tmp_path), out
        assert int(start.group("compilers")) == len(_build.LOOP_SOURCES)
        assert start.start() < out.index("serving on port")
        proc.send_signal(signal.SIGTERM)
        rest, err = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "drained cleanly" in rest, err[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
