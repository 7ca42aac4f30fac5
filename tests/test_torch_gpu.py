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
    CPU,
    MEMORY,
    PODS,
    assert_results_equal,
    hostname_skew_pods,
    rand_case,
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


def _spread_tuple(rng, P, G, S):
    """A random 11-array spread tuple: zone and hostname terms, skews 1-2,
    some static context and minDomains."""
    nl = np.arange(S) % 2 == 0
    return (
        rng.random((P, S)) < 0.3, rng.random((P, S)) < 0.5, nl,
        rng.integers(1, 3, S).astype(np.int32), rng.integers(1, 3, S).astype(np.int32),
        rng.random((G, S)) < 0.9, rng.integers(0, 3, (G, S)).astype(np.int32),
        rng.integers(0, 2, (G, S)).astype(np.int32),
        np.where(rng.random((G, S)) < 0.5, 2**30, 0).astype(np.int32),
        rng.integers(0, 3, (G, S)).astype(np.int32), rng.random((G, S)) < 0.2,
    )


@pytest.mark.parametrize("S", [0, 4, 32])
@pytest.mark.parametrize("T", [5, 40])
def test_affinity_kernel_matches_plain_version(cuda, T, S):
    """K3 against its plain version on the same card tensors, with and
    without spread, one and two term planes."""
    P, G, M = 300, 8, 64
    req, masks, allocs, match, aff, anti, nl, hl, caps = rand_world(T, P=P, G=G, T=T, max_nodes=M)
    spread = _spread_tuple(np.random.default_rng(S), P, G, S) if S else None
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
    spread = _spread_tuple(np.random.default_rng(9), P, G, 8)
    outs = []
    for dev in (cuda, "cpu"):
        ops = ffd_scan_affinity.affinity_operands_from_numpy(
            req, masks, allocs, match, aff, anti, nl, hl, caps, spread, dev
        )
        outs.append(ffd_scan_affinity.ffd_binpack_groups_affinity_cuda(**ops, max_nodes=M))
    assert_results_equal(outs[1], outs[0])


def test_affinity_smem_bytes_from_the_kernel_library(cuda):
    """The C side's formula, as the launch and the estimator's gate read
    it: (R + 2 TP + S) M words of carry plus staging and group scalars."""
    R, TP, S, M = 6, 1, 32, 1024
    words = (R + 2 * TP + S) * M + 32 * (R + 3 * TP + 2) + 4 * TP + 10 * S
    assert ffd_scan_affinity.affinity_smem_bytes(R, TP, S, M) == 4 * words
    assert ffd_scan_affinity.affinity_smem_bytes(6, 1, 0, 1024) < 48 * 1024


def test_estimator_dynamic_route_on_card_equals_cpu(cuda):
    from autoscaler_tpu_torch.estimator import binpacking
    from autoscaler_tpu_torch.utils.workload import build_spread_world

    pods, templates = build_spread_world(600, 4, 6, seed=3)
    before = dict(binpacking.ROUTES)
    launches = ffd_scan_affinity.LAUNCHES["ffd_scan_aff"]
    on_card = binpacking.BinpackingNodeEstimator().estimate_many(pods, templates)
    assert binpacking.ROUTES["ffd_scan_aff"] == before["ffd_scan_aff"] + 1
    assert ffd_scan_affinity.LAUNCHES["ffd_scan_aff"] == launches + 1
    on_cpu = binpacking.BinpackingNodeEstimator(device="cpu").estimate_many(pods, templates)
    for g in templates:
        assert on_card[g][0] == on_cpu[g][0]
        assert [p.name for p in on_card[g][1]] == [p.name for p in on_cpu[g][1]]


def _fit_case(seed, P, N, R=6, CP=4, CN=3):
    """tests/test_pallas_fit.py::build_case widened to R axes, with
    classless pods, -1 node classes and invalid nodes."""
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 60, (P, R)).astype(np.float32)
    free = rng.integers(0, 200, (N, R)).astype(np.float32)
    pod_class = rng.integers(-1, CP, P).astype(np.int32)
    node_class = rng.integers(-1, CN, N).astype(np.int32)
    class_mask = rng.random((CP, CN)) > 0.3
    node_valid = rng.random(N) > 0.05
    free[~node_valid] = 0
    return req, free, pod_class, node_class, class_mask, node_valid


@pytest.mark.parametrize(
    "P,N,R,CP,CN",
    [(64, 64, 6, 4, 3), (1000, 1500, 6, 40, 24), (300, 700, 11, 4, 3),
     (70, 130, 1, 8, 8), (517, 2049, 8, 200, 200)],
)
def test_fit_reduce_kernel_matches_plain_version(cuda, P, N, R, CP, CN):
    """K4 against its plain version on the same card tensors: ragged
    sizes, R from 1 to 11 (the generic-R path above 8), a class mask too
    large for shared memory (200 x 200), and the launch count."""
    ops = tuple(torch.tensor(a, device=cuda) for a in _fit_case(P + N, P, N, R, CP, CN))
    before = fit_reduce.LAUNCHES["fit_reduce"]
    got = fit_reduce.fit_reduce_cuda(*ops)
    torch.cuda.synchronize()
    assert fit_reduce.LAUNCHES["fit_reduce"] == before + 1
    want = fit_reduce._fit_reduce_plain(*ops)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ref = fit_reduce.reference_fit_reduce(*_fit_case(P + N, P, N, R, CP, CN))
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
