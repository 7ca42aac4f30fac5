"""The hand-written kernels K1 and K2 on the card, against their plain
PyTorch versions on the same card tensors, and the port's entry points on
the card against the same calls on the CPU. Marked ``gpu``: without a card
every test skips. On the card (the JAX package is not installed there, so
the repo's conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from autoscaler_tpu_torch.ops import ffd_scan
from torch_parity import CPU, MEMORY, assert_results_equal, rand_case

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
