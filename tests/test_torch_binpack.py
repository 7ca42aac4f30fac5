"""The port's plain FFD family (autoscaler_tpu_torch/ops/binpack.py) and
result blob (ops/bits.py) against the JAX package on the same seeded
numpy operands, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoscaler_tpu.ops import binpack as jbp
from autoscaler_tpu.ops import bits as jbits
from autoscaler_tpu_torch.ops import binpack as tbp
from autoscaler_tpu_torch.ops import bits as tbits
from torch_parity import CPU, GPU, MEMORY, assert_bits_equal, assert_results_equal, rand_case


def t(a):
    return torch.tensor(np.asarray(a))


def groups_parity(req, masks, allocs, max_nodes, caps=None):
    ref = jbp.ffd_binpack_groups(
        jnp.asarray(req), jnp.asarray(masks), jnp.asarray(allocs),
        max_nodes=max_nodes, node_caps=None if caps is None else jnp.asarray(caps),
    )
    out = tbp.ffd_binpack_groups(
        t(req), t(masks), t(allocs), max_nodes=max_nodes,
        node_caps=None if caps is None else t(caps),
    )
    assert_results_equal(ref, out)
    return out


@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ffd_scores(seed, fractional):
    req, _, allocs = rand_case(seed, P=300, G=6, fractional=fractional)
    allocs[1, CPU] = 0.0       # a zero cap drops its term
    allocs[2, MEMORY] = 0.0
    req[::5, CPU] = 0.0
    for g in range(len(allocs)):
        ref = jbp.ffd_scores(jnp.asarray(req), jnp.asarray(allocs[g]))
        assert_bits_equal(ref, tbp.ffd_scores(t(req), t(allocs[g])))
    # the [G, R] form scores every group at once, row for row
    out = tbp.ffd_scores(t(req), t(allocs))
    for g in range(len(allocs)):
        assert_bits_equal(jbp.ffd_scores(jnp.asarray(req), jnp.asarray(allocs[g])), out[g])


@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_ffd_binpack_single(seed, fractional):
    req, masks, allocs = rand_case(seed, P=120, G=2, fractional=fractional)
    for g, cap in ((0, None), (1, 5)):
        ref = jbp.ffd_binpack(
            jnp.asarray(req), jnp.asarray(masks[g]), jnp.asarray(allocs[g]),
            max_nodes=16, node_cap=None if cap is None else jnp.int32(cap),
        )
        out = tbp.ffd_binpack(t(req), t(masks[g]), t(allocs[g]), max_nodes=16, node_cap=cap)
        assert_results_equal(ref, out)


@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_groups_random(seed, fractional):
    req, masks, allocs = rand_case(seed, fractional=fractional)
    groups_parity(req, masks, allocs, max_nodes=64)


def test_groups_per_group_caps():
    req, masks, allocs = rand_case(4, P=300, G=4)
    groups_parity(req, masks, allocs, max_nodes=32, caps=np.array([1, 4, 16, 32], np.int32))


def test_groups_oversized_pods_and_dead_groups():
    req, masks, allocs = rand_case(5, P=100, G=3)
    req[::7, CPU] = 10_000_000.0  # never fits anything
    masks[1, :] = False           # group schedules nothing
    allocs[2, :] = 0.0            # a padded-shape group: no capacity...
    caps = np.array([16, 16, 0], np.int32)  # ...and no cap
    out = groups_parity(req, masks, allocs, max_nodes=16, caps=caps)
    assert int(out.node_count[1]) == 0 and int(out.node_count[2]) == 0


def test_groups_zero_score_pods():
    """All-zero cpu/mem requests score 0 (negated to -0.0 alike): the stable
    sort must keep pod order among them, and among equal nonzero scores."""
    req, masks, allocs = rand_case(6, P=96, G=3)
    req[::3, CPU] = 0.0
    req[::3, MEMORY] = 0.0
    req[1::3, CPU] = 500.0
    req[1::3, MEMORY] = 1000.0
    groups_parity(req, masks, allocs, max_nodes=16)


def test_groups_inf_csi_allocs():
    """An unlimited CSI attach plane is an +inf capacity column."""
    req, masks, allocs = rand_case(21, P=150, G=4)
    allocs = np.concatenate([allocs, np.full((4, 1), np.inf, np.float32)], axis=1)
    allocs[0, -1] = 3.0           # one limited driver
    req = np.concatenate([req, np.ones((150, 1), np.float32)], axis=1)
    groups_parity(req, masks, allocs, max_nodes=32)


def runs_case(seed, U=40, G=5, fractional=False):
    rng = np.random.default_rng(seed)
    req, masks, allocs = rand_case(seed, P=U, G=G, fractional=fractional)
    counts = rng.integers(1, 40, U).astype(np.int32)
    return req, counts, masks, allocs


def runs_parity(req, counts, masks, allocs, max_nodes, caps=None):
    ref = jbp.ffd_binpack_groups_runs(
        jnp.asarray(req), jnp.asarray(counts), jnp.asarray(masks),
        jnp.asarray(allocs), max_nodes=max_nodes,
        node_caps=None if caps is None else jnp.asarray(caps),
    )
    out = tbp.ffd_binpack_groups_runs(
        t(req), t(counts), t(masks), t(allocs), max_nodes=max_nodes,
        node_caps=None if caps is None else t(caps),
    )
    assert_results_equal(ref, out)
    return out


@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_runs_random(seed, fractional):
    req, counts, masks, allocs = runs_case(seed, fractional=fractional)
    runs_parity(req, counts, masks, allocs, max_nodes=64)


def test_runs_caps_oversized_dead_groups_and_inf_allocs():
    req, counts, masks, allocs = runs_case(7, U=30, G=4)
    req[::6, CPU] = 10_000_000.0
    masks[1, :] = False
    allocs = np.concatenate([allocs, np.full((4, 1), np.inf, np.float32)], axis=1)
    req = np.concatenate([req, np.ones((30, 1), np.float32)], axis=1)
    runs_parity(
        req, counts, masks, allocs, max_nodes=32,
        caps=np.array([2, 32, 8, 0], np.int32),
    )


def test_runs_zero_score_runs():
    req, counts, masks, allocs = runs_case(8, U=24, G=3)
    req[::2, CPU] = 0.0
    req[::2, MEMORY] = 0.0
    runs_parity(req, counts, masks, allocs, max_nodes=16)


def test_max_fit_ulp_correction():
    """Quotients that round up across an integer: k*q <= free must hold
    exactly as the per-pod scan judges it."""
    rng = np.random.default_rng(3)
    q = (rng.integers(1, 4000, (4, 6)) * np.float32(1e6 / 2**20)).astype(np.float32)
    q[:, 2] = 0.0
    free = (q[:, :, None] * rng.integers(0, 50, (4, 1, 32))).astype(np.float32)
    free += rng.integers(-1, 2, free.shape).astype(np.float32) * np.float32(1e-3)
    ref = jbp._max_fit(jnp.asarray(q), jnp.asarray(free))
    assert_bits_equal(ref, tbp._max_fit(t(q), t(free)))


def test_groups_gpu_axis():
    req, masks, allocs = rand_case(11)
    rng = np.random.default_rng(12)
    gpu_pods = rng.random(len(req)) < 0.3
    req[gpu_pods, GPU] = rng.integers(1, 4, int(gpu_pods.sum()))
    allocs[:, GPU] = 8.0
    allocs[0, GPU] = 0.0
    groups_parity(req, masks, allocs, max_nodes=16)


@pytest.mark.parametrize("G,P", [(9, 203), (1, 8), (3, 1)])
def test_result_blob_matches_jax(G, P):
    rng = np.random.default_rng(G * 1000 + P)
    counts = rng.integers(0, 2**20, G).astype(np.int32)
    sched = rng.random((G, P)) > 0.4
    ref = np.asarray(jbits.pack_result_blob(jnp.asarray(counts), jnp.asarray(sched)))
    blob = tbits.pack_result_blob(t(counts), t(sched))
    assert blob.dtype == torch.uint8
    np.testing.assert_array_equal(ref, blob.numpy())
    c2, s2 = tbits.unpack_result_blob(blob.numpy(), G, P)
    np.testing.assert_array_equal(c2, counts)
    np.testing.assert_array_equal(s2, sched)

