"""The port's predicate fit (autoscaler_tpu_torch/ops/fit.py) against the
JAX package's ops/fit.py on the same packed worlds: fit_matrix in f32 and
bf16, fits_any_node, first_fit_node, the bf16 rounding helpers and the
routing of huge factored worlds to the tiled path. Exact throughout: the
outputs are booleans and indices, and the bf16 helpers' outputs are
compared bit for bit; and the fit-reason matrix (why each pod does not
fit each node) with each pending pod's dominant reason."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.ops.fit as jfit
import autoscaler_tpu.snapshot.packer as jpack
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.ops.fit as tfit
import autoscaler_tpu_torch.ops.fit_reduce as tfr
import autoscaler_tpu_torch.snapshot.packer as tpack
import autoscaler_tpu_torch.utils.test_utils as ttu
from torch_parity import mask_world, to_np


def packed(seed, dense, P=40, N=12, frac=False):
    """mask_world packed by both packages; ``frac`` leaves every pod
    pending, gives the nodes uneven memory and the pods fractional memory
    requests, a third of them 0.05% below some node's memory (within one
    bf16 ulp), so the bf16 rounding decides some verdicts."""
    out = []
    for tu, obj, pk in ((jtu, jobj, jpack), (ttu, tobj, tpack)):
        nodes, pods, _ = mask_world(tu, obj, seed, P=P, N=N)
        if frac:
            rng = np.random.default_rng(seed)
            for j, n in enumerate(nodes):
                n.allocatable = obj.Resources(
                    cpu_m=float(rng.integers(300, 5000)), memory=float(rng.integers(1, 4096)) * 2**20,
                    pods=110.0,
                )
            for i, p in enumerate(pods):
                mem = float(rng.integers(1, 300_000_000))
                if i % 3 == 0:
                    mem = nodes[i % N].allocatable.memory * 0.9995
                p.requests = obj.Resources(cpu_m=float(rng.integers(10, 300)), memory=mem)
                p.node_name = ""
        kw = {} if pk is jpack else {"device": "cpu"}
        out.append(pk.pack(nodes, pods, dense_mask=dense, **kw)[0])
    return out


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "factored"])
@pytest.mark.parametrize("seed", range(3))
def test_fit_matrix_matches_jax(seed, dense, precision):
    jt, tt = packed(seed, dense, frac=seed == 2)
    want = to_np(jfit.fit_matrix(jt, precision=precision))
    got = tfit.fit_matrix(tt, precision=precision)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(want, to_np(got))


def test_bf16_changes_verdicts_only_conservatively():
    """On the fractional world bf16 admits a subset of f32's pairs, and
    some fewer (the rounding binds)."""
    _, tt = packed(2, True, frac=True)
    f32 = tfit.fit_matrix(tt, "f32")
    bf16 = tfit.fit_matrix(tt, "bf16")
    assert not (bf16 & ~f32).any() and (f32 & ~bf16).any()


def test_unknown_precision_raises():
    _, tt = packed(0, True)
    with pytest.raises(ValueError, match="unknown precision"):
        tfit.fit_matrix(tt, precision="f16")


def test_bf16_helpers_match_jax_bits():
    rng = np.random.default_rng(11)
    x = np.concatenate([
        rng.random(500).astype(np.float32) * 1e5,
        rng.integers(0, 2**20, 300).astype(np.float32),
        np.float32(2.0) ** rng.integers(-10, 30, 100).astype(np.float32),
        np.array([0.0, 1.0, 255.0, 257.0, 65535.0, 3.4e38], np.float32),
    ])
    y = rng.random(x.shape[0]).astype(np.float32) * 2e4 - 1e3   # some negative free
    for jf, tf in ((jfit._bf16_ceil, tfit._bf16_ceil), (jfit._bf16_floor, tfit._bf16_floor)):
        want = to_np(jf(jnp.asarray(x)).astype(jnp.float32))
        got = to_np(tf(torch.tensor(x)).to(torch.float32))
        np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))
    jr, jfree = jfit.bf16_compare_operands(jnp.asarray(x), jnp.asarray(y))
    tr, tfree = tfit.bf16_compare_operands(torch.tensor(x), torch.tensor(y))
    assert tr.dtype == tfree.dtype == torch.bfloat16
    for a, b in ((jr, tr), (jfree, tfree)):
        np.testing.assert_array_equal(
            to_np(a.astype(jnp.float32)).view(np.uint32), to_np(b.float()).view(np.uint32)
        )


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "factored"])
@pytest.mark.parametrize("seed", range(4))
def test_fits_any_and_first_fit_match_jax(seed, dense):
    jt, tt = packed(seed, dense)
    any_t, first_t = tfit.fits_any_node(tt), tfit.first_fit_node(tt)
    assert any_t.dtype == torch.bool and first_t.dtype == torch.int32
    np.testing.assert_array_equal(to_np(jfit.fits_any_node(jt)), to_np(any_t))
    np.testing.assert_array_equal(to_np(jfit.first_fit_node(jt)), to_np(first_t))


@pytest.mark.parametrize("seed", [1, 3])
def test_huge_factored_worlds_route_to_the_tiled_path(monkeypatch, seed):
    """With the limit lowered in both packages, a factored world counts as
    huge: fit_matrix refuses it, fits_any_node / first_fit_node route
    through fit_reduce_exact, and the verdicts still equal the dense
    path's and the JAX package's."""
    jt_d, tt_d = packed(seed, True)
    jt, tt = packed(seed, False)
    ref_any, ref_first = tfit.fits_any_node(tt_d), tfit.first_fit_node(tt_d)
    monkeypatch.setattr(jpack, "DENSE_MASK_CELL_LIMIT", 1)
    monkeypatch.setattr(tpack, "DENSE_MASK_CELL_LIMIT", 1)
    routed = []
    real = tfr.fit_reduce_exact
    monkeypatch.setattr(tfr, "fit_reduce_exact", lambda snap: routed.append(1) or real(snap))
    with pytest.raises(ValueError, match="fit_reduce_exact"):
        tfit.fit_matrix(tt)
    got_any, got_first = tfit.fits_any_node(tt), tfit.first_fit_node(tt)
    assert len(routed) == 2
    assert torch.equal(got_any, ref_any) and torch.equal(got_first, ref_first)
    np.testing.assert_array_equal(to_np(jfit.fits_any_node(jt)), to_np(got_any))
    np.testing.assert_array_equal(to_np(jfit.first_fit_node(jt)), to_np(got_first))
    # a dense snapshot is never "too big", whatever the limit
    assert torch.equal(tfit.fits_any_node(tt_d), ref_any)
    assert len(routed) == 2


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "factored"])
@pytest.mark.parametrize("seed", range(3))
def test_fit_reason_matrix_matches_jax(seed, dense):
    """Why each pod does not fit each node, and each pod's dominant reason,
    on the mask worlds: equal codes, int32 both."""
    jt, tt = packed(seed, dense, frac=seed == 2)
    want, got = jfit.fit_reason_matrix(jt), tfit.fit_reason_matrix(tt)
    assert got.dtype == torch.int32 and got.shape == (tt.num_pods, tt.num_nodes)
    np.testing.assert_array_equal(to_np(want), to_np(got))
    want, got = jfit.pending_fit_reasons(jt), tfit.pending_fit_reasons(tt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_np(want), to_np(got))
    assert len(np.unique(to_np(got))) >= 2


def test_pending_fit_reasons_against_live_cluster():
    """tests/test_explain.py's live-cluster case on both packages: a pod
    that fits, a cpu hog and a memory hog."""
    from autoscaler_tpu.explain.reasons import REASON_CPU, REASON_MEMORY, REASON_NONE
    import autoscaler_tpu.snapshot.cluster_snapshot as jcs
    import autoscaler_tpu_torch.snapshot.cluster_snapshot as tcs

    out = []
    for tu, cs, fit, kw in ((jtu, jcs, jfit, {}), (ttu, tcs, tfit, {"device": "cpu"})):
        snap = cs.ClusterSnapshot(**kw)
        snap.add_node(tu.build_test_node("n1", cpu_m=1000, mem=2 * tu.GB))
        snap.add_pod(tu.build_test_pod("ok", cpu_m=200, mem=100 * tu.MB))
        snap.add_pod(tu.build_test_pod("cpuhog", cpu_m=5000, mem=100 * tu.MB))
        snap.add_pod(tu.build_test_pod("memhog", cpu_m=200, mem=8 * tu.GB))
        t = snap.tensors()
        t = t[0] if isinstance(t, tuple) else t
        codes = to_np(fit.pending_fit_reasons(t))
        out.append({p.name: int(codes[i]) for i, p in enumerate(snap.pending_pods())})
    assert out[0] == out[1] == {"ok": REASON_NONE, "cpuhog": REASON_CPU,
                                "memhog": REASON_MEMORY}


def test_fit_reasons_without_nodes_and_past_the_dense_limit(monkeypatch):
    """No valid node: every pod's dominant reason is the predicate mask.
    A factored world past the dense-cell limit is refused, as fit_matrix
    refuses it."""
    from autoscaler_tpu_torch.explain.reasons import REASON_TOPOLOGY

    jt, tt = packed(0, True)
    empty = dataclasses.replace(tt, node_valid=torch.zeros_like(tt.node_valid))
    j_empty = dataclasses.replace(jt, node_valid=jnp.zeros_like(jt.node_valid))
    got = tfit.pending_fit_reasons(empty)
    np.testing.assert_array_equal(to_np(jfit.pending_fit_reasons(j_empty)), to_np(got))
    assert (to_np(got) == REASON_TOPOLOGY).all()
    _, factored = packed(0, False)
    monkeypatch.setattr(tpack, "DENSE_MASK_CELL_LIMIT", 16)
    with pytest.raises(ValueError, match="fit_reason_matrix"):
        tfit.fit_reason_matrix(factored)
