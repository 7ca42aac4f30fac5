"""K4's wrapper and plain version (autoscaler_tpu_torch/ops/fit_reduce.py)
against the JAX package's Pallas kernel ``pallas_fit_reduce`` (interpret
mode on the CPU) and its numpy oracle, on test_pallas_fit.py's shapes and
tiles; and ``fit_reduce_exact`` against the JAX package's on factored
worlds with exception rows and single-cell overrides. Exact throughout
(booleans and int32 counts and indices)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.ops.pallas_fit as jpf
import autoscaler_tpu.snapshot.packer as jpack
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.ops.fit as tfit
import autoscaler_tpu_torch.ops.fit_reduce as tfr
import autoscaler_tpu_torch.snapshot.packer as tpack
import autoscaler_tpu_torch.utils.test_utils as ttu
from test_pallas_fit import build_case
from torch_parity import mask_world, to_np


def wide_case():
    """test_pallas_fit.py's R = 11 world (more resource axes than a
    sublane tile)."""
    rng = np.random.default_rng(7)
    P, N, R = 40, 50, 11
    pod_req = rng.integers(0, 50, (P, R)).astype(np.float32)
    free = rng.integers(0, 200, (N, R)).astype(np.float32)
    pod_class = rng.integers(0, 3, P).astype(np.int32)
    node_class = rng.integers(0, 2, N).astype(np.int32)
    class_mask = rng.random((3, 2)) > 0.2
    node_valid = np.ones(N, bool)
    return pod_req, free, pod_class, node_class, class_mask, node_valid


def classless_case():
    """build_case(32, 32, seed=1) with every pod classless."""
    case = list(build_case(32, 32, seed=1))
    case[2] = np.full(32, -1, np.int32)
    return tuple(case)


def holes_case():
    """build_case(70, 130, seed=2) with some classless pods, -1 node
    classes and its invalid nodes."""
    case = list(build_case(70, 130, seed=2))
    case[2] = np.where(np.arange(70) % 9 == 4, -1, case[2]).astype(np.int32)
    case[3] = np.where(np.arange(130) % 11 == 6, -1, case[3]).astype(np.int32)
    return tuple(case)


# (name, case, Pallas tiles): the shapes and tiles test_pallas_fit.py
# compiles, so interpret mode builds nothing new
CASES = {
    "64x64": (lambda: build_case(64, 64, seed=128), dict(tp=64, tn=128)),
    "300x700": (lambda: build_case(300, 700, seed=1000), dict(tp=64, tn=128)),
    "1000x1500": (lambda: build_case(1000, 1500, seed=2500), dict(tp=64, tn=128)),
    "wide_r11": (wide_case, dict(tp=8, tn=128)),
    "classless": (classless_case, dict(tp=32, tn=128)),
    "ragged_holes": (holes_case, dict(tp=64, tn=128)),
}


def torch_case(case, device="cpu"):
    return tuple(torch.tensor(a, device=device) for a in case)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_pallas_and_oracle(name):
    make, tiles = CASES[name]
    case = make()
    pallas = jpf.pallas_fit_reduce(*(jnp.asarray(x) for x in case), **tiles)
    oracle = jpf.reference_fit_reduce(*case)
    before = dict(tfr.LAUNCHES)
    got = tfr.fit_reduce_cuda(*torch_case(case))       # CPU tensors: the plain version
    assert tfr.LAUNCHES == before                       # nothing launched
    assert [t.dtype for t in got] == [torch.bool, torch.int32, torch.int32]
    for want_p, want_o, b in zip(pallas, oracle, got):
        np.testing.assert_array_equal(to_np(want_p), to_np(b))
        np.testing.assert_array_equal(want_o, to_np(b))
    ours = tfr.reference_fit_reduce(*case)
    for a, b in zip(oracle, ours):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk_pairs", [1, 700, 1 << 24])
def test_plain_version_chunking_does_not_change_results(monkeypatch, chunk_pairs):
    case = build_case(300, 700, seed=1000)
    want = tfr.reference_fit_reduce(*case)
    monkeypatch.setattr(tfr, "PLAIN_CHUNK_PAIRS", chunk_pairs)
    got = tfr._fit_reduce_plain(*torch_case(case))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, to_np(b))


def test_out_of_range_classes_never_fit():
    """A pod class >= CP or a node class >= CN never fits, as the Pallas
    kernel's one-hot rows are zero there."""
    case = list(build_case(64, 64, seed=128))
    case[2] = np.where(np.arange(64) % 5 == 0, 4, case[2]).astype(np.int32)   # CP = 4
    case[3] = np.where(np.arange(64) % 7 == 0, 3, case[3]).astype(np.int32)   # CN = 3
    pallas = jpf.pallas_fit_reduce(*(jnp.asarray(x) for x in case), tp=64, tn=128)
    got = tfr.fit_reduce_cuda(*torch_case(case))
    for a, b in zip(pallas, got):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    assert not got.any_fit[::5].any()


def test_work_count():
    """The plain version's count of the work the data needs: one class
    test per live pair, and for each pair that passes it the compares up
    to and including the first that fails."""
    req = torch.tensor([[1.0, 5.0], [9.0, 1.0], [1.0, 1.0]])
    free = torch.tensor([[2.0, 2.0], [2.0, 9.0], [9.0, 9.0], [9.0, 9.0]])
    pod_class = torch.tensor([0, 0, -1], dtype=torch.int32)
    node_class = torch.tensor([0, 0, 1, 0], dtype=torch.int32)
    class_mask = torch.tensor([[True, False]])
    node_valid = torch.tensor([True, True, True, False])
    stats = {}
    out = tfr._fit_reduce_plain(req, free, pod_class, node_class, class_mask, node_valid,
                                stats=stats)
    # live pairs: pods 0 and 1 x nodes 0-2; class passes on nodes 0 and 1.
    # pod 0: node 0 compares 1 <= 2 then 5 <= 2 (2), node 1 (2, fits);
    # pod 1: 9 <= 2 fails at once on both (1 + 1)
    assert stats == {"class_tests": 6, "compares": 6}
    assert out.fit_count.tolist() == [1, 0, 0] and out.first_fit.tolist() == [1, -1, -1]


@pytest.mark.parametrize(
    "i,bad,msg",
    [
        (0, lambda t: t.double(), "pod_req"),
        (1, lambda t: t[:, :-1], "free"),
        (2, lambda t: t.long(), "pod_class"),
        (3, lambda t: t[:5], "node_class"),
        (4, lambda t: t.int(), "class_mask"),
        (5, lambda t: t.float(), "node_valid"),
    ],
)
def test_wrapper_refuses_bad_operands(i, bad, msg):
    ops = list(torch_case(build_case(16, 16, seed=3)))
    ops[i] = bad(ops[i])
    with pytest.raises(ValueError, match=msg):
        tfr.fit_reduce_cuda(*ops)


def test_wrapper_raises_on_other_devices():
    ops = torch_case(build_case(16, 16, seed=3), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfr.fit_reduce_cuda(*ops)


def test_empty_operands():
    case = build_case(16, 16, seed=3)
    out = tfr.fit_reduce_cuda(*torch_case((case[0][:0],) + case[1:2] + (case[2][:0],) + case[3:]))
    assert all(t.shape == (0,) for t in out)
    out = tfr.fit_reduce_cuda(*torch_case(
        (case[0], case[1][:0], case[2], case[3][:0], case[4], case[5][:0])
    ))
    assert not out.any_fit.any() and (out.first_fit == -1).all()


# -- fit_reduce_exact ---------------------------------------------------------


def packed(seed, P=40, N=12):
    out = []
    for tu, obj, pk in ((jtu, jobj, jpack), (ttu, tobj, tpack)):
        nodes, pods, _ = mask_world(tu, obj, seed, P=P, N=N)
        pair = []
        for dense in (True, False):
            kw = {} if pk is jpack else {"device": "cpu"}
            pair.append(pk.pack(nodes, pods, dense_mask=dense, **kw)[0])
        out.append(pair)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_fit_reduce_exact_matches_jax_and_the_dense_path(seed):
    """test_pallas_fit.py::TestFitReduceExact's worlds and tiles: the
    factored branch (K4's plain version + the exact patch) and the dense
    branch against the JAX package's, and against the dense fit matrix."""
    (jd, jf), (td, tf) = packed(seed)
    assert (tf.pod_exc >= 0).any()
    if seed == 0:
        assert (tf.cell_pod >= 0).any()
    fits = tfit.fit_matrix(td)
    ref_any = fits.any(dim=1)
    for j_snap, t_snap, kw in ((jf, tf, dict(tp=32, tn=128)), (jd, td, {})):
        want = jpf.fit_reduce_exact(j_snap, **kw)
        got = tfr.fit_reduce_exact(t_snap)
        assert [t.dtype for t in got] == [torch.bool, torch.int32, torch.int32]
        for a, b in zip(want, got):
            np.testing.assert_array_equal(to_np(a), to_np(b))
        assert torch.equal(got.any_fit, ref_any)
        assert torch.equal(got.fit_count, fits.sum(dim=1, dtype=torch.int32))


def test_the_patch_changes_the_class_verdicts():
    """On a world where a host-port DaemonSet pod sits on every node, the
    class factors alone say each DaemonSet pod fits nowhere (its port is
    taken everywhere); the patch from its own-node cell restores its own
    node, and the exception rows carry the anti-affinity pods."""
    nodes = [ttu.build_test_node(f"n{j}", cpu_m=4000) for j in range(10)]
    pods = []
    for j in range(10):
        ds = ttu.build_test_pod(f"ds-{j}", cpu_m=50, node_name=f"n{j}", labels={"app": "ds"})
        ds.host_ports = (9100,)
        pods.append(ds)
    pods += [ttu.build_test_pod(f"web-{i}", cpu_m=100, labels={"app": "ds"},
                                affinity=ttu.anti_affinity({"app": "ds"}) if i % 2 else None)
             for i in range(6)]
    snap, _ = tpack.pack(nodes, pods, dense_mask=False, device="cpu")
    ops = (snap.pod_req, snap.free(), snap.pod_class, snap.node_class, snap.class_mask,
           snap.node_valid)
    bulk = tfr.fit_reduce_cuda(*ops)
    exact = tfr.fit_reduce_exact(snap)
    assert not bulk.any_fit[:10].any()
    assert exact.first_fit[:10].tolist() == list(range(10))
    assert exact.fit_count[:10].tolist() == [1] * 10
    # anti-affinity on app=ds keeps the odd web pods off every node
    assert not exact.any_fit[11:16:2].any() and exact.any_fit[10:16:2].all()
    dense, _ = tpack.pack(nodes, pods, dense_mask=True, device="cpu")
    for a, b in zip(tfr.fit_reduce_exact(dense), exact):
        assert torch.equal(a, b)
