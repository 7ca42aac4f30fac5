"""The port's DebuggingSnapshotter (autoscaler_tpu_torch/debugging.py)
against the JAX package's: the same cluster in both packages' snapshots,
the same stand-in autoscaler and loop result, a fixed capture time, and
the captured JSON payload must be the same string; the dumped tensors must
hold the same arrays and replay into the port."""
from types import SimpleNamespace

import numpy as np
import pytest

import autoscaler_tpu.debugging as jdbg
import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.snapshot.cluster_snapshot as jcs
import autoscaler_tpu.snapshot.packer as jpack
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.debugging as tdbg
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.ops.fit_reduce as tfr
import autoscaler_tpu_torch.snapshot.cluster_snapshot as tcs
import autoscaler_tpu_torch.snapshot.packer as tpack
import autoscaler_tpu_torch.snapshot.tensors as ttens
import autoscaler_tpu_torch.utils.test_utils as ttu
from torch_parity import mask_world


def snapshot(pkg, seed):
    """mask_world in a ClusterSnapshot of package ``pkg`` (JAX or port),
    with three node groups and a loop result as the stand-ins see them."""
    tu, obj, cs = pkg
    nodes, pods, _ = mask_world(tu, obj, seed, P=60, N=14)
    snap = cs.ClusterSnapshot() if cs is jcs else cs.ClusterSnapshot(device="cpu")
    for n in nodes:
        snap.add_node(n)
    for p in pods:
        snap.add_pod(p)
    autoscaler = SimpleNamespace(provider=SimpleNamespace(node_groups=lambda: [
        SimpleNamespace(id=lambda k=k: f"pool-{k}",
                        template_node_info=lambda k=k: nodes[k])
        for k in range(3)
    ]))
    return snap, autoscaler, pods


JAX = (jtu, jobj, jcs)
TORCH = (ttu, tobj, tcs)


def capture(pkg, dbg, seed, scaled_up):
    snap, autoscaler, pods = snapshot(pkg, seed)
    pending = snap.pending_pods()
    filtered = pending[::4]
    up = SimpleNamespace(scaled_up=scaled_up) if scaled_up is not None else None
    result = SimpleNamespace(scale_up=up, pending_pods=len(pending), unneeded_nodes=["n3"])
    s = dbg.DebuggingSnapshotter()
    s.request()
    assert s.is_data_collection_allowed()
    s.capture(autoscaler, snap, pending, result, filtered_pods=filtered, now=1234.5)
    assert not s.is_data_collection_allowed()
    return s.get()


@pytest.mark.parametrize("form", ["dense", "factored"])
@pytest.mark.parametrize("seed,scaled_up", [(0, True), (1, None), (2, False)])
def test_capture_payload_matches_jax(monkeypatch, seed, scaled_up, form):
    """Factored: the limit lowered in both packages packs the world
    factored, and fits_any_node routes through the tiled path."""
    routed = []
    if form == "factored":
        monkeypatch.setattr(jpack, "DENSE_MASK_CELL_LIMIT", 64)
        monkeypatch.setattr(tpack, "DENSE_MASK_CELL_LIMIT", 64)
        real = tfr.fit_reduce_exact
        monkeypatch.setattr(tfr, "fit_reduce_exact", lambda t: routed.append(1) or real(t))
    want = capture(JAX, jdbg, seed, scaled_up)
    got = capture(TORCH, tdbg, seed, scaled_up)
    assert got == want
    assert '"pending_pods_fitting_free_capacity": [\n    "default/' in got
    assert f'"form": "{form}"' in got
    assert len(routed) == (1 if form == "factored" else 0)


def test_capture_only_when_armed():
    snap, autoscaler, _ = snapshot(TORCH, 0)
    s = tdbg.DebuggingSnapshotter()
    result = SimpleNamespace(scale_up=None, pending_pods=0, unneeded_nodes=[])
    s.capture(autoscaler, snap, [], result, now=1.0)
    assert s.get() is None
    s.request()
    s.capture(autoscaler, snap, [], result, now=1.0)
    assert '"pending_pods_fitting_free_capacity": []' in s.get()


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "factored"])
def test_dump_tensors_matches_jax_and_replays(tmp_path, monkeypatch, dense):
    if not dense:
        monkeypatch.setattr(jpack, "DENSE_MASK_CELL_LIMIT", 64)
        monkeypatch.setattr(tpack, "DENSE_MASK_CELL_LIMIT", 64)
    (jsnap, _, _), (tsnap, _, _) = snapshot(JAX, 3), snapshot(TORCH, 3)
    names_j = jdbg.DebuggingSnapshotter.dump_tensors(jsnap, str(tmp_path / "j.npz"))
    names_t = tdbg.DebuggingSnapshotter.dump_tensors(tsnap, str(tmp_path / "t.npz"))
    assert names_j == names_t and ("sched_mask" in names_t) == dense
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        for name in names_t:
            assert j[name].dtype == t[name].dtype, name
            np.testing.assert_array_equal(j[name], t[name], err_msg=name)
        replayed = ttens.tensors_from_numpy({k: j[k] for k in j.files}, device="cpu")
    packed, _ = tsnap.tensors()
    for name in names_t:
        np.testing.assert_array_equal(
            getattr(replayed, name).numpy(), getattr(packed, name).numpy()
        )
    for a, b in zip(tfr.fit_reduce_exact(replayed), tfr.fit_reduce_exact(packed)):
        assert (a == b).all()
