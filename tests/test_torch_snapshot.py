"""The port's packer, SnapshotTensors and ClusterSnapshot
(autoscaler_tpu_torch/snapshot/) against the JAX package's, on the same
worlds: each package builds its own objects from one numpy-seeded
generator, and every field must be equal, dtype included (exact: the
fields are booleans, integers and f32 rows made by the same numpy calls)."""
import dataclasses
import random

import numpy as np
import pytest
import torch

import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.snapshot.cluster_snapshot as jcs
import autoscaler_tpu.snapshot.packer as jpack
import autoscaler_tpu.snapshot.tensors as jtens
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.snapshot.cluster_snapshot as tcs
import autoscaler_tpu_torch.snapshot.packer as tpack
import autoscaler_tpu_torch.snapshot.tensors as ttens
import autoscaler_tpu_torch.utils.test_utils as ttu
from torch_parity import canon, hostname_skew_pods, mask_world, to_np

JAX = (jtu, jobj)
TORCH = (ttu, tobj)


def assert_snapshots_equal(jt, tt):
    """Every SnapshotTensors field: None in both, or equal values of the
    same numpy dtype and shape."""
    assert [f.name for f in dataclasses.fields(jt)] == [
        f.name for f in dataclasses.fields(tt)
    ]
    for f in dataclasses.fields(jt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
            continue
        a, b = to_np(a), to_np(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (f.name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def assert_meta_equal(jm, tm):
    assert jm.node_index == tm.node_index and jm.pod_index == tm.pod_index
    assert jm.group_names == tm.group_names and jm.group_index == tm.group_index
    assert jm.extended_resources == tm.extended_resources
    assert [n.name for n in jm.nodes] == [n.name for n in tm.nodes]
    assert [p.key() for p in jm.pods] == [p.key() for p in tm.pods]


def spread_world(pkg, P=40, N=12):
    """mask_world's nodes with hostname_skew_pods, one in three placed:
    hard-spread rows, which the factored form keeps as exception rows."""
    tu, obj = pkg
    nodes, _, _ = mask_world(tu, obj, 0, P=1, N=N)
    pods = hostname_skew_pods(tu, obj, P=P)
    for i, pod in enumerate(pods):
        if i % 3 == 0:
            pod.node_name = nodes[i % N].name
    return nodes, pods


def extended_world(pkg, seed=5):
    """mask_world with named extended resources on some pods (extra
    resource columns) and on some nodes' allocatable."""
    tu, obj = pkg
    nodes, pods, _ = mask_world(tu, obj, seed, P=30, N=10)
    for j, n in enumerate(nodes):
        if j % 2:
            n.allocatable = dataclasses.replace(
                n.allocatable, extended=(("example.com/fpga", 2.0),)
            )
    for i, p in enumerate(pods):
        if i % 4 == 1:
            p.requests = dataclasses.replace(
                p.requests, extended=(("example.com/fpga", 1.0),)
            )
        if i % 7 == 2:
            p.requests = dataclasses.replace(
                p.requests, extended=(("example.com/nic", 3.0),)
            )
    return nodes, pods


def worlds(name, pkg):
    if name.startswith("mask"):
        nodes, pods, _ = mask_world(*pkg, int(name[4:]))
        return nodes, pods
    if name == "spread":
        return spread_world(pkg)
    return extended_world(pkg)


WORLDS = ["mask0", "mask1", "mask2", "mask3", "spread", "extended"]


def groups_of(nodes):
    return {n.name: f"pool-{j % 3}" for j, n in enumerate(nodes) if j % 5 != 4}


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "factored"])
@pytest.mark.parametrize("world", WORLDS)
def test_pack_matches_jax(world, dense):
    jn, jp = worlds(world, JAX)
    tn, tp = worlds(world, TORCH)
    jt, jm = jpack.pack(jn, jp, groups_of(jn), dense_mask=dense)
    tt, tm = tpack.pack(tn, tp, groups_of(tn), dense_mask=dense, device="cpu")
    assert (tt.sched_mask is None) == (not dense)
    assert_snapshots_equal(jt, tt)
    assert_meta_equal(jm, tm)
    if not dense and world != "extended":
        assert (tt.pod_exc >= 0).any()      # the world reaches the exception rows


def test_pack_explicit_padding_matches_jax():
    jn, jp = worlds("mask1", JAX)
    tn, tp = worlds("mask1", TORCH)
    for dense in (True, False):
        jt, _ = jpack.pack(jn, jp, pad_pods=48, pad_nodes=20, dense_mask=dense)
        tt, _ = tpack.pack(tn, tp, pad_pods=48, pad_nodes=20, dense_mask=dense, device="cpu")
        assert tt.num_pods == 48 and tt.num_nodes == 20
        assert_snapshots_equal(jt, tt)
    with pytest.raises(ValueError, match="truncate"):
        tpack.pack(tn, tp, pad_pods=8, device="cpu")


@pytest.mark.parametrize("delta", [0, -1])
def test_pack_switches_form_at_the_cell_limit(monkeypatch, delta):
    """dense_mask=None: dense up to DENSE_MASK_CELL_LIMIT padded cells,
    factored beyond, in both packages."""
    jn, jp = worlds("mask2", JAX)
    tn, tp = worlds("mask2", TORCH)
    cells = ttens.bucket_size(len(tp)) * ttens.bucket_size(len(tn))
    monkeypatch.setattr(jpack, "DENSE_MASK_CELL_LIMIT", cells + delta)
    monkeypatch.setattr(tpack, "DENSE_MASK_CELL_LIMIT", cells + delta)
    jt, _ = jpack.pack(jn, jp)
    tt, _ = tpack.pack(tn, tp, device="cpu")
    assert (tt.sched_mask is None) == (delta < 0)
    assert_snapshots_equal(jt, tt)


def test_dense_mask_cell_limit_value():
    assert tpack.DENSE_MASK_CELL_LIMIT == jpack.DENSE_MASK_CELL_LIMIT == 1 << 24


def test_pack_copies_its_numpy_arrays():
    """The tensors own their memory: a later write to one snapshot's
    tensor does not reach another pack of the same objects."""
    tn, tp = worlds("mask0", TORCH)
    t1, _ = tpack.pack(tn, tp, device="cpu")
    t2, _ = tpack.pack(tn, tp, device="cpu")
    t1.node_used.fill_(7.0)
    t1.sched_mask.fill_(False)
    assert not torch.equal(t1.node_used, t2.node_used)
    assert t2.sched_mask.any()


@pytest.mark.parametrize("interpod", [True, False])
@pytest.mark.parametrize("world", ["mask0", "mask1", "mask4", "spread"])
def test_compute_factored_mask_matches_jax(world, interpod):
    if world == "mask4":
        jn, jp, jnop = mask_world(*JAX, 4, place=False)
        tn, tp, tnop = mask_world(*TORCH, 4, place=False)
    else:
        jn, jp = worlds(world, JAX)
        tn, tp = worlds(world, TORCH)
        jnop = [next((j for j, n in enumerate(jn) if n.name == p.node_name), -1) for p in jp]
        tnop = list(jnop)
    jf = jpack.compute_factored_mask(jn, jp, jnop, interpod=interpod)
    tf = tpack.compute_factored_mask(tn, tp, tnop, interpod=interpod)
    assert canon(jf) == canon(tf)
    jd = jpack.compute_sched_mask(jn, jp, jnop, interpod=interpod)
    td = tpack.compute_sched_mask(tn, tp, tnop, interpod=interpod)
    np.testing.assert_array_equal(jd, td)


@pytest.mark.parametrize("world", ["mask0", "mask3", "spread"])
def test_row_rules_through_a_view_give_the_dense_rows(world):
    """The one rule engine, handed a view over a block of rows for ANY
    subset of pods (class rows with the self-cell overrides baked in),
    fills each row exactly as compute_sched_mask fills the whole mask."""
    nodes, pods = worlds(world, TORCH)
    nop = [next((j for j, n in enumerate(nodes) if n.name == p.node_name), -1) for p in pods]
    dense = tpack.compute_sched_mask(nodes, pods, nop)
    rows = random.Random(world).sample(range(len(pods)), len(pods) // 2)
    row_of = {i: e for e, i in enumerate(rows)}
    ports = tpack._node_port_counts(pods, nop)
    csi = tpack._node_csi_attached(pods, nop)
    pid, nid, prof = tpack._profile_factorization(nodes, pods, nop, ports, csi)
    block = np.stack([prof[pid[i]][nid] for i in rows])
    for i, j, value in tpack._self_cell_overrides(nodes, pods, nop, ports, csi):
        if i in row_of:
            block[row_of[i], j] = value
    tpack._apply_row_rules(
        tpack._RowView(block, row_of), nodes, pods, nop, True,
        legacy=tpack._legacy_conflict_nodes(pods, nop),
    )
    np.testing.assert_array_equal(block, dense[rows])


def test_hostport_daemonset_stays_class_structured():
    """A host-port DaemonSet pod on every node costs one cell each, no
    exception rows, in both packages."""
    out = []
    for tu, obj in (JAX, TORCH):
        nodes = [tu.build_test_node(f"n{j}", cpu_m=4000) for j in range(20)]
        pods = []
        for j in range(20):
            ds = tu.build_test_pod(f"ds-{j}", cpu_m=50, node_name=f"n{j}")
            ds.host_ports = (9100,)
            pods.append(ds)
        web = tu.build_test_pod("web", cpu_m=100)
        web.host_ports = (9100,)
        pods.append(web)
        nop = list(range(20)) + [-1]
        pk = jpack if tu is jtu else tpack
        out.append(pk.compute_factored_mask(nodes, pods, nop))
    assert canon(out[0]) == canon(out[1])
    assert (out[1].pod_exc == -1).all() and (out[1].cell_pod >= 0).sum() == 20


def test_resources_rows_matches_jax_and_resources_row():
    rng = np.random.default_rng(3)
    draws = [
        dict(cpu_m=float(rng.integers(0, 10**5)), memory=float(rng.integers(0, 2**38)),
             ephemeral=float(rng.integers(0, 2**33)), gpu=float(rng.integers(0, 8)),
             tpu=float(rng.integers(0, 8)), pods=float(rng.integers(0, 256)),
             extended=(("example.com/a", 1.5),) if k % 3 == 0 else ())
        for k in range(64)
    ]
    ext = ("example.com/a", "example.com/b")
    for pods_count in (1.0, None):
        outs = []
        for obj, pk in ((jobj, jpack), (tobj, tpack)):
            items = [obj.Resources(**d) for d in draws]
            out = np.zeros((64, 8), np.float32)
            pk.resources_rows(items, pods_count, out, ext)
            outs.append(out)
            for i, r in enumerate(items):
                np.testing.assert_array_equal(
                    out[i], pk.resources_row(r, r.pods if pods_count is None else 1.0, ext)
                )
        np.testing.assert_array_equal(outs[0].view(np.uint32), outs[1].view(np.uint32))


# -- SnapshotTensors -----------------------------------------------------------


def packed(world, dense):
    jn, jp = worlds(world, JAX)
    tn, tp = worlds(world, TORCH)
    return (jpack.pack(jn, jp, dense_mask=dense)[0],
            tpack.pack(tn, tp, dense_mask=dense, device="cpu")[0])


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "factored"])
@pytest.mark.parametrize("world", ["mask0", "mask2", "spread"])
def test_sched_row_and_dense_sched_match_jax(world, dense):
    jt, tt = packed(world, dense)
    jd = to_np(jt.dense_sched())
    np.testing.assert_array_equal(jd, to_np(tt.dense_sched()))
    for i in range(tt.num_pods):
        np.testing.assert_array_equal(to_np(tt.sched_row(i)), jd[i])
    batch = torch.tensor([5, 0, 5, tt.num_pods - 1, 17])
    np.testing.assert_array_equal(to_np(tt.sched_rows(batch)), jd[batch.numpy()])


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "factored"])
def test_schedule_and_unschedule_match_jax(dense):
    """A sequence of schedule_pod / unschedule_pod calls on the packed
    world, in both packages: every field bit-equal after each step, and
    the inputs untouched."""
    import jax.numpy as jnp

    jt, tt = packed("mask1", dense)
    before = {f: getattr(tt, f).clone() for f in ("node_used", "pod_node")}
    steps = [("s", 3, 5), ("s", 7, 0), ("u", 3), ("u", 11), ("s", 11, 2), ("u", 7)]
    jcur, tcur = jt, tt
    for step in steps:
        if step[0] == "s":
            jcur = jcur.schedule_pod(jnp.int32(step[1]), jnp.int32(step[2]))
            tcur = tcur.schedule_pod(step[1], step[2])
        else:
            jcur = jcur.unschedule_pod(jnp.int32(step[1]))
            tcur = tcur.unschedule_pod(torch.tensor(step[1]))
        assert_snapshots_equal(jcur, tcur)
    for f, t in before.items():
        assert torch.equal(getattr(tt, f), t)


def test_schedule_unschedule_roundtrip_exact():
    t = ttens.empty_snapshot(num_pods=8, num_nodes=4, device="cpu")
    pod_req = t.pod_req.clone()
    pod_req[0] = torch.tensor([0.1, 0.2, 0.3, 1.0, 0.0, 1.0])
    t = dataclasses.replace(t, pod_req=pod_req)
    t1 = t.schedule_pod(0, 1)
    t2 = t1.unschedule_pod(0)
    assert int(t1.pod_node[0]) == 1 and t1.pod_node.dtype == torch.int32
    assert torch.equal(t1.node_used[1], pod_req[0]) and not t1.node_used[0].any()
    assert int(t2.pod_node[0]) == -1
    assert torch.equal(t2.node_used, t.node_used)
    assert torch.equal(t.unschedule_pod(3).node_used, t.node_used)   # never placed


def test_empty_snapshot_matches_jax():
    assert_snapshots_equal(
        jtens.empty_snapshot(num_pods=8, num_nodes=4),
        ttens.empty_snapshot(num_pods=8, num_nodes=4, device="cpu"),
    )


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "factored"])
def test_tensors_from_numpy_replays_a_jax_snapshot(dense):
    """The JAX package's fields as numpy arrays (what dump_tensors writes)
    become the port's SnapshotTensors, equal to the port's own pack."""
    jt, tt = packed("mask3", dense)
    arrays = {
        f.name: np.array(getattr(jt, f.name))
        for f in dataclasses.fields(jt) if getattr(jt, f.name) is not None
    }
    replayed = ttens.tensors_from_numpy(arrays, device="cpu")
    assert_snapshots_equal(tt, replayed)
    arrays["node_used"][0, 0] = 123.0          # a copy, not an alias
    assert float(replayed.node_used[0, 0]) != 123.0
    with pytest.raises(ValueError, match="not SnapshotTensors fields"):
        ttens.tensors_from_numpy({"bogus": np.zeros(3)}, device="cpu")


# -- ClusterSnapshot -------------------------------------------------------------


def _random_ops(seed, n_ops=300):
    """A seeded op sequence over a few node and pod names."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.18:
            ops.append(("add_node", f"n{rng.randrange(8)}", rng.randrange(1, 5) * 1000))
        elif r < 0.25:
            ops.append(("remove_node", rng.random()))
        elif r < 0.45:
            ops.append(("add_pod", f"p{rng.randrange(24)}", rng.randrange(50, 900), rng.random()))
        elif r < 0.52:
            ops.append(("remove_pod", rng.random()))
        elif r < 0.62:
            ops.append(("schedule_pod", rng.random(), rng.random()))
        elif r < 0.72:
            ops.append(("fork",))
        elif r < 0.8:
            ops.append(("revert",))
        elif r < 0.86:
            ops.append(("commit",))
        else:
            ops.append(("tensors",))
    return ops


def _apply(snap, tu, op, log):
    def pick(items, u):
        return items[int(u * len(items))] if items else None

    kind = op[0]
    if kind == "add_node":
        if snap.get_node(op[1]) is None:
            snap.add_node(tu.build_test_node(op[1], cpu_m=op[2]))
    elif kind == "remove_node":
        node = pick(sorted(n.name for n in snap.nodes()), op[1])
        if node:
            snap.remove_node(node)
    elif kind == "add_pod":
        pod = tu.build_test_pod(op[1], cpu_m=op[2])
        if snap.get_pod(pod.key()) is None:
            node = pick(sorted(n.name for n in snap.nodes()), op[3]) if op[3] < 0.6 else ""
            snap.add_pod(pod, node or "")
    elif kind == "remove_pod":
        key = pick(sorted(p.key() for p in snap.pods()), op[1])
        if key:
            snap.remove_pod(key)
    elif kind == "schedule_pod":
        key = pick(sorted(p.key() for p in snap.pods()), op[1])
        node = pick(sorted(n.name for n in snap.nodes()), op[2])
        if key and node:
            snap.schedule_pod(key, node)
    elif kind == "fork":
        snap.fork()
    elif kind == "revert":
        if snap.fork_depth:
            snap.revert()
    elif kind == "commit":
        snap.commit()
    else:
        t, meta = snap.tensors()
        log.append((t, meta))


def _state(snap):
    return (
        [n.name for n in snap.nodes()],
        [p.key() for p in snap.pods()],
        [(p.key(), snap.assignment(p.key())) for p in snap.pods()],
        [[p.key() for p in snap.pods_on_node(n.name)] for n in snap.nodes()],
        [p.key() for p in snap.pending_pods()],
        snap.fork_depth,
    )


@pytest.mark.parametrize("seed", range(4))
def test_cluster_snapshot_matches_jax(seed):
    """The same op sequence (mutations, fork/revert/commit, tensors()) on
    both packages' snapshots: the same state after every op, equal tensors
    from every tensors() call, and the cache served (the same object as
    the previous call) exactly when the JAX package serves it."""
    js, ts = jcs.ClusterSnapshot(), tcs.ClusterSnapshot(device="cpu")
    jlog, tlog = [], []
    for op in _random_ops(seed):
        _apply(js, jtu, op, jlog)
        _apply(ts, ttu, op, tlog)
        assert _state(js) == _state(ts), op
    assert len(tlog) == len(jlog) > 10
    for (jt, jm), (tt, tm) in zip(jlog, tlog):
        assert_snapshots_equal(jt, tt)
        assert_meta_equal(jm, tm)
    j_same = [a[0] is b[0] for a, b in zip(jlog, jlog[1:])]
    t_same = [a[0] is b[0] for a, b in zip(tlog, tlog[1:])]
    assert j_same == t_same and any(t_same)


def test_tensors_cache_survives_fork_revert():
    snap = tcs.ClusterSnapshot(device="cpu")
    snap.add_node(ttu.build_test_node("n"))
    snap.add_pod(ttu.build_test_pod("p", node_name="n"))
    t0, _ = snap.tensors()
    snap.fork()
    snap.add_pod(ttu.build_test_pod("q"))
    snap.revert()
    assert snap.tensors()[0] is t0
    snap.fork()
    snap.add_pod(ttu.build_test_pod("q2"))
    t_fork, _ = snap.tensors()
    snap.revert()
    snap.add_pod(ttu.build_test_pod("r"))
    t2, _ = snap.tensors()
    assert t2 is not t_fork and int(t2.pod_valid.sum()) == 2
    assert t2.node_used.device.type == "cpu"


def test_cluster_snapshot_errors_match_jax():
    for cs, tu in ((jcs, jtu), (tcs, ttu)):
        snap = cs.ClusterSnapshot() if cs is jcs else cs.ClusterSnapshot(device="cpu")
        snap.add_node(tu.build_test_node("n0"))
        with pytest.raises(cs.SnapshotError):
            snap.add_node(tu.build_test_node("n0"))
        with pytest.raises(cs.SnapshotError):
            snap.add_pod(tu.build_test_pod("p"), "nope")
        with pytest.raises(cs.SnapshotError):
            snap.revert()
        with pytest.raises(cs.SnapshotError):
            snap.schedule_pod("default/none", "n0")
