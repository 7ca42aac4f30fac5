"""The port's copies of the repo's affinity and spread workload generators
(autoscaler_tpu_torch/utils/workload.py) draw the same worlds from the
same seed as the originals in benchmarks/affinity_bench.py and
benchmarks/spread_bench.py."""
import numpy as np

from benchmarks.affinity_bench import build_workload as jax_affinity_workload
from benchmarks.spread_bench import build_world as jax_spread_world
from autoscaler_tpu_torch.utils import workload
from torch_parity import canon


def test_affinity_workload_matches_the_bench_generator():
    got = workload.build_affinity_workload(300, 7, 11, seed=3)
    want = jax_affinity_workload(300, 7, 11, seed=3)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3].any() and got[4].any() and got[5].any()


def test_spread_world_matches_the_bench_generator():
    jpods, jtemplates = jax_spread_world(200, 5, 6, seed=2)
    tpods, ttemplates = workload.build_spread_world(200, 5, 6, seed=2)
    assert canon(jpods) == canon(tpods)
    assert canon(jtemplates) == canon(ttemplates)
    assert any(p.affinity for p in tpods) and any(p.topology_spread for p in tpods)


def test_spread_world_topology_key():
    pods, _ = workload.build_spread_world(100, 3, 4, seed=2, topology_key="kubernetes.io/hostname")
    keys = {c.topology_key for p in pods for c in p.topology_spread}
    assert keys == {"kubernetes.io/hostname"}


def test_fit_workload_matches_the_bench_operands():
    """benchmarks/fit_bench.py builds its operands inside main(); its
    lines from the shape to node_valid are run here as they stand and must
    give build_fit_workload's arrays."""
    import inspect

    import benchmarks.fit_bench as fit_bench

    src = inspect.getsource(fit_bench.main)
    body = src[src.index("    P, N, R = "):src.index("    args = [")]
    scope = {"np": np}
    exec(compile("\n".join(line[4:] for line in body.splitlines()), "fit_bench", "exec"), scope)
    want = [scope[k] for k in ("req", "free", "pod_class", "node_class", "class_mask",
                               "node_valid")]
    got = workload.build_fit_workload()
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (100_000, 6) and got[1].shape == (15_000, 6)


def test_snapshot_world_shape():
    """A cut-down snapshot world: its counts, and every placed pod on a
    node it selects and tolerates."""
    from autoscaler_tpu_torch.kube.objects import pod_tolerates_taints

    nodes, pods = workload.build_snapshot_world(N=300, P=2100, port_nodes=100, seed=1)
    assert len(nodes) == 300 and len(pods) == 2200
    by_name = {n.name: n for n in nodes}
    pending = [p for p in pods if not p.node_name]
    assert len(pending) == 300                                  # one in seven
    assert sum(1 for p in pending if p.affinity) == 3           # one in a hundred
    assert sum(1 for p in pods if p.host_ports) == 100
    assert sum(1 for n in nodes if n.taints) == 30
    for p in pods:
        if p.node_name:
            n = by_name[p.node_name]
            assert pod_tolerates_taints(p, n.taints)
            assert all(n.labels.get(k) == v for k, v in p.node_selector.items())
    again = workload.build_snapshot_world(N=300, P=2100, port_nodes=100, seed=1)
    assert canon(again) == canon((nodes, pods))


def test_snapshot_world_packs_factored(monkeypatch):
    """Past the dense-cell limit the world packs factored, with an
    exception row per anti-affinity pod and a cell per host-port pod."""
    from autoscaler_tpu_torch.snapshot import packer

    nodes, pods = workload.build_snapshot_world(N=300, P=2100, port_nodes=100)
    monkeypatch.setattr(packer, "DENSE_MASK_CELL_LIMIT", 1 << 12)
    t, _ = packer.pack(nodes, pods, device="cpu")
    assert t.sched_mask is None
    assert int((t.pod_exc >= 0).sum()) == 3 and int((t.cell_pod >= 0).sum()) == 100
