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
