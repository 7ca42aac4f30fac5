"""The tile census of K4's operands (autoscaler_tpu_torch/tools/
fit_tile_census.py): the shares of (pod, tile) pairs that tile skipping by
capacity could resolve, on a world small enough to count by hand."""
import torch

from autoscaler_tpu_torch.ops import fit_reduce as tfr
from autoscaler_tpu_torch.tools.fit_tile_census import main, tile_census


def test_census_counts_by_hand():
    """Two tiles of two nodes: pod 0 is at most every tile's minimum (both
    pairs resolved as fits), pod 1 is over the first tile's maximum (a miss)
    and at most the second's minimum (a fit); pod 2 has no class and is not
    counted, nor is the invalid node 3, whose 0 free would be the second
    tile's minimum."""
    req = torch.tensor([[1.0, 1.0], [5.0, 5.0], [0.0, 0.0]])
    free = torch.tensor([[2.0, 2.0], [3.0, 3.0], [9.0, 9.0], [0.0, 0.0]])
    ops = (req, free, torch.tensor([0, 0, -1], dtype=torch.int32),
           torch.tensor([0, 0, 0, 0], dtype=torch.int32), torch.tensor([[True]]),
           torch.tensor([True, True, True, False]))
    line = tile_census(ops, tfr._fit_reduce_plain(*ops), tiles=(2,))
    assert line == (
        "2-node tiles hold 1-1 of 1 node classes; 2-node tiles: a request over the "
        "tile's maximum on 25.0000% and under its minimum on every resource on "
        "75.0000% of 4 (pod, tile) pairs; the class test passes on 100.00% of live "
        "pairs, 66.67% fit"
    )


def test_census_runs_on_the_cpu_when_asked(monkeypatch, capsys):
    from autoscaler_tpu_torch.utils import workload

    def small(seed=0):
        return tuple(a[:700] if a.shape[0] == 100_000 else a[:600] if a.shape[0] == 15_000
                     else a for a in full(seed))

    full = workload.build_fit_workload
    monkeypatch.setattr(workload, "build_fit_workload", small)
    assert main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("fit-K4 tile census: 256-node tiles hold ")
    assert "of 24 node classes" in out and "32-node tiles: " in out and out.endswith("fit\n")
