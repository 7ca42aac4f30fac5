"""What decides ``correct``, on the CPU at a tiny size: the plain reference
against the port's CPU path, the lower-precision control failing, the fit
tests counted from the placement alone, and whole runs that fail with the
timed path broken underneath.

    python -m pytest -q -p no:cacheprovider portbench/tests
"""
import numpy as np
import pytest
import torch

from portbench import check
from portbench.spec import Spec
from portbench.tests.tiny import CELLS, run, tiny_root
from portbench.worlds import build_pool

SEEDS = (5, 2**31 + 11, 2**40 + 17)


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return Spec(tiny_root(tmp_path_factory.mktemp("tiny")))


def _world(spec, cell, seed, i=0):
    c = spec.cell(cell)
    config = spec.config(c["config"])
    return config, build_pool(config, spec.traffic(c["traffic"]), seed, "cpu")[i]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_the_port_on_the_cpu(spec, cell, seed):
    config, world = _world(spec, cell, seed)
    entry = spec.entry(config["estimate"])
    answer = entry.fetch(entry.estimate(entry.upload(world, "cpu"), world))
    ref = spec.reference(config["estimate"]).solve(world, "cpu")
    assert check.compare([(answer, ref)])["answers_off"] == 0
    assert 0 < ref.node_count.max() <= world.max_nodes


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_lower_precision_control_fails(spec, cell, seed):
    """The control: the reference in the program's place, computed in
    bfloat16, the precision below the configuration's float32."""
    config, world = _world(spec, cell, seed)
    ref = spec.reference(config["estimate"])
    control = ref.solve(world, "cpu", torch.bfloat16)
    numbers = check.compare([((control.node_count, control.scheduled), ref.solve(world, "cpu"))])
    assert not check.passes(numbers), numbers


def _naive_fit_tests(world) -> int:
    """First-fit decreasing one group and one pod at a time, counting each
    node a pod is compared with."""
    req, allocs = world.pod_req, world.allocs
    score = lambda g: req[:, 0] * allocs[g, 1] + req[:, 1] * allocs[g, 0]  # noqa: E731
    tests = 0
    for g in range(allocs.shape[0]):
        free = []
        for p in np.argsort(-score(g), kind="stable"):
            if not world.masks[g, p]:
                continue
            hit = next((n for n, f in enumerate(free) if (req[p] <= f).all()), None)
            tests += len(free) if hit is None else hit + 1
            if hit is not None:
                free[hit] = free[hit] - req[p]
            elif len(free) < world.caps[g] and (req[p] <= allocs[g]).all():
                free.append(allocs[g] - req[p])
    return tests * int((req > 0).any(axis=0).sum())


@pytest.mark.parametrize("cell", ["burst.k2", "burst.k1"])
def test_fit_tests_count_the_placement_not_the_implementation(spec, cell):
    config, world = _world(spec, cell, SEEDS[1])
    plain = spec.reference("ffd_groups").solve(world, "cpu")
    G, P = world.masks.shape
    none = np.zeros((1, P), bool)
    world.terms = {"match": none, "aff_of": none, "anti_of": none,
                   "node_level": np.zeros(1, bool), "has_label": np.ones((G, 1), bool)}
    gated = spec.reference("ffd_groups_affinity").solve(world, "cpu")
    assert check.compare([((gated.node_count, gated.scheduled), plain)])["answers_off"] == 0
    assert plain.fit_tests == gated.fit_tests == _naive_fit_tests(world)


def _broken(fault, scan):
    """The scan, broken the way ``fault`` says, on its own outputs."""
    def run_scan(*args, **kwargs):
        free, opened, placed = scan(*args, **kwargs)[:3]
        G = opened.shape[0]
        if fault == "state_unchanged":
            opened, placed = torch.zeros_like(opened), torch.zeros_like(placed)
        elif fault == "half_the_groups":
            opened, placed = opened.clone(), placed.clone()
            opened[G // 2:] = 0
            placed[G // 2:] = False
        elif fault == "one_answer_altered":
            placed = placed.clone()
            placed[0, 0] = ~placed[0, 0]
        return free, opened, placed
    return run_scan


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_groups", "one_answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(spec, cell, fault, monkeypatch):
    """The whole run, past the look for a card, with the scan's answer
    broken where it is produced: ``correct`` comes out false. (One card: no
    exchange between cards to leave out.)"""
    from autoscaler_tpu_torch.ops import ffd_scan, ffd_scan_affinity

    if cell == "affinity.k3":
        monkeypatch.setattr(ffd_scan_affinity, "ffd_scan_aff",
                            _broken(fault, ffd_scan_affinity.ffd_scan_aff))
    else:
        monkeypatch.setattr(ffd_scan, "run_scan", _broken(fault, ffd_scan.run_scan))
    result = run(spec, cell, seconds=0.3)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checked"].values())
