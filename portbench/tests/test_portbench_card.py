"""On the card: the plain reference there gives the CPU's answer, and the
timed path's answer, at a size a test run holds; and the control fails.
Marked ``gpu``; without a card the tests skip. On the card:

    python -m pytest -q -p no:cacheprovider -m gpu portbench/tests/test_portbench_card.py
"""
import pytest
import torch

from portbench import check
from portbench.spec import Spec
from portbench.tests.tiny import CELLS, tiny_root
from portbench.worlds import build_pool

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.parametrize("cell", CELLS)
def test_reference_and_port_on_the_card(cuda, cell, tmp_path):
    spec = Spec(tiny_root(tmp_path))
    c = spec.cell(cell)
    config = spec.config(c["config"])
    world = build_pool(config, spec.traffic(c["traffic"]), 2**31 + 3, cuda)[0]
    entry, reference = spec.entry(config["estimate"]), spec.reference(config["estimate"])
    ref = reference.solve(world, cuda)
    on_cpu = reference.solve(world, "cpu")
    assert check.compare([((on_cpu.node_count, on_cpu.scheduled), ref)])["answers_off"] == 0
    assert on_cpu.fit_tests == ref.fit_tests
    answer = entry.fetch(entry.estimate(entry.upload(world, cuda), world))
    assert check.compare([(answer, ref)])["answers_off"] == 0
    control = reference.solve(world, cuda, torch.bfloat16)
    assert not check.passes(check.compare([((control.node_count, control.scheduled), ref)]))
