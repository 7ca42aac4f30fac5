"""The canned workload shapes and the gym's suite on the CPU against the
JAX package (``autoscaler_tpu_torch/tools/canned``: ``burst_small``,
``diurnal_medium``, ``drain_heavy``, and ``gym_suite``'s five scenarios
each as a plain scenario):

- twin runs: each document once through each package's driver; the
  decision logs byte for byte, the score reports, the explain, SLO, journal
  and perf ledgers, the event traces, fault counts and pod latencies equal,
  the JAX package's under the name map (``torch_loadgen_twin``);
- the twin of ``bench.py --gym-ledger``
  (``test_gym.py::TestTuner::test_bench_exit_codes``): a tune of the canned
  suite on the port writes a ledger that ``gym.validate_records`` accepts,
  and the corruption that case plants is an error.

The gym's two cases that read the suite run in ``test_torch_gym.py``, and
``test_loadgen.py``'s two in ``test_torch_loadgen.py``, each from a working
directory where ``tools/canned`` wrote the files.
"""
import json

import pytest

import torch_loadgen_twin as twin
from autoscaler_tpu_torch import gym as tgym
from autoscaler_tpu_torch.tools import canned

NAMES = ("burst_small", "diurnal_medium", "drain_heavy") + tuple(
    s["name"] for s in canned.doc(canned.SUITE)["scenarios"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    yield from twin.one_torch_thread()


@pytest.fixture(scope="module")
def canned_twins():
    return twin.CannedTwins()


@pytest.mark.parametrize("name,artifact", twin.artifact_cases(NAMES))
def test_canned_twin_matches_jax(name, artifact, canned_twins):
    jax_view, port_view = canned_twins.views(name)[artifact]
    assert port_view == jax_view


def test_the_suites_scenarios_are_here():
    assert len(NAMES) == 8 and "gym_kernel_fault" in NAMES


def test_burst_small_takes_the_spread_route(canned_twins):
    """``burst_small``'s burst carries a zone spread (the dynamic route:
    K3 on a card, its torch loop here) and lands on both pools."""
    _, tres = canned_twins["burst_small"]
    served = tres.metrics.estimator_kernel_route_total
    assert served.get(route="torch_scan", reason="not_cuda") >= 1
    groups = {g for r in tres.records for g, _ in r.scale_ups}
    assert groups == {"pool-a", "pool-b"}


@pytest.fixture(scope="module")
def suite_tune():
    suite = tgym.SuiteSpec.from_dict(canned.doc(canned.SUITE))
    return tgym.tune_suite(suite, tgym.TuneConfig(generations=1, population=2, workers=1,
                                                  seed=12, device="cpu"))


def test_gym_ledger_gate_on_the_port(suite_tune):
    """The canned suite's tuning ledger validates and names the suite's
    five scenarios; a record moved to another generation is an error."""
    records = [json.loads(line) for line in suite_tune.ledger_lines().splitlines()]
    assert records and tgym.validate_records(records) == []
    assert records[0]["suite"] == canned.SUITE
    summary = tgym.summarize(records)
    assert summary["generations"] == 1 and summary["winner"]
    records[0]["generation"] = 7
    assert tgym.validate_records(records)
