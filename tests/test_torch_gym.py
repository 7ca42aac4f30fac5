"""The policy gym (``autoscaler_tpu_torch/gym``) on the CPU against the JAX
package:

- every case of tests/test_gym.py run on the port's modules
  (``torch_parity.Rebound``), its slow-marked CLI cycle included; the two
  that read the canned suite run from a working directory where
  ``tools/canned`` wrote it; the one that drives bench.py is left to the
  JAX suite (its twin: ``test_torch_canned_shapes.py``);
- twin tunes: the same suite and config through both packages' tuners,
  with the shared coalescer and without, one worker and several — the
  tuning ledgers byte-equal (``TestTuner::test_solo_and_worker_count_
  invariance`` on the port is the 1-against-N case);
- twin rollouts: an episode's decision log, report and step rewards equal
  the JAX package's;
- the gym CLI's ``tune`` with ``--device``, and 4s's suite
  (``tools/drill_probe.gym_suite_doc``) at a small tune.
"""
import inspect
import json

import pytest
import torch

import autoscaler_tpu.gym as jgym
import autoscaler_tpu.loadgen.spec as jspec
import autoscaler_tpu_torch.fleet.coalescer as tcoalescer
import autoscaler_tpu_torch.gym as tgym
import autoscaler_tpu_torch.gym.env as tgym_env
import autoscaler_tpu_torch.loadgen.driver as tdriver
import autoscaler_tpu_torch.loadgen.spec as tspec
import autoscaler_tpu_torch.parallel.mesh as tmesh
import test_gym
import torch_loadgen_twin as twin
from autoscaler_tpu_torch.tools import drill_probe
from torch_parity import Rebound


def _cpu(device=None):
    return torch.device("cpu") if device is None else torch.device(device)


@pytest.fixture()
def on_cpu(monkeypatch):
    for mod in (tdriver, tgym_env, tcoalescer, tmesh):
        monkeypatch.setattr(mod, "resolve_device", _cpu)


REBOUND = Rebound(test_gym)
# the case that drives bench.py
NOT_HERE = ("test_bench_exit_codes",)
# cases that read the canned suite from benchmarks/scenarios/
CANNED = ("test_canned_suite_parses", "test_loadgen_validate_accepts_suite")


@pytest.fixture(scope="module")
def canned_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("canned")
    twin.write_canned(d)
    return d


def _cases():
    out = []
    for key, value in vars(test_gym).items():
        if key.startswith("test_") and callable(value):
            out.append(key)
        elif key.startswith("Test") and isinstance(value, type):
            out += [f"{key}.{m}" for m in vars(value) if m.startswith("test_")]
    return [n for n in out if not any(s in n for s in NOT_HERE)]


CASES = _cases()


@pytest.mark.parametrize("name", CASES)
def test_jax_gym_case_on_the_port(name, request, on_cpu, monkeypatch):
    if any(s in name for s in CANNED):
        monkeypatch.chdir(request.getfixturevalue("canned_dir"))
    target = getattr(test_gym, name.split(".")[0])
    if "." in name:
        target = getattr(target, name.split(".")[1])
    params = [p for p in inspect.signature(target).parameters if p != "self"]
    REBOUND.case(name)(**{p: request.getfixturevalue(p) for p in params})


def test_the_cases_cover_the_gym_suite():
    assert len(CASES) >= 25
    for suite in ("TestPolicySpec", "TestEnv", "TestFleetCoalescedRollouts", "TestTuner",
                  "TestLedger", "TestSuiteSpec", "TestCliEndToEnd"):
        assert any(n.startswith(suite) for n in CASES), suite
    assert "TestTuner.test_solo_and_worker_count_invariance" in CASES


# -- twins ------------------------------------------------------------------------


def suite_doc():
    return jgym.SuiteSpec(name="tiny", scenarios=[
        test_gym.tiny_spec(),
        test_gym.tiny_spec(name="gymtest2", seed=6, workloads=[
            jspec.WorkloadSpec(kind="spike", rate=5.0, period_ticks=4, completion_rate=0.5)],
            events=[]),
    ]).to_dict()


@pytest.mark.parametrize("workers,coalesce", [(1, False), (3, True)], ids=["solo", "fleet"])
def test_twin_tune_ledgers_equal(workers, coalesce, on_cpu):
    doc = suite_doc()
    ledgers = []
    for k, kw in ((jgym, {}), (tgym, {"device": "cpu"})):
        cfg = k.TuneConfig(generations=2, population=3, seed=3, workers=workers,
                           fleet_coalesce=coalesce, **kw)
        ledgers.append(k.tune_suite(k.SuiteSpec.from_dict(doc), cfg).ledger_lines())
    assert ledgers[0] == ledgers[1]
    assert tgym.validate_records([json.loads(line) for line in ledgers[1].splitlines()]) == []


def test_twin_rollout_matches_jax(on_cpu):
    doc = test_gym.tiny_spec().to_dict()
    policy = {"expander": "most-pods", "scale_down_unneeded_time_s": 20.0}
    out = []
    for k, spec, kw in ((jgym, jspec, {}), (tgym, tspec, {"device": "cpu"})):
        env = k.PolicyGymEnv(spec.ScenarioSpec.from_dict(doc), **kw)
        out.append(env.rollout(policy=k.PolicySpec(**policy)))
    j, t = out
    assert twin.rename(j.decision_log) == t.decision_log
    assert twin.strip_walls(twin.rename(j.report)) == twin.strip_walls(t.report)
    assert j.step_rewards == t.step_rewards and j.score == t.score


def test_gym_cli_tune_on_the_cpu(tmp_path, capsys):
    suite = tmp_path / "suite.json"
    suite.write_text(json.dumps(suite_doc()))
    ledger = tmp_path / "tune.jsonl"
    from autoscaler_tpu_torch.gym.cli import main

    assert main(["tune", str(suite), "--generations", "1", "--population", "2", "--seed", "1",
                 "--ledger", str(ledger), "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["metric"] == "gym_tune_tiny"
    assert main(["validate", str(ledger)]) == 0


def test_drill_suite_tune_matches_jax(on_cpu):
    """4s's suite, tuned as chip_smoke tunes it (one generation of two
    candidates, two workers sharing the coalescer): the port's ledger
    equals the JAX package's."""
    doc = drill_probe.gym_suite_doc()
    text = drill_probe.tune_ledger(doc, "cpu")
    cfg = jgym.TuneConfig(generations=1, population=2, seed=0, workers=2)
    want = jgym.tune_suite(jgym.SuiteSpec.from_dict(doc), cfg).ledger_lines()
    assert text == want
