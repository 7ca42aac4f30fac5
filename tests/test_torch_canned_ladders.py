"""The canned fault ladders on the CPU against the JAX package
(``autoscaler_tpu_torch/tools/canned``: ``kernel_fault_ladder``,
``device_lost_ladder``, ``fault_backoff``, ``skip_reasons``,
``spot_reclaim``):

- twin runs: each document once through each package's driver; the
  decision logs byte for byte, the score reports, the explain, SLO, journal
  and perf ledgers, the event traces, fault counts and pod latencies equal,
  the JAX package's under the name map (``torch_loadgen_twin``);
- the JAX cases that read these files, on the port (``torch_parity.
  Rebound``, the files written from ``tools/canned`` into a temporary
  working directory): ``tests/test_resilience.py::TestFaultLadderScenarios``,
  ``tests/test_explain.py::TestLoadgenAcceptance`` (its ``skip_replays``),
  ``tests/test_perf.py::TestLoadgenPerfDeterminism`` and
  ``tests/test_trace.py::TestLoadgenTraceDeterminism`` (their
  ``ladder_replays``), the CLI flag cases among them;
- the twins of those suites' ``bench.py`` ledger gates: the port's
  ``perf.validate_records`` and ``explain.validate_records`` accept the
  replays' ledgers and reject each corruption the gates plant.
"""
import json

import pytest
import torch

import autoscaler_tpu_torch.gym.env as tgym_env
import autoscaler_tpu_torch.loadgen.driver as tdriver
import autoscaler_tpu_torch.loadgen.fleetdrive as tfleetdrive
import test_explain
import test_perf
import test_resilience
import test_trace
import torch_loadgen_twin as twin
from autoscaler_tpu_torch import explain as texplain
from autoscaler_tpu_torch import perf as tperf
from torch_parity import Rebound

NAMES = ("kernel_fault_ladder", "device_lost_ladder", "fault_backoff", "skip_reasons",
         "spot_reclaim")


def _cpu(device=None):
    return torch.device("cpu") if device is None else torch.device(device)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    yield from twin.one_torch_thread()


@pytest.fixture()
def on_cpu(monkeypatch):
    for mod in (tdriver, tfleetdrive, tgym_env):
        monkeypatch.setattr(mod, "resolve_device", _cpu)


@pytest.fixture(scope="module")
def canned_twins():
    return twin.CannedTwins()


@pytest.fixture(scope="module")
def canned_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("canned")
    twin.write_canned(d)
    return d


@pytest.fixture()
def canned_cwd(canned_dir, monkeypatch):
    """The working directory holds ``benchmarks/scenarios/<name>.json``,
    written from ``tools/canned``."""
    monkeypatch.chdir(canned_dir)
    return canned_dir


@pytest.fixture(scope="module")
def ladder_replays(canned_twins):
    """``kernel_fault_ladder`` run twice on the port."""
    return canned_twins["kernel_fault_ladder"][1], canned_twins.port_again("kernel_fault_ladder")


@pytest.fixture(scope="module")
def skip_replays(canned_twins):
    """``skip_reasons`` run twice on the port."""
    return canned_twins["skip_reasons"][1], canned_twins.port_again("skip_reasons")


# -- twin runs ---------------------------------------------------------------------


@pytest.mark.parametrize("name,artifact", twin.artifact_cases(NAMES))
def test_canned_twin_matches_jax(name, artifact, canned_twins):
    jax_view, port_view = canned_twins.views(name)[artifact]
    assert port_view == jax_view


def test_the_ladders_fault_their_rungs_on_the_cpu(canned_twins):
    """Off the card the faulted cuda and torch rungs descend to the native
    rung, and every tick completes."""
    _, tres = canned_twins["kernel_fault_ladder"]
    served = tres.metrics.estimator_kernel_route_total
    assert served.get(route="native", reason="kernel_fault") >= 1
    assert not any(r.errors for r in tres.records)
    _, lost = canned_twins["device_lost_ladder"]
    assert lost.injected_faults.get("device_lost", 0) >= 3


# -- the JAX cases that read these files, on the port ------------------------------

RESILIENCE = Rebound(test_resilience)
EXPLAIN = Rebound(test_explain, unported=("ffd_binpack_reference_groups",))
PERF = Rebound(test_perf)
TRACE = Rebound(test_trace)
# the bench.py ledger gates: their twins are below
CASES = {
    "test_resilience": (RESILIENCE, RESILIENCE.class_cases("TestFaultLadderScenarios")),
    "test_explain": (EXPLAIN, EXPLAIN.class_cases("TestLoadgenAcceptance",
                                                  leave_out=("bench",))),
    "test_perf": (PERF, PERF.class_cases("TestLoadgenPerfDeterminism", leave_out=("bench",))),
    "test_trace": (TRACE, TRACE.class_cases("TestLoadgenTraceDeterminism",
                                            leave_out=("rung_walk",))),
}
CASE_IDS = [(m, n) for m, (_, names) in CASES.items() for n in names]


@pytest.mark.parametrize("module,name", CASE_IDS, ids=[f"{m}::{n}" for m, n in CASE_IDS])
def test_jax_canned_case_on_the_port(module, name, request, on_cpu, canned_cwd):
    CASES[module][0].run(name, request)


def test_the_cases_cover_what_reads_the_canned_files():
    names = {n for _, n in CASE_IDS}
    assert len(RESILIENCE.class_cases("TestFaultLadderScenarios")) >= 3
    assert "TestLoadgenAcceptance.test_cli_explain_ledger_flag" in names
    assert "TestLoadgenPerfDeterminism.test_cli_perf_ledger_flag" in names
    assert "TestLoadgenTraceDeterminism.test_cli_chrome_trace_flag" in names
    assert len(names) >= 16
    assert not any("bench" in n for n in names)


def test_rung_walk_nested_under_estimate_of_faulted_tick(ladder_replays):
    """``test_trace.py::TestLoadgenTraceDeterminism::test_rung_walk_nested_
    under_estimate_of_faulted_tick`` with the port's rung names (its
    ``("pallas", "fault")`` is a tuple, which ``Rebound`` leaves as it is):
    the faulted tick's ladder walk, cuda fault → torch fault → native ok,
    as deviceDispatch spans under the tick's estimate span."""
    r1, _ = ladder_replays
    walked = None
    for t in r1.recorder.traces():
        rungs = [s for s in t.spans if s.name == "deviceDispatch"]
        if any(s.attrs.get("rung") == "cuda" and s.attrs.get("outcome") == "fault"
               for s in rungs):
            walked = (t, {s.span_id: s for s in t.spans}, rungs)
            break
    assert walked is not None, "no faulted tick found in the ring"
    t, spans, rungs = walked
    assert all(spans[s.parent_id].name == "estimate" for s in rungs)
    outcomes = [(s.attrs["rung"], s.attrs["outcome"]) for s in rungs]
    assert ("cuda", "fault") in outcomes
    assert outcomes[-1][1] == "ok"
    assert t.root.attrs["scenario"] == "kernel_fault_ladder"
    assert "sim_ts" in t.root.attrs and "tick" in t.root.attrs


# -- the ledger gates without bench.py ---------------------------------------------


def test_perf_ledger_gate_on_the_port(ladder_replays):
    """``test_perf.py::TestLoadgenPerfDeterminism::test_bench_perf_ledger_gate``
    through ``perf.validate_records``: the replay's ledger is valid; a
    replayed first miss on the last tick is a compile on a steady-state
    tick; a ledger of the wrong shapes is refused, not a crash."""
    r1, _ = ladder_replays
    records = [json.loads(line) for line in r1.perf_ledger_lines().splitlines()]
    assert records and tperf.validate_records(records) == []
    summary = tperf.summarize(records)
    assert summary["routes"]
    first_miss = next(d for r in records for d in r["dispatches"] if d["cache"] == "miss")
    records[-1]["dispatches"].append(dict(first_miss))
    errors = tperf.validate_records(records)
    assert any("compile-on-steady-state-tick" in e for e in errors), errors
    mangled = [[1, 2, 3], {"schema": tperf.SCHEMA}]
    assert tperf.validate_records(mangled)


def test_explain_ledger_gate_on_the_port(skip_replays):
    """``test_explain.py::TestLoadgenAcceptance::test_bench_explain_ledger_gate``
    through ``explain.validate_records``: the replay's ledger is valid and
    covers the skip reasons; an executed scale-up stripped of its winning
    score is a provenance error."""
    r1, _ = skip_replays
    records = [json.loads(line) for line in r1.explain_ledger_lines().splitlines()]
    assert records and texplain.validate_records(records) == []
    assert texplain.summarize(records)["skip_reasons"]
    executed = next(r for r in records if r.get("scale_up", {}).get("executed"))
    executed["expander"].pop("score", None)
    reread = [json.loads(texplain.record_line(r)) for r in records]
    assert any("winning score" in e for e in texplain.validate_records(reread))
