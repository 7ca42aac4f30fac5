"""The canned scenarios of the state machinery on the CPU against the JAX
package (``autoscaler_tpu_torch/tools/canned``: ``arena_churn``,
``preemption_storm``, ``priority_inversion``):

- twin runs: each document once through each package's driver; the
  decision logs byte for byte, the score reports, the explain, SLO, journal
  and perf ledgers, the event traces, fault counts and pod latencies equal,
  the JAX package's under the name map (``torch_loadgen_twin``);
- the JAX cases that read ``preemption_storm``, on the port
  (``torch_parity.Rebound``, the files written from ``tools/canned`` into a
  temporary working directory): ``tests/test_journal.py``'s
  ``TestKeyframePolicy``, ``TestReconstructionParity``,
  ``TestCorruptionMatrix``, ``TestReplayDivergence`` (its
  ``storm_replays``) and ``TestJournalCli::test_loadgen_journal_flag``;
- what ``hack/verify.sh``'s arena, preemption and journal gates hold, on
  the port: the arena's decisions equal the cold repack's, its ledger
  shows delta scatters, promotions and the rollback; the storm's eviction
  rows name their evictor; the flag off equals the spec without it;
- the twin of ``bench.py --journal-ledger``
  (``test_journal.py::TestJournalCli::test_bench_journal_ledger_gate``):
  ``journal.validate_records`` and a ``JournalReader`` that reconstructs
  every tick accept the storm's journal; a journal without its keyframes
  is refused.
"""
import json

import pytest

import autoscaler_tpu_torch.loadgen.driver as tdriver
import autoscaler_tpu_torch.loadgen.spec as tspec
import test_journal
import torch_loadgen_twin as twin
from autoscaler_tpu_torch import explain as texplain
from autoscaler_tpu_torch import journal as tjournal
from autoscaler_tpu_torch import perf as tperf
from torch_parity import Rebound

NAMES = ("arena_churn", "preemption_storm", "priority_inversion")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    yield from twin.one_torch_thread()


@pytest.fixture()
def on_cpu(monkeypatch):
    """The journal's reconstruction, replay and the cases' own autoscalers
    build snapshots and autoscalers with no device given."""
    twin.port_on_cpu(monkeypatch)


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
    monkeypatch.chdir(canned_dir)
    return canned_dir


@pytest.fixture(scope="module")
def storm_replays(canned_twins):
    """``preemption_storm`` journaled twice on the port with the default
    keyframe policy, and once with a keyframe every tick (the ground truth
    of the reconstruction)."""
    return (canned_twins["preemption_storm"][1], canned_twins.port_again("preemption_storm"),
            canned_twins.port_again("preemption_storm", journal_keyframe_interval=1))


# -- twin runs ---------------------------------------------------------------------


@pytest.mark.parametrize("name,artifact", twin.artifact_cases(NAMES))
def test_canned_twin_matches_jax(name, artifact, canned_twins):
    jax_view, port_view = canned_twins.views(name)[artifact]
    assert port_view == jax_view


# -- the JAX cases that read preemption_storm, on the port -------------------------

JOURNAL = Rebound(test_journal)
CASES = JOURNAL.class_cases("TestKeyframePolicy", "TestReconstructionParity",
                            "TestCorruptionMatrix", "TestReplayDivergence") + [
    "TestJournalCli.test_loadgen_journal_flag"]


@pytest.mark.parametrize("name", CASES)
def test_jax_journal_case_on_the_port(name, request, on_cpu, canned_cwd):
    JOURNAL.run(name, request)


def test_the_cases_cover_the_storm_replays():
    assert len(CASES) >= 17
    assert "TestReplayDivergence.test_tampered_ledger_diverges" in CASES


# -- hack/verify.sh's arena, preemption and journal gates, on the port --------------


def test_arena_decisions_equal_the_cold_repack(canned_twins):
    """The arena changes how tensors reach the device, never what the
    autoscaler decides: ``arena_enabled=false`` writes the same decision
    ledger; the arena's perf ledger validates and shows delta scatters, a
    bucket promotion and the injected fault's rollback."""
    _, tres = canned_twins["arena_churn"]
    cold = canned_twins.port_again("arena_churn", arena_enabled=False)
    assert tres.explain_ledger_lines() == cold.explain_ledger_lines()
    records = [json.loads(line) for line in tres.perf_ledger_lines().splitlines()]
    assert tperf.validate_records(records) == []
    arena = tperf.summarize(records).get("arena") or {}
    assert arena.get("delta_rows", 0) > 0, arena
    assert arena.get("promotions", 0) > 0, arena
    assert arena.get("rollbacks", 0) > 0, arena


def test_preemption_storm_names_every_evictor(canned_twins):
    _, tres = canned_twins["preemption_storm"]
    records = [json.loads(line) for line in tres.explain_ledger_lines().splitlines()]
    assert texplain.validate_records(records) == []
    assert texplain.summarize(records).get("evictions", 0) > 0
    rows = [row for rec in records for row in (rec.get("preemption") or {}).get("evictions", [])]
    assert rows and all(row.get("by") and row.get("reason") == "preempted_by" for row in rows)
    assert sum(len(r["preempted"]) for r in tres.decision_log()) > 0


def test_preemption_flag_off_equals_the_spec_without_it(canned_twins):
    """``preemption_enabled=false`` gives the decisions of a spec that never
    mentions preemption, byte for byte."""
    off = canned_twins.port_again("preemption_storm", preemption_enabled=False)
    doc = json.loads(json.dumps(canned_twins.docs["preemption_storm"]))
    for key in ("preemption_enabled", "preemption_churn_weight"):
        doc["options"].pop(key, None)
    base = tdriver.run_scenario(tspec.ScenarioSpec.from_dict(doc), device="cpu")
    assert off.explain_ledger_lines() == base.explain_ledger_lines()
    assert json.dumps(off.decision_log(), sort_keys=True) == json.dumps(
        base.decision_log(), sort_keys=True)


# -- the ledger gate without bench.py ----------------------------------------------


def test_journal_ledger_gate_on_the_port(storm_replays):
    """The storm's journal validates, every journaled tick reconstructs,
    and keyframes were promoted beyond the init frame; a journal of its
    deltas alone does not validate."""
    r1, _, _ = storm_replays
    records = [json.loads(line) for line in r1.journal_ledger_lines().splitlines()]
    assert records and tjournal.validate_records(records) == []
    reader = tjournal.JournalReader(records)
    assert [reader.reconstruct(t).tick for t in reader.ticks()] == [r["tick"] for r in records]
    reasons = tjournal.summarize(records)["keyframe_reasons"]
    assert sum(v for k, v in reasons.items() if k != "init") > 0, reasons
    headless = [r for r in records if r["kind"] == "delta"]
    assert tjournal.validate_records(headless)
