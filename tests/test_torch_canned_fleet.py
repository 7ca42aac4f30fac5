"""The canned fleet scenarios on the CPU against the JAX package
(``autoscaler_tpu_torch/tools/canned``: ``fleet_tenants``,
``fleet_overload``, ``fleet_rolling_restart``):

- twin runs: each document once through each package's fleet driver; the
  fleet round ledgers, the reports without their walls, the SLO and perf
  ledgers, the fault counts, the certificate and the admission tallies
  equal, the JAX package's under the name map (``torch_loadgen_twin``);
- ``tests/test_fleet.py::test_fleet_cli_runs_canned_scenario`` on the port:
  its subprocess names the JAX package's CLI, so its twin runs the port's
  ``loadgen run`` on a ``tmp_path`` copy of the document;
- what ``hack/verify.sh``'s fleet gates hold of these replays (every answer
  equal to its solo dispatch on both rungs, typed sheds and the burn alert
  of the overload, the gold tier of the rolling restart), on the port's
  (``hack/verify_torch.sh`` holds the replays' files byte-identical and
  leaves these gates to this file);
- the twins of the ``bench.py --fleet-ledger`` and ``--slo-ledger`` gates
  (``test_fleet_ha.py::test_fleet_ledger_validator_and_bench_gate``,
  ``test_slo.py::TestBenchGate``): ``fleet.validate_fleet_records`` and
  ``slo.validate_records`` accept the replays' ledgers and reject each
  corruption those cases plant.
"""
import json
import re

import pytest

import autoscaler_tpu_torch.fleet.coalescer as tcoalescer
import autoscaler_tpu_torch.loadgen.cli as tcli
import autoscaler_tpu_torch.loadgen.fleetdrive as tfleetdrive
import autoscaler_tpu_torch.parallel.mesh as tmesh
import torch_loadgen_twin as twin
from autoscaler_tpu_torch import slo as tslo
from autoscaler_tpu_torch.fleet import ROUTE_BATCHED, ROUTE_ORACLE, validate_fleet_records
from autoscaler_tpu_torch.tools import canned

NAMES = canned.FLEET


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


def test_fleet_cli_runs_canned_scenario(tmp_path, capsys, monkeypatch):
    """``test_fleet.py::test_fleet_cli_runs_canned_scenario`` on the port's
    CLI: exit 0 (parity certified), a round ledger of 8 rounds whose
    answers all equal their solo dispatch, on the batched and (in the
    fault window) the oracle rung, and a perf ledger."""
    import torch

    for mod in (tfleetdrive, tcoalescer, tmesh):
        monkeypatch.setattr(mod, "resolve_device", lambda d=None: torch.device(d or "cpu"))
    spec = tmp_path / "fleet_tenants.json"
    spec.write_text(json.dumps(canned.doc("fleet_tenants")))
    log, perf = tmp_path / "fleet.jsonl", tmp_path / "perf.jsonl"
    rc = tcli.main(["run", str(spec), "--log", str(log), "--perf-ledger", str(perf),
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    rounds = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(rounds) == 8
    assert all(t["match_solo"] for r in rounds for t in r["tenants"])
    assert {t["route"] for r in rounds for t in r["tenants"]} == {ROUTE_BATCHED, ROUTE_ORACLE}
    assert json.loads(out)["parity"]["certified"]
    assert perf.read_text().strip()


# -- hack/verify.sh's fleet gates, on the port's replays ----------------------------


def _rounds(result):
    return [json.loads(line) for line in result.decision_ledger_lines().splitlines()]


def test_fleet_tenants_fairness(canned_twins):
    """Both rungs served (the torch-rung fault window degrades the batches
    to the oracle), every answer equals its solo dispatch, the report
    certifies it and names the buckets pre-warmed."""
    from autoscaler_tpu_torch.loadgen.score import build_fleet_report

    _, tres = canned_twins["fleet_tenants"]
    rounds = _rounds(tres)
    assert rounds and all(r["schema"] == "autoscaler_tpu.fleet.round/3" for r in rounds)
    assert all(t["match_solo"] for r in rounds for t in r["tenants"])
    assert {t["route"] for r in rounds for t in r["tenants"]} == {ROUTE_BATCHED, ROUTE_ORACLE}
    report = build_fleet_report(tres)
    assert report["parity"]["certified"] and report["fleet"]["prewarmed_buckets"]


def test_fleet_tenants_slo_and_exemplars(canned_twins):
    """The in-process half of verify.sh's SLO gate: the SLO ledger
    validates, the fleet objective saw every answer, and every exemplar
    trace id of the exposition resolves in the run's flight recorder."""
    _, tres = canned_twins["fleet_tenants"]
    assert tres.all_match()
    recs = tres.slo_records
    assert tslo.validate_records(recs) == []
    answers = sum(len(r.tenants) for r in tres.records)
    assert recs[-1]["slos"][tslo.SLI_FLEET_E2E]["events_total"] == answers
    expo = tres.metrics.registry.expose(openmetrics=True)
    ex_ids = {int(x) for x in re.findall(r'# \{trace_id="(\d+)"\}', expo)}
    assert ex_ids and ex_ids <= {t.trace_id for t in tres.recorder.traces()}


SHED_REASONS = {"shed_queue_full", "shed_quota", "shed_draining", "shed_deadline",
                "sidecar_crash", "sidecar_partition"}


def test_fleet_overload_sheds_typed_and_alerts(canned_twins):
    """verify.sh's overload chaos gate: typed sheds with retry-after, the
    quota and the outage both shed, no ticket hangs or leaks, parity holds,
    the burn alert fires in the outage and clears by the end."""
    _, tres = canned_twins["fleet_overload"]
    rounds = _rounds(tres)
    sheds = [row for r in rounds for row in r["shed"]]
    assert sheds
    for row in sheds:
        assert row["reason"] in SHED_REASONS and row["error"]
        if row["reason"] in ("shed_queue_full", "shed_quota"):
            assert row["retry_after_s"] > 0
    assert {"shed_quota", "sidecar_crash"} <= {row["reason"] for row in sheds}
    for r in rounds:
        o = r["outcomes"]
        assert o["unresolved"] == 0 and o["resolved"] == len(r["tenants"])
        posted = len(r["tenants"]) + len(r["shed"]) + o["failed"]
        assert posted == o["resolved"] + o["shed"] + o["expired"] + o["failed"]
        assert all(t["match_solo"] for t in r["tenants"])
    alerting = [rec["tick"] for rec in tres.slo_records
                if rec["slos"]["fleet_e2e"]["alerting"]]
    assert any(8 <= t <= 15 for t in alerting)
    assert not tres.slo_records[-1]["slos"]["fleet_e2e"]["alerting"]
    assert tres.injected_faults.get("rpc_slow", 0) > 0


def test_fleet_rolling_restart_keeps_gold(canned_twins):
    """verify.sh's rolling-restart gate: the gold tier is never shed and is
    answered every round, the low tiers shed by quota and queue share, the
    answers spread over replicas and none is served by a replica in its
    restart window, and the burn alert is quiet at the end."""
    _, tres = canned_twins["fleet_rolling_restart"]
    rounds = _rounds(tres)
    gold = {"gold-a", "gold-b"}
    assert not [s for r in rounds for s in r["shed"] if s["tenant"] in gold]
    for r in rounds:
        assert gold <= {t["tenant"] for t in r["tenants"]}
        assert r["outcomes"]["unresolved"] == 0
        assert all(t["match_solo"] for t in r["tenants"])
    sheds = [s for r in rounds for s in r["shed"]]
    assert sheds and "gold" not in {s["tier"] for s in sheds}
    assert {"shed_quota", "shed_queue_full"} <= {s["reason"] for s in sheds}
    endpoints = {t["endpoint"] for r in rounds for t in r["tenants"]}
    assert len(endpoints) >= 2 and "" not in endpoints
    windows = {"replica-0": range(5, 9), "replica-1": range(11, 15),
               "replica-2": range(16, 20)}
    for rep, win in windows.items():
        assert not [t for r in rounds if r["tick"] in win for t in r["tenants"]
                    if t["endpoint"] == rep]
    assert not tres.slo_records[-1]["slos"]["fleet_e2e"]["alerting"]


# -- the ledger gates without bench.py ---------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_fleet_ledger_gate_on_the_port(name, canned_twins):
    """``fleet.validate_fleet_records`` accepts the replay's round ledger;
    a hung ticket never validates clean."""
    _, tres = canned_twins[name]
    records = _rounds(tres)
    assert records and validate_fleet_records(records) == []
    bad = [dict(r) for r in records]
    bad[0] = dict(bad[0], outcomes=dict(bad[0]["outcomes"], unresolved=1))
    assert any("unresolved" in e for e in validate_fleet_records(bad))


@pytest.mark.parametrize("name", NAMES)
def test_slo_ledger_gate_on_the_port(name, canned_twins):
    """``slo.validate_records`` accepts the replay's SLO ledger; a burn
    rate that its window's arithmetic does not give is an error."""
    _, tres = canned_twins[name]
    records = [json.loads(line) for line in tres.slo_ledger_lines().splitlines()]
    assert records and tslo.validate_records(records) == []
    slo = next(iter(records[0]["slos"]))
    window = next(iter(records[0]["slos"][slo]["windows"]))
    records[0]["slos"][slo]["windows"][window]["burn_rate"] = 99.0
    assert any("burn_rate" in e for e in tslo.validate_records(records))
