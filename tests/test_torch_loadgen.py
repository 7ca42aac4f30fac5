"""The scenario engine (``autoscaler_tpu_torch/loadgen``) on the CPU against
the JAX package:

- every case of tests/test_loadgen.py run on the port's modules
  (``torch_parity.Rebound``); the two that read canned scenarios from
  ``benchmarks/scenarios/`` run from a working directory where
  ``tools/canned`` wrote those files (the port's tests never read
  ``benchmarks/``);
- twin runs: each event kind and cloud fault kind that suite covers, and
  each workload kind, in a spec built in code, through both packages'
  drivers — the decision logs byte for byte, the score reports without
  their wall fields, the explain, SLO, journal and perf ledgers, the
  resolved event traces and the pod latencies equal, the JAX package's
  under the name map (``torch_loadgen_twin``);
- the CLI's ``run``/``replay``/``validate`` on a spec written to
  ``tmp_path``, against the JAX package's CLI, and ``--sanitize`` on a
  clean scenario exiting 0 (the sanitizer's own cases:
  ``test_torch_analysis_suites.py``);
- the rung names of the JAX package loading into the port's spec.
"""
import inspect
import json

import pytest
import torch

import autoscaler_tpu.loadgen.cli as jcli
import autoscaler_tpu_torch.gym.env as tgym_env
import autoscaler_tpu_torch.loadgen.cli as tcli
import autoscaler_tpu_torch.loadgen.driver as tdriver
import autoscaler_tpu_torch.loadgen.fleetdrive as tfleetdrive
import autoscaler_tpu_torch.loadgen.spec as tspec
import test_loadgen
import torch_loadgen_twin as twin
from autoscaler_tpu_torch.tools import drill_probe
from torch_parity import Rebound


def _cpu(device=None):
    return torch.device("cpu") if device is None else torch.device(device)


@pytest.fixture()
def on_cpu(monkeypatch):
    """The port's drivers default to the CPU here (their entry points
    default to the first card, which this host does not have)."""
    for mod in (tdriver, tfleetdrive, tgym_env):
        monkeypatch.setattr(mod, "resolve_device", _cpu)


# -- the JAX package's cases on the port -------------------------------------------

REBOUND = Rebound(test_loadgen)
# cases left to the JAX suite: none (the canned-scenario cases run from
# CANNED_CWD's directory)
NOT_HERE = ()
# cases that load canned scenarios from benchmarks/scenarios/
CANNED = ("test_canned_scenarios_parse", "test_canned_fault_scenario_backs_off_and_recovers")


@pytest.fixture(scope="module")
def canned_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("canned")
    twin.write_canned(d)
    return d


def _cases():
    out = []
    for key, value in vars(test_loadgen).items():
        if key.startswith("test_") and callable(value):
            out.append(key)
        elif key.startswith("Test") and isinstance(value, type):
            out += [f"{key}.{m}" for m in vars(value) if m.startswith("test_")]
    return [n for n in out if not any(s in n for s in NOT_HERE)]


CASES = _cases()


@pytest.mark.parametrize("name", CASES)
def test_jax_loadgen_case_on_the_port(name, request, on_cpu, monkeypatch):
    if any(s in name for s in CANNED):
        monkeypatch.chdir(request.getfixturevalue("canned_dir"))
    target = getattr(test_loadgen, name.split(".")[0])
    if "." in name:
        target = getattr(target, name.split(".")[1])
    params = [p for p in inspect.signature(target).parameters if p != "self"]
    REBOUND.case(name)(**{p: request.getfixturevalue(p) for p in params})


def test_the_cases_cover_the_loadgen_suite():
    assert len(CASES) >= 30
    for suite in ("TestSpecRoundTrip", "TestWorkloadExpansion", "TestDeterministicReplay",
                  "TestBurstScenario", "TestFaultScenarios", "TestNodeFlap", "TestReportShape",
                  "TestReviewRegressions", "TestSetOverrideHardening", "TestObjectiveSection"):
        assert any(n.startswith(suite) for n in CASES), suite


# -- twin runs ---------------------------------------------------------------------


def spec_doc(name, **kw):
    doc = dict(
        name=name, seed=9, ticks=8,
        node_groups=[dict(name="g", min_size=0, max_size=10, initial_size=1)],
        events=[dict(at_tick=1, kind="pod_burst", count=8, cpu_m=1500.0, mem_mb=1024.0,
                     prefix="burst")],
    )
    doc.update(kw)
    return doc


BURST = spec_doc("burst")["events"]

# each event kind and each cloud fault kind of tests/test_loadgen.py
TWINS = {
    "burst-complete": spec_doc(
        "burst-complete", ticks=12,
        events=BURST + [dict(at_tick=5, kind="pod_complete", count=8, prefix="burst")]),
    "flap-resize": spec_doc(
        "flap-resize",
        node_groups=[dict(name="g", min_size=3, max_size=10, initial_size=3, zone="z1"),
                     dict(name="h", min_size=0, max_size=6, initial_size=0, cpu_m=8000.0,
                          mem_mb=32768.0, price_per_hour=2.0, provision_ticks=2)],
        events=BURST + [dict(at_tick=2, kind="node_flap", group="g", count=1, duration_ticks=2),
                        dict(at_tick=3, kind="resize", group="h", count=2),
                        dict(at_tick=6, kind="resize", group="h", count=0)]),
    "scale_up_error": spec_doc(
        "scale_up_error", faults=[dict(kind="scale_up_error", group="g", end_tick=4)]),
    "instance_error": spec_doc(
        "instance_error", ticks=10, faults=[dict(kind="instance_error", group="g", end_tick=2,
                                                 error_class="QUOTA_EXCEEDED")]),
    "stuck_creating": spec_doc(
        "stuck_creating", ticks=10, faults=[dict(kind="stuck_creating", group="g")],
        options={"max_node_provision_time_s": 20.0}),
    "refresh_error": spec_doc(
        "refresh_error", faults=[dict(kind="refresh_error", start_tick=2, end_tick=4)]),
    "fault-events": spec_doc(
        "fault-events", ticks=10,
        events=BURST + [
            dict(at_tick=1, kind="fault", fault=dict(kind="scale_up_error", probability=0.5,
                                                     end_tick=3)),
            dict(at_tick=2, kind="pod_burst", count=6, cpu_m=700.0, mem_mb=2048.0,
                 prefix="late", spread_zone_skew=1),
            dict(at_tick=5, kind="clear_faults")]),
    "eviction_error": spec_doc(
        "eviction_error", ticks=12,
        events=BURST + [dict(at_tick=5, kind="pod_complete", count=5, prefix="burst")],
        faults=[dict(kind="eviction_error", group="g", probability=0.5)],
        options={"scale_down_utilization_threshold": 0.9}),
}

WORKLOADS = {
    kind: spec_doc(f"wl-{kind}", ticks=10, events=[], workloads=[
        dict(kind=kind, rate=3.0, period_ticks=4, completion_rate=0.3, cpu_m=900.0)])
    for kind in ("steady", "diurnal", "spike", "drain_heavy")
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_run_matches_jax(name):
    jres, tres = twin.assert_twin(TWINS[name])
    assert tres.records and len(tres.decision_log()) == TWINS[name]["ticks"]


def test_twin_runs_cover_every_event_kind_and_cloud_fault():
    kinds = {e["kind"] for d in TWINS.values() for e in d.get("events", [])}
    assert kinds == set(tspec.EVENT_KINDS)
    faults = {f["kind"] for d in TWINS.values() for f in d.get("faults", [])}
    faults |= {e["fault"]["kind"] for d in TWINS.values() for e in d.get("events", [])
               if e["kind"] == "fault"}
    assert {"scale_up_error", "instance_error", "stuck_creating", "refresh_error",
            "eviction_error"} <= faults


@pytest.mark.parametrize("kind", sorted(WORKLOADS))
def test_twin_workload_matches_jax(kind):
    jres, tres = twin.assert_twin(WORKLOADS[kind])
    assert any(e["kind"] == "pod_burst" for e in tres.trace)


def test_twin_faults_fire_alike():
    """The fault scenarios did fault, and the decision they drive shows."""
    _, tres = twin.run_both(TWINS["scale_up_error"])
    assert tres.injected_faults.get("scale_up_error", 0) >= 1
    assert any("g" in r.backed_off for r in tres.records)
    _, tres = twin.run_both(TWINS["refresh_error"])
    assert any("provider refresh failed" in e for r in tres.records for e in r.errors)


def test_decision_log_is_byte_stable_across_port_runs():
    doc = WORKLOADS["steady"]
    a = tdriver.run_scenario(tspec.ScenarioSpec.from_dict(doc), device="cpu")
    b = tdriver.run_scenario(tspec.ScenarioSpec.from_dict(doc), device="cpu")
    assert json.dumps(a.decision_log(), sort_keys=True) == json.dumps(b.decision_log(),
                                                                      sort_keys=True)
    assert a.journal_ledger_lines() == b.journal_ledger_lines()
    assert a.explain_ledger_lines() == b.explain_ledger_lines()
    assert a.recorder.chrome() == b.recorder.chrome()


def test_binder_time_is_a_wall_field():
    """Each tick times its binder pass (``bind_s``); like ``wall_s`` it
    stays out of the decision log."""
    res = tdriver.run_scenario(tspec.ScenarioSpec.from_dict(TWINS["burst-complete"]),
                               device="cpu")
    assert all(r.bind_s >= 0.0 for r in res.records) and any(r.bind_s > 0 for r in res.records)
    assert all("bind_s" not in e and "wall_s" not in e for e in res.decision_log())
    assert res.device == "cpu"


# -- the CLI -----------------------------------------------------------------------


def _cli_run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_run_replay_validate_match_jax(tmp_path, capsys):
    """run → report, log, trace and ledgers; replay of the trace reproduces
    the log; validate round-trips; every artifact equals the JAX CLI's."""
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(spec_doc("cli", ticks=6, workloads=[
        dict(kind="steady", rate=2.0, completion_rate=0.2)])))
    outs = {}
    for name, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device=cpu"])):
        d = tmp_path / name
        d.mkdir()
        rc, out, _ = _cli_run(main, ["run", str(spec), "--log", str(d / "log.json"),
                                     "--trace", str(d / "trace.json"),
                                     "--report", str(d / "report.json"),
                                     "--explain-ledger", str(d / "explain.jsonl"),
                                     "--slo-ledger", str(d / "slo.jsonl"),
                                     "--journal", str(d / "journal.jsonl"),
                                     "--chrome-trace", str(d / "chrome.json"),
                                     "--perf-ledger", str(d / "perf.jsonl")] + extra, capsys)
        assert rc == 0
        assert json.loads(out) == json.loads((d / "report.json").read_text())
        rc, _, _ = _cli_run(main, ["replay", str(d / "trace.json"),
                                   "--log", str(d / "replay.json")] + extra, capsys)
        assert rc == 0
        assert (d / "replay.json").read_text() == (d / "log.json").read_text()
        rc, out, _ = _cli_run(main, ["validate", str(spec)], capsys)
        assert rc == 0 and out.startswith("ok: cli (6 ticks")
        outs[name] = d
    j, t = outs["jax"], outs["torch"]
    assert twin.rename(json.loads((j / "log.json").read_text())) == json.loads(
        (t / "log.json").read_text())
    assert twin.strip_walls(twin.rename(json.loads((j / "report.json").read_text()))) == \
        twin.strip_walls(json.loads((t / "report.json").read_text()))
    assert (j / "slo.jsonl").read_text() == (t / "slo.jsonl").read_text()
    assert twin.journal_lines((j / "journal.jsonl").read_text()) == twin.journal_lines(
        (t / "journal.jsonl").read_text())
    assert twin.rename(json.loads((j / "trace.json").read_text())) == json.loads(
        (t / "trace.json").read_text())
    assert (t / "chrome.json").stat().st_size > 0


@pytest.mark.parametrize("command", ["run", "replay"])
def test_cli_sanitize_raises_naming_its_item(tmp_path, command):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(spec_doc("san", ticks=2)))
    path = spec
    if command == "replay":
        path = tmp_path / "trace.json"
        path.write_text(json.dumps({"spec": spec_doc("san", ticks=2), "events": []}))
    # the sanitizer is ported (analysis/sanitizer.py): the flag no longer
    # raises; a clean scenario exits 0 under it, as the JAX package's does
    assert tcli.main([command, str(path), "--sanitize", "--device=cpu"]) == 0


def test_cli_errors_exit_2(tmp_path, capsys):
    assert tcli.main(["validate", str(tmp_path / "missing.json")]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"name": "x", "ticks": 0, "node_groups": []}))
    assert tcli.main(["run", str(bad), "--device=cpu"]) == 2
    assert "error:" in capsys.readouterr().err


# -- the rung names ----------------------------------------------------------------


@pytest.mark.parametrize("jax_rung,port_rung", [("pallas", "cuda"), ("xla", "torch"),
                                                ("", ""), ("cuda", "cuda"),
                                                ("torch", "torch")])
def test_jax_rung_names_load_as_the_ports(jax_rung, port_rung):
    doc = spec_doc("rungs", faults=[dict(kind="kernel_fault", rung=jax_rung)])
    spec = tspec.ScenarioSpec.from_dict(doc)
    assert spec.faults[0].rung == port_rung
    written = spec.to_dict()["faults"][0]
    assert written.get("rung", "") == port_rung
    assert tspec.ScenarioSpec.from_json(spec.to_json()) == spec


def test_unknown_rung_rejected():
    with pytest.raises(tspec.SpecError, match="kernel_fault rung"):
        tspec.FaultSpec(kind="kernel_fault", rung="tpu")
    assert tspec.KERNEL_FAULT_RUNGS == ("", "cuda", "torch")


# -- the scalability drill (tools/drill_probe: chip_smoke 3w, 3y, 4r) ----------------


def test_scale_drill_at_a_tenth_matches_jax():
    """4r's drill (100 nodes, 3 000 pods, 30 a node; then 30 emptied nodes
    deleted 10 a tick) through both packages: every artifact equal, every
    pod bound at the group's full size, every emptied node deleted."""
    doc = drill_probe.drill_doc(tenth=True)
    jres, tres = twin.assert_twin(doc)
    assert drill_probe.drill_problems(tres, tenth=True) == []
    summary = drill_probe.drill_summary(tres, 1.0)
    assert summary["nodes"]["peak"] == 100 and summary["nodes"]["final"] == 70
    assert summary["deleted"] == 30 and summary["bound"] == 3000
    # the drill's pods are all alike: its estimates take the dedup route
    assert set(summary["kernel_routes"]) == {"reason=dedup/route=torch_runs"}
    a, b = drill_probe.comparable(tres), drill_probe.comparable(
        drill_probe.run_drill(doc, "cpu")[0])
    assert a == b


def test_profiled_drill_matches_jax_and_writes_a_session_a_tick(tmp_path, monkeypatch):
    """3y's drill at 4r's size (the drill's bursts, then pods of distinct
    sizes, then 10 emptied nodes deleted) equals the JAX package's, and
    with ``jax_profiler_dir`` set on its scale-up and scale-down ticks each
    of the two writes its session, the decisions unchanged."""
    from autoscaler_tpu_torch.trace import device as tdev

    monkeypatch.setattr(tdev, "_sessions_broken", False)
    doc = drill_probe.profile_doc(tenth=True)
    jres, tres = twin.assert_twin(doc)
    up, down = drill_probe.PROFILE_TICKS
    assert tres.records[up].scale_ups and not tres.records[up].scale_downs
    assert len(tres.records[down].scale_downs) == 10 and not tres.records[down].scale_ups
    assert sum(len(r.scale_downs) for r in tres.records) == 10
    profiled, _ = drill_probe.run_drill(doc, "cpu", profiler_dir=str(tmp_path),
                                        profile_ticks=(up, down))
    assert drill_probe.comparable(profiled) == drill_probe.comparable(tres)
    sessions = drill_probe.profile_sessions(profiled, str(tmp_path))
    assert [s["tick"] for s in sessions] == [up, down]
    assert all(s["bytes"] > 0 and s["ranges"].get(s["step"]) == 1 for s in sessions)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"tick_{s['trace_id']:06d}" for s in sessions]
