"""The canned scenarios built in code (``autoscaler_tpu_torch/tools/canned``)
against the JAX package's files, without reading them:

- each document's canonical SHA-256 (keys sorted, compact separators, the
  rung names the port's) against the constant it was pinned to when it was
  built from its file under ``benchmarks/scenarios/``;
- each document through both packages' ``ScenarioSpec.from_dict``
  (``SuiteSpec`` for the suite), the JAX package's under
  ``torch_loadgen_twin.jax_doc``, to the same spec under the name map;
- both packages' ``loadgen validate`` on a ``tmp_path`` copy;
- building the documents opens no file, and ``analysis_probe.fault_ladder_doc`` is the
  canned ``kernel_fault_ladder`` (with 4u's bursts when ``mixed``).
"""
import builtins
import json

import pytest

import autoscaler_tpu.loadgen.cli as jcli
import autoscaler_tpu.loadgen.spec as jspec
import autoscaler_tpu.loadgen.suite as jsuite
import autoscaler_tpu_torch.loadgen.cli as tcli
import autoscaler_tpu_torch.loadgen.spec as tspec
import autoscaler_tpu_torch.loadgen.suite as tsuite
import torch_loadgen_twin as twin
from autoscaler_tpu_torch.tools import analysis_probe, canned, drill_probe

# the canonical SHA-256 of each file under benchmarks/scenarios/, with the
# values of its "rung" keys mapped (pallas -> cuda, xla -> torch)
SHA256 = {
    "kernel_fault_ladder": "59955663a51dd07a9d8df8b29d49584a359cecd9080413fe923672a2bd7d0a79",
    "device_lost_ladder": "921487093d10c42fe924cc80dc6e5e3686bb175439bc0c2427dec8228db5e7a2",
    "fault_backoff": "a840c419554548ba0bbe04b9874fce08f0cd0fc0a97461f9445a6805ffc73f1b",
    "skip_reasons": "b2942ac9371295bb86e8125e7dbf8f94e3dc75fd13525d28151f439520fb88e9",
    "spot_reclaim": "39fb817e2de1a67b23bfabdeffccc7f8ea2acf2ee3771558802e76042a4ccd9a",
    "fleet_tenants": "7d94fb4a58be61e313bf934d28dd34489452fa322359e4afcaa468719adf9d21",
    "fleet_overload": "193ac56133016486bfad7149c95c1972aaabe35a465014eb235882ca86e304e2",
    "fleet_rolling_restart": "91c8a4cf99d2599a33579241ff388e0a7ab861d9b0e866c4d21c4e0dac06e997",
    "arena_churn": "cd90a5e44806f89fa8055c6b593218aa39fbc1a91c75c173724a5619442fa47b",
    "preemption_storm": "7f216efa6af74f9952043f4e506ecdb8d1821d4243c64068855c5125ce2703d8",
    "priority_inversion": "fbe375a094baf8f5c1cf604f1c6c6cbc2d319a4e1c7338bc3d733deef474a370",
    "burst_small": "0442d62ad110c1a342c79009f35772ebeadcc7d729807ca66da40f548a5fc6c4",
    "diurnal_medium": "a2ce8e100553a38409c6e198947955775dde06257187d463c946fe2e8f2ec711",
    "drain_heavy": "ada8490724bf6176f56e9f2ed2ca2eb1299bd22317c7766a6add3574748554b2",
    "gym_suite": "197155fb429554c6c2b3e5cc88f699c16ac93d3b6eb35fe8cebe2ac45e8bc2e6",
}


def test_names_cover_the_fifteen_files_in_order():
    assert list(canned.NAMES) == list(SHA256)
    assert canned.NAMES[-1] == canned.SUITE == "gym_suite"
    assert set(canned.FLEET) == {n for n in canned.NAMES
                                 if n != canned.SUITE and canned.is_fleet(canned.doc(n))}


@pytest.mark.parametrize("name", list(SHA256))
def test_document_matches_its_file(name):
    assert canned.canonical_sha256(canned.doc(name)) == SHA256[name]


def test_docs_are_fresh_copies():
    a = canned.doc("kernel_fault_ladder")
    a["events"][0]["fault"]["rung"] = "pallas"
    assert canned.doc("kernel_fault_ladder")["events"][0]["fault"]["rung"] == "cuda"


def test_scenario_docs_are_the_fourteen_then_the_suites_five():
    names = [n for n, _ in canned.scenario_docs()]
    suite = [s["name"] for s in canned.doc(canned.SUITE)["scenarios"]]
    assert names == [n for n in canned.NAMES if n != canned.SUITE] + suite
    assert len(names) == 19 and "gym_kernel_fault" in names
    assert set(canned.DEVICE_FAULTS) <= set(names)


@pytest.mark.parametrize("name", list(SHA256))
def test_both_packages_parse_to_the_same_spec(name):
    doc = canned.doc(name)
    if name == canned.SUITE:
        j = jsuite.SuiteSpec.from_dict(twin.jax_doc(doc))
        t = tsuite.SuiteSpec.from_dict(doc)
        assert t.scenario_names() == j.scenario_names()
    else:
        j = jspec.ScenarioSpec.from_dict(twin.jax_doc(doc))
        t = tspec.ScenarioSpec.from_dict(doc)
        assert tspec.ScenarioSpec.from_json(t.to_json()) == t
    assert twin.rename(j.to_dict()) == t.to_dict()


@pytest.mark.parametrize("name", list(SHA256))
def test_both_validate_clis_accept_the_doc(name, tmp_path, capsys):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(canned.doc(name)))
    assert tcli.main(["validate", str(path)]) == 0
    port_out = capsys.readouterr().out
    jpath = tmp_path / f"{name}.jax.json"
    jpath.write_text(json.dumps(twin.jax_doc(canned.doc(name))))
    assert jcli.main(["validate", str(jpath)]) == 0
    assert capsys.readouterr().out == port_out
    assert port_out.startswith(f"ok: suite {name}" if name == canned.SUITE else f"ok: {name}")


def test_documents_are_built_without_opening_a_file(monkeypatch, tmp_path):
    """The documents come from code alone; ``write_all`` writes only its
    own directory."""
    opened = []
    real_open = builtins.open

    def spy(path, *args, **kwargs):
        opened.append(str(path))
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", spy)
    for name in canned.NAMES:
        canned.doc(name)
    canned.scenario_docs()
    assert opened == []
    paths = canned.write_all(str(tmp_path / "out"))
    assert opened == [paths[n] for n in canned.NAMES]
    assert all(p.startswith(str(tmp_path)) for p in opened)
    monkeypatch.undo()
    for name, path in paths.items():
        assert json.loads(open(path).read()) == canned.doc(name)


def test_fault_ladder_doc_is_the_canned_one():
    assert analysis_probe.fault_ladder_doc(mixed=False) == canned.doc("kernel_fault_ladder")
    mixed = analysis_probe.fault_ladder_doc()
    plain = canned.doc("kernel_fault_ladder")
    assert mixed["events"][:len(plain["events"])] == plain["events"]
    extra = mixed["events"][len(plain["events"]):]
    assert len(extra) == 2 * analysis_probe.MIXED_PODS
    assert {e["at_tick"] for e in extra} == set(analysis_probe.MIXED_TICKS)
    assert {k: v for k, v in mixed.items() if k != "events"} == {
        k: v for k, v in plain.items() if k != "events"}


@pytest.mark.parametrize("name", ["kernel_fault_ladder", "device_lost_ladder",
                                  "gym_kernel_fault"])
def test_fault_window_reads_the_armed_ticks(name):
    doc = dict(canned.scenario_docs())[name]
    assert canned.fault_window(doc) == ((2, 10) if name != "device_lost_ladder" else (2, 9))


# -- 4v's checks (chip_smoke), held here to card runs made from CPU runs -----------


@pytest.fixture(scope="module")
def cpu_runs():
    docs = dict(canned.scenario_docs())
    return {name: canned.run(docs[name], "cpu") for name in ("diurnal_medium",
                                                             "kernel_fault_ladder")}


def _as_card(report):
    """The score report a card gives where the CPU gave ``report``: each
    ``torch_scan`` estimate (reason ``not_cuda``) served on K2 instead, one
    rung engagement each, under the kernel's own perf row."""
    card = json.loads(json.dumps(report))
    n = card["kernel_routes"].pop("reason=not_cuda/route=torch_scan")
    card["kernel_routes"]["reason=ok/route=cuda"] = n
    card["function_duration"]["deviceDispatch"]["count"] -= n
    row = card["perf"]["routes"].pop("torch_scan")
    card["perf"]["routes"]["cuda"] = dict(row, compiles=1, signatures=1, utilization=0.5)
    card["platform"] = "gpu"
    return card


def test_report_view_names_the_cards_kernel_route_as_the_cpu_does(cpu_runs):
    from autoscaler_tpu_torch.loadgen.score import build_report

    report = build_report(cpu_runs["diurnal_medium"]["result"])
    assert report["kernel_routes"]["reason=not_cuda/route=torch_scan"] > 0
    card = _as_card(report)
    assert drill_probe.report_view(card) == drill_probe.report_view(report)
    # an estimate the card served on the torch loop instead of its kernel
    loop = json.loads(json.dumps(card))
    loop["kernel_routes"]["reason=ok/route=cuda"] -= 1
    loop["kernel_routes"]["reason=smem/route=torch_scan"] = 1
    assert drill_probe.report_view(loop) != drill_probe.report_view(report)
    # one rung engagement more than the route map allows
    extra = json.loads(json.dumps(card))
    extra["function_duration"]["deviceDispatch"]["count"] += 1
    assert drill_probe.report_view(extra) != drill_probe.report_view(report)
    # the fleet's batched route: K1/K2 on a card, the torch rung on the CPU
    row = {"dispatches": 26, "compiles": 1, "compile_s": 0.001, "execute_s": 0.025,
           "signatures": 1}
    fleet = {"perf": {"routes": {"fleet_batched": row}, "ticks": 31}}
    on_card = {"perf": {"routes": {"fleet_batched": dict(row, compiles=5, signatures=5)},
                        "ticks": 31}}
    assert drill_probe.report_view(on_card) == drill_probe.report_view(fleet)
    on_card["perf"]["routes"]["fleet_batched"]["dispatches"] = 25
    assert drill_probe.report_view(on_card) != drill_probe.report_view(fleet)


def _design_ticks(cpu_ticks, start, clear):
    """A card's tick log as the design wants it, made from the CPU's: every
    estimate that the CPU served on a host rung (in the fault window, and
    past it while the breakers stayed open) raised, and the CPU's
    torch_scan estimates were served on K2."""
    out = []
    for t in json.loads(json.dumps(cpu_ticks)):
        if any(k.startswith(("native", "python")) for k in t["served"]):
            t["served"] = {}
            t["errors"] = ["run_once crashed (internalError): injected kernel_fault on "
                           "torch rung"]
        t["served"] = {("cuda:ok" if k == "torch_scan:not_cuda" else k): v
                       for k, v in t["served"].items()}
        t["degraded"] = ["cuda", "torch"] if start <= t["tick"] < clear + 2 else []
        out.append(t)
    return out


def test_card_problems_hold_the_fault_ladders_design(cpu_runs):
    name = "kernel_fault_ladder"
    document = canned.doc(name)
    start, clear = canned.fault_window(document)
    run = cpu_runs[name]
    cpu_view = drill_probe.comparable(run["result"])
    ticks = _design_ticks(run["ticks"], start, clear)
    assert canned.card_problems(name, document, dict(run, ticks=ticks), cpu_view) == []

    def problems(edit):
        bad = json.loads(json.dumps(ticks))
        edit(bad)
        return canned.card_problems(name, document, dict(run, ticks=bad), cpu_view)

    def host_in_window(bad):
        bad[start + 2]["served"] = {"native:kernel_fault": 1}

    def untyped(bad):
        bad[start]["errors"] = ["boom"]

    def host_after(bad):
        bad[clear + 4]["served"] = {"python_ref:kernel_fault": 1}

    def late_error(bad):
        bad[-1]["errors"] = ["run_once crashed (internalError): the cuda rung's breaker "
                             "is open"]

    def launched(bad):
        bad[start + 1]["launches"] = {"ffd_scan_swar": 1}

    assert any("with the card's rungs faulted" in p for p in problems(host_in_window))
    assert any("untyped error boom" in p for p in problems(untyped))
    assert "a host rung served after the clear" in problems(host_after)
    assert any("past the breakers' cooldown" in p for p in problems(late_error))
    assert any("launched while faulted" in p for p in problems(launched))
