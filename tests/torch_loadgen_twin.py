"""Twin runs of the scenario engine: one scenario document through both
packages' drivers on the CPU, and what each writes — decision log, score
report, explain, SLO, journal and perf ledgers — the JAX package's under
the name map (``torch_parity.NAME_MAP``).

What the comparison leaves out, and why:

- the wall fields (``tick_wall_s``, ``round_wall_s`` of the reports, the
  per-tenant latency walls of a fleet report, the seconds of each phase in
  ``function_duration``, whose counts stay): host time;
- each journal line's ``explain_sha256``: it pins a decision line that
  differs between the packages exactly by the rung names;
- each perf dispatch's ``cost`` and ``utilization``, and the utilization
  of a report's perf routes: the port's cost model is its own (no XLA
  compile to ask; ``perf/costmodel.py``).
"""
import json
import os

import autoscaler_tpu.loadgen.driver as jdriver
import autoscaler_tpu.loadgen.fleetdrive as jfleetdrive
import autoscaler_tpu.loadgen.score as jscore
import autoscaler_tpu.loadgen.spec as jspec
import autoscaler_tpu_torch.loadgen.driver as tdriver
import autoscaler_tpu_torch.loadgen.fleetdrive as tfleetdrive
import autoscaler_tpu_torch.loadgen.score as tscore
import autoscaler_tpu_torch.loadgen.spec as tspec
from torch_parity import NAME_MAP, port_label

WALL_KEYS = ("tick_wall_s", "round_wall_s")


def rename(value, key=""):
    """A JAX package record with its rung, route and reason labels under
    the name map: lists under ``degraded``/``degraded_rungs``, the values of
    ``rung``/``route``/``reason`` keys, and ``k=v/k=v`` label keys."""
    if isinstance(value, dict):
        return {label_key(k): rename(v, k) for k, v in value.items()}
    if isinstance(value, list):
        if key in ("degraded", "degraded_rungs"):
            return [port_label("rung", r) for r in value]
        return [rename(v, key) for v in value]
    if isinstance(value, str) and key in NAME_MAP:
        return port_label(key, value)
    return value


def label_key(key: str) -> str:
    """``reason=dedup/route=xla_runs`` → the port's labels; route names as
    keys (a report's perf routes) too."""
    if "=" in key:
        return "/".join(
            f"{k}={port_label(k, v)}" for k, v in (part.split("=", 1) for part in key.split("/"))
        )
    return port_label("route", key)


def strip_walls(report: dict) -> dict:
    out = {k: v for k, v in report.items() if k not in WALL_KEYS}
    if "function_duration" in out:
        out["function_duration"] = {
            phase: row["count"] for phase, row in out["function_duration"].items()}
    perf = out.get("perf")
    if isinstance(perf, dict) and "routes" in perf:
        out["perf"] = dict(perf, routes={
            route: {k: v for k, v in row.items() if k != "utilization"}
            for route, row in perf["routes"].items()})
    fleet = out.get("fleet")
    if isinstance(fleet, dict):
        out["fleet"] = {k: v for k, v in fleet.items() if k != "per_tenant_latency_s"}
    return out


def perf_lines(text: str) -> list:
    out = []
    for line in text.splitlines():
        rec = json.loads(line)
        for d in rec.get("dispatches", []):
            d.pop("cost", None)
            d.pop("utilization", None)
        out.append(rec)
    return out


def journal_lines(text: str) -> list:
    return [{k: v for k, v in json.loads(line).items() if k != "explain_sha256"}
            for line in text.splitlines()]


def jsonl(text: str) -> list:
    return [json.loads(line) for line in text.splitlines()]


def jax_doc(doc: dict) -> dict:
    """A copy of ``doc`` for the JAX package: the port's rung names, where
    a fault names one, read back as the JAX package's (the port's spec
    takes either)."""
    back = {v: k for k, v in NAME_MAP["rung"].items()}

    def walk(value, key=""):
        if isinstance(value, dict):
            return {k: walk(v, k) for k, v in value.items()}
        if isinstance(value, list):
            return [walk(v) for v in value]
        return back.get(value, value) if key == "rung" else value

    return walk(json.loads(json.dumps(doc)))


def run_both(doc: dict, **kw):
    """The scenario ``doc`` through both drivers → (jax result, port result)."""
    jres = jdriver.run_scenario(jspec.ScenarioSpec.from_dict(jax_doc(doc)), **kw)
    tres = tdriver.run_scenario(tspec.ScenarioSpec.from_dict(json.loads(json.dumps(doc))),
                                device="cpu", **kw)
    return jres, tres


def views(jres, tres, weights=None) -> dict:
    """{artifact: (jax's under the name map, the port's)}."""
    jw = jscore.ObjectiveWeights.parse(weights or "")
    tw = tscore.ObjectiveWeights.parse(weights or "")
    return {
        "decision_log": (json.dumps(rename(jres.decision_log()), sort_keys=True),
                         json.dumps(tres.decision_log(), sort_keys=True)),
        "report": (strip_walls(rename(jscore.build_report(jres, jw))),
                   strip_walls(tscore.build_report(tres, tw))),
        "explain": (rename(jsonl(jres.explain_ledger_lines())), jsonl(tres.explain_ledger_lines())),
        "slo": (jres.slo_ledger_lines(), tres.slo_ledger_lines()),
        "journal": (journal_lines(jres.journal_ledger_lines()),
                    journal_lines(tres.journal_ledger_lines())),
        "perf": (rename(perf_lines(jres.perf_ledger_lines())), perf_lines(tres.perf_ledger_lines())),
        "trace": (rename(jres.trace), tres.trace),
        "injected": (jres.injected_faults, tres.injected_faults),
        "latency": (jres.pod_latency, tres.pod_latency),
    }


def differing(jres, tres, weights=None) -> list:
    return sorted(k for k, (a, b) in views(jres, tres, weights).items() if a != b)


def assert_twin(doc: dict, **kw):
    """Run ``doc`` through both packages and hold every artifact equal →
    (jax result, port result)."""
    jres, tres = run_both(doc, **kw)
    diff = differing(jres, tres)
    assert not diff, f"{doc['name']}: {diff} differ"
    return jres, tres


def run_fleet_both(doc: dict):
    """The fleet scenario ``doc`` through both drivers → (jax result, port
    result). The JAX package's coalescer serves on a mesh of one device,
    as the port's does (its default mesh spans every device, eight host
    devices under the test suite's settings)."""
    import jax

    import autoscaler_tpu.parallel.mesh as jmesh

    make_mesh = jmesh.make_mesh
    jmesh.make_mesh = lambda devices=None: make_mesh(
        jax.devices()[:1] if devices is None else devices)
    try:
        jres = jfleetdrive.run_fleet_scenario(jspec.ScenarioSpec.from_dict(jax_doc(doc)))
    finally:
        jmesh.make_mesh = make_mesh
    tres = tfleetdrive.run_fleet_scenario(
        tspec.ScenarioSpec.from_dict(json.loads(json.dumps(doc))), device="cpu")
    return jres, tres


def fleet_views(jres, tres) -> dict:
    return {
        "decision_ledger": (rename(jsonl(jres.decision_ledger_lines())),
                            jsonl(tres.decision_ledger_lines())),
        "report": (strip_walls(rename(jscore.build_fleet_report(jres))),
                   strip_walls(tscore.build_fleet_report(tres))),
        "slo": (jres.slo_ledger_lines(), tres.slo_ledger_lines()),
        "perf": (rename(perf_lines(jres.perf_ledger_lines())), perf_lines(tres.perf_ledger_lines())),
        "injected": (jres.injected_faults, tres.injected_faults),
        "all_match": (jres.all_match(), tres.all_match()),
        "unresolved": (jres.unresolved, tres.unresolved),
        "admission": (jres.admission, tres.admission),
    }


# -- the canned scenarios (autoscaler_tpu_torch/tools/canned) -------------------------

PLAIN_ARTIFACTS = ("decision_log", "report", "explain", "slo", "journal", "perf", "trace",
                   "injected", "latency")
FLEET_ARTIFACTS = ("decision_ledger", "report", "slo", "perf", "injected", "all_match",
                   "unresolved", "admission")


class CannedTwins:
    """Each canned scenario (``canned.scenario_docs``: the fourteen, and the
    gym suite's five as plain scenarios) through both packages' drivers
    once, at its first use → (jax result, port result), and their views
    (``views``, ``fleet_views``)."""

    def __init__(self):
        from autoscaler_tpu_torch.tools import canned

        self.docs = dict(canned.scenario_docs())
        self.runs, self._views = {}, {}

    def is_fleet(self, name: str) -> bool:
        return "fleet" in self.docs[name]

    def __getitem__(self, name: str):
        if name not in self.runs:
            run = run_fleet_both if self.is_fleet(name) else run_both
            self.runs[name] = run(self.docs[name])
        return self.runs[name]

    def views(self, name: str) -> dict:
        if name not in self._views:
            jres, tres = self[name]
            self._views[name] = (fleet_views if self.is_fleet(name) else views)(jres, tres)
        return self._views[name]

    def port_again(self, name: str, **options):
        """Another run of ``name`` on the port alone, its options updated
        with ``options``."""
        doc = json.loads(json.dumps(self.docs[name]))
        doc.setdefault("options", {}).update(options)
        spec = tspec.ScenarioSpec.from_dict(doc)
        if self.is_fleet(name):
            return tfleetdrive.run_fleet_scenario(spec, device="cpu")
        return tdriver.run_scenario(spec, device="cpu")


def artifact_cases(names) -> list:
    """(scenario, artifact) for each of ``names`` and each artifact its
    twin views compare."""
    from autoscaler_tpu_torch.tools import canned

    return [(n, a) for n in names
            for a in (FLEET_ARTIFACTS if n in canned.FLEET else PLAIN_ARTIFACTS)]


def one_torch_thread():
    """A module fixture's body: torch on one intra-op thread while the
    module runs, then as it was. The canned runs are small and the test
    workers share the host's cores; each worker's torch spinning a thread
    a core slows them tens of times. Results do not depend on it."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def write_canned(directory) -> None:
    """The canned documents where the JAX package's tests read them:
    ``<directory>/benchmarks/scenarios/<name>.json``."""
    from autoscaler_tpu_torch.tools import canned

    canned.write_all(os.path.join(str(directory), "benchmarks", "scenarios"))


def port_on_cpu(monkeypatch) -> None:
    """Point every loaded port module's ``resolve_device`` at the CPU (the
    port's entry points default to the first card, which a CPU host does
    not have)."""
    import sys

    import torch

    from autoscaler_tpu_torch import device

    def cpu(dev=None):
        return torch.device("cpu") if dev is None else torch.device(dev)

    real = device.resolve_device
    for name, mod in list(sys.modules.items()):
        if (name == "autoscaler_tpu_torch" or name.startswith("autoscaler_tpu_torch.")) and \
                getattr(mod, "resolve_device", None) is real:
            monkeypatch.setattr(mod, "resolve_device", cpu)
