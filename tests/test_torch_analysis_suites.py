"""The JAX package's other graftlint suites on the port's analysis package:
``tests/test_analysis_cfg.py``, ``tests/test_analysis_corpus.py`` (over the
read-only ``tests/analysis_corpus/``), ``tests/test_sanitizer.py`` and the
fast half of ``tests/test_contracts.py``.

- The CFG and sanitizer cases run on the port through
  ``torch_analysis_parity.AnalysisRebound``. The two sanitizer cases that
  read ``benchmarks/`` (slow-marked there) have twins here on the
  fault-ladder scenario built in code (``tools/analysis_probe``).
- Each corpus case runs with its sources and paths under the port's name;
  the two GL015 cases use JAX forms (``@jax.jit``, a tracer branch) and
  run as torch-form twins (``CORPUS_TWINS``, a captured step), which must
  give the same rule ids on the same lines as the fixture's
  ``gl-expect`` markers. The corpus suite's other cases run through
  ``AnalysisRebound`` with its case loader ported the same way.
- The contract suite's fast cases read the JAX package's Pallas contracts:
  their twins read the port's. Its slow ground truth (interpret-mode
  execution) has its twin in ``test_contract_verdict_matches_the_entry``:
  every contracted entry of the port on ``analysis_probe``'s seeded worlds,
  well-formed and perturbed, the verdict equal to the entry's acceptance
  on the CPU (on the card: chip_smoke's 4u).
"""
from __future__ import annotations

import json
import re
import textwrap
from pathlib import Path

import pytest

import test_analysis_cfg
import test_analysis_corpus
import test_sanitizer
from autoscaler_tpu_torch.analysis import analyze_sources
from autoscaler_tpu_torch.analysis.contracts import evaluate_contract, load_module_contracts
from autoscaler_tpu_torch.analysis.sanitizer import DeterminismSanitizer
from autoscaler_tpu_torch.tools import analysis_probe
from torch_analysis_parity import AnalysisRebound, case_params, port_text, run_case

REPO = Path(__file__).resolve().parent.parent
OPS = REPO / "autoscaler_tpu_torch" / "ops"

# -- the CFG -------------------------------------------------------------------------

CFG = AnalysisRebound(test_analysis_cfg)


@pytest.mark.parametrize("name", case_params(test_analysis_cfg))
def test_cfg_case_on_port(name, request):
    run_case(CFG, name, request)


# -- the runtime sanitizer ------------------------------------------------------------

SANITIZER_TWINNED = {
    "test_full_canned_replay_clean_and_subset_of_static",
    "test_loadgen_cli_sanitize_flag_clean_scenario",
}
SANITIZER = AnalysisRebound(test_sanitizer)


@pytest.mark.parametrize("name", case_params(test_sanitizer, SANITIZER_TWINNED))
def test_sanitizer_case_on_port(name, request):
    run_case(SANITIZER, name, request)


def test_twin_full_canned_replay_clean_and_subset_of_static():
    """The fault-ladder scenario (in code) replays clean under the port's
    sanitizer, and every event would sit in the port's static inventory."""
    from autoscaler_tpu_torch.analysis.dataflow import source_sites
    from autoscaler_tpu_torch.analysis.engine import FileModel
    from autoscaler_tpu_torch.loadgen.driver import run_scenario
    from autoscaler_tpu_torch.loadgen.score import build_report
    from autoscaler_tpu_torch.loadgen.spec import ScenarioSpec

    spec = ScenarioSpec.from_dict(analysis_probe.fault_ladder_doc())
    with DeterminismSanitizer() as san:
        result = run_scenario(spec, device="cpu")
        report = build_report(result)
    assert report["decisions"]["scale_up_events"] > 0
    assert san.events == [], san.report()
    pkg = REPO / "autoscaler_tpu_torch"
    models = [FileModel(str(f), f.read_text(encoding="utf-8"))
              for f in sorted(pkg.rglob("*.py")) if "__pycache__" not in f.parts]
    static_sites = {(s.path, s.line) for s in source_sites(models)}
    assert static_sites, "the port's static source inventory is empty"
    for e in san.events:
        assert (e.path, e.line) in static_sites


@pytest.mark.parametrize("command", ["run", "replay"])
def test_twin_loadgen_cli_sanitize_flag_clean_scenario(tmp_path, command):
    from autoscaler_tpu_torch.loadgen.cli import main as loadgen_main

    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(analysis_probe.fault_ladder_doc()))
    path = spec
    if command == "replay":
        path = tmp_path / "trace.json"
        assert loadgen_main(["run", str(spec), "--trace", str(path), "--device=cpu"]) == 0
    assert loadgen_main([command, str(path), "--sanitize", "--device=cpu"]) == 0


@pytest.mark.parametrize("command", ["run", "replay"])
def test_loadgen_cli_sanitize_exits_1_on_a_planted_read(tmp_path, command, monkeypatch,
                                                        capsys):
    """A wall-clock read planted in a replay-scoped frame of the loop turns
    ``--sanitize``'s clean exit into 1, with the read's file:line."""
    from autoscaler_tpu_torch.loadgen import driver
    from autoscaler_tpu_torch.loadgen.cli import main as loadgen_main

    ns = {"real": driver.run_scenario}
    exec(compile(textwrap.dedent("""
        import time


        def run_scenario(*args, **kwargs):
            time.time()
            return real(*args, **kwargs)
        """), "/x/autoscaler_tpu_torch/loadgen/planted.py", "exec"), ns)
    monkeypatch.setattr(driver, "run_scenario", ns["run_scenario"])
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(analysis_probe.fault_ladder_doc(mixed=False)))
    path = spec
    if command == "replay":
        path = tmp_path / "trace.json"
        assert loadgen_main(["run", str(spec), "--trace", str(path), "--device=cpu"]) == 0
    capsys.readouterr()
    assert loadgen_main([command, str(path), "--device=cpu"]) == 0
    assert loadgen_main([command, str(path), "--sanitize", "--device=cpu"]) == 1
    err = capsys.readouterr().err
    assert "autoscaler_tpu_torch/loadgen/planted.py:6: wall-clock time.time()" in err


def test_ladder_replay_clean_and_equal_on_the_cpu():
    """chip_smoke 4u's replay (analysis_probe.ladder_replay) on the CPU:
    every exit 0, no event, the sanitized replay equal to the run."""
    out = analysis_probe.ladder_replay(analysis_probe.fault_ladder_doc(), "cpu")
    assert analysis_probe.replay_problems(out) == []
    assert out["ticks_with_errors"] == 0  # off the card the faulted rungs descend


# -- the corpus ---------------------------------------------------------------------

# torch-form twins of the corpus cases written in JAX forms: a captured
# step's tensor branch and parameter loop, at the fixtures' own lines
CORPUS_TWINS = {
    "gl015_tracer_branch.py": """\
# corpus-path: autoscaler_tpu_torch/ops/gl015_tracer_branch.py
# corpus-rules: GL015
#
# Hazards inside a CUDA-graph-captured step: a Python `if` on a tensor and
# a Python loop whose trip count is a parameter both freeze at capture —
# every replay repeats the captured branch and count.
import torch
import torch.nn.functional as F


# recorded in capture() below
def clamp_score(x: torch.Tensor):
    if x > 0:  # gl-expect: GL015
        return x
    return -x


# recorded in capture() below
def accumulate(x, n):
    total = torch.zeros(())
    for _ in range(n):  # gl-expect: GL015
        total = total + x
    return total


def capture(graph, x):
    with torch.cuda.graph(graph):
        clamp_score(x)
        accumulate(x, 3)
""",
    "gl015_static_ok.py": """\
# corpus-path: autoscaler_tpu_torch/ops/gl015_static_ok.py
# corpus-rules: GL015
#
# The negative twin: branching on a host parameter is decided per call at
# capture (each call is its own recorded path), a tensor comparison routed
# through torch.where stays on the card, and a literal-bound Python loop
# records the same count on every capture. None of these freeze a value
# the replay would need to change — GL015 must stay silent.
from functools import partial

import torch
import torch.nn.functional as F


def scale(x, mode):
    if mode == "double":
        return x * 2
    return x


def clamp_score(x: torch.Tensor):
    return torch.where(x > 0, x, -x)


def triple_sum(x):
    total = torch.zeros(())
    for _ in range(3):
        total = total + torch.sum(x)
    return total


def capture(graph, x):
    graph.capture_begin()
    scale(x, "double")
    clamp_score(x)
    triple_sum(x)
    graph.capture_end()
""",
}


def _ported_case(entry: Path):
    """A corpus case's (sources, rules, expected) under the port's name;
    a JAX-form case is replaced by its torch-form twin."""
    if entry.name in CORPUS_TWINS:
        text = CORPUS_TWINS[entry.name]
        vpath = re.search(r"#\s*corpus-path:\s*(\S+)", text).group(1)
        rules = set(re.findall(r"GL\d{3}", re.search(r"corpus-rules:(.*)", text).group(1)))
        expected = {(vpath, n, m.group(1)) for n, line in enumerate(text.splitlines(), 1)
                    if (m := re.search(r"#\s*gl-expect:\s*(GL\d{3})", line))}
        return {vpath: text}, rules, expected
    sources, rules, expected = test_analysis_corpus._load_case(entry)
    return ({port_text(p): port_text(s) for p, s in sources.items()}, rules,
            {(port_text(p), n, r) for p, n, r in expected})


CORPUS_CASES = [c.name for c in test_analysis_corpus._cases()]


@pytest.mark.parametrize("case", CORPUS_CASES, ids=CORPUS_CASES)
def test_corpus_case_on_port(case):
    sources, rules, expected = _ported_case(test_analysis_corpus.CORPUS / case)
    found, _ = analyze_sources(sources)
    got = {(f.path, f.line, f.rule) for f in found if f.rule in rules}
    assert got == expected, f"{case}: expected {sorted(expected)}, got {sorted(got)}"


@pytest.mark.parametrize("case", sorted(CORPUS_TWINS))
def test_corpus_twin_expects_the_fixtures_lines(case):
    """Each torch-form twin expects its rule ids on the JAX fixture's lines."""
    _, _, want = test_analysis_corpus._load_case(test_analysis_corpus.CORPUS / case)
    _, _, got = _ported_case(test_analysis_corpus.CORPUS / case)
    assert sorted((n, r) for _, n, r in got) == sorted((n, r) for _, n, r in want)


CORPUS = AnalysisRebound(test_analysis_corpus)
CORPUS.globals["_load_case"] = _ported_case


@pytest.mark.parametrize("name", case_params(test_analysis_corpus, {"test_corpus_case"}))
def test_corpus_suite_case_on_port(name, request):
    run_case(CORPUS, name, request)


# -- the kernel contracts --------------------------------------------------------------

FS_CONTRACTS, FS_CONSTS = load_module_contracts(str(OPS / "ffd_scan.py"))


def test_twin_verdict_rejects_misaligned_chunk():
    """The port's statics carry no tile (the kernels stage STEP_BLOCK steps
    in csrc): the misaligned axis is the padded pod axis of K1's stream."""
    ok, reason = evaluate_contract(
        FS_CONTRACTS["ffd_scan_f32"],
        {"stream": (3, 48, 4), "allocs": (3, 4), "caps": (3,)},
        {"max_nodes": 8}, FS_CONSTS)
    assert not ok and "48" in reason and "32" in reason


def test_twin_verdict_rejects_symbol_conflict():
    ok, reason = evaluate_contract(
        FS_CONTRACTS["ffd_binpack_groups_cuda"],
        {"pod_req": (10, 4), "pod_masks": (3, 11), "template_allocs": (3, 4)},
        {}, FS_CONSTS)
    assert not ok and "P" in reason


def test_twin_verdict_accepts_wellformed():
    ok, reason = evaluate_contract(
        FS_CONTRACTS["ffd_binpack_groups_cuda"],
        {"pod_req": (10, 4), "pod_masks": (3, 10), "template_allocs": (3, 4),
         "node_caps": (3,)},
        {"max_nodes": 8}, FS_CONSTS)
    assert ok, reason
    ok, reason = evaluate_contract(FS_CONTRACTS["ffd_binpack_groups_cuda"], {},
                                   {"max_nodes": 0}, FS_CONSTS)
    assert not ok and "max_nodes=0" in reason


def test_twin_every_ops_kernel_entry_declares_a_contract():
    names = set()
    for module in ("binpack", "preempt", "ffd_scan", "ffd_scan_affinity", "fit_reduce",
                   "histogram", "arena_apply"):
        names |= set(load_module_contracts(str(OPS / f"{module}.py"))[0])
    assert {
        "ffd_binpack", "ffd_binpack_groups", "ffd_binpack_groups_runs",
        "ffd_binpack_groups_runs_affinity", "ffd_binpack_groups_affinity",
        "ffd_binpack_preempt", "ffd_binpack_groups_cuda", "ffd_binpack_scenarios_cuda",
        "ffd_scan_f32", "ffd_scan_swar", "ffd_binpack_groups_affinity_cuda",
        "fit_reduce_cuda", "fit_reduce_rows", "ordered_scatter_add",
    } <= names
    assert set(analysis_probe.ENTRY_MODULE) <= names


WORLDS = analysis_probe.contract_worlds()


@pytest.mark.parametrize("entry", sorted(analysis_probe.PERTURBATIONS))
def test_contract_verdict_matches_the_entry(entry):
    """The contract's verdict on each seeded world's shapes equals the
    entry's own acceptance on the CPU, well-formed and perturbed (the shape
    checks run before the device branch, so the card takes the same)."""
    worlds = [w for w in WORLDS if w.entry == entry]
    rows = analysis_probe.ground_truth(worlds, "cpu")
    assert analysis_probe.truth_problems(rows) == []
    assert sum(r["accepted"] for r in rows) >= 2
    assert sum(not r["accepted"] for r in rows) == len(analysis_probe.PERTURBATIONS[entry])
    assert not any(r["launched"] for r in rows)  # the CPU runs the plain versions
