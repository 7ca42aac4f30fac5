"""The static checker and its determinism sanitizer at full width:
chip_smoke's 4u, and the CPU tests' worlds.

    python3 -m autoscaler_tpu_torch.tools.analysis_probe                 # one card
    python3 -m autoscaler_tpu_torch.tools.analysis_probe --device cpu

Three parts:

- ``lint_tree``: graftlint (``autoscaler_tpu_torch.analysis``) over the
  port's whole tree with no baseline → its files, findings and seconds.
- ``ladder_replay``: the fault-ladder scenario (``fault_ladder_doc``, the
  JAX package's canned ``kernel_fault_ladder`` from ``tools/canned``, with a
  burst of pods of distinct sizes before the faults and after the clear,
  so the estimate takes K2 and not the dedup route) through the loadgen
  CLI: ``run --sanitize --trace``, then ``replay --sanitize`` and a plain
  ``replay`` of the trace. Neither sanitized pass may trap an ambient read
  (in a fresh process the run builds and loads K2 at first use under the
  sanitizer), and the replay's report and decision log must equal the
  run's, walls stripped.
- ``contract_worlds`` / ``ground_truth``: each kernel entry that declares
  a ``KERNEL_CONTRACTS`` contract (K1/K2 through ``ffd_binpack_groups_cuda``,
  ``ffd_binpack_scenarios_cuda``, ``ffd_scan_f32``, ``ffd_scan_swar``; K3
  through ``ffd_binpack_groups_affinity_cuda``; K4 ``fit_reduce_cuda``,
  its rows entry ``fit_reduce_rows``; K5 ``ordered_scatter_add``) on seeded
  small worlds, well-formed and perturbed (an axis off by one, a
  misaligned ``P_pad``, ``max_nodes`` 0). ``evaluate_contract``'s verdict
  on a world's shapes must equal whether the entry accepted it, and on a
  card every accepted launch must be bit-equal to the entry's plain
  version (the same entry on CPU copies of the operands).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np

from autoscaler_tpu_torch.device import resolve_device

PKG = Path(__file__).resolve().parent.parent
MIXED_PODS = 64          # pods of distinct sizes a burst (tools/drill_probe)
MIXED_TICKS = (1, 14)    # before the faults arm (tick 2), after the breaker closes


# -- the linter ---------------------------------------------------------------------


def lint_tree(path: str = str(PKG)) -> dict:
    """graftlint over ``path`` with no baseline (what ``python -m
    autoscaler_tpu_torch.analysis <path> --no-baseline`` reports)."""
    from autoscaler_tpu_torch.analysis import analyze_paths

    t0 = time.perf_counter()
    found, stats = analyze_paths([path])
    return {
        "files": stats.files,
        "findings": [f.render() for f in found],
        "suppressed": dict(sorted(stats.suppressed_by_rule.items())),
        "seconds": time.perf_counter() - t0,
    }


# -- the sanitized replay -------------------------------------------------------------


def fault_ladder_doc(mixed: bool = True) -> dict:
    """The JAX package's canned ``kernel_fault_ladder`` scenario
    (``tools/canned``): one pool, a steady stream of alike pods, the
    estimator's two device rungs faulted at tick 2 and cleared at tick 10
    (the rung names are the port's), and with ``mixed`` a burst of
    ``MIXED_PODS`` pods of distinct sizes at each of ``MIXED_TICKS``."""
    from autoscaler_tpu_torch.tools.canned import doc as canned_doc
    from autoscaler_tpu_torch.tools.drill_probe import mixed_burst

    doc = canned_doc("kernel_fault_ladder")
    if mixed:
        for k, tick in enumerate(MIXED_TICKS):
            doc["events"] += mixed_burst(tick, MIXED_PODS, prefix=f"mix{k}")
    return doc


def strip_walls(report: dict) -> dict:
    """A score report without what a rerun may change: the tick walls, the
    phases' seconds (their counts stay), the platform and the cost model's
    utilization."""
    out = {k: v for k, v in report.items() if k not in ("tick_wall_s", "platform")}
    if "function_duration" in out:
        out["function_duration"] = {
            phase: row["count"] for phase, row in out["function_duration"].items()}
    for row in out.get("perf", {}).get("routes", {}).values():
        row.pop("utilization", None)
    return out


def _cli(argv: List[str]):
    """``loadgen`` CLI in this process → (exit code, standard error, s)."""
    from autoscaler_tpu_torch.loadgen.cli import main

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue(), time.perf_counter() - t0


def ladder_replay(doc: dict, device=None, workdir: str = "") -> dict:
    """``run --sanitize --trace`` of ``doc``, then ``replay --sanitize`` and
    a plain ``replay`` of its trace, on ``device`` → {"rc": [run, sanitized
    replay, plain replay], "events" (the sanitizers' report lines),
    "equal" (the sanitized replay's report and log against the run's,
    walls stripped), "run_s", "sanitized_s", "replay_s", "sanitizer_s"
    (the sanitized replay less the plain one)}. In a fresh process the
    run builds and loads the kernels at first use (``ops/_build``) under
    the sanitizer."""
    dev = str(resolve_device(device))
    with tempfile.TemporaryDirectory(dir=workdir or None) as tmp:
        d = Path(tmp)
        (d / "spec.json").write_text(json.dumps(doc))
        out = {}
        common = ["--device", dev]
        rc_run, err_run, out["run_s"] = _cli([
            "run", str(d / "spec.json"), "--sanitize", "--trace", str(d / "trace.json"),
            "--report", str(d / "run.json"), "--log", str(d / "run_log.json"), *common])
        rc_san, err_san, out["sanitized_s"] = _cli([
            "replay", str(d / "trace.json"), "--sanitize", "--report", str(d / "san.json"),
            "--log", str(d / "san_log.json"), *common])
        rc_plain, _, out["replay_s"] = _cli(["replay", str(d / "trace.json"), "--report",
                                             str(d / "plain.json"), *common])
        out["rc"] = [rc_run, rc_san, rc_plain]
        out["events"] = [line for line in (err_run + err_san).splitlines()
                         if "during replay" in line]
        reports = {}
        for name in ("run", "san"):
            if (d / f"{name}.json").exists():
                reports[name] = (strip_walls(json.loads((d / f"{name}.json").read_text())),
                                 (d / f"{name}_log.json").read_text())
        out["equal"] = len(reports) == 2 and reports["run"] == reports["san"]
        out["ticks_with_errors"] = (reports.get("run", ({}, ""))[0]
                                    .get("decisions", {}).get("ticks_with_errors"))
    out["sanitizer_s"] = out["sanitized_s"] - out["replay_s"]
    return out


def replay_problems(out: dict) -> list:
    bad = []
    if out["rc"] != [0, 0, 0]:
        bad.append(f"exit codes {out['rc']} (run, sanitized replay, replay)")
    if out["events"]:
        bad.append(f"the sanitizer trapped {out['events']}")
    if not out["equal"]:
        bad.append("the sanitized replay's report or log differs from the run's")
    return bad


# -- the kernel contracts' ground truth ------------------------------------------------


class World(NamedTuple):
    entry: str        # the contracted entry's name
    label: str        # "well-formed" or the perturbation
    seed: int
    kwargs: dict      # the entry's arguments: numpy arrays and Python ints


# the perturbations each entry's worlds cycle through, after two well-formed
PERTURBATIONS = {
    "ffd_binpack_groups_cuda": ("P axis off", "R axis off", "max_nodes 0"),
    "ffd_binpack_scenarios_cuda": ("P axis off", "R axis off", "max_nodes 0"),
    "ffd_scan_f32": ("misaligned P_pad", "NP axis off", "G axis off", "max_nodes 0"),
    "ffd_scan_swar": ("misaligned P_pad", "NP axis off", "G axis off", "max_nodes 0"),
    "ffd_binpack_groups_affinity_cuda": ("P axis off", "R axis off", "T axis off",
                                         "max_nodes 0"),
    "fit_reduce_cuda": ("P axis off", "R axis off", "N axis off"),
    "fit_reduce_rows": ("S axis off", "R axis off", "N axis off"),
    "ordered_scatter_add": ("K axis off",),
}
ENTRY_MODULE = {
    "ffd_binpack_groups_cuda": "ffd_scan", "ffd_binpack_scenarios_cuda": "ffd_scan",
    "ffd_scan_f32": "ffd_scan", "ffd_scan_swar": "ffd_scan",
    "ffd_binpack_groups_affinity_cuda": "ffd_scan_affinity",
    "fit_reduce_cuda": "fit_reduce", "fit_reduce_rows": "fit_reduce",
    "ordered_scatter_add": "histogram",
}
# the kernel each entry launches, by its LAUNCHES name (K1/K2 by the route)
KERNEL_OF = {
    "ffd_binpack_groups_cuda": ("ffd_scan_swar", "ffd_scan_f32"),
    "ffd_binpack_scenarios_cuda": ("ffd_scan_swar", "ffd_scan_f32"),
    "ffd_scan_f32": ("ffd_scan_f32",), "ffd_scan_swar": ("ffd_scan_swar",),
    "ffd_binpack_groups_affinity_cuda": ("ffd_scan_aff",),
    "fit_reduce_cuda": ("fit_reduce",), "fit_reduce_rows": ("fit_reduce_rows",),
    "ordered_scatter_add": ("ordered_scatter_add",),
}


def _extra(a: np.ndarray, axis: int) -> np.ndarray:
    """``a`` with its ``axis`` one longer (the first slice repeated)."""
    return np.concatenate([a, np.take(a, [0], axis=axis)], axis=axis)


def _binpack_world(rng, P, G, R, integral: bool):
    req = rng.integers(1, 9, (P, R)).astype(np.float32) * 100
    if not integral:
        req[:, 0] += 0.5
    masks = rng.random((G, P)) < 0.8
    allocs = rng.integers(10, 20, (G, R)).astype(np.float32) * 100
    caps = rng.integers(2, 9, G).astype(np.int32)
    return req, masks, allocs, caps


def _world(entry: str, seed: int, label: str) -> dict:
    import torch

    rng = np.random.default_rng(1000 * seed + len(entry))
    P, G, R, M = int(rng.integers(20, 70)), int(rng.integers(2, 6)), 3, 16
    if entry == "ffd_binpack_groups_cuda":
        req, masks, allocs, caps = _binpack_world(rng, P, G, R, seed % 2 == 0)
        kw = dict(pod_req=req, pod_masks=masks, template_allocs=allocs, max_nodes=M,
                  node_caps=caps)
        if label == "P axis off":
            kw["pod_masks"] = _extra(masks, 1)
        elif label == "R axis off":
            kw["template_allocs"] = _extra(allocs, 1)
    elif entry == "ffd_binpack_scenarios_cuda":
        S = 3
        parts = [_binpack_world(rng, P, G, R, seed % 2 == 0) for _ in range(S)]
        req, masks, allocs, caps = (np.stack([p[i] for p in parts]) for i in range(4))
        kw = dict(scen_req=req, scen_masks=masks, scen_allocs=allocs, max_nodes=M,
                  scen_caps=caps)
        if label == "P axis off":
            kw["scen_masks"] = _extra(masks, 2)
        elif label == "R axis off":
            kw["scen_allocs"] = _extra(allocs, 2)
    elif entry in ("ffd_scan_f32", "ffd_scan_swar"):
        from autoscaler_tpu_torch.ops import ffd_scan

        req, masks, allocs, caps = _binpack_world(rng, P, G, R, entry == "ffd_scan_swar")
        ops = ffd_scan.prepare_scan(*(torch.tensor(a) for a in (req, masks, allocs)), M,
                                    torch.tensor(caps))
        assert (ops.plan is not None) == (entry == "ffd_scan_swar")
        kw = dict(stream=ops.stream.numpy(), allocs=ops.allocs.numpy(), caps=ops.caps.numpy(),
                  max_nodes=M)
        if entry == "ffd_scan_swar":
            kw["guards"] = ops.guards.numpy()
        if label == "misaligned P_pad":
            kw["stream"] = np.ascontiguousarray(kw["stream"][:, :-1])
        elif label == "NP axis off":
            kw["allocs"] = _extra(kw["allocs"], 1)
        elif label == "G axis off":
            kw["caps"] = _extra(kw["caps"], 0)
    elif entry == "ffd_binpack_groups_affinity_cuda":
        from autoscaler_tpu_torch.utils.workload import build_affinity_workload

        T = 2
        (req, masks, allocs, match, aff_of, anti_of, node_level,
         has_label) = build_affinity_workload(P, G, T, seed=seed)[:8]
        kw = dict(pod_req=req, pod_masks=masks, template_allocs=allocs, max_nodes=M,
                  match=match, aff_of=aff_of, anti_of=anti_of, node_level=node_level,
                  has_label=has_label, node_caps=np.full(G, M, np.int32))
        if label == "P axis off":
            kw["match"] = _extra(np.asarray(match), 1)
        elif label == "R axis off":
            kw["template_allocs"] = _extra(np.asarray(allocs), 1)
        elif label == "T axis off":
            kw["has_label"] = _extra(np.asarray(has_label), 1)
    elif entry == "fit_reduce_cuda":
        N, CP, CN = int(rng.integers(20, 90)), 4, 3
        kw = dict(pod_req=rng.integers(1, 9, (P, R)).astype(np.float32),
                  free=rng.integers(0, 12, (N, R)).astype(np.float32),
                  pod_class=rng.integers(-1, CP, P).astype(np.int32),
                  node_class=rng.integers(-1, CN, N).astype(np.int32),
                  class_mask=rng.random((CP, CN)) < 0.7,
                  node_valid=rng.random(N) < 0.9)
        if label == "P axis off":
            kw["pod_class"] = _extra(kw["pod_class"], 0)
        elif label == "R axis off":
            kw["free"] = _extra(kw["free"], 1)
        elif label == "N axis off":
            kw["node_valid"] = _extra(kw["node_valid"], 0)
    elif entry == "fit_reduce_rows":
        N = int(rng.integers(20, 90))
        slots = np.arange(P, dtype=np.int32)
        slots[rng.random(P) < 0.2] = -1
        kw = dict(pod_req=rng.integers(1, 9, (P, R)).astype(np.float32),
                  free=rng.integers(0, 12, (N, R)).astype(np.float32),
                  rows=rng.random((P, N)) < 0.6, slots=slots)
        if label == "S axis off":
            kw["slots"] = _extra(slots, 0)
        elif label == "R axis off":
            kw["free"] = _extra(kw["free"], 1)
        elif label == "N axis off":
            kw["rows"] = _extra(kw["rows"], 1)
    elif entry == "ordered_scatter_add":
        N, K = int(rng.integers(50, 200)), int(rng.integers(100, 2000))
        kw = dict(target=rng.random(N).astype(np.float32),
                  index=rng.integers(-2, N + 2, K).astype(np.int32 if seed % 2 else np.int64),
                  values=rng.random(K).astype(np.float32))
        if label == "K axis off":
            kw["values"] = _extra(kw["values"], 0)
    else:
        raise ValueError(f"no worlds for {entry}")
    if label == "max_nodes 0":
        kw["max_nodes"] = 0
    return kw


def contract_worlds(per_entry: int = 10) -> List[World]:
    """``per_entry`` seeded worlds of each contracted entry: two
    well-formed, then its perturbations in turn, then well-formed again."""
    out = []
    for entry, perturb in PERTURBATIONS.items():
        labels = ["well-formed", "well-formed", *perturb]
        for seed in range(per_entry):
            label = labels[seed] if seed < len(labels) else "well-formed"
            out.append(World(entry, label, seed, _world(entry, seed, label)))
    return out


def contracts() -> Dict[str, tuple]:
    """entry → (its contract, its module's int constants), read by AST."""
    from autoscaler_tpu_torch.analysis.contracts import load_module_contracts

    out = {}
    consts_of = {}
    for entry, module in ENTRY_MODULE.items():
        if module not in consts_of:
            consts_of[module] = load_module_contracts(str(PKG / "ops" / f"{module}.py"))
        declared, consts = consts_of[module]
        # STEP_BLOCK is imported, not defined, in the affinity module: the
        # checker resolves it the same way
        out[entry] = (declared[entry], {**consts_of.get("ffd_scan", ({}, {}))[1], **consts})
    return out


def verdict(world: World, table=None):
    """``evaluate_contract`` on the world's shapes and statics."""
    from autoscaler_tpu_torch.analysis.contracts import evaluate_contract

    contract, consts = (table or contracts())[world.entry]
    shapes = {k: v.shape for k, v in world.kwargs.items() if isinstance(v, np.ndarray)}
    statics = {k: v for k, v in world.kwargs.items() if isinstance(v, int)}
    return evaluate_contract(contract, shapes, statics, consts)


def _entry(name: str):
    import importlib

    return getattr(importlib.import_module(
        f"autoscaler_tpu_torch.ops.{ENTRY_MODULE[name]}"), name)


def run_world(world: World, device):
    """The entry on the world's operands on ``device`` → (accepted, its
    outputs as a tuple of tensors, or the error's text)."""
    import torch

    kw = {k: torch.tensor(v, device=device) if isinstance(v, np.ndarray) else v
          for k, v in world.kwargs.items()}
    try:
        out = _entry(world.entry)(**kw)
        out = (out,) if isinstance(out, torch.Tensor) else tuple(out)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return True, out
    except (ValueError, RuntimeError, IndexError, TypeError) as err:
        return False, f"{type(err).__name__}: {err}"


def ground_truth(worlds: List[World], device=None) -> List[dict]:
    """Each world's verdict against the entry's acceptance on ``device``;
    on a card each accepted launch against its plain version (the same
    entry on CPU copies) → one row a world."""
    import torch

    from autoscaler_tpu_torch.ops import ffd_scan, ffd_scan_affinity, fit_reduce, histogram

    dev = resolve_device(device)
    counters = (ffd_scan.LAUNCHES, ffd_scan_affinity.LAUNCHES, fit_reduce.LAUNCHES,
                histogram.LAUNCHES)
    table = contracts()
    rows = []
    for w in worlds:
        ok, reason = verdict(w, table)
        before = {k: v for d in counters for k, v in d.items()}
        accepted, out = run_world(w, dev)
        after = {k: v for d in counters for k, v in d.items()}
        row = {"entry": w.entry, "label": w.label, "seed": w.seed, "verdict": ok,
               "reason": reason, "accepted": accepted,
               "launched": sorted(k for k in after if after[k] != before[k])}
        if not accepted:
            row["error"] = out
        if accepted and dev.type == "cuda":
            _, plain = run_world(w, torch.device("cpu"))
            row["bit_equal"] = len(plain) == len(out) and all(
                a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.cpu(), b)
                for a, b in zip(out, plain))
        rows.append(row)
    return rows


def truth_problems(rows: List[dict]) -> list:
    bad = []
    for r in rows:
        where = f"{r['entry']} seed {r['seed']} ({r['label']})"
        if r["verdict"] != r["accepted"]:
            bad.append(f"{where}: contract {'accepts' if r['verdict'] else 'rejects'} "
                       f"({r['reason']}) but the entry {'ran' if r['accepted'] else 'refused'}"
                       f"{'' if r['accepted'] else ': ' + r['error']}")
        if r["accepted"] and r.get("bit_equal") is False:
            bad.append(f"{where}: the launch differs from the plain version")
        if r["label"] != "well-formed" and r["verdict"]:
            bad.append(f"{where}: a perturbed world was accepted")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the first card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    lint = lint_tree()
    print(f"# lint: {lint['files']} files, {len(lint['findings'])} findings, "
          f"{lint['seconds']:.3f} s host clock", flush=True)
    replay = ladder_replay(fault_ladder_doc(), dev)
    print(f"# sanitized replay: {json.dumps(replay, sort_keys=True)}", flush=True)
    rows = ground_truth(contract_worlds(), dev)
    by_entry: Dict[str, list] = {}
    for r in rows:
        by_entry.setdefault(r["entry"], []).append(int(r["accepted"]))
    print(f"# contracts: {len(rows)} worlds, accepted by entry {by_entry}", flush=True)
    bad = lint["findings"] + replay_problems(replay) + truth_problems(rows)
    for line in bad:
        print(f"# problem: {line}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
