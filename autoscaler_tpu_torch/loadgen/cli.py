"""loadgen CLI.

    python -m autoscaler_tpu_torch.loadgen run spec.json --device=cpu
    python -m autoscaler_tpu_torch.loadgen run spec.json --report out.json --trace trace.json
    python -m autoscaler_tpu_torch.loadgen replay trace.json
    python -m autoscaler_tpu_torch.loadgen validate spec.json

``run`` executes a scenario and prints the score report (one JSON object)
to stdout; ``--log`` additionally writes the full per-tick decision log.
``--trace`` captures the resolved event timeline; ``replay`` re-executes a
captured trace (generators already expanded) against the same spec and must
reproduce the decision log byte-for-byte.

``--device`` picks where the loop runs (default: the first CUDA card, as
``python -m autoscaler_tpu_torch.main`` does; ``cpu`` for the host).
``--sanitize`` runs ``run`` or ``replay`` under the determinism sanitizer
(``analysis/sanitizer.py``) and exits 1 on any ambient read it traps.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from autoscaler_tpu_torch.loadgen.spec import ScenarioSpec, SpecError


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m autoscaler_tpu_torch.loadgen", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="execute a scenario spec")
    run.add_argument("scenario", help="path to a scenario JSON file")
    run.add_argument("--report", default="", help="write the score report here "
                     "(default: stdout only)")
    run.add_argument("--log", default="", help="write the per-tick decision log")
    run.add_argument("--trace", default="", help="write the resolved event trace")
    run.add_argument("--chrome-trace", default="",
                     help="write the run's tick span trees as a Chrome-"
                          "trace/Perfetto JSON (deterministic: two runs of "
                          "the same spec are byte-identical)")
    run.add_argument("--perf-ledger", default="",
                     help="write the run's per-tick perf records (compile "
                          "telemetry, cost model, residency) as JSONL "
                          "(deterministic: two runs of the same spec are "
                          "byte-identical)")
    run.add_argument("--explain-ledger", default="",
                     help="write the run's per-tick decision records "
                          "(constraint attribution, expander scoring "
                          "table, skip reasons) as JSONL (deterministic: "
                          "two runs of the same spec are byte-identical)")
    run.add_argument("--slo-ledger", default="",
                     help="write the run's per-tick SLO window records "
                          "(multi-window burn rates over the request-"
                          "lifecycle SLIs) as JSONL (deterministic: two "
                          "runs of the same spec are byte-identical)")
    run.add_argument("--journal", default="",
                     help="write the run's flight journal — per-tick "
                          "keyframe/delta state records — as JSONL "
                          "(deterministic: two runs of the same spec are "
                          "byte-identical; python -m autoscaler_tpu_torch.journal "
                          "reconstructs/diffs/replays it)")
    run.add_argument("--seed", type=int, default=None,
                     help="override the spec's seed")
    run.add_argument("--set", action="append", default=[], dest="overrides",
                     metavar="KEY=VALUE",
                     help="override one AutoscalingOptions field of the "
                          "spec (repeatable; VALUE parses as JSON, else "
                          "string) — e.g. --set arena_enabled=false runs "
                          "the same scenario on the cold-repack path for "
                          "the arena parity gate")
    run.add_argument("--real-sleep", action="store_true",
                     help="actually sleep injected provider latency")
    run.add_argument("--sanitize", action="store_true",
                     help="run under the determinism sanitizer "
                          "(analysis/sanitizer.py): trap ambient "
                          "wall-clock/rng/environment reads in replay-"
                          "scoped frames and exit 1 on any")
    run.add_argument("--device", default=None,
                     help="torch device of the loop (default: the first "
                          "CUDA card; 'cpu' for the host)")

    rep = sub.add_parser("replay", help="re-execute a captured trace")
    rep.add_argument("trace", help="path to a trace JSON file (from run --trace)")
    rep.add_argument("--report", default="")
    rep.add_argument("--log", default="")
    rep.add_argument("--chrome-trace", default="")
    rep.add_argument("--perf-ledger", default="")
    rep.add_argument("--explain-ledger", default="")
    rep.add_argument("--slo-ledger", default="")
    rep.add_argument("--journal", default="")
    rep.add_argument("--sanitize", action="store_true",
                     help="run under the determinism sanitizer (see run)")
    rep.add_argument("--device", default=None,
                     help="torch device of the loop (see run)")

    val = sub.add_parser("validate", help="parse + round-trip a scenario spec")
    val.add_argument("scenario")
    return p


def _write(path: str, doc) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def _run(spec: ScenarioSpec, report_path: str, log_path: str,
         trace_path: str = "", real_sleep: bool = False,
         chrome_trace_path: str = "", perf_ledger_path: str = "",
         explain_ledger_path: str = "", slo_ledger_path: str = "",
         journal_path: str = "", device=None) -> int:
    if spec.fleet is not None:
        if journal_path:
            # same loud failure as --explain-ledger: fleet drills run no
            # control loop, so there is no packed state to journal
            raise SpecError(
                "--journal is not supported for fleet scenarios (no "
                "control-loop state records)"
            )
        if explain_ledger_path:
            # fail loudly: the fleet drill produces no run_once decision
            # records, and exiting 0 without the requested file would
            # strand whatever reads it next
            raise SpecError(
                "--explain-ledger is not supported for fleet scenarios "
                "(no control-loop decision records); the fleet decision "
                "ledger is written by --log"
            )
        return _run_fleet(spec, report_path, log_path, trace_path,
                          chrome_trace_path, perf_ledger_path,
                          slo_ledger_path, device=device)
    from autoscaler_tpu_torch.loadgen.driver import run_scenario
    from autoscaler_tpu_torch.loadgen.score import ObjectiveWeights, build_report

    result = run_scenario(spec, real_sleep=real_sleep, device=device)
    # the objective weights ride the same override seam as every other
    # option (--set gym_objective_weights=cost=20): a report scored with
    # different weights than the tuning ledger would break the "humans
    # and the gym read the same number" contract
    weights = ObjectiveWeights.parse(
        spec.options.get("gym_objective_weights", "")
    )
    report = build_report(result, weights=weights)
    print(json.dumps(report, indent=2, sort_keys=True))
    if report_path:
        _write(report_path, report)
    if log_path:
        _write(log_path, result.decision_log())
    if trace_path:
        _write(trace_path, {"spec": spec.to_dict(), "events": result.trace})
    if chrome_trace_path and result.recorder is not None:
        # already byte-stable JSON (sorted keys, deterministic timeline):
        # written verbatim so two runs diff clean
        with open(chrome_trace_path, "w") as f:
            f.write(result.recorder.chrome() or "")
    if perf_ledger_path:
        # one sorted-key JSON line per tick — the byte-stable perf ledger
        # (two replays diff clean)
        with open(perf_ledger_path, "w") as f:
            f.write(result.perf_ledger_lines())
    if explain_ledger_path:
        # the byte-stable decision ledger (two replays diff clean)
        with open(explain_ledger_path, "w") as f:
            f.write(result.explain_ledger_lines())
    if slo_ledger_path:
        # the byte-stable SLO window ledger (two replays diff clean)
        with open(slo_ledger_path, "w") as f:
            f.write(result.slo_ledger_lines())
    if journal_path:
        # the byte-stable flight journal (two replays diff clean
        # then replays every tick against the decision ledger)
        with open(journal_path, "w") as f:
            f.write(result.journal_ledger_lines())
    return 0


def _run_fleet(spec: ScenarioSpec, report_path: str, log_path: str,
               trace_path: str = "", chrome_trace_path: str = "",
               perf_ledger_path: str = "", slo_ledger_path: str = "",
               device=None) -> int:
    """Fleet scenarios drive the coalescing estimator service; the decision
    log IS the fleet decision ledger (per-round verdict digests + parity
    bits — byte-identical across replays)."""
    from autoscaler_tpu_torch.loadgen.fleetdrive import run_fleet_scenario
    from autoscaler_tpu_torch.loadgen.score import build_fleet_report

    result = run_fleet_scenario(spec, device=device)
    report = build_fleet_report(result)
    print(json.dumps(report, indent=2, sort_keys=True))
    if report_path:
        _write(report_path, report)
    if log_path:
        # sorted-key JSONL, one line per round: the byte-stable fleet
        # decision ledger
        with open(log_path, "w") as f:
            f.write(result.decision_ledger_lines())
    if trace_path:
        from autoscaler_tpu_torch.loadgen.driver import _event_dict

        _write(trace_path, {"spec": spec.to_dict(),
                            "events": [_event_dict(e) for e in spec.events]})
    if chrome_trace_path and result.recorder is not None:
        with open(chrome_trace_path, "w") as f:
            f.write(result.recorder.chrome() or "")
    if perf_ledger_path:
        with open(perf_ledger_path, "w") as f:
            f.write(result.perf_ledger_lines())
    if slo_ledger_path:
        with open(slo_ledger_path, "w") as f:
            f.write(result.slo_ledger_lines())
    return 0 if result.all_match() else 1


def _sanitized(run_fn) -> int:
    """Execute ``run_fn`` under the runtime determinism sanitizer: any
    ambient wall-clock/rng/environment read trapped inside a replay-scoped
    frame fails the run with the attributed ``file:line`` report — the
    dynamic half of the GL010 contract."""
    from autoscaler_tpu_torch.analysis.sanitizer import DeterminismSanitizer

    with DeterminismSanitizer() as san:
        rc = run_fn()
    if san.events:
        print(
            "determinism sanitizer: ambient reads inside replay-scoped "
            "frames (each would make the replay unreproducible):",
            file=sys.stderr,
        )
        print(san.report(), file=sys.stderr)
        return 1
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    try:
        if args.command == "run":
            spec = ScenarioSpec.load(args.scenario)
            if args.seed is not None:
                spec.seed = args.seed
            for item in args.overrides:
                key, sep, raw = item.partition("=")
                if not sep or not key:
                    raise SpecError(f"--set wants KEY=VALUE, got {item!r}")
                try:
                    value = json.loads(raw)
                except json.JSONDecodeError:
                    value = raw
                # merged into the spec's options overrides: the driver
                # validates field names when it builds AutoscalingOptions
                spec.options[key] = value
            go = lambda: _run(spec, args.report, args.log, args.trace,
                              real_sleep=args.real_sleep,
                              chrome_trace_path=args.chrome_trace,
                              perf_ledger_path=args.perf_ledger,
                              explain_ledger_path=args.explain_ledger,
                              slo_ledger_path=args.slo_ledger,
                              journal_path=args.journal,
                              device=args.device)
            return _sanitized(go) if args.sanitize else go()
        if args.command == "replay":
            with open(args.trace) as f:
                doc = json.load(f)
            spec = ScenarioSpec.from_dict(doc["spec"])
            # the trace IS the timeline: generators were already expanded
            # when it was captured, so replay them as explicit events
            spec.workloads = []
            from autoscaler_tpu_torch.loadgen.spec import _load_event

            spec.events = [_load_event(e) for e in doc["events"]]
            go = lambda: _run(spec, args.report, args.log,
                              chrome_trace_path=args.chrome_trace,
                              perf_ledger_path=args.perf_ledger,
                              explain_ledger_path=args.explain_ledger,
                              slo_ledger_path=args.slo_ledger,
                              journal_path=args.journal,
                              device=args.device)
            return _sanitized(go) if args.sanitize else go()
        if args.command == "validate":
            with open(args.scenario) as f:
                doc = json.load(f)
            from autoscaler_tpu_torch.loadgen.suite import SuiteSpec, is_suite_doc

            if is_suite_doc(doc):
                # a gym tuning suite:
                # every member scenario must parse + round-trip like any
                # canned spec
                suite = SuiteSpec.from_dict(doc)
                roundtrip = SuiteSpec.from_dict(suite.to_dict())
                assert roundtrip.to_dict() == suite.to_dict(), \
                    "suite round-trip mismatch"
                print(f"ok: suite {suite.name} "
                      f"({len(suite.scenarios)} scenarios: "
                      f"{', '.join(suite.scenario_names())})")
                return 0
            spec = ScenarioSpec.from_dict(doc)
            roundtrip = ScenarioSpec.from_json(spec.to_json())
            assert roundtrip == spec, "round-trip mismatch"
            fleet_note = (
                f", {len(spec.fleet.tenants)} fleet tenants"
                if spec.fleet is not None else ""
            )
            print(f"ok: {spec.name} ({spec.ticks} ticks, "
                  f"{len(spec.node_groups)} groups, {len(spec.events)} events, "
                  f"{len(spec.workloads)} workloads, {len(spec.faults)} faults"
                  f"{fleet_note})")
            return 0
    except (SpecError, FileNotFoundError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 2
