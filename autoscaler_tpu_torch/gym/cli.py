"""gym CLI.

    python -m autoscaler_tpu_torch.gym tune suite.json --device=cpu \\
        --generations 4 --population 8 --ledger tune.jsonl
    python -m autoscaler_tpu_torch.gym replay suite.json --device=cpu \\
        --ledger tune.jsonl
    python -m autoscaler_tpu_torch.gym apply tune.jsonl
    python -m autoscaler_tpu_torch.gym validate tune.jsonl

``tune`` runs the population tuner over a suite and prints one summary
JSON object (winner policy, score trajectory, improvement over the
all-defaults baseline); ``--ledger`` writes the byte-stable tuning ledger
(one sorted-key JSON line per generation — two runs of the same tune are
byte-identical). ``replay`` re-runs a tune with the config recorded in an
existing ledger and byte-compares — exit 1 on any divergence (the
determinism gate). ``apply`` renders a ledger's winning PolicySpec as a
production flags snippet, a ``loadgen run --set`` snippet, and a
deploy/chart values.yaml fragment. ``validate`` checks a ledger's schema
and the improvement invariant without re-running anything.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.gym import ledger as gym_ledger
from autoscaler_tpu_torch.gym.policy import PolicyError, PolicySpec
from autoscaler_tpu_torch.loadgen.score import ObjectiveWeights
from autoscaler_tpu_torch.loadgen.suite import SuiteSpec
from autoscaler_tpu_torch.loadgen.spec import SpecError


def build_arg_parser() -> argparse.ArgumentParser:
    defaults = AutoscalingOptions()
    p = argparse.ArgumentParser(
        prog="python -m autoscaler_tpu_torch.gym", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="command", required=True)

    tune = sub.add_parser("tune", help="tune policies over a scenario suite")
    tune.add_argument("suite", help="path to a suite JSON "
                      "({\"name\": ..., \"scenarios\": [...]})")
    tune.add_argument("--generations", type=int, default=4)
    tune.add_argument("--population", type=int, default=8,
                      help="candidates sampled per generation (the "
                           "all-defaults control rides along in gen 0)")
    tune.add_argument("--seed", type=int, default=0,
                      help="tune seed: drives ALL candidate sampling "
                           "(scenario seeds come from the suite)")
    tune.add_argument("--ledger", default="",
                      help="write the tuning ledger here (JSONL, one "
                           "generation per line; byte-identical across "
                           "runs of the same tune)")
    tune.add_argument("--workers", type=int,
                      default=defaults.gym_rollout_workers,
                      help="concurrent candidate rollouts "
                           "(--gym-rollout-workers)")
    tune.add_argument("--weights", default=defaults.gym_objective_weights,
                      help='objective weights, "slo=1,cost=8,churn=0.25" '
                           "(--gym-objective-weights; empty = scorer "
                           "defaults)")
    tune.add_argument("--device", default=None,
                      help="torch device of the rollouts and the shared "
                           "coalescer (default: the first CUDA card; 'cpu' "
                           "for the host)")
    tune.add_argument("--no-fleet", action="store_true",
                      help="solo rollout dispatches (skip the shared fleet "
                           "coalescer; scores are identical either way — "
                           "this is the parity-test lane)")

    rep = sub.add_parser("replay", help="re-run a recorded tune and "
                         "byte-compare the ledgers")
    rep.add_argument("suite")
    rep.add_argument("--ledger", required=True,
                     help="the existing tuning ledger to reproduce")
    rep.add_argument("--device", default=None,
                     help="torch device of the rollouts (see tune)")

    app = sub.add_parser("apply", help="render a ledger's winning policy")
    app.add_argument("ledger")

    val = sub.add_parser("validate", help="validate a tuning ledger "
                         "(schema + improvement invariant)")
    val.add_argument("ledger")
    return p


def _options_for(args: argparse.Namespace) -> AutoscalingOptions:
    """The --gym-* flag surface, CLI-shaped: the same AutoscalingOptions
    fields main.py wires back a standalone tune."""
    return AutoscalingOptions(
        gym_rollout_workers=args.workers,
        gym_objective_weights=args.weights,
        gym_fleet_coalesce=not args.no_fleet,
    )


def _run_tune(args, ledger_path: str):
    from autoscaler_tpu_torch.gym.tune import TuneConfig, tune_suite

    suite = SuiteSpec.load(args.suite)
    config = TuneConfig.from_options(
        _options_for(args),
        generations=args.generations,
        population=args.population,
        seed=args.seed,
        device=args.device,
    )
    result = tune_suite(suite, config)
    if ledger_path:
        with open(ledger_path, "w") as f:
            f.write(result.ledger_lines())
    return result


def _tune(args) -> int:
    result = _run_tune(args, args.ledger)
    summary = gym_ledger.summarize(result.records)
    print(json.dumps({
        "metric": f"gym_tune_{result.suite}",
        "suite": result.suite,
        "seed": args.seed,
        **summary,
        "winner_flags": result.best_policy.render_flags(),
    }, indent=2, sort_keys=True))
    return 0


def _replay(args) -> int:
    from autoscaler_tpu_torch.gym.tune import TuneConfig, tune_suite
    from autoscaler_tpu_torch.loadgen.suite import SuiteSpec

    original = gym_ledger.load_jsonl(args.ledger)
    errors = gym_ledger.validate_records(original)
    if errors:
        print("ledger invalid before replay:", file=sys.stderr)
        for err in errors[:20]:
            print(f"  {err}", file=sys.stderr)
        return 2
    head = original[0]
    suite = SuiteSpec.load(args.suite)
    if suite.name != head["suite"] or suite.scenario_names() != head["scenarios"]:
        # a mismatched suite would re-tune different worlds and read as a
        # (false) determinism violation after burning a whole tune
        print(
            f"error: suite {suite.name!r} ({suite.scenario_names()}) does "
            f"not match the ledger's recorded suite {head['suite']!r} "
            f"({head['scenarios']})",
            file=sys.stderr,
        )
        return 2
    # the recorded weights pass through VERBATIM (a string re-encoding
    # would round them and replay a tune nobody ran)
    w = head["weights"]
    config = TuneConfig(
        generations=head["generations"],
        population=head["population"],
        seed=head["seed"],
        weights=ObjectiveWeights(
            w_slo=w["slo"], w_cost=w["cost"], w_churn=w["churn"]
        ),
        fleet_coalesce=head.get("fleet_coalesced", True),
        device=args.device,
    )
    result = tune_suite(suite, config)
    replayed = result.ledger_lines()
    original_text = "".join(
        gym_ledger.record_line(rec) for rec in original
    )
    if replayed != original_text:
        print(
            "ERROR: replayed tuning ledger diverges from the recorded one "
            "(determinism violation)",
            file=sys.stderr,
        )
        for i, (a, b) in enumerate(
            zip(original_text.splitlines(), replayed.splitlines())
        ):
            if a != b:
                print(f"  first divergence at line {i + 1}", file=sys.stderr)
                break
        return 1
    print(f"replay ok: {len(original)} generations byte-identical")
    return 0


def _apply(args) -> int:
    records = gym_ledger.load_jsonl(args.ledger)
    errors = gym_ledger.validate_records(records)
    if errors:
        print("ledger invalid:", file=sys.stderr)
        for err in errors[:20]:
            print(f"  {err}", file=sys.stderr)
        return 2
    winner = PolicySpec.from_dict(records[-1]["best_so_far"]["policy"])
    summary = gym_ledger.summarize(records)
    print(f"# winner of {args.ledger} "
          f"(score {summary['winner']['total']:g} vs baseline "
          f"{summary['baseline_total']:g})")
    print("# autoscaler flags:")
    print(winner.render_flags() or "# (all defaults)")
    print("# loadgen --set form:")
    print(winner.render_set_args() or "# (all defaults)")
    print("# deploy/chart values.yaml fragment:")
    print(winner.render_values_yaml(), end="")
    return 0


def _validate(args) -> int:
    records = gym_ledger.load_jsonl(args.ledger)
    errors = gym_ledger.validate_records(records)
    if errors:
        for err in errors[:20]:
            print(f"error: {err}", file=sys.stderr)
        return 1
    print(json.dumps(gym_ledger.summarize(records), indent=2, sort_keys=True))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    try:
        if args.command == "tune":
            return _tune(args)
        if args.command == "replay":
            return _replay(args)
        if args.command == "apply":
            return _apply(args)
        if args.command == "validate":
            return _validate(args)
    except (SpecError, PolicyError, ValueError, FileNotFoundError,
            json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 2
