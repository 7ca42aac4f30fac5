"""Tuning ledger: one sorted-key JSON line per tuner generation.

The port's copy of ``autoscaler_tpu/gym/ledger.py``: schema
``autoscaler_tpu.gym.generation/1``, the same as the JAX package's, so the
two packages' ledgers compare byte for byte. Every value in a record is a
pure function of (suite, tune seed, weights): candidate policies come from
the seeded PolicyRng, scores from deterministic rollouts — so two runs of
the same tune write byte-identical JSONL files, and ``validate_records``
machine-checks the schema plus the improvement invariant: ``best_so_far``
(the score column is a reward — higher is better) never decreases across
generations, and the final winner strictly beats the recorded
all-defaults baseline.

``record_line`` serializes STRICTLY (same contract as the explain ledger):
a non-JSON value leaking in fails at the writer, not as a silently quoted
string that passes the byte-diff gate with the wrong type.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List

from autoscaler_tpu_torch.gym.policy import PolicyError, PolicySpec

SCHEMA = "autoscaler_tpu.gym.generation/1"

# the machine-readable field contract: change the
# field set → update this AND bump the version tag above
SCHEMA_FIELDS = {
    SCHEMA: {
        "required": (
            "suite",
            "generation",
            "generations",
            "seed",
            "population",
            "weights",
            "scenarios",
            "fleet_coalesced",
            "candidates",
            "pruned",
            "best",
            "best_so_far",
        ),
        "optional": (),
    },
}

# the reserved candidate id of the all-defaults control: evaluated on the
# FULL suite in generation 0, never pruned — the improvement gate's
# denominator
BASELINE_ID = "defaults"


def stable_json(doc: Any) -> str:
    """Byte-stable one-line JSON (sorted keys, tight separators)."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def record_line(rec: Dict[str, Any]) -> str:
    """One ledger line (newline-terminated) for one generation record."""
    return stable_json(rec) + "\n"


def dump_jsonl(records: Iterable[Dict[str, Any]], path: str) -> int:
    n = 0
    with open(path, "w") as f:
        for rec in records:
            f.write(record_line(rec))
            n += 1
    return n


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    records: List[Dict[str, Any]] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from None
    return records


def _num(value: Any) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def _check_candidate(
    i: int, j: int, cand: Any, scenario_names: List[str], errors: List[str]
) -> None:
    where = f"record {i} candidate {j}"
    if not isinstance(cand, dict):
        errors.append(f"{where}: not an object")
        return
    cid = cand.get("id")
    if not isinstance(cid, str) or not cid:
        errors.append(f"{where}: missing/empty id")
    policy = cand.get("policy")
    if not isinstance(policy, dict):
        errors.append(f"{where}: policy must be an object")
    else:
        try:
            PolicySpec.from_dict(policy)
        except PolicyError as e:
            errors.append(f"{where}: policy outside the knob space: {e}")
    scores = cand.get("scores")
    if not isinstance(scores, dict):
        errors.append(f"{where}: scores must map scenario -> score")
        return
    for scen, val in scores.items():
        if scen not in scenario_names:
            errors.append(f"{where}: score for unknown scenario {scen!r}")
        if not _num(val):
            errors.append(f"{where}: score for {scen!r} is not a number")
    eliminated = cand.get("eliminated_after")
    if eliminated is not None and eliminated not in scenario_names:
        errors.append(
            f"{where}: eliminated_after names unknown scenario {eliminated!r}"
        )
    total = cand.get("total")
    if eliminated is None:
        # a full-suite candidate must carry every scenario score and the
        # comparable total
        missing = [s for s in scenario_names if s not in scores]
        if missing:
            errors.append(f"{where}: surviving candidate missing {missing}")
        if not _num(total):
            errors.append(f"{where}: surviving candidate needs a numeric total")
    elif total is not None:
        errors.append(
            f"{where}: eliminated candidate must not carry a total "
            "(partial scores are not comparable)"
        )


def validate_records(records: Iterable[Any]) -> List[str]:
    """→ error strings ([] = valid). Checks the schema, generation
    monotonicity, candidate/score shapes, that generation 0 carries the
    all-defaults baseline on the full suite, that each record's ``best``
    is the max over its surviving candidates, and the improvement
    invariant (best_so_far non-decreasing)."""
    errors: List[str] = []
    prev_gen = -1
    prev_best = None
    config_keys = None
    declared_generations = None
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            errors.append(f"record {i}: not an object")
            continue
        if rec.get("schema") != SCHEMA:
            errors.append(
                f"record {i}: schema {rec.get('schema')!r} != {SCHEMA!r}"
            )
            continue
        gen = rec.get("generation")
        if not isinstance(gen, int) or gen != prev_gen + 1:
            errors.append(
                f"record {i}: generation {gen!r} not monotonic "
                f"(expected {prev_gen + 1})"
            )
        prev_gen = gen if isinstance(gen, int) else prev_gen + 1
        if not isinstance(rec.get("suite"), str) or not rec.get("suite"):
            errors.append(f"record {i}: missing suite name")
        if not isinstance(rec.get("fleet_coalesced"), bool):
            errors.append(f"record {i}: fleet_coalesced must be a bool")
        scen = rec.get("scenarios")
        if not isinstance(scen, list) or not scen:
            errors.append(f"record {i}: scenarios must be a non-empty list")
            continue
        key = (
            tuple(scen), rec.get("seed"), rec.get("population"),
            rec.get("generations"), stable_json(rec.get("weights")),
        )
        if config_keys is None:
            config_keys = key
        elif key != config_keys:
            errors.append(
                f"record {i}: tune config drifted mid-ledger (seed/"
                "population/scenarios/weights must be constant)"
            )
        cands = rec.get("candidates")
        if not isinstance(cands, list) or not cands:
            errors.append(f"record {i}: candidates must be a non-empty list")
            continue
        for j, cand in enumerate(cands):
            _check_candidate(i, j, cand, list(scen), errors)
        pruned = rec.get("pruned")
        eliminated = sum(
            1
            for c in cands
            if isinstance(c, dict) and c.get("eliminated_after") is not None
        )
        if not isinstance(pruned, int) or pruned < 0:
            errors.append(f"record {i}: pruned must be a non-negative int")
        elif pruned != eliminated:
            errors.append(
                f"record {i}: pruned={pruned} disagrees with the "
                f"{eliminated} candidates carrying eliminated_after"
            )
        if i == 0 and not any(
            isinstance(c, dict) and c.get("id") == BASELINE_ID for c in cands
        ):
            errors.append(
                f"record 0: no {BASELINE_ID!r} baseline candidate — the "
                "improvement gate has no denominator"
            )
        totals = [
            c["total"] for c in cands
            if isinstance(c, dict) and _num(c.get("total"))
        ]
        best = rec.get("best")
        if not isinstance(best, dict) or not _num(best.get("total")):
            errors.append(f"record {i}: best must carry a numeric total")
        elif totals and best["total"] != max(totals):
            errors.append(
                f"record {i}: best.total {best['total']} != max candidate "
                f"total {max(totals)}"
            )
        bsf = rec.get("best_so_far")
        if not isinstance(bsf, dict) or not _num(bsf.get("total")):
            errors.append(f"record {i}: best_so_far must carry a numeric total")
            continue
        if not isinstance(bsf.get("policy"), dict):
            errors.append(f"record {i}: best_so_far must carry its policy")
        if prev_best is not None and bsf["total"] < prev_best:
            errors.append(
                f"record {i}: improvement invariant violated — best_so_far "
                f"{bsf['total']} < previous {prev_best}"
            )
        prev_best = bsf["total"]
        declared = rec.get("generations")
        if declared_generations is None and isinstance(declared, int):
            declared_generations = declared
    if prev_gen < 0:
        errors.append("empty ledger")
    elif declared_generations is not None and prev_gen + 1 != declared_generations:
        # a truncated (or over-long) ledger must not validate clean: its
        # mid-tune best would masquerade as the winner, and a replay
        # would read as a false determinism violation
        errors.append(
            f"ledger holds {prev_gen + 1} generation records but the "
            f"tune config declares {declared_generations} (truncated?)"
        )
    return errors


def summarize(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a VALID ledger: the winner, the per-generation best
    trajectory, and the improvement over the all-defaults baseline (the
    number a determinism gate reads)."""
    baseline_total = None
    for cand in records[0].get("candidates", []):
        if cand.get("id") == BASELINE_ID and _num(cand.get("total")):
            baseline_total = cand["total"]
    trajectory = [rec["best_so_far"]["total"] for rec in records]
    final = records[-1]["best_so_far"]
    rollouts = sum(
        len(c.get("scores", {})) for rec in records
        for c in rec.get("candidates", [])
    )
    out: Dict[str, Any] = {
        "generations": len(records),
        "scenarios": records[0]["scenarios"],
        "rollouts": rollouts,
        "best_trajectory": trajectory,
        "winner": final,
        "baseline_total": baseline_total,
    }
    if baseline_total is not None:
        out["improvement"] = round(final["total"] - baseline_total, 6)
        out["beats_baseline"] = final["total"] > baseline_total
    return out
