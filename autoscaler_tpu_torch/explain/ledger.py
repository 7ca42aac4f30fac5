"""Decision-ledger serialization and schema validation.

One ledger line per control-loop tick: the tick's DecisionRecord (pending
split, per-group estimator verdicts with rejection reasons, the expander
scoring table, skip/backoff/breaker state, the executed plan, scale-down
reasons) serialized as sorted-key JSON. Every value is a pure function of
the tick's decisions and the closed reason vocabularies (reasons.py), so
two loadgen replays of one scenario write byte-identical JSONL files
(hack/verify.sh diffs them).

``validate_records`` is the machine-checked gate behind
``bench.py --explain-ledger``: beyond shape checks it enforces the two
provenance invariants the subsystem exists for —

- every tick that executed a scale-up carries the winning expander choice
  AND its recorded score (a plan with no recorded why is a regression);
- every pod reported still-pending after the scale-up decision carries a
  reason from the closed vocabulary (an unexplained pending pod means the
  attribution path silently dropped it).

The port's copy of ``autoscaler_tpu/explain/ledger.py``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List

from autoscaler_tpu_torch.explain.reasons import (
    EVICTION_REASONS,
    LEDGER_POD_REASONS,
    REASON_EXPENDABLE_BELOW_CUTOFF,
    SKIP_REASON_VALUES,
)

# /2: the preemption section (admitted pending pods + eviction rows, every
# row naming its evictor) and the expendable_below_cutoff pod reason —
# formerly-silent drops now carry ledger lines outside the
# remain_unschedulable count
SCHEMA = "autoscaler_tpu.explain.decision/2"

# the machine-readable field contract (graftlint GL017): change the
# field set → update this AND bump the version tag above. The producer
# (DecisionExplainer) attaches sections dynamically, so required stays
# minimal and every attachable section is declared optional.
SCHEMA_FIELDS = {
    SCHEMA: {
        "required": ("tick", "now_ts"),
        "optional": (
            "skipped_groups",
            "pods",
            "scale_up",
            "expander",
            "preemption",
            "estimator",
        ),
    },
}


def stable_json(doc: Any) -> str:
    """Byte-stable one-line JSON (sorted keys, tight separators; exotic
    values degrade to str rather than failing the serving handler)."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"), default=str)


def record_line(rec: Dict[str, Any]) -> str:
    """One ledger line (newline-terminated) for one tick's DecisionRecord.

    STRICT serialization, unlike the /explainz serving path: a non-JSON
    value leaking into the ledger (a numpy scalar from the attribution
    path, say) must fail at the writer, not be silently coerced to a
    quoted string that passes the byte-diff gate with the wrong type."""
    return (
        json.dumps(rec, sort_keys=True, separators=(",", ":")) + "\n"
    )


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


def _check_expander(i: int, rec: Dict[str, Any], errors: List[str]) -> None:
    """The scaled-up ⇒ recorded-winning-score invariant."""
    up = rec.get("scale_up")
    if not isinstance(up, dict) or not up.get("executed"):
        return
    exp = rec.get("expander")
    where = f"record {i}"
    if not isinstance(exp, dict):
        errors.append(f"{where}: scale-up executed but no expander section")
        return
    chosen = exp.get("chosen")
    if not isinstance(chosen, str) or not chosen:
        errors.append(f"{where}: scale-up executed but expander.chosen empty")
        return
    options = exp.get("options")
    if not isinstance(options, list) or not any(
        isinstance(o, dict) and o.get("group") == chosen for o in options
    ):
        errors.append(
            f"{where}: chosen group {chosen!r} missing from the expander "
            "scoring table"
        )
    if "score" in exp and exp["score"] is not None and not _num(exp["score"]):
        errors.append(f"{where}: expander.score must be a number or null")
    if "score" not in exp:
        errors.append(
            f"{where}: scale-up executed but no winning score recorded"
        )


def _check_pods(i: int, rec: Dict[str, Any], errors: List[str]) -> None:
    """The pending-pod ⇒ reason invariant (closed vocabulary)."""
    where = f"record {i}"
    pods = rec.get("pods", {})
    if not isinstance(pods, dict):
        errors.append(f"{where}: pods must map pod keys to reasons")
        return
    for key, reason in pods.items():
        if not isinstance(key, str) or reason not in LEDGER_POD_REASONS:
            errors.append(
                f"{where}: pod {key!r} carries reason {reason!r} outside the "
                "closed vocabulary"
            )
    up = rec.get("scale_up")
    if isinstance(up, dict) and isinstance(up.get("remain_unschedulable"), int):
        # expendable drops never reach scale-up, so they carry reasons
        # WITHOUT counting against the remain_unschedulable cross-check
        explained = sum(
            1
            for reason in pods.values()
            if reason != REASON_EXPENDABLE_BELOW_CUTOFF
        )
        if explained != up["remain_unschedulable"]:
            errors.append(
                f"{where}: {up['remain_unschedulable']} pods remained "
                f"unschedulable but {explained} carry reasons — an "
                "unexplained pending pod means attribution dropped it"
            )


def _check_preemption(i: int, rec: Dict[str, Any], errors: List[str]) -> None:
    """The eviction ⇒ named-evictor invariant: every eviction row carries a
    closed-vocabulary reason, a victim key, and the evictor that displaced
    it (the acceptance surface of the preemption ledger)."""
    where = f"record {i}"
    pre = rec.get("preemption")
    if pre is None:
        return
    if not isinstance(pre, dict):
        errors.append(f"{where}: preemption section must be an object")
        return
    admitted = pre.get("admitted", [])
    if not isinstance(admitted, list) or any(
        not isinstance(k, str) for k in admitted
    ):
        errors.append(f"{where}: preemption.admitted must list pod keys")
    evictions = pre.get("evictions", [])
    if not isinstance(evictions, list):
        errors.append(f"{where}: preemption.evictions must be a list")
        return
    for j, row in enumerate(evictions):
        at = f"{where} eviction {j}"
        if not isinstance(row, dict):
            errors.append(f"{at}: not an object")
            continue
        if not isinstance(row.get("pod"), str) or not row.get("pod"):
            errors.append(f"{at}: missing victim pod key")
        if row.get("reason") not in EVICTION_REASONS:
            errors.append(
                f"{at}: reason {row.get('reason')!r} outside the closed "
                "eviction vocabulary"
            )
        if not isinstance(row.get("by"), str) or not row.get("by"):
            errors.append(
                f"{at}: eviction of {row.get('pod')!r} does not name its "
                "evictor"
            )


def validate_records(records: Iterable[Any]) -> List[str]:
    """Validate a decision ledger; returns error strings (empty = valid).
    Checks the record schema, tick monotonicity, the closed reason
    vocabularies, and the two provenance cross-checks (see module doc)."""
    errors: List[str] = []
    last_tick = None
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            errors.append(f"record {i}: not an object")
            continue
        if rec.get("schema") != SCHEMA:
            errors.append(
                f"record {i}: schema {rec.get('schema')!r} != {SCHEMA!r}"
            )
        tick = rec.get("tick")
        if not isinstance(tick, int):
            errors.append(f"record {i}: tick must be an int")
        elif last_tick is not None and tick <= last_tick:
            errors.append(
                f"record {i}: tick {tick} not increasing (prev {last_tick})"
            )
        if isinstance(tick, int):
            last_tick = tick
        if not _num(rec.get("now_ts")):
            errors.append(f"record {i}: now_ts must be a number")
        skipped = rec.get("skipped_groups", {})
        if not isinstance(skipped, dict):
            errors.append(f"record {i}: skipped_groups must be an object")
        else:
            for gid, reason in skipped.items():
                if reason not in SKIP_REASON_VALUES:
                    errors.append(
                        f"record {i}: group {gid!r} skip reason {reason!r} "
                        "outside the closed SkipReason vocabulary"
                    )
        est = rec.get("estimator")
        if est is not None and (
            not isinstance(est, dict) or not isinstance(est.get("groups"), dict)
        ):
            errors.append(
                f"record {i}: estimator section must carry a groups object"
            )
        _check_pods(i, rec, errors)
        _check_expander(i, rec, errors)
        _check_preemption(i, rec, errors)
    return errors


def summarize(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a decision ledger into the figures bench.py reports:
    rejection-reason histograms (per-pod dominant and per-group estimator
    verdicts), expander win counts, skip-reason counts, plan totals."""
    pod_reasons: Dict[str, int] = {}
    group_reasons: Dict[str, int] = {}
    wins: Dict[str, int] = {}
    skips: Dict[str, int] = {}
    scale_up_nodes = 0
    evictions = 0
    preempt_admitted = 0
    ticks = 0
    for rec in records:
        ticks += 1
        for reason in rec.get("pods", {}).values():
            pod_reasons[reason] = pod_reasons.get(reason, 0) + 1
        est = rec.get("estimator", {})
        for verdict in est.get("groups", {}).values():
            for reason, count in verdict.get("reasons", {}).items():
                group_reasons[reason] = group_reasons.get(reason, 0) + int(count)
        exp = rec.get("expander", {})
        chosen = exp.get("chosen")
        if chosen:
            wins[chosen] = wins.get(chosen, 0) + 1
        for reason in rec.get("skipped_groups", {}).values():
            skips[reason] = skips.get(reason, 0) + 1
        up = rec.get("scale_up", {})
        scale_up_nodes += sum(int(d) for _, d in up.get("executed", ()))
        pre = rec.get("preemption", {})
        evictions += len(pre.get("evictions", ()))
        preempt_admitted += len(pre.get("admitted", ()))
    return {
        "ticks": ticks,
        "pod_reasons": {k: pod_reasons[k] for k in sorted(pod_reasons)},
        "group_reasons": {k: group_reasons[k] for k in sorted(group_reasons)},
        "expander_wins": {k: wins[k] for k in sorted(wins)},
        "skip_reasons": {k: skips[k] for k in sorted(skips)},
        "scale_up_nodes": scale_up_nodes,
        "evictions": evictions,
        "preempt_admitted": preempt_admitted,
    }
