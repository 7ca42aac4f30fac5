"""Flight-journal serialization and schema validation.

One journal line per control-loop tick: the tick's packed cluster state —
a full keyframe (every tensor field, name tables, the effective options
document) or a row-scatter delta against the previous line (the arena's
``DeltaProgram`` shape: per-field axis-0 index lists plus payload rows) —
alongside the options fingerprint, the tick's trace/explain/perf ids, the
preemption replay context, and the sha256 of the tick's explain-ledger
line. Every value is a pure function of the tick's packed state, so two
loadgen replays of one scenario write byte-identical JSONL journals
(hack/verify.sh diffs them).

``validate_records`` is the machine-checked gate behind
``bench.py --journal-ledger``: beyond shape checks it enforces the
reconstruction invariants the subsystem exists for —

- the first record is a keyframe (a journal that opens on a delta can
  never be reconstructed) and every keyframe names its promotion reason;
- ticks increase strictly (an out-of-order tick silently corrupts every
  reconstruction after it);
- every record carries the options fingerprint and the explain-line hash
  (state history without decision provenance answers no incident).

The port's copy of ``autoscaler_tpu/journal/ledger.py``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List

# /1: keyframe/delta state history over the packer's row-scatter delta
# format, options fingerprint per record, preemption replay context, and
# the explain-line hash that pins each state line to its decision line
SCHEMA = "autoscaler_tpu.journal.tick/1"

# the machine-readable field contract (graftlint GL017): change the
# field set → update this AND bump the version tag above
SCHEMA_FIELDS = {
    SCHEMA: {
        "required": (
            "tick",
            "kind",
            "options_fp",
            "explain_sha256",
            "ids",
            "ctx",
            "state",
        ),
        "optional": ("reason", "options"),
    },
}

# closed keyframe-promotion vocabulary: why a full keyframe was written
# instead of a delta (reseed:* mirrors the packer's full-repack reasons)
KEYFRAME_REASONS = frozenset({
    "init",
    "interval",
    "shape_change",
    "options_change",
    "reseed:init",
    "reseed:schema_change",
    "reseed:capacity_growth",
})


def stable_json(doc: Any) -> str:
    """Byte-stable one-line JSON (sorted keys, tight separators; exotic
    values degrade to str rather than failing the serving handler)."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"), default=str)


def record_line(rec: Dict[str, Any]) -> str:
    """One journal line (newline-terminated) for one tick's state record.

    STRICT serialization, unlike the /journalz serving path: a non-JSON
    value leaking into the journal (a numpy scalar from the codec, say)
    must fail at the writer, not be silently coerced to a quoted string
    that passes the byte-diff gate with the wrong type."""
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


def _check_state(i: int, rec: Dict[str, Any], errors: List[str]) -> None:
    """Keyframes carry full fields + name tables; deltas carry ops."""
    where = f"record {i}"
    state = rec.get("state")
    if not isinstance(state, dict):
        errors.append(f"{where}: state must be an object")
        return
    kind = rec.get("kind")
    if kind == "keyframe":
        fields = state.get("fields")
        if not isinstance(fields, dict) or not fields:
            errors.append(f"{where}: keyframe carries no tensor fields")
        else:
            for name, arr in fields.items():
                if not isinstance(arr, dict) or not all(
                    k in arr for k in ("dtype", "shape", "b64")
                ):
                    errors.append(
                        f"{where}: field {name!r} missing dtype/shape/b64"
                    )
        names = state.get("names")
        if not isinstance(names, dict) or not all(
            isinstance(names.get(k), list) for k in ("pods", "nodes", "groups")
        ):
            errors.append(f"{where}: keyframe missing full name tables")
        if not isinstance(rec.get("options"), dict):
            errors.append(f"{where}: keyframe missing the options document")
    elif kind == "delta":
        ops = state.get("ops")
        if not isinstance(ops, list):
            errors.append(f"{where}: delta.ops must be a list")
            return
        for j, op in enumerate(ops):
            at = f"{where} op {j}"
            if not isinstance(op, dict) or not isinstance(
                op.get("field"), str
            ):
                errors.append(f"{at}: op does not name its field")
                continue
            if not isinstance(op.get("payload"), dict):
                errors.append(f"{at}: op carries no payload")


def validate_records(records: Iterable[Any]) -> List[str]:
    """Validate a journal; returns error strings (empty = valid). Checks
    the record schema, strict tick monotonicity, the keyframe-first and
    keyframe-reason invariants, and per-record provenance (options
    fingerprint + explain-line hash)."""
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
        kind = rec.get("kind")
        if kind not in ("keyframe", "delta"):
            errors.append(f"record {i}: kind {kind!r} not keyframe|delta")
        if i == 0 and kind != "keyframe":
            errors.append(
                "record 0: journal must open on a keyframe (a leading "
                "delta can never be reconstructed)"
            )
        if kind == "keyframe" and rec.get("reason") not in KEYFRAME_REASONS:
            errors.append(
                f"record {i}: keyframe reason {rec.get('reason')!r} outside "
                "the closed promotion vocabulary"
            )
        fp = rec.get("options_fp")
        if not isinstance(fp, str) or not fp:
            errors.append(f"record {i}: missing options fingerprint")
        if not isinstance(rec.get("ctx"), dict):
            errors.append(f"record {i}: ctx must be an object")
        if kind == "keyframe" and not isinstance(rec.get("options"), dict):
            errors.append(
                f"record {i}: keyframe must carry its options document "
                "(the reconstruction anchor)"
            )
        if not isinstance(rec.get("explain_sha256"), str):
            errors.append(f"record {i}: missing explain-line hash")
        ids = rec.get("ids")
        if not isinstance(ids, dict) or not all(
            isinstance(ids.get(k), int) for k in ("trace", "explain", "perf")
        ):
            errors.append(f"record {i}: ids must carry trace/explain/perf")
        _check_state(i, rec, errors)
    return errors


def summarize(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a journal into the figures bench.py and the loadgen
    scorer report: tick/keyframe/delta counts, keyframe promotion reasons,
    delta-op volume, and the encoded state bytes shipped."""
    ticks = 0
    keyframes = 0
    deltas = 0
    delta_ops = 0
    reasons: Dict[str, int] = {}
    state_bytes = 0
    for rec in records:
        ticks += 1
        state = rec.get("state", {})
        if rec.get("kind") == "keyframe":
            keyframes += 1
            reason = str(rec.get("reason"))
            reasons[reason] = reasons.get(reason, 0) + 1
            for arr in state.get("fields", {}).values():
                state_bytes += len(arr.get("b64", ""))
        else:
            deltas += 1
            ops = state.get("ops", ())
            delta_ops += len(ops)
            for op in ops:
                state_bytes += len(op.get("payload", {}).get("b64", ""))
    return {
        "ticks": ticks,
        "keyframes": keyframes,
        "deltas": deltas,
        "delta_ops": delta_ops,
        "keyframe_reasons": {k: reasons[k] for k in sorted(reasons)},
        "state_b64_bytes": state_bytes,
    }
