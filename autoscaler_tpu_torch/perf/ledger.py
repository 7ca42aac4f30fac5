"""Perf-ledger serialization and schema validation.

One ledger line per control-loop tick: the observatory's tick record
(dispatch telemetry + residency snapshot) serialized as sorted-key JSON.
Every value in a record is deterministic under a synthetic timeline
clock — walls are timeline-clock deltas, cost figures are pure functions
of (route, shapes), residency bytes are pure functions of world shapes —
so two replays of one scenario write byte-identical JSONL files. The SLO
ledger serializes through ``stable_json`` too.

``validate_records`` is the machine-checked regression gate: beyond shape
checks it enforces *compile-cache coherence* — a ``cache: miss`` for a
(route, shape-signature) pair the ledger already recorded is a
compile-on-steady-state-tick regression (the compiled executable for that
signature was resident and was lost). The check is truncation-safe: a
ledger that starts mid-stream (ring-evicted prefix) can show hits whose
miss predates the window, but can never legitimately show a second miss.

The port's copy of ``autoscaler_tpu/perf/ledger.py``: the schema string
and the field contract are the JAX package's, so both packages' ledgers
validate alike.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Set, Tuple

SCHEMA = "autoscaler_tpu.perf.tick/1"

# the machine-readable field contract (graftlint GL017 diffs every
# producer, validate_records, and summarize against it): change the
# field set → update this AND bump the version tag above
SCHEMA_FIELDS = {
    SCHEMA: {
        "required": ("tick", "now_ts", "dispatches", "resident_bytes"),
        "optional": ("arena",),
    },
}

_DISPATCH_NUMERIC_OPTIONAL = (
    "execute_est_s",
    "compile_est_s",
    "utilization",
)


def stable_json(doc: Any) -> str:
    """Byte-stable one-line JSON (sorted keys, tight separators; exotic
    values degrade to str rather than failing the serving handler)."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"), default=str)


def record_line(rec: Dict[str, Any]) -> str:
    """One ledger line (newline-terminated) for one tick record."""
    return stable_json(rec) + "\n"


def dump_jsonl(records: Iterable[Dict[str, Any]], path: str) -> int:
    """Write tick records as JSONL; returns the line count."""
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


def _check_dispatch(
    i: int, j: int, d: Any, seen: Set[Tuple[str, str]], errors: List[str]
) -> None:
    where = f"record {i} dispatch {j}"
    if not isinstance(d, dict):
        errors.append(f"{where}: not an object")
        return
    route = d.get("route")
    if not isinstance(route, str) or not route:
        errors.append(f"{where}: missing/empty route")
        return
    sig = d.get("sig")
    if not isinstance(sig, str):
        errors.append(f"{where}: sig must be a string")
        sig = ""
    cache = d.get("cache")
    cold = d.get("cold")
    if cache not in ("hit", "miss"):
        errors.append(f"{where}: cache must be hit|miss, got {cache!r}")
    if not isinstance(cold, bool) or (cold != (cache == "miss")):
        errors.append(f"{where}: cold={cold!r} disagrees with cache={cache!r}")
    if not _num(d.get("dispatch_s")) or d["dispatch_s"] < 0:
        errors.append(f"{where}: dispatch_s must be a non-negative number")
    if not isinstance(d.get("operand_bytes"), int) or d["operand_bytes"] < 0:
        errors.append(f"{where}: operand_bytes must be a non-negative int")
    for k in _DISPATCH_NUMERIC_OPTIONAL:
        if k in d and (not _num(d[k]) or d[k] < 0):
            errors.append(f"{where}: {k} must be a non-negative number")
    cost = d.get("cost")
    if cost is not None and (
        not isinstance(cost, dict)
        or not all(isinstance(k, str) and _num(v) for k, v in cost.items())
    ):
        errors.append(f"{where}: cost must map names to numbers")
    # compile-cache coherence — THE steady-state regression gate: a miss
    # for a pair the ledger already carries means the resident executable
    # for that signature was lost and re-paid mid-run
    key = (route, sig)
    if cache == "miss" and key in seen:
        errors.append(
            f"{where}: compile-on-steady-state-tick regression — "
            f"cache=miss for already-seen (route={route!r}, sig={sig!r})"
        )
    seen.add(key)


_ARENA_KEYS = (
    "applies", "delta_rows", "delta_bytes", "full_uploads", "promotions",
    "rollbacks", "aux_uploads",
)


def _check_arena(
    i: int, arena: Any, first_arena: bool, errors: List[str]
) -> None:
    """The resident-arena steady-state gate: a tick record's ``arena``
    section may only report full uploads when the tick also reports a
    bucket promotion or a fault rollback — an unexplained full upload is
    the flatten-per-tick tax regressing. Truncation-safe like the
    compile-cache check: the FIRST arena record a ledger carries may be
    the init seed (its miss/upload predates nothing)."""
    where = f"record {i} arena"
    if not isinstance(arena, dict):
        errors.append(f"{where}: not an object")
        return
    for k, v in arena.items():
        if k not in _ARENA_KEYS:
            errors.append(f"{where}: unknown key {k!r}")
        elif not isinstance(v, int) or v < 0:
            errors.append(f"{where}: {k} must be a non-negative int")
    fulls = arena.get("full_uploads", 0)
    if (
        isinstance(fulls, int) and fulls > 0 and not first_arena
        and not arena.get("promotions", 0) and not arena.get("rollbacks", 0)
    ):
        errors.append(
            f"{where}: full-upload-on-steady-state-tick regression — "
            f"{fulls} full uploads with no bucket promotion or rollback"
        )


def validate_records(records: Iterable[Any]) -> List[str]:
    """Validate a perf ledger; returns a list of error strings (empty =
    valid). Checks the tick-record schema, tick monotonicity,
    compile-cache coherence, and resident-arena upload coherence across
    the whole ledger."""
    errors: List[str] = []
    seen: Set[Tuple[str, str]] = set()
    arena_seen = False
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
        resident = rec.get("resident_bytes")
        if not isinstance(resident, dict) or not all(
            isinstance(k, str) and isinstance(v, int) and v >= 0
            for k, v in resident.items()
        ):
            errors.append(
                f"record {i}: resident_bytes must map pools to byte counts"
            )
        arena = rec.get("arena")
        if arena is not None:
            _check_arena(i, arena, not arena_seen, errors)
            arena_seen = True
        dispatches = rec.get("dispatches")
        if not isinstance(dispatches, list):
            errors.append(f"record {i}: dispatches must be a list")
            continue
        for j, d in enumerate(dispatches):
            _check_dispatch(i, j, d, seen, errors)
    return errors


def summarize(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a ledger into the per-route figures bench.py reports:
    dispatch/compile counts, cold (compile) wall vs warm (execute) wall,
    the last utilization sample, and the resident-bytes peak per pool."""
    routes: Dict[str, Dict[str, Any]] = {}
    # signature sets accumulate OUTSIDE the summary containers (graftlint
    # GL010): only their order-insensitive count enters the serialized
    # summary, so a raw set can never leak its hash-seed-dependent
    # iteration order into a byte-diffed report
    sigs: Dict[str, Set[str]] = {}
    peaks: Dict[str, int] = {}
    arena_totals: Dict[str, int] = {}
    ticks = 0
    for rec in records:
        ticks += 1
        for pool, nbytes in rec.get("resident_bytes", {}).items():
            peaks[pool] = max(peaks.get(pool, 0), int(nbytes))
        for k, v in rec.get("arena", {}).items():
            arena_totals[k] = arena_totals.get(k, 0) + int(v)
        for d in rec.get("dispatches", ()):
            route = d.get("route", "?")
            r = routes.setdefault(
                route,
                {
                    "dispatches": 0,
                    "compiles": 0,
                    "compile_s": 0.0,
                    "execute_s": 0.0,
                },
            )
            r["dispatches"] += 1
            sigs.setdefault(route, set()).add(d.get("sig", ""))
            if d.get("cache") == "miss":
                r["compiles"] += 1
                r["compile_s"] += float(d.get("dispatch_s", 0.0))
            else:
                r["execute_s"] += float(d.get("dispatch_s", 0.0))
            if "utilization" in d:
                r["utilization"] = d["utilization"]
    for route, r in routes.items():
        r["signatures"] = len(sigs.get(route, ()))
        r["compile_s"] = round(r["compile_s"], 6)
        r["execute_s"] = round(r["execute_s"], 6)
    return {
        "ticks": ticks,
        "routes": {k: routes[k] for k in sorted(routes)},
        "resident_bytes_peak": {k: peaks[k] for k in sorted(peaks)},
        **(
            {"arena": {k: arena_totals[k] for k in sorted(arena_totals)}}
            if arena_totals
            else {}
        ),
    }
