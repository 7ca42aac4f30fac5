"""Fleet decision-ledger schema: the ``validate_records`` twin the
``autoscaler_tpu.fleet.round`` tag never had.

One sorted-key JSON line per fleet round (FleetRoundRecord.to_dict in
loadgen/fleetdrive.py is the producer). /2 added the overload-armor
columns (typed ``shed`` rows + the ``outcomes`` tally); /3 added the
fleet-HA columns (per-verdict ``endpoint`` + ``failovers``, quota
``tier``). The tag and SCHEMA_FIELDS manifest live here — graftlint
GL017 cross-checks every producer, this validator, and the summarizer
against the manifest, so a field drifting in any of the three without a
version bump fails the lint gate, not a replay three PRs later.

``validate_records`` also machine-checks the two accounting identities
the chaos gate used to assert ad hoc:

- ``len(shed) == outcomes["shed"] + outcomes["expired"]`` — every shed
  row is tallied exactly once;
- ``outcomes["unresolved"] == 0`` — the zero-hung-tickets audit: a
  ticket the coalescer admitted but never resolved/failed/shed is the
  deadline-deadlock bug class, and a ledger carrying one must never
  validate clean.

The port's copy of ``autoscaler_tpu/fleet/ledger.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

# re-exported serialization helpers — one stable_json for every ledger
from autoscaler_tpu_torch.perf.ledger import (  # noqa: F401 — re-exported API
    dump_jsonl,
    load_jsonl,
    record_line,
    stable_json,
)

FLEET_SCHEMA = "autoscaler_tpu.fleet.round/3"

SCHEMA_FIELDS = {
    FLEET_SCHEMA: {
        "required": (
            "tick",
            "now_ts",
            "tenants",
            "degraded",
            "errors",
            "shed",
            "outcomes",
        ),
        "optional": (),
    },
}

# every FleetTenantVerdict column (loadgen/fleetdrive.py dataclass);
# asdict() serializes them all, so a row missing one is a drifted writer
_VERDICT_KEYS = (
    "tenant",
    "bucket",
    "batch_size",
    "padding_waste",
    "route",
    "node_counts",
    "scheduled_pods",
    "verdict_sha256",
    "match_solo",
    "best_group",
    "endpoint",
    "failovers",
    "tier",
)

_OUTCOME_KEYS = ("resolved", "shed", "expired", "failed", "unresolved")


def _num(value: Any) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def _check_tenants(i: int, rec: Dict[str, Any], errors: List[str]) -> None:
    tenants = rec.get("tenants")
    if not isinstance(tenants, list):
        errors.append(f"record {i}: tenants must be a list")
        return
    for j, row in enumerate(tenants):
        at = f"record {i} tenant {j}"
        if not isinstance(row, dict):
            errors.append(f"{at}: not an object")
            continue
        missing = [k for k in _VERDICT_KEYS if k not in row]
        if missing:
            errors.append(f"{at}: verdict row missing {missing}")
        if not isinstance(row.get("tenant"), str) or not row.get("tenant"):
            errors.append(f"{at}: missing tenant name")
        if not isinstance(row.get("verdict_sha256"), str):
            errors.append(f"{at}: verdict_sha256 must be a string")
        if not isinstance(row.get("match_solo"), bool):
            errors.append(f"{at}: match_solo must be a bool")
        if not isinstance(row.get("failovers"), int) or row.get("failovers", 0) < 0:
            errors.append(f"{at}: failovers must be a non-negative int")


def _check_outcomes(i: int, rec: Dict[str, Any], errors: List[str]) -> None:
    outcomes = rec.get("outcomes")
    if not isinstance(outcomes, dict):
        errors.append(f"record {i}: outcomes must be an object")
        return
    for k, v in outcomes.items():
        if k not in _OUTCOME_KEYS:
            errors.append(f"record {i}: unknown outcome {k!r}")
        elif not isinstance(v, int) or v < 0:
            errors.append(f"record {i}: outcome {k} must be a non-negative int")
    shed = rec.get("shed")
    if isinstance(shed, list):
        tallied = outcomes.get("shed", 0) + outcomes.get("expired", 0)
        if isinstance(tallied, int) and tallied != len(shed):
            errors.append(
                f"record {i}: {len(shed)} shed rows but outcomes tally "
                f"{tallied} (shed+expired) — a shed request went uncounted"
            )
    unresolved = outcomes.get("unresolved", 0)
    if unresolved:
        errors.append(
            f"record {i}: {unresolved} unresolved ticket(s) — the "
            "zero-hung-tickets audit fails (an admitted request reached "
            "no terminal outcome)"
        )


def validate_records(records: Iterable[Any]) -> List[str]:
    """Validate a fleet decision ledger; returns error strings (empty =
    valid). Checks the round-record schema, tick monotonicity, verdict
    row shape, and the shed/outcome accounting identities."""
    errors: List[str] = []
    last_tick = None
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            errors.append(f"record {i}: not an object")
            continue
        if rec.get("schema") != FLEET_SCHEMA:
            errors.append(
                f"record {i}: schema {rec.get('schema')!r} != {FLEET_SCHEMA!r}"
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
        degraded = rec.get("degraded")
        if not isinstance(degraded, list) or any(
            not isinstance(s, str) for s in degraded
        ):
            errors.append(f"record {i}: degraded must be a list of strings")
        errs = rec.get("errors")
        if not isinstance(errs, list) or any(
            not isinstance(s, str) for s in errs
        ):
            errors.append(f"record {i}: errors must be a list of strings")
        shed = rec.get("shed")
        if not isinstance(shed, list) or any(
            not isinstance(row, dict) for row in shed
        ):
            errors.append(f"record {i}: shed must be a list of objects")
        _check_tenants(i, rec, errors)
        _check_outcomes(i, rec, errors)
    return errors


def summarize(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a fleet ledger into the figures bench.py reports: round
    count, terminal-outcome totals, shed volume, per-endpoint verdict
    counts, total failovers, and the solo-match certificate ratio."""
    rounds = 0
    outcome_totals: Dict[str, int] = {}
    shed_rows = 0
    endpoints: Dict[str, int] = {}
    failovers = 0
    verdicts = 0
    solo_matches = 0
    for rec in records:
        rounds += 1
        for k, v in rec.get("outcomes", {}).items():
            outcome_totals[k] = outcome_totals.get(k, 0) + int(v)
        shed_rows += len(rec.get("shed", ()))
        for row in rec.get("tenants", ()):
            verdicts += 1
            if row.get("match_solo"):
                solo_matches += 1
            ep = row.get("endpoint", "")
            if ep:
                endpoints[ep] = endpoints.get(ep, 0) + 1
            failovers += int(row.get("failovers", 0))
    return {
        "rounds": rounds,
        "outcomes": {k: outcome_totals[k] for k in sorted(outcome_totals)},
        "shed_rows": shed_rows,
        "verdicts": verdicts,
        "solo_matches": solo_matches,
        "endpoints": {k: endpoints[k] for k in sorted(endpoints)},
        "failovers": failovers,
    }
