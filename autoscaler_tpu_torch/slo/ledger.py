"""SLO-ledger schema validation.

One ledger line per control-loop tick / fleet round: the engine's window
record (every SLO's multi-window burn rates as of that tick) serialized as
sorted-key JSON via the shared ``record_line`` choke point. Every value is
deterministic under the loadgen drivers' injected clocks, so two replays
of one scenario write byte-identical JSONL files (hack/verify.sh diffs
them).

``validate_records`` is the machine-checked gate behind
``bench.py --slo-ledger``: beyond shape checks it enforces

- **window monotonicity** — ticks strictly increase, ``now_ts`` never goes
  backwards, and each SLO's lifetime event counters never decrease (a
  decreasing counter means the engine lost events mid-run);
- **burn-rate arithmetic** — every window's ``error_rate`` must equal
  ``bad/total`` and its ``burn_rate`` must equal
  ``error_rate/(1 − target)`` to within float tolerance, and ``alerting``
  must equal the multiwindow predicate (every window populated and burning
  past ``burn_alert``) — a record whose alert bit disagrees with its own
  arithmetic is exactly the silent corruption this gate exists to catch.

The port's copy of ``autoscaler_tpu/slo/ledger.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

# serialization rides the one ledger choke point (perf/ledger.py):
# sorted-key, tight-separator, strict JSON
from autoscaler_tpu_torch.perf.ledger import (  # noqa: F401 — re-exported API
    load_jsonl,
    record_line,
    stable_json,
)

SCHEMA = "autoscaler_tpu.slo.window/1"

# the machine-readable field contract (graftlint GL017): change the
# field set → update this AND bump the version tag above
SCHEMA_FIELDS = {
    SCHEMA: {
        "required": ("tick", "now_ts", "slos"),
        "optional": (),
    },
}

_TOL = 1e-6


def _num(value: Any) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def _check_window(
    where: str, entry: Dict[str, Any], w: Any, errors: List[str]
) -> bool:
    """One window row's shape + burn-rate arithmetic. Returns whether the
    window is populated AND burning past the alert factor (the alerting
    cross-check's operand)."""
    if not isinstance(w, dict):
        errors.append(f"{where}: window must be an object")
        return False
    total, bad = w.get("total"), w.get("bad")
    ok = True
    if not isinstance(total, int) or total < 0:
        errors.append(f"{where}: total must be a non-negative int")
        ok = False
    if not isinstance(bad, int) or bad < 0:
        errors.append(f"{where}: bad must be a non-negative int")
        ok = False
    if ok and bad > total:
        errors.append(f"{where}: bad={bad} exceeds total={total}")
        ok = False
    if not _num(w.get("window_s")) or w["window_s"] <= 0:
        errors.append(f"{where}: window_s must be a positive number")
        ok = False
    if not _num(w.get("error_rate")) or not _num(w.get("burn_rate")):
        errors.append(f"{where}: error_rate/burn_rate must be numbers")
        return False
    if not ok:
        return False
    # the burn-rate arithmetic cross-check
    want_rate = bad / total if total else 0.0
    if abs(w["error_rate"] - want_rate) > _TOL:
        errors.append(
            f"{where}: error_rate {w['error_rate']} != bad/total "
            f"{want_rate:.9f}"
        )
    target = entry.get("target")
    if _num(target) and 0.0 < target < 1.0:
        budget = 1.0 - target
        want_burn = w["error_rate"] / budget
        # tolerance scales with 1/budget: the recorded error_rate is
        # rounded to 9 digits, and that rounding error is amplified by
        # the budget division — a tight-budget SLO (target 0.9999) must
        # not fail validation on an arithmetically correct record
        tol = max(_TOL, _TOL * want_burn, 1e-9 / budget)
        if abs(w["burn_rate"] - want_burn) > tol:
            errors.append(
                f"{where}: burn_rate {w['burn_rate']} != error_rate/(1-"
                f"target) {want_burn:.9f}"
            )
    burn_alert = entry.get("burn_alert")
    return (
        total > 0
        and _num(burn_alert)
        and w["burn_rate"] >= burn_alert
    )


def _check_slo(
    i: int,
    name: str,
    entry: Any,
    last_totals: Dict[str, int],
    errors: List[str],
) -> None:
    where = f"record {i} slo {name!r}"
    if not isinstance(entry, dict):
        errors.append(f"{where}: not an object")
        return
    target = entry.get("target")
    if not _num(target) or not (0.0 < target < 1.0):
        errors.append(f"{where}: target must be in (0, 1), got {target!r}")
    if not _num(entry.get("threshold_s")) or entry["threshold_s"] <= 0:
        errors.append(f"{where}: threshold_s must be a positive number")
    if not _num(entry.get("burn_alert")) or entry["burn_alert"] <= 0:
        errors.append(f"{where}: burn_alert must be a positive number")
    ev_total, ev_bad = entry.get("events_total"), entry.get("events_bad")
    if not isinstance(ev_total, int) or not isinstance(ev_bad, int):
        errors.append(f"{where}: events_total/events_bad must be ints")
    else:
        if ev_bad > ev_total or ev_bad < 0:
            errors.append(
                f"{where}: events_bad={ev_bad} outside [0, {ev_total}]"
            )
        prev = last_totals.get(name)
        if prev is not None and ev_total < prev:
            errors.append(
                f"{where}: events_total {ev_total} decreased (prev {prev}) "
                "— the engine lost events mid-run"
            )
        last_totals[name] = ev_total
    windows = entry.get("windows")
    if not isinstance(windows, dict) or not windows:
        errors.append(f"{where}: windows must be a non-empty object")
        return
    burning = []
    for wname in sorted(windows):
        w = windows[wname]
        burning.append(
            _check_window(f"{where} window {wname}", entry, w, errors)
        )
        if (
            isinstance(w, dict)
            and isinstance(w.get("total"), int)
            and isinstance(ev_total, int)
            and w["total"] > ev_total
        ):
            errors.append(
                f"{where} window {wname}: windowed total {w['total']} "
                f"exceeds lifetime events_total {ev_total}"
            )
    alerting = entry.get("alerting")
    if not isinstance(alerting, bool):
        errors.append(f"{where}: alerting must be a bool")
    elif alerting != all(burning):
        errors.append(
            f"{where}: alerting={alerting} disagrees with the multiwindow "
            f"predicate (every window populated and burning past "
            f"burn_alert = {all(burning)})"
        )


def validate_records(records: Iterable[Any]) -> List[str]:
    """Validate an SLO ledger; returns error strings (empty = valid)."""
    errors: List[str] = []
    last_tick = None
    last_now = None
    last_totals: Dict[str, int] = {}
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
        now = rec.get("now_ts")
        if not _num(now):
            errors.append(f"record {i}: now_ts must be a number")
        else:
            if last_now is not None and now < last_now:
                errors.append(
                    f"record {i}: now_ts {now} went backwards "
                    f"(prev {last_now})"
                )
            last_now = now
        slos = rec.get("slos")
        if not isinstance(slos, dict) or not slos:
            errors.append(f"record {i}: slos must be a non-empty object")
            continue
        for name in sorted(slos):
            _check_slo(i, name, slos[name], last_totals, errors)
    return errors


def summarize(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate an SLO ledger into the figures bench.py reports: final
    event totals, the worst burn rate seen per (slo, window), and how many
    ticks each SLO spent alerting."""
    worst: Dict[str, Dict[str, float]] = {}
    alert_ticks: Dict[str, int] = {}
    finals: Dict[str, Dict[str, Any]] = {}
    ticks = 0
    for rec in records:
        ticks += 1
        for name, entry in rec.get("slos", {}).items():
            if not isinstance(entry, dict):
                continue
            if entry.get("alerting"):
                alert_ticks[name] = alert_ticks.get(name, 0) + 1
            for wname, w in entry.get("windows", {}).items():
                if isinstance(w, dict) and _num(w.get("burn_rate")):
                    peaks = worst.setdefault(name, {})
                    peaks[wname] = max(peaks.get(wname, 0.0), w["burn_rate"])
            finals[name] = {
                "events_total": entry.get("events_total", 0),
                "events_bad": entry.get("events_bad", 0),
                "target": entry.get("target"),
            }
    return {
        "ticks": ticks,
        "slos": {
            name: {
                **finals[name],
                "alert_ticks": alert_ticks.get(name, 0),
                "worst_burn_rate": {
                    k: worst.get(name, {}).get(k, 0.0)
                    for k in sorted(worst.get(name, {}))
                },
            }
            for name in sorted(finals)
        },
    }
