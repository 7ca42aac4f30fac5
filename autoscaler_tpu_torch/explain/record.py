"""The decision explainer: a crash-safe per-tick DecisionRecord assembler
and a bounded ring of recent records (served by ``/explainz``, appended to
the loadgen JSONL decision ledger).

Assembly mirrors the perf observatory's tick lifecycle
(perf/observatory.py): ``begin_tick`` opens the record, the control loop
``note()``s sections as phases complete (pending split → scale-up verdicts
→ scale-down reasons), and ``end_tick`` — called from ``run_once``'s
``finally`` — pushes whatever was assembled into the ring. A tick that
crashed mid-loop therefore still leaves a (partial) record: the sections
that completed before the crash are exactly the decisions that were made.

Determinism contract: every value noted here is a pure function of the
tick's inputs and the closed reason vocabularies (reasons.py) — no wall
clock, no ambient randomness (graftlint GL001 polices this package) — so
two loadgen replays of one scenario assemble byte-identical records;
``ledger.py`` serializes them.

Threading: the control loop writes while ``/explainz`` HTTP threads read —
every mutation of explainer state happens under the instance lock
(graftlint GL004 polices this module).

The port's copy of ``autoscaler_tpu/explain/record.py``.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

from autoscaler_tpu_torch.explain import ledger as ledger_mod


class DecisionExplainer:
    """One explainer per autoscaler (the loadgen driver's replays never
    share mutable decision state with a prior run)."""

    def __init__(self, ring_capacity: int = 64):
        self._lock = threading.Lock()
        self._ring: "deque[Dict[str, Any]]" = deque(
            maxlen=max(int(ring_capacity), 1)
        )
        self._tick: Optional[Dict[str, Any]] = None

    # -- tick lifecycle (StaticAutoscaler.run_once) --------------------------
    def begin_tick(self, tick_id: int, now_ts: float) -> None:
        with self._lock:
            self._tick = {
                "schema": ledger_mod.SCHEMA,
                "tick": int(tick_id),
                "now_ts": float(now_ts),
            }

    def note(self, section: str, doc: Any) -> None:
        """Attach one completed section to the open tick record (no-op when
        no tick is open — bare component calls in tests). Never raises on a
        live loop path: the record is observability, not control flow."""
        with self._lock:
            if self._tick is not None:
                self._tick[section] = doc

    def end_tick(self) -> Optional[Dict[str, Any]]:
        """Finalize the open record into the ring — crash paths included
        (the caller's ``finally``). Returns the record, or None when no
        tick was open."""
        with self._lock:
            rec = self._tick
            self._tick = None
            if rec is None:
                return None
            self._ring.append(rec)
            return rec

    # -- queries (/explainz, loadgen, /status) -------------------------------
    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def last_record(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def summaries(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for r in self._ring:
                exp = r.get("expander", {})
                up = r.get("scale_up", {})
                # pods the scale-up pass left pending without a recorded
                # reason — nonzero means the attribution path dropped pods
                # (the ledger gate fails on it; surfaced here too)
                unexplained = max(
                    int(up.get("remain_unschedulable", 0))
                    - len(r.get("pods", {})),
                    0,
                )
                out.append(
                    {
                        "tick": r["tick"],
                        "now_ts": r["now_ts"],
                        "pending": r.get("pending", {}).get("pending", 0),
                        "chosen": exp.get("chosen", ""),
                        "scaled_up": sum(
                            int(d) for _, d in up.get("executed", ())
                        ),
                        "skipped_groups": len(r.get("skipped_groups", {})),
                        "unexplained": unexplained,
                    }
                )
            return out

    def list_json(self) -> str:
        return (
            ledger_mod.stable_json(
                {"schema": ledger_mod.SCHEMA, "ticks": self.summaries()}
            )
            + "\n"
        )

    def detail_json(self, tick: int) -> Optional[str]:
        with self._lock:
            for r in self._ring:
                if r["tick"] == tick:
                    return ledger_mod.stable_json(r) + "\n"
        return None

    def pod_json(self, pod_key: str) -> str:
        """Per-pod drill-down: every ringed tick's verdict for the pod —
        its rejection reason while pending, or 'triggered' on the tick
        whose plan covered it."""
        rows: List[Dict[str, Any]] = []
        with self._lock:
            for r in self._ring:
                reason = r.get("pods", {}).get(pod_key)
                up = r.get("scale_up", {})
                triggered = pod_key in up.get("pods_triggered", ())
                if reason is None and not triggered:
                    continue
                rows.append(
                    {
                        "tick": r["tick"],
                        "now_ts": r["now_ts"],
                        "reason": "triggered" if triggered else reason,
                    }
                )
        return (
            ledger_mod.stable_json(
                {"schema": ledger_mod.SCHEMA, "pod": pod_key, "ticks": rows}
            )
            + "\n"
        )

    def group_json(self, group_id: str) -> str:
        """Per-group drill-down: each ringed tick's estimator verdict,
        expander score, or skip reason for the group."""
        rows: List[Dict[str, Any]] = []
        with self._lock:
            for r in self._ring:
                row: Dict[str, Any] = {"tick": r["tick"], "now_ts": r["now_ts"]}
                hit = False
                verdict = r.get("estimator", {}).get("groups", {}).get(group_id)
                if verdict is not None:
                    row["estimator"] = verdict
                    hit = True
                skip = r.get("skipped_groups", {}).get(group_id)
                if skip is not None:
                    row["skipped"] = skip
                    hit = True
                for opt in r.get("expander", {}).get("options", ()):
                    if opt.get("group") == group_id:
                        row["expander"] = opt
                        hit = True
                if r.get("expander", {}).get("chosen") == group_id:
                    row["chosen"] = True
                    hit = True
                if hit:
                    rows.append(row)
        return (
            ledger_mod.stable_json(
                {"schema": ledger_mod.SCHEMA, "group": group_id, "ticks": rows}
            )
            + "\n"
        )

    def last_decision_summary(self) -> Optional[Dict[str, Any]]:
        """The /status one-liner: most recent ringed tick that made (or
        declined) a scale-up decision — chosen group, winning score, and
        the top rejection reasons across that tick's estimator verdicts."""
        with self._lock:
            for r in reversed(self._ring):
                exp = r.get("expander")
                est = r.get("estimator")
                if exp is None and est is None:
                    continue
                totals: Dict[str, int] = {}
                for verdict in (est or {}).get("groups", {}).values():
                    for reason, count in verdict.get("reasons", {}).items():
                        totals[reason] = totals.get(reason, 0) + int(count)
                top = sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))
                return {
                    "tick": r["tick"],
                    "chosen": (exp or {}).get("chosen", ""),
                    "score": (exp or {}).get("score"),
                    "top_rejections": [
                        f"{name}={count}" for name, count in top[:3]
                    ],
                }
        return None
