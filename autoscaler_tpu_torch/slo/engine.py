"""The SLO burn-rate engine.

One engine per serving process (control loop or fleet driver). SLI events
arrive through :meth:`observe` (a latency judged against its spec's
threshold) or :meth:`observe_explain` (the pending-pod tracker over the
explain ring's per-tick still-pending set); :meth:`tick` computes the
multi-window burn rates on the caller's clock and appends one window
record to a bounded ring — the record that /sloz serves and the
``autoscaler_tpu.slo.window/1`` JSONL ledger serializes.

Determinism contract (graftlint GL001/GL010 police this package): every
timestamp is an injected ``now`` (the control loop passes its tick's
``now_ts``, the fleet path passes ticket stamps taken on the
``trace.timeline_now()`` seam), set-shaped state is only ever consumed
through ``sorted()``, and burn-rate floats are plain ratios of event
counts — two loadgen replays of one scenario append byte-identical window
records.

Threading (GL004): the control loop writes while /sloz HTTP threads read —
every mutation of engine state happens under the instance lock; metric
series are published outside it (they take their own locks; the order is
always engine state → series, same as the fleet queue-depth rule).

The port's copy of ``autoscaler_tpu/slo/engine.py``.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from autoscaler_tpu_torch.slo import ledger as ledger_mod
from autoscaler_tpu_torch.slo.spec import (
    SLI_PENDING_POD,
    SloSpec,
    default_slos,
)

# per-SLO event window cap: burn windows need only the recent past; a
# runaway event source must cost bounded memory
MAX_EVENTS = 8192


class SloEngine:
    """Judges SLI events against declarative targets and computes
    multi-window error-budget burn rates."""

    def __init__(
        self,
        specs: Optional[Sequence[SloSpec]] = None,
        ring_capacity: int = 64,
        max_events: int = MAX_EVENTS,
        metrics: Any = None,
    ) -> None:
        catalog = tuple(specs) if specs is not None else default_slos()
        if not catalog:
            raise ValueError("SloEngine needs at least one SloSpec")
        for s in catalog:
            s.validate()
        names = [s.name for s in catalog]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {sorted(names)}")
        # immutable after construction: readable without the lock
        self.specs: Dict[str, SloSpec] = {s.name: s for s in catalog}
        self.metrics = metrics
        self._lock = threading.Lock()
        # per SLO: (event now, bad 0/1) in arrival order — the burn
        # windows scan this; bounded so the scan and the memory are O(1)
        self._events: Dict[str, "deque[Tuple[float, int]]"] = {
            name: deque(maxlen=max(int(max_events), 1)) for name in self.specs
        }
        # lifetime [total, bad] per SLO (never windowed — the ledger's
        # events_total monotonicity gate rides on it)
        self._totals: Dict[str, List[int]] = {
            name: [0, 0] for name in self.specs
        }
        self._ring: "deque[Dict[str, Any]]" = deque(
            maxlen=max(int(ring_capacity), 1)
        )
        # pending-pod tracker over the explain ring: pod key → first-seen
        # now_ts, plus the keys already charged a bad event (overstayers
        # are charged ONCE, the first tick they exceed the threshold)
        self._pending_first: Dict[str, float] = {}
        self._pending_charged: Set[str] = set()

    def spec_names(self) -> List[str]:
        return sorted(self.specs)

    # -- SLI ingestion --------------------------------------------------------
    def observe(self, slo: str, seconds: float, now: float) -> None:
        """Judge one latency event against its SLO threshold. Unknown SLO
        names are dropped (an engine built with the fleet-only catalog must
        not crash a caller feeding the full one)."""
        spec = self.specs.get(slo)
        if spec is None:
            return
        self.observe_event(slo, bad=seconds > spec.threshold_s, now=now)

    def observe_event(self, slo: str, bad: bool, now: float) -> None:
        """Record one pre-judged event (failures are bad regardless of
        latency — the fleet path charges a failed batch here)."""
        if slo not in self.specs:
            return
        flag = 1 if bad else 0
        with self._lock:
            self._events[slo].append((float(now), flag))
            totals = self._totals[slo]
            totals[0] += 1
            totals[1] += flag
        if self.metrics is not None:
            self.metrics.slo_events_total.inc(
                slo=slo, verdict="bad" if bad else "good"
            )

    def observe_explain(self, record: Any) -> None:
        """The pending-pod SLI, fed from one tick's decision record
        (explain/record.py): pods enter the tracker when they first appear
        in the record's still-pending set; a pod that leaves the set
        resolves its event (good iff it stayed within the threshold); a pod
        that overstays the threshold is charged one bad event immediately —
        without this, a pod pending forever would never burn budget."""
        if not isinstance(record, dict):
            return
        spec = self.specs.get(SLI_PENDING_POD)
        if spec is None:
            return
        now = record.get("now_ts")
        if not isinstance(now, (int, float)):
            return
        pods = record.get("pods")
        if not isinstance(pods, dict):
            # the per-pod section is only noted when pods remained pending
            # after scale-up; a HEALTHY tick that cleared the pending set
            # carries the "pending" split reporting ZERO pending but no
            # "pods" — that is an EMPTY set (tracked pods resolved NOW),
            # not a malformed record. Without this, the tracker froze the
            # moment the set emptied and charged the resolved pods false
            # bad events whenever they finally "left" ticks later. Any
            # other shape — no "pending" split at all, or a split still
            # reporting pending pods (a tick that crashed between the
            # pending note and the scale-up explain) — established nothing
            # about WHICH pods resolved, so the tracker freezes: a pod
            # pending through a crash loop keeps accumulating pending time
            # instead of being falsely resolved every crash.
            split = record.get("pending")
            if not (isinstance(split, dict) and split.get("pending") == 0):
                return
            pods = {}
        now = float(now)
        events: List[bool] = []  # bad flags, in deterministic key order
        with self._lock:
            first = self._pending_first
            current = set(pods)
            for key in sorted(current - set(first)):
                first[key] = now
            for key in sorted(set(first) - current):
                dur = now - first.pop(key)
                charged = key in self._pending_charged
                self._pending_charged.discard(key)
                if not charged:
                    events.append(dur > spec.threshold_s)
            for key in sorted(current & set(first)):
                if (
                    now - first[key] > spec.threshold_s
                    and key not in self._pending_charged
                ):
                    self._pending_charged.add(key)
                    events.append(True)
        for bad in events:
            self.observe_event(SLI_PENDING_POD, bad=bad, now=now)

    # -- the per-tick window computation --------------------------------------
    def tick(self, now: float, tick_id: int) -> Dict[str, Any]:
        """Compute every SLO's multi-window burn rates as of ``now``,
        append the window record to the ring, publish the burn gauges, and
        return the record (the ledger line's content)."""
        gauge_rows: List[Tuple[str, str, float]] = []
        with self._lock:
            slos: Dict[str, Any] = {}
            for name in sorted(self.specs):
                spec = self.specs[name]
                totals = self._totals[name]
                windows: Dict[str, Any] = {}
                alerting = bool(spec.windows_s)
                for w in spec.windows_s:
                    cutoff = float(now) - w
                    total = bad = 0
                    for ts, flag in self._events[name]:
                        if ts >= cutoff:
                            total += 1
                            bad += flag
                    error_rate = bad / total if total else 0.0
                    burn = error_rate / spec.error_budget
                    windows[f"{w:g}"] = {
                        "window_s": w,
                        "total": total,
                        "bad": bad,
                        "error_rate": round(error_rate, 9),
                        "burn_rate": round(burn, 9),
                    }
                    if total == 0 or burn < spec.burn_alert:
                        alerting = False
                    gauge_rows.append((name, f"{w:g}", burn))
                slos[name] = {
                    "target": spec.target,
                    "threshold_s": spec.threshold_s,
                    "burn_alert": spec.burn_alert,
                    "events_total": totals[0],
                    "events_bad": totals[1],
                    "alerting": alerting,
                    "windows": windows,
                }
            rec = {
                "schema": ledger_mod.SCHEMA,
                "tick": int(tick_id),
                "now_ts": float(now),
                "slos": slos,
            }
            self._ring.append(rec)
        if self.metrics is not None:
            for name, window, burn in gauge_rows:
                self.metrics.slo_burn_rate.set(burn, slo=name, window=window)
        return rec

    # -- queries (/sloz, loadgen ledgers) -------------------------------------
    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def last_record(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def list_json(self) -> str:
        """The /sloz index: every SLO's spec plus its latest window row."""
        last = self.last_record()
        slos: Dict[str, Any] = {}
        for name in sorted(self.specs):
            spec = self.specs[name]
            entry: Dict[str, Any] = {"description": spec.description}
            if last is not None and name in last.get("slos", {}):
                entry.update(last["slos"][name])
            else:
                entry.update(
                    target=spec.target,
                    threshold_s=spec.threshold_s,
                    burn_alert=spec.burn_alert,
                )
            slos[name] = entry
        doc = {
            "schema": ledger_mod.SCHEMA,
            "slos": slos,
            "window_records": len(self.records()),
        }
        return ledger_mod.stable_json(doc) + "\n"

    def detail_json(self, slo: str) -> Optional[str]:
        """The ``?slo=`` drill-down: the spec plus this SLO's full window
        history from the ring. None for an unknown SLO (the handler's 400)."""
        spec = self.specs.get(slo)
        if spec is None:
            return None
        history = [
            {
                "tick": rec["tick"],
                "now_ts": rec["now_ts"],
                **rec["slos"].get(slo, {}),
            }
            for rec in self.records()
        ]
        doc = {
            "schema": ledger_mod.SCHEMA,
            "slo": slo,
            "description": spec.description,
            "target": spec.target,
            "threshold_s": spec.threshold_s,
            "windows_s": list(spec.windows_s),
            "burn_alert": spec.burn_alert,
            "history": history,
        }
        return ledger_mod.stable_json(doc) + "\n"
