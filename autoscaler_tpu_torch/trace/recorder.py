"""Flight recorder: a bounded in-memory ring of the last N tick traces.

Served by `/tracez` (main.ObservabilityServer): a JSON summary list,
`?id=` full span-tree detail, and `?format=chrome` Chrome-trace/Perfetto
export. Slow ticks are *pinned* — they survive ring eviction in a second
bounded slot, so the one 9-second tick from last night is still there when
an operator looks, even after thousands of healthy ticks rolled the ring.

The Chrome export is deterministic by construction: stable span ordering
(insertion order inside monotonically-numbered traces), timeline-clock
timestamps only, `sort_keys` JSON — two loadgen replays of the same
scenario diff clean (hack/verify.sh gates on exactly that).

The port's copy of ``autoscaler_tpu/trace/recorder.py``.
"""
from __future__ import annotations

import json
import threading
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from autoscaler_tpu_torch.trace.tracer import TickTrace

# /1: the Trace-Event-Format export envelope — ms display unit plus the
# flat event list (complete "X" spans, instant "i" events, metadata "M"
# track names). Consumers outside this repo (Perfetto, chrome://tracing)
# ignore the schema key; hack/verify.sh byte-diffs two replays' exports.
CHROME_SCHEMA = "autoscaler_tpu.trace.chrome/1"

# the machine-readable field contract (graftlint GL017): change the
# field set → update this AND bump the version tag above
SCHEMA_FIELDS = {
    CHROME_SCHEMA: {
        "required": ("displayTimeUnit", "traceEvents"),
        "optional": (),
    },
}


def validate_chrome_doc(doc: Any) -> List[str]:
    """Validate a chrome-trace export document; returns error strings
    (empty = valid). The machine-checked twin of ``chrome_trace_doc``:
    envelope shape plus the per-event invariants Perfetto relies on
    (every event carries name/ph/pid/tid; complete events carry
    non-negative ts/dur)."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["document: not an object"]
    if doc.get("schema") != CHROME_SCHEMA:
        errors.append(f"document: schema {doc.get('schema')!r} != {CHROME_SCHEMA!r}")
    if doc.get("displayTimeUnit") != "ms":
        errors.append("document: displayTimeUnit must be 'ms'")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return errors + ["document: traceEvents must be a list"]
    for j, ev in enumerate(events):
        where = f"event {j}"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errors.append(f"{where}: missing/empty name")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            errors.append(f"{where}: ph {ph!r} outside X|i|M")
        if not isinstance(ev.get("pid"), int) or not isinstance(
            ev.get("tid"), int
        ):
            errors.append(f"{where}: pid/tid must be ints")
        if ph == "X" and (
            not isinstance(ev.get("ts"), int)
            or not isinstance(ev.get("dur"), int)
            or ev["ts"] < 0
            or ev["dur"] < 0
        ):
            errors.append(f"{where}: complete event needs ts/dur >= 0 µs")
    return errors


class FlightRecorder:
    """Thread-safe ring of TickTraces + a bounded pinned set."""

    def __init__(self, capacity: int = 64, pinned_capacity: int = 16):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(capacity), 1))
        self._pinned: "OrderedDict[int, TickTrace]" = OrderedDict()
        self._pinned_capacity = max(int(pinned_capacity), 1)

    def add(self, trace: TickTrace, pin: bool = False) -> None:
        with self._lock:
            self._ring.append(trace)
            if pin:
                self.pin_locked(trace)

    def pin_locked(self, trace: TickTrace) -> None:
        trace.pinned = True
        self._pinned[trace.trace_id] = trace
        while len(self._pinned) > self._pinned_capacity:
            _, evicted = self._pinned.popitem(last=False)
            evicted.pinned = False

    def pin(self, trace_id: int) -> bool:
        with self._lock:
            trace = self._find(trace_id)
            if trace is None:
                return False
            self.pin_locked(trace)
            return True

    def _find(self, trace_id: int) -> Optional[TickTrace]:
        if trace_id in self._pinned:
            return self._pinned[trace_id]
        # most recent match: serving tracers ADOPT caller trace ids
        # (rpc/service.py), so several recorded traces can legitimately
        # share one id — one per served RPC of the same client tick
        for t in reversed(self._ring):
            if t.trace_id == trace_id:
                return t
        return None

    def traces(self) -> List[TickTrace]:
        """Ring ∪ pinned, ordered by trace id (insertion order within an
        id). Distinct traces sharing an id are all kept — a serving-side
        recorder holds one adopted trace per served RPC, and collapsing
        them would hide all but the last request of a client tick."""
        with self._lock:
            out = list(self._ring)
            ring_ids = {id(t) for t in out}
            for t in self._pinned.values():
                if id(t) not in ring_ids:
                    out.append(t)
            return sorted(out, key=lambda t: t.trace_id)

    def get(self, trace_id: int) -> Optional[TickTrace]:
        with self._lock:
            return self._find(trace_id)

    def summaries(self) -> List[Dict[str, Any]]:
        return [t.summary() for t in self.traces()]

    # -- exports --------------------------------------------------------------
    def list_json(self) -> str:
        return _stable_json({"traces": self.summaries()})

    def detail_json(self, trace_id: int) -> Optional[str]:
        trace = self.get(trace_id)
        return _stable_json(trace.to_dict()) if trace is not None else None

    def chrome(self, trace_id: Optional[int] = None) -> Optional[str]:
        """Chrome-trace ("Trace Event Format") JSON that loads in Perfetto /
        chrome://tracing. One process track per tick (pid = trace id), spans
        as complete ("X") events, span events as instants ("i")."""
        if trace_id is not None:
            trace = self.get(trace_id)
            if trace is None:
                return None
            traces = [trace]
        else:
            traces = self.traces()
        return _stable_json(chrome_trace_doc(traces))


def chrome_trace_doc(traces: List[TickTrace]) -> Dict[str, Any]:
    """Convert TickTraces to one Trace-Event-Format document. Timestamps
    are timeline-clock microseconds relative to the first exported root —
    deterministic whenever the clock is."""
    events: List[Dict[str, Any]] = []
    base = None
    for t in traces:
        if t.root is not None:
            base = t.root.start
            break
    base = base or 0.0

    def us(ts: float) -> int:
        return int(round((ts - base) * 1e6))

    for t in traces:
        pid = t.trace_id
        # "M"-phase metadata names the tracks: Perfetto shows
        # "autoscaler/tick N" process rows and an "autoscaler/tick" thread
        # lane instead of raw pid/tid integers
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"autoscaler/tick {t.trace_id}"},
            }
        )
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": "autoscaler/tick"},
            }
        )
        for sp in t.spans:
            end = sp.end if sp.end is not None else sp.start
            events.append(
                {
                    "name": sp.name,
                    "cat": "autoscaler",
                    "ph": "X",
                    "pid": pid,
                    "tid": 0,
                    "ts": us(sp.start),
                    "dur": max(us(end) - us(sp.start), 0),
                    "args": {
                        "span_id": sp.span_id,
                        "parent_id": sp.parent_id,
                        **_jsonable(sp.attrs),
                    },
                }
            )
            for ev in sp.events:
                events.append(
                    {
                        "name": ev["name"],
                        "cat": "autoscaler",
                        "ph": "i",
                        "s": "t",
                        "pid": pid,
                        "tid": 0,
                        "ts": us(ev.get("ts", sp.start)),
                        "args": {
                            "span_id": sp.span_id,
                            **_jsonable(ev.get("attrs", {})),
                        },
                    }
                )
    return {
        "schema": CHROME_SCHEMA,
        "displayTimeUnit": "ms",
        "traceEvents": events,
    }


def _jsonable(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


def _stable_json(doc: Any) -> str:
    # default=str: an exotic attribute value must degrade to its repr, not
    # take down the /tracez handler
    return (
        json.dumps(doc, sort_keys=True, separators=(",", ":"), default=str)
        + "\n"
    )
