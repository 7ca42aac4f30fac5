"""Structured per-tick tracing: span trees over the whole control loop.

The reference CA answers "why was this tick slow?" with a flat
`function_duration_seconds` summary (metrics.go:399) — it cannot attribute
a 2s tick to snapshot re-pack vs. kernel dispatch vs. a kube GET retry
storm. This module is the missing correlation layer: every `run_once`
produces one span tree (`TickTrace`) whose spans are named with the SAME
FunctionLabel vocabulary the metrics use, and whose durations feed
`function_duration_seconds` through one choke point
(`AutoscalerMetrics.observe_duration_value`) so the two can never disagree.

Design constraints, in order:

- **Dependency-free.** This package imports only the stdlib; every other
  layer (estimator ladder, kube client, rpc client, utils/http) imports it,
  so it must sit at the bottom of the graph.
- **Deterministic under an injected clock.** The tracer's timeline clock is
  injectable. The loadgen driver injects a synthetic counter clock, so two
  replays of the same scenario produce byte-identical trace exports —
  the same determinism contract the decision log already carries. Wall
  time is measured separately (for metrics and slow-tick detection) and is
  never part of the exported trace; wall-derived span attributes go
  through :func:`set_wall_attrs`, which drops them on deterministic
  tracers.
- **Ambient context, explicit ownership.** One contextvar carries the
  active (tracer, trace, span) through the tick, so leaf layers
  (`ladder.py`, `utils/http.py`) annotate the current span without any
  wiring. Outside a tick, :func:`span` degrades to a metrics-only
  observation (when given a registry) or a no-op — bare component calls in
  tests keep their metric series, and nothing leaks.

The port's copy of ``autoscaler_tpu/trace/tracer.py``.
"""
from __future__ import annotations

import contextvars
import logging
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

logger = logging.getLogger("trace")

# sentinel: "feed metrics under the span's own name"
_SAME = "__same_as_name__"


class _NoopSpan:
    """Returned by :func:`span` when no trace is active: every mutator is a
    no-op so call sites never branch on tracing being enabled."""

    __slots__ = ()

    def set_attrs(self, **attrs: Any) -> None:
        pass

    def add_event(self, name: str, ts: float = 0.0, **attrs: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()


@dataclass
class Span:
    """One timed operation. ``start``/``end`` are tracer-clock values (the
    deterministic timeline); ``wall_s`` is real elapsed wall time (metrics
    + slow-tick detection only — never exported)."""

    name: str
    span_id: int
    parent_id: Optional[int]
    start: float
    metric_label: Optional[str] = None
    end: Optional[float] = None
    attrs: Dict[str, Any] = field(default_factory=dict)
    events: List[Dict[str, Any]] = field(default_factory=list)
    wall_s: float = 0.0
    _wall_start: float = 0.0
    # explicit metrics registry for THIS span's duration feed (the
    # span(metrics=...) argument): honored even inside an active trace, so
    # a component's series survive a tracer built without metrics
    _metrics: Any = None

    def set_attrs(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def add_event(self, name: str, ts: float = 0.0, **attrs: Any) -> None:
        ev: Dict[str, Any] = {"name": name, "ts": ts}
        if attrs:
            ev["attrs"] = attrs
        self.events.append(ev)

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def to_dict(self) -> Dict[str, Any]:
        """Deterministic serialization: timeline-clock fields and attributes
        only — ``wall_s`` stays out by design (it is the one field that
        legitimately differs between identical replays)."""
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end if self.end is not None else self.start,
            "attrs": dict(self.attrs),
            "events": [dict(e) for e in self.events],
        }


@dataclass
class TickTrace:
    """The span tree of one ``run_once`` tick. ``spans[0]`` is the root."""

    trace_id: int
    spans: List[Span] = field(default_factory=list)
    pinned: bool = False

    @property
    def root(self) -> Optional[Span]:
        return self.spans[0] if self.spans else None

    def to_dict(self) -> Dict[str, Any]:
        root = self.root
        return {
            "trace_id": self.trace_id,
            "name": root.name if root else "",
            "duration": root.duration if root else 0.0,
            "pinned": self.pinned,
            "spans": [s.to_dict() for s in self.spans],
        }

    def summary(self) -> Dict[str, Any]:
        root = self.root
        return {
            "trace_id": self.trace_id,
            "name": root.name if root else "",
            "duration": root.duration if root else 0.0,
            "span_count": len(self.spans),
            "pinned": self.pinned,
            "error": bool(root and "error" in root.attrs),
            "attrs": dict(root.attrs) if root else {},
        }

    def render(self) -> str:
        """Indented text dump of the span tree (the slow-tick log artifact).
        Includes wall_s — this is a log line for an operator, not the
        byte-stable replay artifact."""
        children: Dict[Optional[int], List[Span]] = {}
        for s in self.spans:
            children.setdefault(s.parent_id, []).append(s)
        lines: List[str] = []

        def walk(span: Span, depth: int) -> None:
            attrs = " ".join(f"{k}={v}" for k, v in sorted(span.attrs.items()))
            lines.append(
                f"{'  ' * depth}{span.name} "
                f"dur={span.duration:.6f}s wall={span.wall_s:.6f}s"
                + (f" [{attrs}]" if attrs else "")
            )
            for ev in span.events:
                ev_attrs = " ".join(
                    f"{k}={v}" for k, v in sorted(ev.get("attrs", {}).items())
                )
                lines.append(
                    f"{'  ' * (depth + 1)}@ {ev['name']}"
                    + (f" [{ev_attrs}]" if ev_attrs else "")
                )
            for child in children.get(span.span_id, ()):
                walk(child, depth + 1)

        if self.root is not None:
            walk(self.root, 0)
        return "\n".join(lines)


# the one ambient slot: (tracer, trace, current span) for THIS context
_ACTIVE: contextvars.ContextVar[
    Optional[Tuple["Tracer", TickTrace, Span]]
] = contextvars.ContextVar("autoscaler_tpu_trace_active", default=None)


def current_span() -> Optional[Span]:
    active = _ACTIVE.get()
    return active[2] if active is not None else None


def add_event(name: str, **attrs: Any) -> None:
    """Stamp an event on the current span (no-op outside a trace). The
    event timestamp comes from the tracer's timeline clock, so events stay
    deterministic under injection."""
    active = _ACTIVE.get()
    if active is None:
        return
    tracer, _trace, sp = active
    sp.add_event(name, ts=tracer.clock(), **attrs)


def set_attrs(**attrs: Any) -> None:
    active = _ACTIVE.get()
    if active is not None:
        active[2].set_attrs(**attrs)


def set_wall_attrs(**attrs: Any) -> None:
    """Attach wall-time-derived attributes (compile/execute splits,
    dispatch latencies). Dropped on deterministic tracers — wall time is
    the one signal that differs between identical replays, and the trace
    export must stay byte-stable."""
    active = _ACTIVE.get()
    if active is None:
        return
    tracer, _trace, sp = active
    if tracer.deterministic:
        return
    sp.set_attrs(**attrs)


def current_context() -> Optional[str]:
    """The propagable identity of the active span: ``"<trace_id>:<span_id>"``,
    or None outside a trace. This is what the rpc client stamps into gRPC
    metadata (and the fleet proto's ``trace_context`` field) so the sidecar
    can adopt the caller's trace as the parent of its serving span — the
    cross-process analog of the ambient contextvar."""
    active = _ACTIVE.get()
    if active is None:
        return None
    _tracer, trace_, sp = active
    return f"{trace_.trace_id}:{sp.span_id}"


def parse_context(ctx: Optional[str]) -> Optional[Tuple[int, int]]:
    """``"<trace_id>:<span_id>"`` → (trace_id, span_id), or None for
    anything that is not a well-formed context (absent, foreign, corrupt —
    propagation is best-effort observability and must never fail a
    request)."""
    if not ctx or not isinstance(ctx, str):
        return None
    tid, sep, sid = ctx.partition(":")
    if not sep:
        return None
    try:
        return int(tid), int(sid)
    except ValueError:
        return None


def timeline_clock() -> Optional[Callable[[], float]]:
    """The active tracer's timeline clock itself, or None outside a trace.
    For state whose lifecycle CROSSES threads (a fleet ticket submitted
    inside a traced tick but resolved on the coalescer's window thread):
    capture the clock at the traced end and stamp every later lifecycle
    point from it, so all stamps share one clock domain — mixing a
    synthetic timeline reading with the bare-monotonic fallback of
    :func:`timeline_now` would make their differences garbage."""
    active = _ACTIVE.get()
    return active[0].clock if active is not None else None


def timeline_now() -> float:
    """THE whitelisted clock seam for replay-reachable duration pairs
    (graftlint GL001): inside a trace, the active tracer's timeline clock —
    which the loadgen driver replaces with a synthetic counter, so replayed
    elapsed-time measurements (and anything branching on them, like the
    estimator's over-budget warning) are byte-identical across runs.
    Outside any trace it degrades to the process monotonic clock."""
    active = _ACTIVE.get()
    if active is not None:
        return active[0].clock()
    return time.monotonic()  # graftlint: disable=GL001 — the seam's own fallback: no trace means no injected clock to defer to


def _feed_metrics(metrics: Any, label: str, elapsed: float) -> None:
    """THE metrics choke point: every span duration and every legacy
    ``observe_duration`` call land in ``function_duration_seconds`` through
    ``AutoscalerMetrics.observe_duration_value`` — the vocabulary (span name
    == function label) and the counts cannot diverge."""
    observe = getattr(metrics, "observe_duration_value", None)
    if observe is not None:
        observe(label, elapsed)


@contextmanager
def span(
    name: str,
    metric_label: Optional[str] = _SAME,
    metrics: Any = None,
    **attrs: Any,
) -> Iterator[Any]:
    """Open a child span under the current one.

    - Inside an active trace: a real :class:`Span`; its wall duration feeds
      the active tracer's metrics under ``metric_label`` (default: the span
      name; pass ``None`` to opt out).
    - Outside a trace with ``metrics`` given: a detached observation — the
      duration still lands in ``function_duration_seconds`` so bare
      component calls (unit tests, tools) keep their series.
    - Outside a trace without ``metrics``: a pure no-op.
    """
    label = name if metric_label is _SAME else metric_label
    active = _ACTIVE.get()
    if active is None:
        if metrics is None or not label:
            yield NOOP_SPAN
            return
        wall0 = time.perf_counter()
        try:
            yield NOOP_SPAN
        finally:
            _feed_metrics(metrics, label, time.perf_counter() - wall0)
        return
    tracer, trace_, parent = active
    sp = tracer._start(trace_, parent, name, label, attrs)
    sp._metrics = metrics
    token = _ACTIVE.set((tracer, trace_, sp))
    try:
        yield sp
    except BaseException as e:
        sp.set_attrs(error=type(e).__name__)
        raise
    finally:
        _ACTIVE.reset(token)
        tracer._finish(sp)


class Tracer:
    """Produces one :class:`TickTrace` per ``run_once`` and hands it to the
    flight recorder.

    ``clock``: the timeline clock (injectable; loadgen passes a synthetic
    deterministic counter). ``metrics``: an ``AutoscalerMetrics`` whose
    ``function_duration_seconds`` every span duration feeds. Wall time is
    always measured with ``time.perf_counter`` regardless of the timeline
    clock — metrics and slow-tick detection stay real even when the
    exported timeline is simulated."""

    def __init__(
        self,
        clock: Optional[Callable[[], float]] = None,
        metrics: Any = None,
        recorder: Any = None,
        slow_tick_threshold_s: float = 0.0,
        deterministic: Optional[bool] = None,
    ):
        from autoscaler_tpu_torch.trace.recorder import FlightRecorder

        self._wall = time.perf_counter
        self.clock = clock if clock is not None else self._wall
        self.metrics = metrics
        self.recorder = recorder if recorder is not None else FlightRecorder()
        self.slow_tick_threshold_s = slow_tick_threshold_s
        # injected clock ⇒ replayable timeline ⇒ wall attrs must stay out
        self.deterministic = (
            deterministic if deterministic is not None else clock is not None
        )
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._context_attrs: Dict[str, Any] = {}

    def set_context(self, **attrs: Any) -> None:
        """Attributes stamped onto the NEXT tick's root span and then
        consumed — the loadgen driver's seam for tagging traces with
        scenario sim-time/tick (stale tags must not leak onto later
        ticks)."""
        self._context_attrs = dict(attrs)

    # -- span lifecycle (called by the module-level span()) ------------------
    def _start(
        self,
        trace_: TickTrace,
        parent: Optional[Span],
        name: str,
        label: Optional[str],
        attrs: Dict[str, Any],
    ) -> Span:
        sp = Span(
            name=name,
            span_id=len(trace_.spans),
            parent_id=parent.span_id if parent is not None else None,
            start=self.clock(),
            metric_label=label,
            attrs=dict(attrs),
        )
        sp._wall_start = self._wall()
        trace_.spans.append(sp)
        return sp

    def _finish(self, sp: Span) -> None:
        sp.end = self.clock()
        sp.wall_s = self._wall() - sp._wall_start
        # span-level registry wins: span(metrics=...) must feed even under
        # a tracer constructed without one
        metrics = sp._metrics if sp._metrics is not None else self.metrics
        if metrics is not None and sp.metric_label:
            _feed_metrics(metrics, sp.metric_label, sp.wall_s)

    # -- the per-tick entry point --------------------------------------------
    @contextmanager
    def tick(
        self,
        name: str,
        parent_context: Optional[str] = None,
        **attrs: Any,
    ) -> Iterator[Span]:
        """Open the root span of one tick. On exit — error paths included —
        the trace is finalized, fed to the flight recorder, and (when the
        tick's wall time exceeds ``slow_tick_threshold_s``) its full span
        tree is logged and the trace pinned in the ring.

        ``parent_context`` (a :func:`current_context` string from another
        process) makes this a *serving* trace: it ADOPTS the caller's trace
        id — client and sidecar spans for one request share one trace id,
        so /tracez on either side joins the tree — and the root span
        records ``parent_trace_id``/``parent_span_id`` naming the exact
        remote parent span. A malformed context degrades to a normal local
        trace (propagation is best-effort observability)."""
        if _ACTIVE.get() is not None:
            # re-entrant tick (an autoscaler driven inside another traced
            # component): degrade to a plain child span
            with span(name, **attrs) as sp:
                yield sp
            return
        adopted = parse_context(parent_context)
        if adopted is None:
            with self._seq_lock:
                trace_id = self._seq
                self._seq += 1
        else:
            trace_id = adopted[0]
            # keep locally-minted ids out of the adopted space: a serving
            # tracer that has adopted id N must never hand id N to an
            # unrelated context-less request, or /tracez drill-down would
            # conflate the two. (Two *clients* whose own counters collide
            # can still share an id on the serving side — the listing
            # disambiguates by the parent/tenant attrs on each root.)
            with self._seq_lock:
                self._seq = max(self._seq, trace_id + 1)
            attrs = {
                **attrs,
                "parent_trace_id": adopted[0],
                "parent_span_id": adopted[1],
            }
        trace_ = TickTrace(trace_id=trace_id)
        merged = {**self._context_attrs, **attrs, "trace_id": trace_id}
        self._context_attrs = {}  # consumed: one set_context, one tick
        root = self._start(trace_, None, name, name, merged)
        token = _ACTIVE.set((self, trace_, root))
        try:
            yield root
        except BaseException as e:
            root.set_attrs(error=type(e).__name__)
            raise
        finally:
            _ACTIVE.reset(token)
            self._finish(root)
            slow = (
                self.slow_tick_threshold_s > 0
                and root.wall_s > self.slow_tick_threshold_s
            )
            if self.recorder is not None:
                self.recorder.add(trace_, pin=slow)
            if slow:
                logger.warning(
                    "slow tick: trace %d took %.3fs wall (threshold %.3fs); "
                    "span tree:\n%s",
                    trace_id, root.wall_s, self.slow_tick_threshold_s,
                    trace_.render(),
                )
