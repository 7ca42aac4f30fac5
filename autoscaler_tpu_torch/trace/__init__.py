"""Tick tracing: span trees, flight recorder, and device-timing correlation.

Dependency-free (stdlib only) so every layer can import it. See tracer.py
for the design contract (injectable clock ⇒ byte-identical loadgen replays;
span durations feed ``function_duration_seconds`` through one choke point).

The port's copy of ``autoscaler_tpu/trace/__init__.py``, ``tracer.py`` and
``recorder.py``; ``trace/device.py`` is the JAX package's on torch.profiler.
"""
from autoscaler_tpu_torch.trace.recorder import (
    CHROME_SCHEMA,
    FlightRecorder,
    chrome_trace_doc,
    validate_chrome_doc,
)
from autoscaler_tpu_torch.trace.tracer import (
    NOOP_SPAN,
    Span,
    TickTrace,
    Tracer,
    add_event,
    current_context,
    current_span,
    parse_context,
    set_attrs,
    set_wall_attrs,
    span,
    timeline_clock,
    timeline_now,
)

__all__ = [
    "CHROME_SCHEMA",
    "FlightRecorder",
    "NOOP_SPAN",
    "Span",
    "TickTrace",
    "Tracer",
    "add_event",
    "chrome_trace_doc",
    "current_context",
    "current_span",
    "parse_context",
    "set_attrs",
    "set_wall_attrs",
    "span",
    "timeline_clock",
    "timeline_now",
    "validate_chrome_doc",
]
