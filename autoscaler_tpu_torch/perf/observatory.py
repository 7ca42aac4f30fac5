"""The perf observatory: per-dispatch compile telemetry, the cost model,
device-residency accounting, and a bounded ring of per-tick perf records
(served by ``/perfz``).

Determinism contract (the one every trace artifact here honors): every
duration handed to the observatory was measured on ``trace.timeline_now()``
by the caller — the tracer's injectable clock — and every derived figure
(cost model, residency bytes, cache verdicts) is a pure function of call
shapes. No device time and no ``torch.cuda`` query enters a record. Two
replays of one scenario under a synthetic clock therefore assemble
byte-identical tick records; ``ledger.py`` serializes them.

The compile-vs-execute split is "the first wall of a (route, shape
signature) minus the median of its warm walls". On a CUDA card the first
dispatch of a route also carries what its first use pays: the ``nvcc``
build of the kernel's source when the checkout has no library for it yet
(``ops/_build.py``), the module load, and the first launch's setup; on the
CPU it is the first call's allocations and warm-up. Nothing is prebuilt to
hide it.

Threading: the control loop writes while ``/perfz``/``/metrics`` HTTP
threads read — every mutation of observatory state happens under the
instance lock (graftlint GL004 polices this module). The one exception is
the pending-dispatch slot, which is thread-local by design: ``note_kernel``
and the matching ``on_dispatch`` run on the same dispatching thread.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from autoscaler_tpu_torch.perf import ledger as ledger_mod
from autoscaler_tpu_torch.perf.costmodel import (
    analyze_cost,
    default_peak_flops,
    operand_bytes,
    shape_signature,
)
from autoscaler_tpu_torch.perf.residency import POOL_KERNEL_OPERANDS, ResidencyLedger

# bounded warm-wall window per (route, signature): enough samples for a
# stable median, bounded memory over a long-lived process
_WARM_WINDOW = 64


class _RouteStats:
    """Per-(route, signature) dispatch telemetry. Mutated only under the
    owning observatory's lock."""

    __slots__ = ("first_wall", "first_tick", "warm", "dispatches")

    def __init__(self) -> None:
        self.first_wall: Optional[float] = None
        self.first_tick: Optional[int] = None
        self.warm: List[float] = []
        self.dispatches = 0


class PerfObservatory:
    """One observatory per autoscaler (replays never share mutable state
    with a prior run).

    ``cost_model`` gates the cost model (``costmodel.analyze_cost``), read
    once per NEW (route, signature) and opt-in (``--perf-cost-model``), as
    in the JAX package. ``peak_flops`` (None: ``default_peak_flops()``)
    divides the utilization. Compile telemetry and residency accounting
    are always on. The port's copy of ``autoscaler_tpu/perf/
    observatory.py``."""

    def __init__(
        self,
        metrics: Any = None,
        cost_model: bool = False,
        ring_capacity: int = 64,
        peak_flops: Optional[float] = None,
    ):
        self._lock = threading.Lock()
        self.metrics = metrics
        self.cost_model_enabled = bool(cost_model)
        self.residency = ResidencyLedger(metrics=metrics)
        self._ring: "deque[Dict[str, Any]]" = deque(
            maxlen=max(int(ring_capacity), 1)
        )
        self._stats: Dict[Tuple[str, str], _RouteStats] = {}
        self._costs: Dict[Tuple[str, str], Optional[Dict[str, float]]] = {}
        self._pending = threading.local()
        self._tick: Optional[Dict[str, Any]] = None
        self._peak_flops = (
            float(peak_flops) if peak_flops else default_peak_flops()
        )

    # -- dispatch boundary (estimator/binpacking calls these) ----------------
    def note_kernel(
        self, fn: Any, args: Tuple[Any, ...], kwargs: Dict[str, Any]
    ) -> None:
        """Called just before a device-kernel invocation: derives the shape
        signature and operand footprint of THIS dispatch and parks the call
        for the matching :meth:`on_dispatch` (same thread, same dispatch).
        Host rungs skip this — they get split telemetry without a cost
        record."""
        sig = shape_signature(args, kwargs)
        op_bytes = operand_bytes(args, kwargs)
        self.residency.set(POOL_KERNEL_OPERANDS, "dispatch", op_bytes)
        self._pending.slot = (fn, args, kwargs, sig, op_bytes)

    def _take_pending(
        self,
    ) -> Optional[Tuple[Any, tuple, dict, str, int]]:
        slot = getattr(self._pending, "slot", None)
        self._pending.slot = None
        return slot

    def clear_pending(self) -> None:
        """Drop any parked call on THIS thread — the estimator calls this
        before each rung so a prior rung that faulted after its kernel
        entry was observed cannot leak its call onto the next rung's
        record. The operand bytes that call seated are released with it:
        a faulted rung's arrays are not in flight, and leaving them
        seated would stamp a dead dispatch's operands into the tick's
        residency snapshot when a host rung ends up serving."""
        if getattr(self._pending, "slot", None) is not None:
            self.residency.drop(POOL_KERNEL_OPERANDS, "dispatch")
        self._pending.slot = None

    def on_dispatch(self, route: str, wall_s: float, span: Any = None) -> None:
        """Record one served dispatch: compile-vs-execute split, cache
        verdict, cost-model attrs — onto the span, the metrics, and the
        open tick record. ``wall_s`` is the caller's timeline-clock
        measurement (deterministic under a synthetic clock)."""
        pending = self._take_pending()
        if pending is not None:
            fn, args, kwargs, sig, op_bytes = pending
        else:
            fn, args, kwargs, sig, op_bytes = None, (), {}, "", 0
        key = (route, sig)
        with self._lock:
            known = key in self._costs
        cost: Optional[Dict[str, float]] = None
        if not known and fn is not None and self.cost_model_enabled:
            # the model of a new (route, signature), read outside the lock
            cost = analyze_cost(route, args, kwargs)
        rec: Dict[str, Any] = {
            "route": route,
            "sig": sig,
            "operand_bytes": int(op_bytes),
            "dispatch_s": round(float(wall_s), 9),
        }
        with self._lock:
            stats = self._stats.get(key)
            if stats is None:
                stats = self._stats[key] = _RouteStats()
            stats.dispatches += 1
            cold = stats.first_wall is None
            if cold:
                stats.first_wall = float(wall_s)
                stats.first_tick = (
                    self._tick.get("tick") if self._tick is not None else None
                )
                if key not in self._costs:
                    self._costs[key] = cost
            else:
                stats.warm.append(float(wall_s))
                del stats.warm[:-_WARM_WINDOW]
            cost = self._costs.get(key)
            rec["cold"] = cold
            rec["cache"] = "miss" if cold else "hit"
            if not cold:
                warm = stats.warm
                median = sorted(warm)[len(warm) // 2]
                rec["execute_est_s"] = round(median, 9)
                rec["compile_est_s"] = round(
                    max(float(stats.first_wall) - median, 0.0), 9
                )
                if cost and cost.get("flops") and median > 0:
                    rec["utilization"] = round(
                        float(cost["flops"]) / (median * self._peak_flops), 9
                    )
            if cost is not None:
                rec["cost"] = dict(sorted(cost.items()))
            if self._tick is not None:
                self._tick["dispatches"].append(rec)
        self._feed(route, rec)
        if span is not None:
            self._annotate(span, rec)

    def _feed(self, route: str, rec: Dict[str, Any]) -> None:
        m = self.metrics
        if m is None:
            return
        if rec["cold"]:
            m.kernel_compile_seconds.observe(rec["dispatch_s"], route=route)
            m.kernel_compile_cache_total.inc(route=route, outcome="miss")
        else:
            m.kernel_execute_seconds.observe(rec["dispatch_s"], route=route)
            m.kernel_compile_cache_total.inc(route=route, outcome="hit")
        if "utilization" in rec:
            m.kernel_model_utilization.set(rec["utilization"], route=route)

    @staticmethod
    def _annotate(span: Any, rec: Dict[str, Any]) -> None:
        """Span attributes for this dispatch. Plain attrs, not wall attrs:
        the measurements come from the timeline clock, so they replay
        byte-identically."""
        attrs: Dict[str, Any] = {
            "cold": rec["cold"],
            "cache": rec["cache"],
            "dispatch_s": rec["dispatch_s"],
        }
        if rec.get("sig"):
            attrs["shape_sig"] = rec["sig"]
        if rec.get("operand_bytes"):
            attrs["operand_bytes"] = rec["operand_bytes"]
        for k in ("execute_est_s", "compile_est_s", "utilization"):
            if k in rec:
                attrs[k] = rec[k]
        cost = rec.get("cost")
        if cost:
            if "flops" in cost:
                attrs["model_flops"] = cost["flops"]
            if "bytes_accessed" in cost:
                attrs["model_bytes"] = cost["bytes_accessed"]
            if "peak_bytes" in cost:
                attrs["model_peak_bytes"] = cost["peak_bytes"]
        span.set_attrs(**attrs)

    def note_arena(self, stats: Dict[str, int]) -> None:
        """Stamp the resident arena's per-tick counters (delta rows,
        full uploads, promotions, rollbacks — snapshot/arena.take_stats)
        into the open tick record. Values are pure functions of the
        world's mutation stream, so they replay byte-identically; a tick
        with no arena activity records nothing. Summed if called twice
        (a tick may flush stats around a crash boundary)."""
        clean = {k: int(v) for k, v in sorted(stats.items())}
        if not any(clean.values()):
            return
        with self._lock:
            if self._tick is None:
                return
            prev = self._tick.get("arena")
            if prev is None:
                self._tick["arena"] = clean
            else:
                for k, v in clean.items():
                    prev[k] = prev.get(k, 0) + v

    # -- tick lifecycle (StaticAutoscaler.run_once) --------------------------
    def begin_tick(self, tick_id: int, now_ts: float) -> None:
        with self._lock:
            self._tick = {
                "schema": ledger_mod.SCHEMA,
                "tick": int(tick_id),
                "now_ts": float(now_ts),
                "dispatches": [],
            }

    def end_tick(self) -> Optional[Dict[str, Any]]:
        """Finalize the open tick record: stamp the residency snapshot,
        push it into the ring, return it. None when no tick is open (bare
        component calls). The ``kernel_operands`` pool is released after
        the snapshot — it accounts THIS tick's in-flight dispatch arrays,
        and leaving it seated would report the last dispatch's operands as
        live through every idle tick that follows (and keep a faulted
        rung's bytes on the books)."""
        resident = self.residency.snapshot()
        self.residency.drop(POOL_KERNEL_OPERANDS, "dispatch")
        with self._lock:
            rec = self._tick
            self._tick = None
            if rec is None:
                return None
            rec["resident_bytes"] = resident
            self._ring.append(rec)
            return rec

    # -- queries (/perfz) ----------------------------------------------------
    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def last_record(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def summaries(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {
                    "tick": r["tick"],
                    "now_ts": r["now_ts"],
                    "dispatches": len(r["dispatches"]),
                    "compiles": sum(
                        1 for d in r["dispatches"] if d.get("cold")
                    ),
                    "resident_bytes": dict(r.get("resident_bytes", {})),
                }
                for r in self._ring
            ]

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
