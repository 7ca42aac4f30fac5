"""Synthetic workload generators: WorkloadSpec → concrete timed events.

Expansion happens ONCE, before the run starts, from a generator-indexed
substream of the scenario seed — so the resolved event list (the trace) is
the single source of randomness-free truth the driver executes. KIS-S
(arxiv 2507.07932) replays inference traffic against the autoscaler the
same way: the load process is fixed up front, only the controller under
test reacts.

Shapes:

- ``steady``      — Poisson arrivals at ``rate``/tick, optional completions
- ``diurnal``     — sinusoidal day: rate × (1 + sin) / 2 over period_ticks
- ``spike``       — near-idle background with a burst of ``rate × period``
                    pods every ``period_ticks``
- ``drain_heavy`` — heavy completions against a modest arrival stream, the
                    scale-down-dominated regime (utilization collapses and
                    the planner must drain)
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from autoscaler_tpu_torch.loadgen.spec import Event, ScenarioSpec, SpecError, WorkloadSpec


def expand_workloads(spec: ScenarioSpec) -> List[Event]:
    """All generator-produced events for the scenario, deterministic in
    (spec.seed, generator index). Returned unsorted; the driver merges them
    with the explicit event list and orders by (at_tick, insertion)."""
    out: List[Event] = []
    for wi, wl in enumerate(spec.workloads):
        rng = np.random.default_rng((spec.seed, 7919, wi))
        out.extend(_expand_one(wl, wi, spec.ticks, rng))
    return out


def _expand_one(
    wl: WorkloadSpec, wi: int, ticks: int, rng: np.random.Generator
) -> List[Event]:
    end = min(wl.end_tick if wl.end_tick is not None else ticks, ticks)
    prefix = f"wl{wi}-{wl.kind}"
    events: List[Event] = []
    arrived = 0
    window = max(end - wl.start_tick, 1)
    for tick in range(wl.start_tick, end):
        rate = _rate_at(wl, tick, window)
        n = int(rng.poisson(rate)) if rate > 0 else 0
        if n > 0:
            events.append(
                Event(
                    at_tick=tick,
                    kind="pod_burst",
                    count=n,
                    cpu_m=wl.cpu_m,
                    mem_mb=wl.mem_mb,
                    labels={"workload": prefix, **wl.labels},
                    prefix=prefix,
                    spread_zone_skew=wl.spread_zone_skew,
                    priority=wl.priority,
                    preemption_policy=wl.preemption_policy,
                )
            )
            arrived += n
        if wl.completion_rate > 0 and arrived > 0:
            done = int(rng.binomial(arrived, min(wl.completion_rate, 1.0)))
            if done > 0:
                events.append(
                    Event(
                        at_tick=tick, kind="pod_complete", count=done,
                        prefix=prefix,
                    )
                )
                arrived -= done
    return events


def _rate_at(wl: WorkloadSpec, tick: int, window: int) -> float:
    t = tick - wl.start_tick
    if wl.kind == "steady":
        return wl.rate
    if wl.kind == "diurnal":
        if wl.period_ticks <= 0:
            raise SpecError("diurnal workload needs period_ticks > 0")
        phase = 2.0 * math.pi * t / wl.period_ticks
        return wl.rate * (1.0 + math.sin(phase)) / 2.0
    if wl.kind == "spike":
        if wl.period_ticks <= 0:
            raise SpecError("spike workload needs period_ticks > 0")
        # one tick of burst per period, 2% trickle in between
        return wl.rate * wl.period_ticks if t % wl.period_ticks == 0 else wl.rate * 0.02
    if wl.kind == "drain_heavy":
        # front-loaded arrivals that stop two-thirds in: the tail of the run
        # is pure completion pressure (the scale-down regime)
        return wl.rate if t < 2 * window // 3 else 0.0
    raise SpecError(f"unknown workload kind {wl.kind!r}")
