"""Declarative SLO targets.

An :class:`SloSpec` names one service-level objective over one SLI event
stream: a latency threshold every event is judged against (good/bad) and a
target good-fraction, evaluated as multi-window error-budget burn rates
(the Google SRE workbook's multiwindow multi-burn-rate alert shape — the
same SLO-driven signals KIS-S uses to judge autoscaling policies).

The default catalog covers the three request-lifecycle surfaces the system
now has:

- ``fleet_e2e`` — a fleet tenant's submit→resolve latency through the
  coalescing estimator service (the per-ticket stamps on the
  ``trace.timeline_now()`` seam, fleet/coalescer.py);
- ``tick_run_once`` — one control-loop reconcile tick's duration
  (the timeline extent of the ``main`` span, core/static_autoscaler.py);
- ``pending_pod`` — how long a pod stays pending, tracked from the explain
  ring's per-tick still-pending set (explain/record.py): a pod's SLI event
  fires when it leaves the pending set (good if it resolved inside the
  threshold) or the first tick it overstays the threshold (bad, once).

Specs are plain frozen dataclasses so fleet drivers, the control loop, and
tests can declare their own; everything downstream (engine, ledger,
/sloz) is spec-driven.

The port's copy of ``autoscaler_tpu/slo/spec.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# SLI stream names (closed vocabulary — ledger records and metrics labels
# use exactly these)
SLI_FLEET_E2E = "fleet_e2e"
SLI_TICK_DURATION = "tick_run_once"
SLI_PENDING_POD = "pending_pod"


class SloError(ValueError):
    """An SloSpec that cannot mean what an SLO means."""


@dataclass(frozen=True)
class SloSpec:
    """One objective: ``target`` fraction of events must land within
    ``threshold_s``, watched over ``windows_s`` burn-rate windows."""

    name: str
    description: str
    target: float                 # good-event fraction objective, in (0, 1)
    threshold_s: float            # per-event latency objective
    # burn-rate windows, seconds (short → fast page, long → slow page);
    # the classic pairing is (300, 3600)
    windows_s: Tuple[float, ...] = (300.0, 3600.0)
    # page when the burn rate over EVERY window meets this factor — the
    # multiwindow guard against paging on one bad minute (14.4 = the SRE
    # workbook's 2%-budget-in-1h pace)
    burn_alert: float = 14.4

    def validate(self) -> None:
        if not self.name:
            raise SloError("SloSpec needs a name")
        if not (0.0 < self.target < 1.0):
            raise SloError(
                f"slo {self.name!r}: target must be in (0, 1) — a target of "
                f"1.0 has no error budget to burn (got {self.target})"
            )
        if self.threshold_s <= 0:
            raise SloError(
                f"slo {self.name!r}: threshold_s must be positive "
                f"(got {self.threshold_s})"
            )
        if not self.windows_s or any(w <= 0 for w in self.windows_s):
            raise SloError(
                f"slo {self.name!r}: windows_s must be positive "
                f"(got {self.windows_s})"
            )
        if self.burn_alert <= 0:
            raise SloError(
                f"slo {self.name!r}: burn_alert must be positive "
                f"(got {self.burn_alert})"
            )

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target


def fleet_slos() -> Tuple[SloSpec, ...]:
    """The serving-side objective — for processes that RUN a fleet
    coalescer (the loadgen fleet driver; a sidecar embedder passing
    ``serve(slo=...)``). A process with no coalescer must NOT declare it:
    an objective that can never receive events reports a permanently
    healthy fleet, which is worse than not reporting one."""
    return (
        SloSpec(
            name=SLI_FLEET_E2E,
            description="fleet BatchEstimate submit→resolve p99 within 1s",
            target=0.99,
            threshold_s=1.0,
        ),
    )


def control_loop_slos() -> Tuple[SloSpec, ...]:
    """The control-loop catalog: tick duration and the pod-facing
    pending-latency objective — the two SLI streams run_once itself
    produces."""
    return (
        SloSpec(
            name=SLI_TICK_DURATION,
            description="run_once reconcile tick p99 within 1s",
            target=0.99,
            threshold_s=1.0,
        ),
        SloSpec(
            name=SLI_PENDING_POD,
            description="95% of pending pods schedule within 60s",
            target=0.95,
            threshold_s=60.0,
        ),
    )


def default_slos() -> Tuple[SloSpec, ...]:
    """The full catalog (generic engines, tests)."""
    return fleet_slos() + control_loop_slos()
