"""PolicySpec: the typed action space of the policy gym.

An *action* is not a flag string — it is a declared point in a bounded
knob space (the knobs ROADMAP item 4 names as hand-tuned today: expander
strategy, scale-down aggressiveness, breaker/ladder cooldowns). The spec
is applied through the existing AutoscalingOptions override seam (the
loadgen ``--set`` machinery): ``to_overrides()`` yields the exact dict a
``--set KEY=VALUE`` series would, and the driver's
``config.options.validate_overrides`` schema gate runs on top. Bounds are
enforced HERE, before any rollout: an out-of-range candidate raises
:class:`PolicyError` naming the knob — it never silently clamps, because a
clamped candidate would score as a policy nobody proposed.

Stdlib only: the tuner, the CLI renderers and the ledger all round-trip
PolicySpec through plain dicts.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple


class PolicyError(ValueError):
    """A PolicySpec outside the declared knob space (unknown knob or
    out-of-bounds value) — candidates fail loudly, never clamp."""


@dataclass(frozen=True)
class Knob:
    """One tunable dimension: its kind, bounds/choices, the nominal
    baseline (the driver-default value CE sampling centers on when a
    candidate leaves the knob unset), and the production flag it renders
    to in ``gym apply``."""

    name: str
    kind: str                       # "float" | "int" | "choice"
    lo: float = 0.0
    hi: float = 0.0
    choices: Tuple[str, ...] = ()
    baseline: Any = None
    flag: str = ""
    values_key: str = ""            # deploy/chart values.yaml key


# THE knob space — the single declaration validation, sampling (gym/tune),
# the docs knob table and the apply renderers all read.
KNOB_SPACE: Tuple[Knob, ...] = (
    Knob(
        "expander", "choice",
        choices=("least-waste", "most-pods", "price", "random"),
        baseline="least-waste", flag="--expander", values_key="expander",
    ),
    Knob(
        "scale_down_utilization_threshold", "float", lo=0.05, hi=0.95,
        baseline=0.5, flag="--scale-down-utilization-threshold",
        values_key="scaleDownUtilizationThreshold",
    ),
    Knob(
        "scale_down_unneeded_time_s", "float", lo=0.0, hi=3600.0,
        baseline=20.0, flag="--scale-down-unneeded-time",
        values_key="scaleDownUnneededTime",
    ),
    Knob(
        "scale_down_delay_after_add_s", "float", lo=0.0, hi=3600.0,
        baseline=0.0, flag="--scale-down-delay-after-add",
        values_key="scaleDownDelayAfterAdd",
    ),
    Knob(
        "kernel_breaker_cooldown_s", "float", lo=1.0, hi=3600.0,
        baseline=120.0, flag="--kernel-breaker-cooldown",
        values_key="kernelBreakerCooldown",
    ),
    Knob(
        "kernel_breaker_failure_threshold", "int", lo=1, hi=10,
        baseline=3, flag="--kernel-breaker-failure-threshold",
        values_key="kernelBreakerFailureThreshold",
    ),
    # expander churn penalty per planned eviction an option leaves
    # uncovered (0 = churn-blind); only bites when the scenario enables
    # preemption_enabled — on priority-flat scenarios the filter
    # disengages and any value scores identically
    Knob(
        "preemption_churn_weight", "float", lo=0.0, hi=100.0,
        baseline=0.0, flag="--preemption-churn-weight",
        values_key="preemptionChurnWeight",
    ),
)

KNOBS: Dict[str, Knob] = {k.name: k for k in KNOB_SPACE}


def _check_value(knob: Knob, value: Any) -> None:
    if knob.kind == "choice":
        if value not in knob.choices:
            raise PolicyError(
                f"knob {knob.name!r}: {value!r} not one of {knob.choices}"
            )
        return
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise PolicyError(
            f"knob {knob.name!r}: wants a number in [{knob.lo}, {knob.hi}], "
            f"got {type(value).__name__} ({value!r})"
        )
    if knob.kind == "int" and int(value) != value:
        raise PolicyError(
            f"knob {knob.name!r}: wants an integer in "
            f"[{int(knob.lo)}, {int(knob.hi)}], got {value!r}"
        )
    if not knob.lo <= value <= knob.hi:
        raise PolicyError(
            f"knob {knob.name!r}: {value!r} outside [{knob.lo}, {knob.hi}] "
            "(candidates fail loudly, never clamp)"
        )


@dataclass(frozen=True)
class PolicySpec:
    """One candidate policy. ``None`` leaves the knob at the environment's
    default — the all-``None`` spec IS the all-defaults baseline candidate
    every tune must beat."""

    expander: Optional[str] = None
    scale_down_utilization_threshold: Optional[float] = None
    scale_down_unneeded_time_s: Optional[float] = None
    scale_down_delay_after_add_s: Optional[float] = None
    kernel_breaker_cooldown_s: Optional[float] = None
    kernel_breaker_failure_threshold: Optional[int] = None
    preemption_churn_weight: Optional[float] = None

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        for knob in KNOB_SPACE:
            value = getattr(self, knob.name)
            if value is not None:
                _check_value(knob, value)

    def is_default(self) -> bool:
        return all(getattr(self, k.name) is None for k in KNOB_SPACE)

    def resolved(self, name: str) -> Any:
        """The knob's effective nominal value (set value, else baseline) —
        what CE sampling and the apply renderers read."""
        value = getattr(self, name)
        return KNOBS[name].baseline if value is None else value

    # -- the AutoscalingOptions seam ------------------------------------------
    def to_overrides(self) -> Dict[str, Any]:
        """→ the ``--set``-shaped override dict (set knobs only); merged
        into ScenarioSpec.options and schema-checked by the driver's
        validate_overrides gate like any other override."""
        out: Dict[str, Any] = {}
        for k in KNOB_SPACE:
            value = getattr(self, k.name)
            if value is None:
                continue
            if k.kind == "int":
                value = int(value)      # 3.0 from a sampler is the int knob 3
            elif k.kind == "float":
                value = float(value)
            out[k.name] = value
        return out

    # -- round-trip ------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return self.to_overrides()

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "PolicySpec":
        if not isinstance(doc, dict):
            raise PolicyError(f"policy must be an object, got {type(doc)}")
        unknown = set(doc) - set(KNOBS)
        if unknown:
            raise PolicyError(
                f"unknown policy knobs {sorted(unknown)} "
                f"(the space is {sorted(KNOBS)})"
            )
        return cls(**doc)

    # -- production renderers (gym apply) --------------------------------------
    def render_flags(self) -> str:
        """The winning policy as a main.py flag snippet."""
        parts: List[str] = []
        for knob in KNOB_SPACE:
            value = getattr(self, knob.name)
            if value is None:
                continue
            parts.append(f"{knob.flag}={_render_scalar(knob, value)}")
        return " ".join(parts)

    def render_set_args(self) -> str:
        """The winning policy as a ``loadgen run --set`` snippet."""
        return " ".join(
            f"--set {k.name}={_render_scalar(k, getattr(self, k.name))}"
            for k in KNOB_SPACE
            if getattr(self, k.name) is not None
        )

    def render_values_yaml(self) -> str:
        """The winning policy as a deploy/chart values.yaml fragment
        (camelCase keys under ``autoscaling:``, the chart's convention)."""
        lines = ["autoscaling:"]
        for knob in KNOB_SPACE:
            value = getattr(self, knob.name)
            if value is None:
                continue
            lines.append(f"  {knob.values_key}: {_render_scalar(knob, value)}")
        if len(lines) == 1:
            lines.append("  {}  # all-defaults policy: nothing to override")
        return "\n".join(lines) + "\n"


def _render_scalar(knob: Knob, value: Any) -> str:
    if knob.kind == "choice":
        return str(value)
    if knob.kind == "int":
        return str(int(value))
    # .10g: enough digits that the rendered flag/--set reproduces the
    # winning candidate EXACTLY (%g's 6 significant digits would round a
    # tuned 117.6293 to 117.629 — a policy nobody evaluated)
    return f"{float(value):.10g}"


DEFAULT_POLICY = PolicySpec()
