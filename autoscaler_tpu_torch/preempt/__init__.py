"""Priority-aware preemption planning (ops/preempt.py is the kernel side).

``policy`` holds the PriorityClass / preemptionPolicy semantics — who may
evict whom; ``engine`` turns one snapshot into a PreemptionPlan (admitted
pending pods, their placements, and the victim→evictor map) by walking the
estimator's kernel ladder. The control loop consumes the plan behind
``--preemption-enabled`` (core/static_autoscaler.py) and the expander
penalizes eviction-heavy scale-up options with its churn score.

The port's copy of ``autoscaler_tpu/preempt/__init__.py``.
"""
from autoscaler_tpu_torch.preempt.engine import PreemptionEngine, PreemptionPlan
from autoscaler_tpu_torch.preempt.policy import (
    can_preempt,
    evictable_mask,
    victim_eligible,
)

__all__ = [
    "PreemptionEngine",
    "PreemptionPlan",
    "can_preempt",
    "evictable_mask",
    "victim_eligible",
]
