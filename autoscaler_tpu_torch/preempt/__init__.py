"""Priority-aware preemption, as far as the port has it: the
PriorityClass / preemptionPolicy semantics of ``policy`` (the flight
journal reads ``evictable_mask``). The engine and its kernel
(``autoscaler_tpu/preempt/engine.py``, ``ops/preempt.py``) are not ported
(ROADMAP queue 1, the preemption kernel item).
"""
