"""Scenario engine: trace-driven replay, synthetic load generation, and
fault injection for the full control loop.

The reference autoscaler is exercised end-to-end by kubemark +
cluster-loader worlds (proposals/scalability_tests.md); unit fixtures can't
answer "what does the loop DO over 200 iterations of a diurnal trace with a
flaky cloud". This package is that substrate: a scripted cluster (fake
provider + fake kube API + fake clock) driven through the real
``StaticAutoscaler.run_once``, with every decision recorded and scored.

Layers (ARCHITECTURE.md "Scenario engine"):

- ``spec``      — ScenarioSpec dataclasses + strict JSON round-trip
- ``workloads`` — synthetic generators (steady / diurnal / spike / drain)
                  expanded deterministically from a seed into timed events
- ``faults``    — fault-injection wrappers for the cloud provider and kube
                  API (error classes, probability, latency, stuck-CREATING)
- ``driver``    — the tick loop: apply events → run_once → materialize the
                  cloud → bind pods (kubelet+scheduler analog) → record
- ``fleetdrive``— the fleet drill: K tenants through the coalescing
                  estimator service, every answer byte-certified against a
                  solo dispatch (scenarios with a ``fleet`` section)
- ``score``     — report: pending-pod latency percentiles, provisioned vs
                  optimal, decision counts, per-tick wall time
- ``cli``       — ``python -m autoscaler_tpu_torch.loadgen run <scenario.json>``

Determinism contract: a scenario (spec + seed) resolves to a byte-stable
event trace, and one trace produces one decision log — ``run`` twice and
diff nothing. Traces can be captured (``--trace``) and replayed
(``replay``) so a flaky-looking run is pinned exactly.

The port of ``autoscaler_tpu/loadgen/``: the drivers take an explicit
``device`` (None = the first CUDA card, ``"cpu"`` for the host), and on the
CPU every decision log, report (wall fields aside) and fleet verdict equals
the JAX package's, its rung names read as the port's.
"""
from autoscaler_tpu_torch.loadgen.driver import ScenarioDriver, run_scenario
from autoscaler_tpu_torch.loadgen.spec import (
    Event,
    FaultSpec,
    FleetSpec,
    NodeGroupSpec,
    ScenarioSpec,
    TenantSpec,
    WorkloadSpec,
)

__all__ = [
    "Event",
    "FaultSpec",
    "FleetSpec",
    "NodeGroupSpec",
    "ScenarioDriver",
    "ScenarioSpec",
    "TenantSpec",
    "WorkloadSpec",
    "run_scenario",
]
