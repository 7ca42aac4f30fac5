"""Scenario spec: the declarative description of one control-loop drill.

The port's copy of ``autoscaler_tpu/loadgen/spec.py``, with the port's
device rungs (``KERNEL_FAULT_RUNGS``; the JAX package's names load through
``JAX_RUNG_NAMES``).

A scenario is (cluster shape, timed events, synthetic workloads, faults,
autoscaler knobs). Everything is a plain dataclass with an exact JSON
round-trip — ``ScenarioSpec.from_dict(spec.to_dict()) == spec`` — so canned
scenarios live as reviewable JSON and
captured traces replay byte-for-byte.

Event kinds (``Event.kind``):

- ``pod_burst``      — ``count`` pending pods arrive (cpu_m/mem_mb/labels/
                       spread_zone_skew for a DoNotSchedule zone constraint)
- ``pod_complete``   — up to ``count`` running pods whose name starts with
                       ``prefix`` terminate (completions / scale-in of the
                       workload itself)
- ``node_flap``      — ``count`` ready nodes of ``group`` go NotReady for
                       ``duration_ticks`` ticks, then recover
- ``resize``         — the group's cloud target is set out-of-band (an
                       operator or another controller resizing the MIG)
- ``fault``          — arm a FaultSpec mid-run (``fault`` payload); the
                       fault's own ``start_tick`` is relative to the event
- ``clear_faults``   — disarm every active fault

Faults (``FaultSpec.kind``) target the provider/kube boundary:

- ``scale_up_error``  — increase_size raises (cloud rejects the resize);
                        drives the orchestrator's register_failed_scale_up
                        → ExponentialBackoff path
- ``instance_error``  — created instances surface InstanceErrorInfo (the
                        clusterapi failed-machine / GCE instance-error
                        path) → deleteCreatedNodesWithErrors
- ``stuck_creating``  — created instances never register (no Node object)
                        → provision-timeout → failed-scale-up backoff
- ``provider_latency``— refresh()/nodes() report ``latency_s`` of injected
                        latency per call (recorded; optionally slept)
- ``refresh_error``   — provider.refresh() raises → loop-level error path
- ``eviction_error``  — evictions rejected (PDB analog) with ``probability``
- ``spot_reclaim``    — bound pods with priority < ``priority_cutoff`` on
                        the target group's nodes are re-pended (the cloud
                        reclaiming spot capacity out from under low-priority
                        work); drives the preemption-engine drills

Device / API faults (this is what certifies the degradation ladder and the
crash-only loop — see ARCHITECTURE.md "Resilience"):

- ``kernel_fault``    — the estimator kernel rung named by ``rung``
                        (``cuda``/``torch``; "" = both device rungs) fails
                        at dispatch → circuit breaker trips → decisions
                        flow on the native/python rungs off the card (on
                        a card a cuda-rung fault raises: the tick records
                        the typed error)
- ``device_lost``     — both device rungs fail (device-loss analog);
                        ``rung`` is ignored
- ``kube_api_error``  — the cluster-API listing inside run_once raises →
                        exercises the crash-only loop (the tick records an
                        error; the process keeps looping)
- ``arena_fault``     — the resident device arena's delta apply fails →
                        the faulted tick serves from a cold upload (the
                        live arena is never corrupted) and the arena
                        reseeds next tick (double-buffer rollback; only
                        fires when the scenario enables ``arena_enabled``)
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

MB = 1024 * 1024

EVENT_KINDS = (
    "pod_burst",
    "pod_complete",
    "node_flap",
    "resize",
    "fault",
    "clear_faults",
)
FAULT_KINDS = (
    "scale_up_error",
    "instance_error",
    "stuck_creating",
    "provider_latency",
    "refresh_error",
    "eviction_error",
    "kernel_fault",
    "device_lost",
    "kube_api_error",
    # template_node_info raises for the targeted group — the orchestrator
    # skips it with SkipReason.NO_TEMPLATE (decision-provenance scenarios)
    "template_error",
    # the resident arena's delta apply fails → cold-upload fallback +
    # next-tick reseed (double-buffer rollback certification)
    "arena_fault",
    # -- process-level fleet chaos: driven through the fleet
    # driver's submit/dispatch seams so outage → shed → recovery replays
    # byte-identically on the sim clock --
    # the sidecar process is dead: every submit in the window fails typed
    # unavailable (the client-side view of a crashed endpoint); the SLO
    # burn alert must fire during the outage and clear after recovery
    "sidecar_crash",
    # the network to the sidecar is gone: same shed shape as a crash but
    # a distinct kind, so scenarios can separate process death from
    # partition in the ledger
    "sidecar_partition",
    # RPC service is slow: latency_s of sim-clock latency folded into each
    # ticket's service stamps — slow answers reach the SLIs/SLO exactly
    # as real slowness would
    "rpc_slow",
    # -- multi-replica fleet chaos: consumed by the fleet
    # driver's replica router (balancer-picked endpoint per request) so
    # rolling restarts and flapping endpoints certify the health-weighted
    # rebalancing byte-identically on the sim clock --
    # replica `replica` is DOWN for the window (a rolling restart / pod
    # kill): requests routed there fail unavailable and the balancer
    # fails over; with >= 2 replicas a restart must be a non-event
    "replica_restart",
    # replica `replica` flaps: each consultation is down with
    # `probability` (seeded RNG) — the flapping-endpoint case the
    # health-weighted picker exists to starve of first-attempt traffic
    "endpoint_flap",
    # -- preemption chaos: the cloud reclaims spot capacity —
    # bound pods with priority < `priority_cutoff` on the target group's
    # nodes ("" = every group) are re-pended group-wide at the window
    # start, refilling the pending queue with exactly the low-priority
    # work the preemption engine and churn-aware expander must re-place
    "spot_reclaim",
)
# estimator rungs a kernel_fault may target ("" = every device rung)
KERNEL_FAULT_RUNGS = ("", "cuda", "torch")
# the JAX package's device rungs, read as the port's: a spec written for
# the JAX package (``pallas``/``xla``) loads unchanged, and writes back the
# port's names (the rung entry of the label name map between the packages)
JAX_RUNG_NAMES = {"pallas": "cuda", "xla": "torch"}
WORKLOAD_KINDS = ("steady", "diurnal", "spike", "drain_heavy")


class SpecError(ValueError):
    """A scenario document that doesn't describe a runnable scenario."""


@dataclass
class NodeGroupSpec:
    """One scalable set of identical nodes in the scripted cloud."""

    name: str
    min_size: int = 0
    max_size: int = 10
    initial_size: int = 1
    cpu_m: float = 4000.0
    mem_mb: float = 16384.0
    pods: float = 110.0
    zone: str = ""            # sets topology.kubernetes.io/zone when nonempty
    labels: Dict[str, str] = field(default_factory=dict)
    price_per_hour: float = 1.0
    # ticks between the cloud accepting a resize and the Node registering
    # ready (the boot cycle the upcoming-node logic reasons about)
    provision_ticks: int = 1


@dataclass
class FaultSpec:
    kind: str = "scale_up_error"
    # which node group the fault hits; "" = all groups
    group: str = ""
    # fraction of eligible calls that fail, decided by the scenario RNG
    probability: float = 1.0
    start_tick: int = 0
    # inclusive-exclusive window; None = until cleared / end of run
    end_tick: Optional[int] = None
    latency_s: float = 0.0          # provider_latency
    error_class: str = "OTHER"      # instance_error: OUT_OF_RESOURCES|QUOTA_EXCEEDED|OTHER
    # kernel_fault: which estimator rung fails ("" = both device rungs)
    rung: str = ""
    # replica_restart / endpoint_flap: which fleet replica index the fault
    # targets (required >= 0 for those kinds; -1 = not a replica fault)
    replica: int = -1
    # spot_reclaim: bound pods with priority strictly below this are
    # re-pended (0 with the default pod priority of 0 reclaims nothing —
    # a reclaim scenario must set it)
    priority_cutoff: int = 0
    message: str = "injected fault"

    def __post_init__(self):
        self.rung = JAX_RUNG_NAMES.get(self.rung, self.rung)
        if self.kind not in FAULT_KINDS:
            raise SpecError(f"unknown fault kind {self.kind!r} (one of {FAULT_KINDS})")
        if not 0.0 <= self.probability <= 1.0:
            raise SpecError(f"fault probability {self.probability} outside [0, 1]")
        if self.rung and self.kind != "kernel_fault":
            raise SpecError(
                f"fault field 'rung' only applies to kernel_fault, not {self.kind!r}"
            )
        if self.kind in ("replica_restart", "endpoint_flap"):
            if self.replica < 0:
                raise SpecError(
                    f"fault kind {self.kind!r} needs a target `replica` "
                    "index >= 0 (which endpoint restarts/flaps)"
                )
        elif self.replica != -1:
            raise SpecError(
                "fault field 'replica' only applies to "
                f"replica_restart/endpoint_flap, not {self.kind!r}"
            )
        if self.group and self.kind in (
            "kernel_fault", "device_lost", "kube_api_error", "arena_fault",
            "sidecar_crash", "sidecar_partition", "rpc_slow",
            "replica_restart", "endpoint_flap",
        ):
            # these faults hit process-wide seams (the kernel ladder, the
            # cluster listing) — a group scope would be silently ignored
            # (or, for kube_api_error, silently disable the fault)
            raise SpecError(
                f"fault kind {self.kind!r} is not group-scoped; drop 'group'"
            )
        if self.kind == "kernel_fault" and self.rung not in KERNEL_FAULT_RUNGS:
            raise SpecError(
                f"kernel_fault rung {self.rung!r} (one of {KERNEL_FAULT_RUNGS})"
            )
        if self.priority_cutoff != 0 and self.kind != "spot_reclaim":
            raise SpecError(
                "fault field 'priority_cutoff' only applies to "
                f"spot_reclaim, not {self.kind!r}"
            )
        if self.kind == "spot_reclaim" and self.priority_cutoff <= 0:
            raise SpecError(
                "spot_reclaim needs priority_cutoff > 0 (bound pods with "
                "priority below it are re-pended; 0 reclaims nothing)"
            )

    def active(self, tick: int) -> bool:
        if tick < self.start_tick:
            return False
        return self.end_tick is None or tick < self.end_tick


@dataclass
class Event:
    at_tick: int
    kind: str
    group: str = ""                 # node_flap / resize target
    count: int = 0                  # pods / nodes / resize target size
    cpu_m: float = 500.0            # pod_burst request
    mem_mb: float = 512.0
    labels: Dict[str, str] = field(default_factory=dict)
    prefix: str = ""                # pod_complete name filter
    duration_ticks: int = 1         # node_flap outage length
    # pod_burst: when > 0, pods carry a DoNotSchedule zone-spread
    # constraint with this max_skew (exercises the within-wave kernels)
    spread_zone_skew: int = 0
    # pod_burst: PriorityClass value the pods carry (feeds the expendable
    # cutoff, FOS ordering and the preemption engine's priority channel)
    priority: int = 0
    # pod_burst: "Never" pins preemptionPolicy=Never (the pods wait for
    # capacity instead of evicting); "" = default policy (may preempt)
    preemption_policy: str = ""
    fault: Optional[FaultSpec] = None

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise SpecError(f"unknown event kind {self.kind!r} (one of {EVENT_KINDS})")
        if self.at_tick < 0:
            raise SpecError(f"event at_tick {self.at_tick} is negative")
        if self.kind == "fault" and self.fault is None:
            raise SpecError("fault event without a fault payload")
        if self.preemption_policy not in ("", "Never"):
            raise SpecError(
                f"unknown preemption_policy {self.preemption_policy!r} "
                "(one of '', 'Never')"
            )


@dataclass
class WorkloadSpec:
    """A synthetic generator expanded into pod_burst/pod_complete events by
    ``loadgen.workloads`` before the run starts (so a recorded trace holds
    only concrete events)."""

    kind: str = "steady"
    # average pending-pod arrivals per tick (peak rate for diurnal/spike)
    rate: float = 5.0
    cpu_m: float = 500.0
    mem_mb: float = 512.0
    start_tick: int = 0
    end_tick: Optional[int] = None
    period_ticks: int = 48          # diurnal: one day; spike: inter-burst gap
    # fraction of arrived pods completing per tick (drain_heavy churns hard)
    completion_rate: float = 0.0
    spread_zone_skew: int = 0
    # PriorityClass value every pod of this workload carries, and whether
    # those pods may preempt ("" = default policy; "Never" = wait-only) —
    # threaded verbatim into the expanded pod_burst events
    priority: int = 0
    preemption_policy: str = ""
    labels: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in WORKLOAD_KINDS:
            raise SpecError(
                f"unknown workload kind {self.kind!r} (one of {WORKLOAD_KINDS})"
            )
        if self.rate < 0:
            raise SpecError(f"workload rate {self.rate} is negative")
        if self.preemption_policy not in ("", "Never"):
            raise SpecError(
                f"unknown preemption_policy {self.preemption_policy!r} "
                "(one of '', 'Never')"
            )


@dataclass
class TenantSpec:
    """One synthetic tenant of a fleet scenario: an autoscaler posting
    estimate questions of a fixed (pods, groups) shape. Request CONTENT is
    drawn per round from the scenario RNG keyed (seed, tenant index,
    round), so two replays generate identical request streams."""

    name: str
    pods: int = 16
    groups: int = 4
    max_nodes: int = 32
    cpu_m: float = 500.0         # request magnitude scale
    mem_mb: float = 512.0
    whatif: bool = False         # attach per-group prices → what-if ranking
    # storm intensity: how many requests this tenant posts per round (>1
    # models a tenant over its --fleet-tenant-qps quota — the overload
    # scenarios' admission-shed driver; content stays RNG-keyed per copy)
    requests_per_round: int = 1
    # per-request deadline budget in seconds carried into the ticket
    # (0 = no deadline): the coalescer sheds queue-expired tickets typed
    deadline_s: float = 0.0

    def __post_init__(self):
        if self.pods <= 0 or self.groups <= 0:
            raise SpecError(
                f"tenant {self.name!r} needs positive pods/groups, got "
                f"{self.pods}/{self.groups}"
            )
        if self.max_nodes <= 0:
            raise SpecError(
                f"tenant {self.name!r} max_nodes must be positive"
            )
        if self.requests_per_round < 1:
            raise SpecError(
                f"tenant {self.name!r} requests_per_round must be >= 1"
            )
        if self.deadline_s < 0:
            raise SpecError(
                f"tenant {self.name!r} deadline_s must be >= 0"
            )


@dataclass
class FleetSpec:
    """The fleet-serving drill: ``ticks`` coalescing rounds, each
    tenant posting one estimate request per round; the driver certifies
    every fleet answer byte-identical to a solo dispatch of the same
    operands (loadgen/fleetdrive.py). Faults ride the scenario's normal
    fault list — a ``kernel_fault`` on the ``cuda`` rung hits the fleet
    ladder's batched rung on a card (``torch`` off it).

    ``replicas`` models the serving side as N sidecar endpoints behind
    the health-weighted balancer: each request is routed to a
    balancer-picked replica first, ``replica_restart``/``endpoint_flap``
    faults take individual replicas down, and the chosen endpoint rides
    the decision ledger so rebalancing replays byte-identically."""

    tenants: List[TenantSpec] = field(default_factory=list)
    replicas: int = 1

    def __post_init__(self):
        if not self.tenants:
            raise SpecError("fleet scenario needs at least one tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise SpecError(f"duplicate tenant names in {names}")
        if self.replicas < 1:
            raise SpecError(
                f"fleet replicas must be >= 1, got {self.replicas}"
            )


@dataclass
class ScenarioSpec:
    name: str
    seed: int = 0
    ticks: int = 20
    tick_interval_s: float = 10.0
    node_groups: List[NodeGroupSpec] = field(default_factory=list)
    events: List[Event] = field(default_factory=list)
    workloads: List[WorkloadSpec] = field(default_factory=list)
    faults: List[FaultSpec] = field(default_factory=list)
    # AutoscalingOptions overrides (pythonized field name → value); the
    # driver starts from scenario-friendly defaults (no cooldowns, short
    # unneeded time) and applies these on top
    options: Dict[str, Any] = field(default_factory=dict)
    # fleet-serving drill: when set, the scenario drives the coalescing
    # estimator service instead of the control loop (ticks = coalescing
    # rounds; node_groups/workloads are unused and may be empty)
    fleet: Optional[FleetSpec] = None

    def __post_init__(self):
        if self.ticks <= 0:
            raise SpecError(f"ticks must be positive, got {self.ticks}")
        if self.tick_interval_s <= 0:
            raise SpecError(
                f"tick_interval_s must be positive, got {self.tick_interval_s}"
            )
        if self.fleet is not None:
            if self.workloads:
                raise SpecError(
                    "fleet scenarios drive the estimator service, not the "
                    "control loop — drop `workloads`"
                )
        elif not self.node_groups:
            raise SpecError("scenario needs at least one node group")
        names = [g.name for g in self.node_groups]
        if len(set(names)) != len(names):
            raise SpecError(f"duplicate node group names in {names}")
        late = [e.at_tick for e in self.events if e.at_tick >= self.ticks]
        if late:
            raise SpecError(
                f"events at ticks {late} never fire: the run ends at tick "
                f"{self.ticks - 1} (raise `ticks` or move the events)"
            )
        # replica faults must name a replica that exists — an out-of-range
        # index would be silently inert and let a chaos gate pass without
        # ever exercising failover (the same fail-loudly stance every
        # other misapplied fault field gets)
        replica_faults = [
            f for f in self.faults
            if f.kind in ("replica_restart", "endpoint_flap")
        ] + [
            e.fault for e in self.events
            if e.fault is not None
            and e.fault.kind in ("replica_restart", "endpoint_flap")
        ]
        if replica_faults:
            if self.fleet is None:
                raise SpecError(
                    "replica_restart/endpoint_flap faults need a `fleet` "
                    "section (they target fleet replicas)"
                )
            bad = sorted({
                f.replica for f in replica_faults
                if f.replica >= self.fleet.replicas
            })
            if bad:
                raise SpecError(
                    f"replica fault targets {bad} are out of range: the "
                    f"fleet has {self.fleet.replicas} replicas "
                    f"(indices 0..{self.fleet.replicas - 1})"
                )

    # -- JSON round-trip -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return _strip(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "ScenarioSpec":
        if not isinstance(doc, dict):
            raise SpecError(f"scenario document must be an object, got {type(doc)}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - known
        if unknown:
            raise SpecError(f"unknown scenario fields {sorted(unknown)}")
        kw = dict(doc)
        kw["node_groups"] = [
            _load(NodeGroupSpec, g) for g in doc.get("node_groups", [])
        ]
        kw["events"] = [_load_event(e) for e in doc.get("events", [])]
        kw["workloads"] = [_load(WorkloadSpec, w) for w in doc.get("workloads", [])]
        kw["faults"] = [_load(FaultSpec, f) for f in doc.get("faults", [])]
        fleet = doc.get("fleet")
        if fleet is not None:
            if not isinstance(fleet, dict):
                raise SpecError(
                    f"fleet section must be an object, got {type(fleet)}"
                )
            unknown_fleet = set(fleet) - {"tenants", "replicas"}
            if unknown_fleet:
                raise SpecError(
                    f"unknown fleet fields {sorted(unknown_fleet)}"
                )
            kw["fleet"] = FleetSpec(
                tenants=[_load(TenantSpec, t) for t in fleet.get("tenants", [])],
                replicas=int(fleet.get("replicas", 1)),
            )
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "ScenarioSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


def _strip(value):
    """Drop default-y noise (None, empty containers) so canned JSON stays
    reviewable; from_dict fills the defaults back, keeping the round-trip
    exact for any spec built from JSON."""
    if isinstance(value, dict):
        return {
            k: _strip(v)
            for k, v in value.items()
            if v is not None and v != {} and v != []
        }
    if isinstance(value, list):
        return [_strip(v) for v in value]
    return value


def _load(cls, doc: Dict[str, Any]):
    if not isinstance(doc, dict):
        raise SpecError(f"{cls.__name__} entry must be an object, got {type(doc)}")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(doc) - known
    if unknown:
        raise SpecError(f"unknown {cls.__name__} fields {sorted(unknown)}")
    return cls(**doc)


def _load_event(doc: Dict[str, Any]) -> Event:
    doc = dict(doc)
    fault = doc.pop("fault", None)
    if fault is not None:
        doc["fault"] = _load(FaultSpec, fault)
    return _load(Event, doc)
