"""Fault injection at the cloudprovider / kube-API / device-kernel boundary.

Wraps a ``TestCloudProvider`` (and the driver's eviction path) so scripted
failures exercise the SAME recovery machinery production hits: a rejected
IncreaseSize lands in ``ScaleUpOrchestrator``'s except-branch →
``register_failed_scale_up`` → ``ExponentialBackoff``; an instance created
with ``InstanceErrorInfo`` rides ``instances_with_errors`` →
``deleteCreatedNodesWithErrors``; a stuck-CREATING instance ages through
``unregistered`` → ``long_unregistered`` → provision-timeout backoff.

Device/API faults extend the same discipline to the resilience layer:
``on_kernel_dispatch`` is installed as the estimator ladder's
``fault_hook`` (estimator/ladder.KernelLadder), so ``kernel_fault`` /
``device_lost`` trip the per-rung circuit breakers exactly as a real
kernel build fault or device loss would (on a card a cuda-rung fault
raises instead of descending: the driver records it for the tick); ``on_kube_api`` raises inside
``run_once``'s cluster listing, exercising the crash-only control loop.

The injector is tick-clocked and RNG-seeded by the driver: the SAME
scenario + seed trips the SAME faults on the SAME calls, which is what
makes a recorded fault run replayable.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from autoscaler_tpu_torch.cloudprovider.interface import (
    InstanceErrorClass,
    InstanceErrorInfo,
)
from autoscaler_tpu_torch.estimator.ladder import DEVICE_RUNGS
from autoscaler_tpu_torch.loadgen.spec import FaultSpec

import numpy as np


class InjectedCloudError(Exception):
    """The cloud said no (scripted)."""


class FaultInjector:
    """Holds the active FaultSpecs; consulted by the provider callbacks and
    the driver's cloud materializer. ``tick`` is advanced by the driver."""

    def __init__(self, faults: List[FaultSpec], seed: int, real_sleep: bool = False):
        self._static = list(faults)
        self._armed: List[FaultSpec] = []   # armed mid-run via fault events
        self._rng = np.random.default_rng((seed, 104729))
        self.tick = 0
        self.real_sleep = real_sleep
        self.injected: Dict[str, int] = {}   # fault kind → times it fired
        self.injected_latency_s = 0.0

    # -- driver wiring -------------------------------------------------------
    def arm(self, fault: FaultSpec, at_tick: int) -> None:
        """A ``fault`` event: the spec's window is relative to the event."""
        import dataclasses

        self._armed.append(
            dataclasses.replace(
                fault,
                start_tick=at_tick + fault.start_tick,
                end_tick=(
                    None if fault.end_tick is None else at_tick + fault.end_tick
                ),
            )
        )

    def clear(self) -> None:
        self._armed.clear()
        self._static = []

    def _active(self, kind: str, group: str) -> Optional[FaultSpec]:
        for f in self._static + self._armed:
            if f.kind != kind or not f.active(self.tick):
                continue
            # group-scoped faults fire ONLY on calls attributed to that
            # group; group-less calls (refresh, unresolved nodes) are
            # reachable by global faults alone
            if f.group and f.group != group:
                continue
            if f.probability >= 1.0 or self._rng.random() < f.probability:
                return f
        return None

    def _note(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1

    def _first_firing(self, kinds, match=None) -> Optional[str]:
        """First fault of ``kinds`` (kind-major over static+armed, the
        shared iteration order every injection point uses) that is active
        this tick, passes ``match``, and wins its probability draw. The
        draw order is part of the byte-identical-replay contract: one rng
        draw per matching sub-1.0-probability fault, in this exact
        sequence."""
        for kind in kinds:
            for f in self._static + self._armed:
                if f.kind != kind or not f.active(self.tick):
                    continue
                if match is not None and not match(f):
                    continue
                if f.probability >= 1.0 or self._rng.random() < f.probability:
                    self._note(kind)
                    return kind
        return None

    # -- injection points ----------------------------------------------------
    def on_refresh(self) -> None:
        self._latency("")
        f = self._active("refresh_error", "")
        if f is not None:
            self._note("refresh_error")
            raise InjectedCloudError(f.message)

    def on_scale_up(self, group: str, delta: int) -> None:
        """TestCloudProvider's on_scale_up seam: raising rejects the resize
        before the target advances (test_provider.py:81-86)."""
        self._latency(group)
        f = self._active("scale_up_error", group)
        if f is not None:
            self._note("scale_up_error")
            raise InjectedCloudError(f"{f.message} (group {group}, delta {delta})")

    def instance_fate(self, group: str) -> tuple:
        """(error_info, stuck) for one instance the cloud is about to
        create. error_info ≠ None models the clusterapi failed-machine /
        GCE instance-error surface; stuck=True models an instance that
        never registers a Node."""
        f = self._active("instance_error", group)
        if f is not None:
            self._note("instance_error")
            return (
                InstanceErrorInfo(
                    error_class=InstanceErrorClass[f.error_class],
                    error_code="loadgen",
                    error_message=f.message,
                ),
                False,
            )
        f = self._active("stuck_creating", group)
        if f is not None:
            self._note("stuck_creating")
            return None, True
        return None, False

    def on_evict(self, pod_key: str, group: str = "") -> bool:
        """True → reject this eviction (PDB/API-flake analog); ``group`` is
        the node group of the pod's node so group-scoped faults only stall
        their own group's drains."""
        f = self._active("eviction_error", group)
        if f is not None:
            self._note("eviction_error")
            return True
        return False

    def on_kernel_dispatch(self, rung: str) -> Optional[str]:
        """Estimator-ladder fault hook: returns the fault kind when a
        scripted device fault is armed for ``rung``, else None. Only the
        device rungs (``ladder.DEVICE_RUNGS``: cuda, torch) can fault — the
        host rungs are the degradation target and always survive."""
        if rung not in DEVICE_RUNGS:
            return None
        return self._first_firing(
            ("device_lost", "kernel_fault"),
            match=lambda f: (
                f.kind != "kernel_fault" or not f.rung or f.rung == rung
            ),
        )

    def on_fleet_submit(self) -> Optional[str]:
        """Process-level fleet chaos seam (loadgen/fleetdrive.py consults
        it before every tenant submit): an active ``sidecar_crash`` /
        ``sidecar_partition`` makes THIS submit fail typed-unavailable —
        the client-side view of a dead endpoint — instead of reaching the
        coalescer. Returns the fault kind or None."""
        for kind in ("sidecar_crash", "sidecar_partition"):
            f = self._active(kind, "")
            if f is not None:
                self._note(kind)
                return kind
        return None

    def on_replica(self, replica: int) -> Optional[str]:
        """Multi-replica fleet chaos seam (the fleet driver's router
        consults it per routing attempt): is replica ``replica`` down
        RIGHT NOW? ``replica_restart`` downs its target for the whole
        active window (a rolling pod kill); ``endpoint_flap`` downs it
        per-consultation with the fault's ``probability`` on the seeded
        RNG (a flapping endpoint). Returns the fault kind or None.

        Consultation order is the router's deterministic attempt order,
        so the RNG stream — and therefore every flap verdict — replays
        byte-identically."""
        return self._first_firing(
            ("replica_restart", "endpoint_flap"),
            match=lambda f: f.replica == replica,
        )

    def on_rpc_dispatch(self, tenant: str) -> float:
        """``rpc_slow`` seam (the coalescer's latency_hook): sim-clock
        seconds of injected service latency folded into this ticket's
        demux/resolve stamps. Deterministic: consulted in demux order,
        which is submission order."""
        f = self._active("rpc_slow", "")
        if f is not None and f.latency_s > 0:
            self._note("rpc_slow")
            self.injected_latency_s += f.latency_s
            return f.latency_s
        return 0.0

    def on_spot_reclaim(self) -> List[FaultSpec]:
        """spot_reclaim seam (the driver consults it once per tick, after
        events apply): each spot_reclaim fault whose window STARTS this
        tick and wins its probability draw fires exactly once — the
        driver re-pends bound pods with priority < ``priority_cutoff`` on
        the target group's nodes. One-shot-per-window keeps a reclaim a
        discrete cloud event rather than a per-tick bleed, and the single
        draw per firing window is part of the replay contract."""
        fired: List[FaultSpec] = []
        for f in self._static + self._armed:
            if f.kind != "spot_reclaim" or self.tick != f.start_tick:
                continue
            if f.probability >= 1.0 or self._rng.random() < f.probability:
                self._note("spot_reclaim")
                fired.append(f)
        return fired

    def on_arena_apply(self) -> Optional[str]:
        """Resident-arena fault hook (snapshot/arena.DeviceArena
        fault_hook): a truthy return fails THIS tick's delta apply — the
        arena rolls back (live generation intact, tick served from a cold
        upload) and reseeds next tick. Certifies the double-buffer
        rollback path end-to-end under byte-identical replay."""
        f = self._active("arena_fault", "")
        if f is not None:
            self._note("arena_fault")
            return "arena_fault"
        return None

    def on_template(self, group: str) -> None:
        """Template seam (TestNodeGroup.template_node_info, wrapped by the
        driver): raising models a cloud that cannot describe the group's
        machine shape — the orchestrator must skip the group with
        SkipReason.NO_TEMPLATE, never crash the loop."""
        f = self._active("template_error", group)
        if f is not None:
            self._note("template_error")
            raise InjectedCloudError(f"{f.message} (group {group})")

    def on_kube_api(self, op: str) -> None:
        """Cluster-API seam (the listing inside run_once): raising here is
        the apiserver 5xx / connection-reset analog, which the crash-only
        loop must absorb."""
        f = self._active("kube_api_error", "")
        if f is not None:
            self._note("kube_api_error")
            raise InjectedCloudError(f"{f.message} ({op})")

    def _latency(self, group: str) -> None:
        f = self._active("provider_latency", group)
        if f is not None and f.latency_s > 0:
            self._note("provider_latency")
            self.injected_latency_s += f.latency_s
            if self.real_sleep:
                time.sleep(f.latency_s)  # graftlint: disable=GL001 — opt-in wall-latency mode (real_sleep); replay drivers leave it False and count injected_latency_s instead
