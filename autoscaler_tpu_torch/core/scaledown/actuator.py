"""Scale-down actuation: taint → evict → delete, concurrent with budgets,
pacing, and batching.

Reference: cluster-autoscaler/core/scaledown/actuation/ —
Actuator.StartDeletion actuator.go:80 (budget crop :126 → sync taint :187 →
async empty :156 / drain :206 → per-node scheduleDeletion goroutine :356 →
batcher), Evictor drain.go:83,90 (time-budgeted retry loop: EvictionRetryTime
between attempts, MaxPodEvictionTime per pod, then a wait for actual pod
termination bounded by grace + PodEvictionHeadroom; DaemonSet best-effort
eviction :178), NodeDeletionBatcher delete_in_batch.go:71,115 (per-group
batched DeleteNodes on a timer), soft taints softtaint.go:31,77 (bulk
PreferNoSchedule budget).

Like the reference's goroutines, node drains here run on a thread pool
bounded by max_scale_down_parallelism (the cloud/API calls are IO-bound, so
threads are the right host-side concurrency primitive). start_deletion joins
the wave by default so the control loop keeps its synchronous contract; the
NodeDeletionTracker stays the cross-loop source of truth either way.

The port's copy of ``autoscaler_tpu/core/scaledown/actuator.py``. The workers
see host objects only (nodes, pods, the provider and the API), never a
tensor.
"""
from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.cloudprovider.interface import CloudProvider, NodeGroup
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.core.scaledown.planner import ScaleDownPlan
from autoscaler_tpu_torch.core.scaledown.tracking import NodeDeletionTracker
from autoscaler_tpu_torch.kube.api import (
    ClusterAPI,
    EvictionError,
    deletion_candidate_taint,
    to_be_deleted_taint,
)
from autoscaler_tpu_torch.kube.objects import (
    DELETION_CANDIDATE_TAINT,
    TO_BE_DELETED_TAINT,
    Node,
    Pod,
)
from autoscaler_tpu_torch.simulator.removal import NodeToRemove
from autoscaler_tpu_torch.utils.errors import to_autoscaler_error


@dataclass
class ActuationResult:
    deleted_empty: List[str] = field(default_factory=list)
    deleted_drain: List[str] = field(default_factory=list)
    failed: Dict[str, str] = field(default_factory=dict)
    evicted_pods: List[str] = field(default_factory=list)


class Evictor:
    """reference actuation/drain.go:83 DrainNodeWithPods — per-pod eviction
    with a time-budgeted retry loop, then a bounded wait for the evicted
    pods to actually disappear. clock/sleep are injectable for tests."""

    def __init__(
        self,
        api: ClusterAPI,
        options: AutoscalingOptions,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.api = api
        self.options = options
        self.clock = clock
        self.sleep = sleep

    def drain_node(
        self, node: Node, pods: Sequence[Pod], tracker: NodeDeletionTracker, now_ts: float
    ) -> Tuple[bool, List[str]]:
        evicted: List[str] = []
        for pod in pods:
            if not self._evict_with_retry(pod):
                return False, evicted
            tracker.register_eviction(pod.key(), now_ts)
            evicted.append(pod.key())
        self._wait_pods_gone(pods)
        return True, evicted

    def _evict_with_retry(self, pod: Pod) -> bool:
        """Retry until MaxPodEvictionTime elapses, pausing EvictionRetryTime
        between attempts (drain.go:90). Always makes at least one attempt."""
        deadline = self.clock() + self.options.max_pod_eviction_time_s
        while True:
            try:
                self.api.evict_pod(pod)
                return True
            except EvictionError:
                if self.clock() >= deadline:
                    return False
                self.sleep(self.options.eviction_retry_time_s)

    def _wait_pods_gone(self, pods: Sequence[Pod]) -> None:
        """Bounded confirmation that evicted pods terminated: grace period
        plus PodEvictionHeadroom (drain.go:123-140)."""
        budget = (
            self.options.max_graceful_termination_s
            + self.options.pod_eviction_headroom_s
        )
        deadline = self.clock() + budget
        remaining = [p.key() for p in pods]
        while remaining and self.clock() < deadline:
            remaining = [k for k in remaining if self.api.pod_exists(k)]
            if remaining:
                self.sleep(0.5)

    def evict_daemonset_pods(self, pods: Sequence[Pod]) -> List[str]:
        """Best-effort DaemonSet eviction (reference actuation/drain.go:177):
        failures never block the node deletion, and PDBs are not simulated —
        the eviction API enforces them server-side (the reference has the
        same behavior)."""
        evicted: List[str] = []
        for pod in pods:
            try:
                self.api.evict_pod(pod)
                evicted.append(pod.key())
            except EvictionError:
                pass
        return evicted


class NodeDeletionBatcher:
    """reference actuation/delete_in_batch.go:71 — collect nodes per group;
    with a positive interval the FIRST add for a group arms a timer that
    flushes that group's batch as one DeleteNodes call (:115); interval 0
    means flush-per-add. Thread-safe: drain workers add concurrently.

    on_result(node, group_id, error_or_None) fires once per node when its
    batch flushes."""

    def __init__(
        self,
        provider: CloudProvider,
        interval_s: float = 0.0,
        on_result: Optional[Callable[[Node, str, Optional[str]], None]] = None,
    ):
        self.provider = provider
        self.interval_s = interval_s
        self.on_result = on_result
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight = 0
        self._pending: Dict[str, List[Node]] = {}
        self._timers: Dict[str, threading.Timer] = {}

    def add_node(self, group: NodeGroup, node: Node) -> None:
        gid = group.id()
        with self._lock:
            self._pending.setdefault(gid, []).append(node)
            if self.interval_s <= 0:
                pass  # flushed below, outside the lock
            elif gid not in self._timers:
                t = threading.Timer(self.interval_s, self._flush_group, args=(gid,))
                t.daemon = True
                self._timers[gid] = t
                t.start()
        if self.interval_s <= 0:
            self._flush_group(gid)

    def _take_group(self, gid: str) -> List[Node]:
        """Pop a group's batch; a non-empty take marks a flush in flight so
        flush() can join timer flushes that already popped their nodes."""
        with self._lock:
            timer = self._timers.pop(gid, None)
            if timer is not None:
                timer.cancel()
            nodes = self._pending.pop(gid, [])
            if nodes:
                self._inflight += 1
            return nodes

    def _flush_group(
        self, gid: str, groups: Optional[Dict[str, NodeGroup]] = None
    ) -> Dict[str, Optional[str]]:
        nodes = self._take_group(gid)
        if not nodes:
            return {}
        try:
            if groups is None:
                groups = {g.id(): g for g in self.provider.node_groups()}
            group = groups.get(gid)
            if group is None:
                err: Optional[str] = f"group {gid} no longer exists"
            else:
                try:
                    group.delete_nodes(nodes)
                    err = None
                except Exception as e:
                    # typed wrapping: str() is preserved for non-empty
                    # messages, and an empty one gains the exception class
                    err = str(to_autoscaler_error(e))
            if self.on_result is not None:
                for node in nodes:
                    self.on_result(node, gid, err)
            return {gid: err}
        finally:
            with self._idle:
                self._inflight -= 1
                self._idle.notify_all()

    def flush(self) -> Dict[str, Optional[str]]:
        """Force-flush everything now (cancels pending timers) and JOIN any
        timer flush already mid-delete, so callers get the full wave's
        results before returning. The control loop uses this to close a
        deletion wave synchronously."""
        with self._lock:
            gids = list(self._pending.keys())
        results: Dict[str, Optional[str]] = {}
        groups = {g.id(): g for g in self.provider.node_groups()} if gids else {}
        for gid in gids:
            results.update(self._flush_group(gid, groups))
        with self._idle:
            while self._inflight > 0:
                self._idle.wait()
        return results


class ScaleDownActuator:
    def __init__(
        self,
        provider: CloudProvider,
        options: AutoscalingOptions,
        api: ClusterAPI,
        tracker: Optional[NodeDeletionTracker] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.provider = provider
        self.options = options
        self.api = api
        self.tracker = tracker or NodeDeletionTracker()
        self.sleep = sleep
        self.evictor = Evictor(api, options, clock=clock, sleep=sleep)

    # -- reference actuator.go:80 -------------------------------------------
    def start_deletion(self, plan: ScaleDownPlan, now_ts: float) -> ActuationResult:
        result = ActuationResult()
        result_lock = threading.Lock()
        empty = plan.empty[: self.options.max_empty_bulk_delete]
        drain = plan.drain[: self.options.max_drain_parallelism]

        def rollback_node(name: str) -> None:
            """A node that survives a failed/aborted deletion must return
            to service: taint off, and cordon off if we cordoned it — else
            it stays unschedulable forever (reference CleanToBeDeleted
            uncordons when the flag is set). Independent attempts: a failed
            taint removal must not skip the uncordon, and a cordon that
            landed server-side before its call raised must still be undone."""
            try:
                self.api.remove_taint(name, TO_BE_DELETED_TAINT)
            except Exception as e:
                # best-effort by design, but the swallow must not be
                # silent: a node left tainted is invisible to schedulers
                # until the next loop re-reconciles it
                logging.getLogger("scaledown").debug(
                    "rollback: taint removal on %s failed: %s",
                    name,
                    to_autoscaler_error(e),
                )
            if self.options.cordon_node_before_terminating:
                try:
                    self.api.uncordon_node(name)
                except Exception as e:
                    logging.getLogger("scaledown").debug(
                        "rollback: uncordon of %s failed: %s",
                        name,
                        to_autoscaler_error(e),
                    )

        # 1. taint everything up front, atomically-ish (actuator.go:95,111);
        # roll back taints on nodes we end up not deleting.
        for r in empty + drain:
            try:
                self.api.add_taint(r.node.name, to_be_deleted_taint())
                if self.options.cordon_node_before_terminating:
                    self.api.cordon_node(r.node.name)
            except Exception as e:
                # typed wrapping keeps str() identical for non-empty
                # messages, so the result map reads the same downstream
                result.failed[r.node.name] = (
                    f"taint failed: {to_autoscaler_error(e)}"
                )
                rollback_node(r.node.name)
        empty = [r for r in empty if r.node.name not in result.failed]
        drain = [r for r in drain if r.node.name not in result.failed]

        was_drain: Dict[str, bool] = {}

        def on_batch_result(node: Node, gid: str, err: Optional[str]) -> None:
            if err:
                self.tracker.end_deletion(gid, node.name, ok=False, error=err, ts=now_ts)
                with result_lock:
                    result.failed[node.name] = err
                rollback_node(node.name)
                return
            self.api.delete_node_object(node.name)
            self.tracker.end_deletion(gid, node.name, ok=True, ts=now_ts)
            with result_lock:
                (
                    result.deleted_drain if was_drain[node.name] else result.deleted_empty
                ).append(node.name)
            self.api.record_event(
                "Node", node.name, "ScaleDown", "node removed by autoscaler"
            )

        batcher = NodeDeletionBatcher(
            self.provider,
            interval_s=self.options.node_deletion_batcher_interval_s,
            on_result=on_batch_result,
        )

        def delete_empty(r: NodeToRemove, group: NodeGroup) -> None:
            """actuator.go:156 deleteAsyncEmpty — no drain simulation, just
            optional best-effort DS eviction then the batched cloud delete."""
            if self.options.node_delete_delay_after_taint_s > 0:
                # scheduler gets time to observe the ToBeDeleted taint
                # (actuator.go NodeDeleteDelayAfterTaint); paid inside the
                # worker so parallel waves overlap the pause
                self.sleep(self.options.node_delete_delay_after_taint_s)
            if self.options.daemonset_eviction_for_empty_nodes:
                evicted = self.evictor.evict_daemonset_pods(r.daemonset_pods)
                with result_lock:
                    result.evicted_pods.extend(evicted)
            batcher.add_node(group, r.node)

        def delete_drain(r: NodeToRemove, group: NodeGroup) -> None:
            """actuator.go:206,356 scheduleDeletion — evict (paced), then
            hand the node to the batcher; eviction failure rolls the taint
            back and never reaches the cloud call."""
            if self.options.node_delete_delay_after_taint_s > 0:
                self.sleep(self.options.node_delete_delay_after_taint_s)
            ok, evicted = self.evictor.drain_node(
                r.node, r.pods_to_reschedule, self.tracker, now_ts
            )
            with result_lock:
                result.evicted_pods.extend(evicted)
            if ok and self.options.daemonset_eviction_for_occupied_nodes:
                ds_evicted = self.evictor.evict_daemonset_pods(r.daemonset_pods)
                with result_lock:
                    result.evicted_pods.extend(ds_evicted)
            if not ok:
                self.tracker.end_deletion(
                    group.id(), r.node.name, ok=False, error="eviction failed", ts=now_ts
                )
                with result_lock:
                    result.failed[r.node.name] = "eviction failed"
                rollback_node(r.node.name)
                return
            batcher.add_node(group, r.node)

        def run_guarded(fn, r: NodeToRemove, group: NodeGroup) -> None:
            """An unexpected error in a worker must still close out the
            node's deletion (end_deletion + taint rollback) — an unretrieved
            future exception would otherwise leak the node in the tracker as
            being-deleted forever."""
            try:
                fn(r, group)
            except Exception as e:
                # one typed rendering feeds both the tracker and the
                # result map so they can never disagree about the cause
                msg = str(to_autoscaler_error(e))
                self.tracker.end_deletion(
                    group.id(), r.node.name, ok=False, error=msg, ts=now_ts
                )
                with result_lock:
                    result.failed[r.node.name] = msg
                rollback_node(r.node.name)

        # 2. fan the wave out on a bounded worker pool (the goroutine analog).
        workers = max(1, self.options.max_scale_down_parallelism)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for r, is_drain, fn in [(r, False, delete_empty) for r in empty] + [
                (r, True, delete_drain) for r in drain
            ]:
                group = self.provider.node_group_for_node(r.node)
                if group is None:
                    result.failed[r.node.name] = "no node group"
                    # the up-front taint/cordon must not outlive the abort
                    rollback_node(r.node.name)
                    continue
                was_drain[r.node.name] = is_drain
                self.tracker.start_deletion(group.id(), r.node.name, drain=is_drain)
                pool.submit(run_guarded, fn, r, group)
        # 3. close the wave: one batched cloud delete per group
        # (delete_in_batch.go:115), even if the batch timer hasn't fired.
        batcher.flush()
        return result

    # -- soft taints (reference softtaint.go:31,77) --------------------------
    def update_soft_deletion_taints(
        self, all_nodes: Sequence[Node], unneeded_names: Sequence[str]
    ) -> int:
        """Keep DeletionCandidate (PreferNoSchedule) taints in sync with the
        current unneeded set, bounded by the bulk count budget AND the time
        budget (reference softtaint.go:77 — each taint is one API round
        trip, and a slow control plane must not let this housekeeping eat
        the whole tick). The clock is the tracer's timeline seam, so the
        budget check replays deterministically under loadgen."""
        from autoscaler_tpu_torch import trace

        budget = self.options.max_bulk_soft_taint_count
        time_budget = self.options.max_bulk_soft_taint_time_s
        t0 = trace.timeline_now()
        changed = 0
        unneeded = set(unneeded_names)
        for node in all_nodes:
            if changed >= budget:
                break
            if time_budget > 0 and trace.timeline_now() - t0 > time_budget:
                break
            has = any(t.key == DELETION_CANDIDATE_TAINT for t in node.taints)
            if node.name in unneeded and not has:
                self.api.add_taint(node.name, deletion_candidate_taint())
                changed += 1
            elif node.name not in unneeded and has:
                self.api.remove_taint(node.name, DELETION_CANDIDATE_TAINT)
                changed += 1
        return changed

    def clean_up_to_be_deleted_taints(self, nodes: Sequence[Node]) -> int:
        """Startup cleanup of leftover ToBeDeleted taints from a crashed
        predecessor (reference static_autoscaler.go:230-248)."""
        removed = 0
        for node in nodes:
            if any(t.key == TO_BE_DELETED_TAINT for t in node.taints):
                if not self.tracker.is_being_deleted(node.name):
                    self.api.remove_taint(node.name, TO_BE_DELETED_TAINT)
                    removed += 1
        return removed
