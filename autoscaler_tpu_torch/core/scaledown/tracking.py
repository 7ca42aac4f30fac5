"""Scale-down bookkeeping: unneeded-time tracking, unremovable TTL cache,
node deletion tracker, PDB tracker.

Reference:
- unneeded nodes: core/scaledown/unneeded/nodes.go:38 (Update, RemovableAt
  :120 — node must be continuously unneeded for scale_down_unneeded_time /
  unready for scale_down_unready_time, group must stay >= min size, cluster
  resource minimums must hold)
- unremovable cache: core/scaledown/unremovable/nodes.go:30 (TTL re-check)
- deletion tracker: core/scaledown/deletiontracker/nodedeletiontracker.go:32
- PDB tracker: core/scaledown/pdb/pdb.go:26 + basic.go:66,86

The port's copy of ``autoscaler_tpu/core/scaledown/tracking.py``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from autoscaler_tpu_torch.cloudprovider.interface import CloudProvider
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.kube.objects import Node, Pod, PodDisruptionBudget


@dataclass
class _UnneededEntry:
    since_ts: float
    node: Node


class UnneededNodes:
    """Tracks how long each node has been continuously unneeded."""

    def __init__(self) -> None:
        self._entries: Dict[str, _UnneededEntry] = {}

    def reset(self) -> None:
        """Drop all unneeded clocks (the reference's ResetUnneededNodes
        callback, fired when the cluster becomes non-actionable so stale
        timers can't trigger deletions when it resumes)."""
        self._entries.clear()

    def update(self, unneeded: Sequence[Node], now_ts: float) -> None:
        names = {n.name for n in unneeded}
        for name in list(self._entries):
            if name not in names:
                del self._entries[name]
        for node in unneeded:
            if node.name not in self._entries:
                self._entries[node.name] = _UnneededEntry(now_ts, node)
            else:
                self._entries[node.name].node = node

    def names(self) -> List[str]:
        return list(self._entries)

    def since(self, name: str) -> Optional[float]:
        e = self._entries.get(name)
        return e.since_ts if e else None

    def reset_since(self, name: str, now_ts: float) -> None:
        """Restart a node's continuously-unneeded clock — used when pods from
        a just-deleted node were simulated onto it (UsageTracker), since its
        utilization is about to rise."""
        e = self._entries.get(name)
        if e is not None:
            e.since_ts = now_ts

    def removable_at(
        self,
        node: Node,
        now_ts: float,
        options: AutoscalingOptions,
        provider: Optional[CloudProvider] = None,
        nodes_being_deleted_in_group: int = 0,
    ) -> bool:
        """reference unneeded/nodes.go:120 RemovableAt."""
        e = self._entries.get(node.name)
        if e is None:
            return False
        group_opts = options.node_group_defaults
        group = provider.node_group_for_node(node) if provider else None
        if group is not None:
            group_opts = options.group_options(group.id())
        required = (
            group_opts.scale_down_unneeded_time_s
            if node.ready
            else group_opts.scale_down_unready_time_s
        )
        if now_ts - e.since_ts < required:
            return False
        if group is not None:
            remaining = group.target_size() - nodes_being_deleted_in_group - 1
            if remaining < group.min_size():
                return False
        return True


class UnremovableNodesCache:
    """TTL cache so unremovable nodes are not re-simulated every loop
    (reference unremovable/nodes.go:30)."""

    def __init__(self, ttl_s: float = 300.0):
        self.ttl_s = ttl_s
        self._until: Dict[str, float] = {}

    def add(self, node_name: str, now_ts: float) -> None:
        self._until[node_name] = now_ts + self.ttl_s

    def is_recently_unremovable(self, node_name: str, now_ts: float) -> bool:
        return self._until.get(node_name, 0.0) > now_ts

    def clear(self) -> None:
        self._until.clear()


@dataclass
class DeletionResult:
    node_name: str
    group_id: str
    ok: bool
    error: str = ""
    ts: float = 0.0


class NodeDeletionTracker:
    """In-flight deletion accounting (reference
    deletiontracker/nodedeletiontracker.go:32,70-173)."""

    def __init__(self) -> None:
        # deletions run on worker threads (actuator.py) — guard all mutation
        self._lock = threading.Lock()
        self._empty: Dict[str, str] = {}   # node → group
        self._drained: Dict[str, str] = {}
        self._results: List[DeletionResult] = []
        self._evictions: Dict[str, float] = {}  # pod key → ts

    def start_deletion(self, group_id: str, node_name: str, drain: bool) -> None:
        with self._lock:
            (self._drained if drain else self._empty)[node_name] = group_id

    def end_deletion(self, group_id: str, node_name: str, ok: bool, error: str = "", ts: float = 0.0) -> None:
        with self._lock:
            self._empty.pop(node_name, None)
            self._drained.pop(node_name, None)
            self._results.append(DeletionResult(node_name, group_id, ok, error, ts))

    def is_being_deleted(self, node_name: str) -> bool:
        with self._lock:
            return node_name in self._empty or node_name in self._drained

    def deletions_in_group(self, group_id: str) -> int:
        with self._lock:
            return sum(1 for g in self._empty.values() if g == group_id) + sum(
                1 for g in self._drained.values() if g == group_id
            )

    def deletions_count(self, drain: bool) -> int:
        with self._lock:
            return len(self._drained) if drain else len(self._empty)

    def in_flight_names(self) -> List[str]:
        with self._lock:
            return list(self._empty) + list(self._drained)

    def register_eviction(self, pod_key: str, ts: float) -> None:
        with self._lock:
            self._evictions[pod_key] = ts

    def recent_evictions(self, since_ts: float) -> List[str]:
        with self._lock:
            return [k for k, t in self._evictions.items() if t >= since_ts]

    def drain_results(self) -> List[DeletionResult]:
        with self._lock:
            return list(self._results)

    def clear_results(self) -> None:
        with self._lock:
            self._results.clear()


class RemainingPdbTracker:
    """reference pdb/basic.go — per-loop PDB budget accounting."""

    def __init__(self, pdbs: Sequence[PodDisruptionBudget] = ()):
        self._pdbs = list(pdbs)
        self._remaining: Dict[int, int] = {id(p): p.disruptions_allowed for p in self._pdbs}

    def set_pdbs(self, pdbs: Sequence[PodDisruptionBudget]) -> None:
        self._pdbs = list(pdbs)
        self._remaining = {id(p): p.disruptions_allowed for p in self._pdbs}

    def matching(self, pod: Pod) -> List[PodDisruptionBudget]:
        return [
            p
            for p in self._pdbs
            if p.namespace == pod.namespace and p.selector.matches(pod.labels)
        ]

    def can_remove_pods(self, pods: Sequence[Pod]) -> bool:
        """reference basic.go:66 CanRemovePods."""
        need: Dict[int, int] = {}
        for pod in pods:
            for pdb in self.matching(pod):
                need[id(pdb)] = need.get(id(pdb), 0) + 1
        return all(self._remaining.get(k, 0) >= v for k, v in need.items())

    def remove_pods(self, pods: Sequence[Pod]) -> None:
        """reference basic.go:86 RemovePods — commit the budget use."""
        for pod in pods:
            for pdb in self.matching(pod):
                self._remaining[id(pdb)] -= 1

    def pdbs(self) -> List[PodDisruptionBudget]:
        return list(self._pdbs)
