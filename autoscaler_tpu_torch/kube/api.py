"""Cluster API boundary — the host's write path to the orchestration plane.

The reference talks to the Kubernetes API server via client-go typed clients
and the eviction API (cluster-autoscaler/core/scaledown/actuation/drain.go:83,
utils/taints/taints.go, utils/kubernetes/listers.go:38). This framework keeps
that boundary behind a small interface so the control loop is testable
in-process (FakeClusterAPI) and bindable to any real control plane.

The port's copy of ``autoscaler_tpu/kube/api.py``.
"""
from __future__ import annotations

import abc
import copy
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.kube.objects import (
    DaemonSet,
    DELETION_CANDIDATE_TAINT,
    NO_SCHEDULE,
    PREFER_NO_SCHEDULE,
    TO_BE_DELETED_TAINT,
    Node,
    Pod,
    PodDisruptionBudget,
    Taint,
)


class EvictionError(Exception):
    pass


class ClusterAPI(abc.ABC):
    """List/watch + write operations the autoscaler needs."""

    @abc.abstractmethod
    def list_nodes(self) -> List[Node]: ...

    @abc.abstractmethod
    def list_pods(self) -> List[Pod]: ...

    def list_pdbs(self) -> List[PodDisruptionBudget]:
        return []

    def list_daemonsets(self) -> List[DaemonSet]:
        """apps/v1 DaemonSets for --force-ds template charging; default
        empty for implementations without an apps store."""
        return []

    @abc.abstractmethod
    def evict_pod(self, pod: Pod) -> None:
        """Eviction-API analog; raises EvictionError on PDB rejection."""

    def pod_exists(self, pod_key: str) -> bool:
        """Whether the pod object is still present — the drain path polls
        this (bounded by termination grace + eviction headroom) to confirm
        evicted pods actually terminated (reference actuation/drain.go:83).
        Implementations without cheap lookups may return False (skip wait)."""
        return False

    @abc.abstractmethod
    def add_taint(self, node_name: str, taint: Taint) -> None: ...

    @abc.abstractmethod
    def remove_taint(self, node_name: str, taint_key: str) -> None: ...

    @abc.abstractmethod
    def delete_node_object(self, node_name: str) -> None:
        """Remove the Node object after cloud deletion."""

    def cordon_node(self, node_name: str) -> None:
        """Mark the node unschedulable (kubectl cordon) — used when
        --cordon-node-before-terminating is set (reference
        utils/taints + actuator cordon path). Default: no-op."""

    def uncordon_node(self, node_name: str) -> None:
        """Undo cordon_node on a node whose deletion failed — without the
        rollback a surviving node would stay unschedulable forever.
        Default: no-op."""

    def record_event(self, kind: str, name: str, reason: str, message: str) -> None:
        pass

    def write_configmap(self, namespace: str, name: str, data: dict) -> None:
        """Create-or-update a ConfigMap (the status ConfigMap write,
        reference clusterstate.go:701 WriteStatusConfigMap). Default no-op
        for implementations without a config store."""

    def read_configmap(self, namespace: str, name: str) -> Optional[dict]:
        """ConfigMap data dict, or None if absent (the priority expander's
        live config read, reference expander/priority/priority.go). Default
        None for implementations without a config store."""
        return None


@dataclass
class FakeClusterAPI(ClusterAPI):
    """In-memory control plane for tests and local simulation. Thread-safe:
    the actuator drains nodes from a worker pool."""

    nodes: Dict[str, Node] = field(default_factory=dict)
    pods: Dict[str, Pod] = field(default_factory=dict)
    pdbs: List[PodDisruptionBudget] = field(default_factory=list)
    daemonsets: List[DaemonSet] = field(default_factory=list)
    evicted: List[str] = field(default_factory=list)
    events: List[Tuple[str, str, str, str]] = field(default_factory=list)
    configmaps: Dict[Tuple[str, str], Dict] = field(default_factory=dict)
    fail_evictions_for: set = field(default_factory=set)
    # pod key → number of times eviction fails before succeeding (transient
    # failure injection for retry pacing tests)
    eviction_failures: Dict[str, int] = field(default_factory=dict)
    _lock: threading.RLock = field(default_factory=threading.RLock, repr=False)

    def add_node(self, node: Node) -> None:
        with self._lock:
            self.nodes[node.name] = node

    def add_pod(self, pod: Pod) -> None:
        with self._lock:
            self.pods[pod.key()] = pod

    def list_nodes(self) -> List[Node]:
        with self._lock:
            return list(self.nodes.values())

    def list_pods(self) -> List[Pod]:
        with self._lock:
            return list(self.pods.values())

    def list_pdbs(self) -> List[PodDisruptionBudget]:
        with self._lock:
            return list(self.pdbs)

    def list_daemonsets(self) -> List[DaemonSet]:
        with self._lock:
            return list(self.daemonsets)

    def evict_pod(self, pod: Pod) -> None:
        with self._lock:
            key = pod.key()
            if key in self.fail_evictions_for:
                raise EvictionError(f"eviction of {key} rejected")
            remaining = self.eviction_failures.get(key, 0)
            if remaining > 0:
                self.eviction_failures[key] = remaining - 1
                raise EvictionError(f"eviction of {key} transiently rejected")
            self.evicted.append(key)
            self.pods.pop(key, None)

    def pod_exists(self, pod_key: str) -> bool:
        with self._lock:
            return pod_key in self.pods

    # Node writes REPLACE the stored object (copy-on-write) rather than
    # mutating in place: listings must behave like the real client, where
    # every watch event parses a fresh object — IncrementalPacker diffs
    # listings by object identity (snapshot/incremental.py), so an in-place
    # mutation would be invisible to the persistent packed tensors.
    def add_taint(self, node_name: str, taint: Taint) -> None:
        with self._lock:
            node = self.nodes[node_name]
            if not any(t.key == taint.key for t in node.taints):
                updated = copy.copy(node)
                updated.taints = list(node.taints) + [taint]
                self.nodes[node_name] = updated

    def remove_taint(self, node_name: str, taint_key: str) -> None:
        with self._lock:
            node = self.nodes.get(node_name)
            if node and any(t.key == taint_key for t in node.taints):
                updated = copy.copy(node)
                updated.taints = [t for t in node.taints if t.key != taint_key]
                self.nodes[node_name] = updated

    def cordon_node(self, node_name: str) -> None:
        with self._lock:
            node = self.nodes.get(node_name)
            if node and not node.unschedulable:
                updated = copy.copy(node)
                updated.unschedulable = True
                self.nodes[node_name] = updated

    def uncordon_node(self, node_name: str) -> None:
        with self._lock:
            node = self.nodes.get(node_name)
            if node and node.unschedulable:
                updated = copy.copy(node)
                updated.unschedulable = False
                self.nodes[node_name] = updated

    def delete_node_object(self, node_name: str) -> None:
        with self._lock:
            self.nodes.pop(node_name, None)
            for key, pod in list(self.pods.items()):
                if pod.node_name == node_name:
                    del self.pods[key]

    def record_event(self, kind: str, name: str, reason: str, message: str) -> None:
        with self._lock:
            self.events.append((kind, name, reason, message))

    def write_configmap(self, namespace: str, name: str, data: dict) -> None:
        with self._lock:
            self.configmaps[(namespace, name)] = dict(data)

    def read_configmap(self, namespace: str, name: str) -> Optional[dict]:
        with self._lock:
            data = self.configmaps.get((namespace, name))
            return dict(data) if data is not None else None

    def delete_configmap(self, namespace: str, name: str) -> None:
        with self._lock:
            self.configmaps.pop((namespace, name), None)


def to_be_deleted_taint() -> Taint:
    """reference utils/taints: ToBeDeletedByClusterAutoscaler NoSchedule."""
    return Taint(key=TO_BE_DELETED_TAINT, value="", effect=NO_SCHEDULE)


def deletion_candidate_taint() -> Taint:
    """reference utils/taints: DeletionCandidateOfClusterAutoscaler
    PreferNoSchedule (soft taint)."""
    return Taint(key=DELETION_CANDIDATE_TAINT, value="", effect=PREFER_NO_SCHEDULE)
