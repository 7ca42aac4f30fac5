"""Drain policy: which pods may move, which block node removal.

Reference: cluster-autoscaler/utils/drain/drain.go:76
(GetPodsForDeletionOnNodeDrain: mirror/DaemonSet/kube-system/local-storage/
unreplicated/safe-to-evict rules, BlockingPod + reasons :44-50) and
cluster-autoscaler/simulator/drain.go:50 (GetPodsToMove = policy + PDB check
:73). Pure host-side policy — the feasibility arithmetic runs on device
(ops/scaledown.py); this module decides which pods even enter it.

The port's copy of ``autoscaler_tpu/simulator/drain.py``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.kube.objects import (
    SAFE_TO_EVICT_ANNOTATION,
    Pod,
    PodDisruptionBudget,
)


class BlockingReason(enum.Enum):
    """reference: utils/drain/drain.go:50-73."""

    NO_REASON = "NoReason"
    CONTROLLER_NOT_FOUND = "ControllerNotFound"
    NOT_REPLICATED = "NotReplicated"
    LOCAL_STORAGE_REQUESTED = "LocalStorageRequested"
    NOT_SAFE_TO_EVICT_ANNOTATION = "NotSafeToEvictAnnotation"
    UNMOVABLE_KUBE_SYSTEM_POD = "UnmovableKubeSystemPod"
    NOT_ENOUGH_PDB = "NotEnoughPdb"
    MIN_REPLICAS_REACHED = "MinReplicasReached"


@dataclass
class BlockingPod:
    pod: Pod
    reason: BlockingReason


@dataclass
class DrainabilityRules:
    """Knobs mirroring the reference flags (main.go / drain.go callers)."""

    skip_nodes_with_system_pods: bool = True
    skip_nodes_with_local_storage: bool = True
    skip_nodes_with_custom_controller_pods: bool = True
    # a replicated pod whose controller runs fewer than this many replicas
    # blocks drain (reference drain.go:131 MinReplicasReached; replica count
    # approximated by the controller's live pod count, supplied by the
    # caller via owner_replica_counts)
    min_replica_count: int = 0


def _safe_to_evict(pod: Pod) -> Optional[bool]:
    v = pod.annotations.get(SAFE_TO_EVICT_ANNOTATION)
    if v is None:
        return None
    return v.lower() == "true"


def owner_key(pod: Pod) -> Optional[Tuple[str, str, str]]:
    """(namespace, kind, name) of the pod's controller, or None."""
    if pod.owner_ref is None:
        return None
    return (pod.namespace, pod.owner_ref.kind, pod.owner_ref.name)


def count_owner_replicas(all_pods: Sequence[Pod]) -> dict:
    """controller → live pod count, the replica proxy for the MinReplicas
    drain rule (built once per loop from the full pod list)."""
    counts: dict = {}
    for p in all_pods:
        k = owner_key(p)
        if k is not None:
            counts[k] = counts.get(k, 0) + 1
    return counts


def get_pods_for_deletion_on_node_drain(
    pods: Sequence[Pod],
    rules: DrainabilityRules,
    pdbs: Sequence[PodDisruptionBudget] = (),
    owner_replica_counts: Optional[dict] = None,
) -> Tuple[List[Pod], Optional[BlockingPod]]:
    """→ (pods_to_move, first_blocking_pod). Mirror pods are ignored entirely;
    DaemonSet pods are not "moved" (they are evicted best-effort at the end of
    a drain, reference actuation/drain.go:178) so they never appear in either
    output. The first blocking pod aborts, as the reference does."""
    to_move: List[Pod] = []
    for pod in pods:
        if pod.mirror:
            continue
        if pod.daemonset:
            continue
        safe = _safe_to_evict(pod)
        if safe is False:
            return [], BlockingPod(pod, BlockingReason.NOT_SAFE_TO_EVICT_ANNOTATION)
        if safe is not True:
            # controller / replication checks apply unless explicitly safe
            if pod.owner_ref is None or not pod.owner_ref.controller:
                if rules.skip_nodes_with_custom_controller_pods or pod.owner_ref is None:
                    return [], BlockingPod(pod, BlockingReason.NOT_REPLICATED)
            if not pod.restartable:
                return [], BlockingPod(pod, BlockingReason.CONTROLLER_NOT_FOUND)
            if rules.min_replica_count > 0 and owner_replica_counts is not None:
                k = owner_key(pod)
                if (
                    k is not None
                    and owner_replica_counts.get(k, 0) < rules.min_replica_count
                ):
                    return [], BlockingPod(
                        pod, BlockingReason.MIN_REPLICAS_REACHED
                    )
            if rules.skip_nodes_with_local_storage and pod.local_storage:
                return [], BlockingPod(pod, BlockingReason.LOCAL_STORAGE_REQUESTED)
            if rules.skip_nodes_with_system_pods and pod.namespace == "kube-system":
                if not _has_pdb(pod, pdbs):
                    return [], BlockingPod(pod, BlockingReason.UNMOVABLE_KUBE_SYSTEM_POD)
        to_move.append(pod)
    return to_move, None


def _has_pdb(pod: Pod, pdbs: Sequence[PodDisruptionBudget]) -> bool:
    return any(
        pdb.namespace == pod.namespace and pdb.selector.matches(pod.labels)
        for pdb in pdbs
    )


def check_pdbs(
    pods: Sequence[Pod], pdbs: Sequence[PodDisruptionBudget]
) -> Optional[BlockingPod]:
    """PDB gate for a set of pods being moved together (reference
    simulator/drain.go:73): each matching PDB must allow >= 1 disruption per
    matched pod (conservative per-pod accounting, as the reference's
    RemainingPdbTracker does)."""
    remaining = {id(p): p.disruptions_allowed for p in pdbs}
    for pod in pods:
        for pdb in pdbs:
            if pdb.namespace == pod.namespace and pdb.selector.matches(pod.labels):
                if remaining[id(pdb)] <= 0:
                    return BlockingPod(pod, BlockingReason.NOT_ENOUGH_PDB)
                remaining[id(pdb)] -= 1
    return None


def get_pods_to_move(
    pods_on_node: Sequence[Pod],
    rules: DrainabilityRules,
    pdbs: Sequence[PodDisruptionBudget] = (),
    owner_replica_counts: Optional[dict] = None,
) -> Tuple[List[Pod], Optional[BlockingPod]]:
    """Full GetPodsToMove: drain policy then PDB check (simulator/drain.go:50)."""
    to_move, blocking = get_pods_for_deletion_on_node_drain(
        pods_on_node, rules, pdbs, owner_replica_counts
    )
    if blocking is not None:
        return [], blocking
    pdb_block = check_pdbs(to_move, pdbs)
    if pdb_block is not None:
        return [], pdb_block
    return to_move, None


def daemonset_pods_of(pods: Sequence[Pod]) -> List[Pod]:
    """DaemonSet pods eligible for best-effort eviction when their node is
    removed (reference actuation/drain.go:177-188). Mirror pods are managed
    by the kubelet and never evicted. Shared by the empty-node and drained-
    node paths so their eviction sets cannot drift."""
    return [p for p in pods if p.daemonset and not p.mirror]
