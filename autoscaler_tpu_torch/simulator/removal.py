"""RemovalSimulator: the object-level side of the scale-down device code,
the counterpart of ``autoscaler_tpu/simulator/removal.py``.

Reference: cluster-autoscaler/simulator/cluster.go: RemovalSimulator,
FindNodesToRemove :116, SimulateNodeRemoval :145, FindEmptyNodesToRemove
:187, UnremovableReason enum :56-90. The drain rules run on the host, one
candidate at a time; the refit of all candidates is one
``removal_feasibility`` dispatch on the snapshot's device instead of a
fork/refit/revert a node, and the host reads its outputs back once.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from autoscaler_tpu_torch.kube.objects import Node, Pod, PodDisruptionBudget
from autoscaler_tpu_torch.ops.scaledown import empty_nodes as empty_nodes_kernel
from autoscaler_tpu_torch.ops.scaledown import (
    joint_removal_feasibility,
    joint_removal_feasibility_spread,
    removal_feasibility,
    removal_feasibility_spread,
)
from autoscaler_tpu_torch.simulator.drain import (
    BlockingPod,
    DrainabilityRules,
    count_owner_replicas,
    daemonset_pods_of,
    get_pods_to_move,
)
from autoscaler_tpu_torch.snapshot.affinity import (
    build_spread_context_from_meta,
    has_hard_spread,
)
from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot


class UnremovableReason(enum.Enum):
    """reference: simulator/cluster.go:56-90 (subset exercised here)."""

    NO_REASON = "NoReason"
    BLOCKED_BY_POD = "BlockedByPod"
    NO_PLACE_TO_MOVE_PODS = "NoPlaceToMovePods"
    NOT_UNNEEDED_LONG_ENOUGH = "NotUnneededLongEnough"
    NOT_UNREADY_LONG_ENOUGH = "NotUnreadyLongEnough"
    NODE_GROUP_MIN_SIZE_REACHED = "NodeGroupMinSizeReached"
    MINIMAL_RESOURCE_LIMIT_EXCEEDED = "MinimalResourceLimitExceeded"
    SCALE_DOWN_DISABLED_ANNOTATION = "ScaleDownDisabledAnnotation"
    NOT_UTILIZED_ENOUGH = "NotUnderutilized"
    UNREADY_NOT_ALLOWED = "UnreadyNotAllowed"
    RECENTLY_UNREMOVABLE = "RecentlyUnremovable"


@dataclass
class NodeToRemove:
    node: Node
    pods_to_reschedule: List[Pod] = field(default_factory=list)
    destinations: Dict[str, str] = field(default_factory=dict)  # pod key → node name
    # DaemonSet pods riding on the node: never simulated for rescheduling
    # (the controller recreates them elsewhere), optionally evicted
    # best-effort at actuation (reference actuation/drain.go:177-188).
    daemonset_pods: List[Pod] = field(default_factory=list)


@dataclass
class UnremovableNode:
    node: Node
    reason: UnremovableReason
    blocking_pod: Optional[BlockingPod] = None


def _spread_refit_context(meta, tensors, moving_pods):
    """→ (spread8, static_counts, sp_match_np) or (None, None, None): the
    within-refit topology-spread context, on the tensors' device. Static
    counts cover ALL placed pods (candidates' movable pods included: the
    refit subtracts each candidate's own contribution, matching
    findPlaceFor's remove-then-place order, cluster.go:220)."""
    if not has_hard_spread(moving_pods):
        return None, None, None
    ctx = build_spread_context_from_meta(moving_pods, meta, tensors)
    if ctx is None:
        return None, None, None
    (sp_of, sp_match, node_dom, sp_elig, dom_valid,
     static_counts, skew, min_dom, domnum) = ctx
    spread8 = (sp_of, sp_match, node_dom, sp_elig, dom_valid,
               skew, min_dom, domnum)
    return spread8, static_counts, sp_match.cpu().numpy()


def _cand_sub_matrix(sp_match_np, meta, pods_per_cand):
    """[C, S] — per candidate, how many of its moving pods match each term.
    Terminating movers are EXCLUDED: static_counts never counted them
    (countPodsMatchSelector skips deletion-stamped pods), so
    subtracting them would drive the domain count negative and over-admit."""
    S = sp_match_np.shape[1]
    out = np.zeros((len(pods_per_cand), S), np.int32)
    for ci, pods in enumerate(pods_per_cand):
        for p in pods:
            if p.deletion_ts is None:
                out[ci] += sp_match_np[meta.pod_index[p.key()]]
    return out


def _on(tensors, array: np.ndarray) -> torch.Tensor:
    """A host array as a tensor on the snapshot's device (a copy)."""
    return torch.tensor(array, device=tensors.device)


class RemovalSimulator:
    def __init__(self, rules: Optional[DrainabilityRules] = None):
        self.rules = rules or DrainabilityRules()

    def find_empty_nodes(
        self, snapshot: ClusterSnapshot, candidates: Sequence[str]
    ) -> List[str]:
        """Nodes among candidates with no pods needing rescheduling
        (reference cluster.go:187)."""
        tensors, meta = snapshot.tensors()
        movable = np.zeros(tensors.num_pods, bool)
        for i, pod in enumerate(meta.pods):
            movable[i] = not (pod.mirror or pod.daemonset)
        empty = empty_nodes_kernel(tensors, _on(tensors, movable)).cpu().numpy()
        out = []
        for name in candidates:
            j = meta.node_index.get(name)
            if j is not None and empty[j]:
                out.append(name)
        return out

    def find_nodes_to_remove(
        self,
        snapshot: ClusterSnapshot,
        candidates: Sequence[str],
        pdbs: Sequence[PodDisruptionBudget] = (),
        max_pods_per_node: int = 128,
    ) -> Tuple[List[NodeToRemove], List[UnremovableNode]]:
        """Batched FindNodesToRemove (reference cluster.go:116): drain rules
        per candidate on the host, then ONE removal_feasibility dispatch for
        all candidates on the snapshot's device."""
        tensors, meta = snapshot.tensors()
        cand_names = [c for c in candidates if c in meta.node_index]
        if not cand_names:
            return [], []

        C = len(cand_names)
        S = max_pods_per_node
        cand_idx = np.zeros(C, np.int32)
        pod_slots = np.full((C, S), -1, np.int32)
        blocked = np.zeros(C, bool)
        blocking: Dict[str, BlockingPod] = {}
        movable_pods: Dict[str, List[Pod]] = {}
        ds_pods: Dict[str, List[Pod]] = {}

        # controller → live replica count, the MinReplicas drain-rule input
        # (built once per dispatch; None disables the check)
        owner_counts = None
        if self.rules.min_replica_count > 0:
            owner_counts = count_owner_replicas(snapshot.pods())
        for ci, name in enumerate(cand_names):
            cand_idx[ci] = meta.node_index[name]
            pods_on = snapshot.pods_on_node(name)
            ds_pods[name] = daemonset_pods_of(pods_on)
            to_move, block = get_pods_to_move(
                pods_on, self.rules, pdbs, owner_counts
            )
            if block is not None:
                blocked[ci] = True
                blocking[name] = block
                continue
            movable_pods[name] = to_move
            for si, pod in enumerate(to_move[:S]):
                pod_slots[ci, si] = meta.pod_index[pod.key()]
            if len(to_move) > S:
                blocked[ci] = True  # too many pods to evaluate — conservative

        all_moving = [p for pods in movable_pods.values() for p in pods]
        spread8, static_counts, sp_match_np = _spread_refit_context(
            meta, tensors, all_moving
        )
        if spread8 is not None:
            pods_per_cand = [
                movable_pods.get(name, [])[:S] for name in cand_names
            ]
            res = removal_feasibility_spread(
                tensors,
                _on(tensors, cand_idx),
                _on(tensors, pod_slots),
                _on(tensors, blocked),
                spread8,
                static_counts,
                _on(tensors, _cand_sub_matrix(sp_match_np, meta, pods_per_cand)),
            )
        else:
            res = removal_feasibility(
                tensors,
                _on(tensors, cand_idx),
                _on(tensors, pod_slots),
                _on(tensors, blocked),
            )
        feasible = res.feasible.cpu().numpy()
        dests = res.destinations.cpu().numpy()

        to_remove: List[NodeToRemove] = []
        unremovable: List[UnremovableNode] = []
        for ci, name in enumerate(cand_names):
            node = snapshot.get_node(name)
            if blocked[ci]:
                unremovable.append(
                    UnremovableNode(
                        node, UnremovableReason.BLOCKED_BY_POD, blocking.get(name)
                    )
                )
            elif feasible[ci]:
                moves = movable_pods.get(name, [])
                destinations = {
                    pod.key(): meta.nodes[dests[ci, si]].name
                    for si, pod in enumerate(moves[:S])
                    if dests[ci, si] >= 0
                }
                to_remove.append(
                    NodeToRemove(node, moves, destinations, ds_pods.get(name, []))
                )
            else:
                unremovable.append(
                    UnremovableNode(node, UnremovableReason.NO_PLACE_TO_MOVE_PODS)
                )
        return to_remove, unremovable

    def validate_removal_set(
        self,
        snapshot: ClusterSnapshot,
        drains: Sequence[NodeToRemove],
        also_removed: Sequence[str] = (),
        max_pods_per_node: int = 128,
    ) -> Tuple[List[NodeToRemove], List[UnremovableNode]]:
        """Joint re-simulation of the picked deletion set, in pick order.

        Per-candidate feasibility (find_nodes_to_remove) evaluates every
        candidate against the same base state; this pass replays the chosen
        drains sequentially over ONE shared capacity state, with every node
        leaving the cluster (the drains themselves plus `also_removed`, e.g.
        empty nodes picked for deletion) excluded as a destination — the
        joint check the reference gets from re-simulating against a fresh
        snapshot during actuation (actuator.go:371, cluster.go:145). Returns
        (validated drains with updated destinations, rejected)."""
        tensors, meta = snapshot.tensors()
        # Guard against drains computed from an older snapshot: a drain whose
        # node or pods have since vanished cannot be validated — reject it
        # rather than crash (find_nodes_to_remove filters the same way).
        rejected: List[UnremovableNode] = []
        current: List[NodeToRemove] = []
        for r in drains:
            known = r.node.name in meta.node_index and all(
                p.key() in meta.pod_index for p in r.pods_to_reschedule
            )
            if known:
                current.append(r)
            else:
                rejected.append(
                    UnremovableNode(r.node, UnremovableReason.NO_PLACE_TO_MOVE_PODS)
                )
        drains = current
        if not drains:
            return [], rejected
        C, S = len(drains), max_pods_per_node
        cand_idx = np.zeros(C, np.int32)
        pod_slots = np.full((C, S), -1, np.int32)
        excluded = np.zeros(tensors.num_nodes, bool)
        for name in also_removed:
            j = meta.node_index.get(name)
            if j is not None:
                excluded[j] = True
        for ci, r in enumerate(drains):
            j = meta.node_index[r.node.name]
            cand_idx[ci] = j
            excluded[j] = True
            for si, pod in enumerate(r.pods_to_reschedule[:S]):
                pod_slots[ci, si] = meta.pod_index[pod.key()]

        all_moving = [p for r in drains for p in r.pods_to_reschedule]
        spread8, static_counts, sp_match_np = _spread_refit_context(
            meta, tensors, all_moving
        )
        if spread8 is not None:
            pods_per_cand = [r.pods_to_reschedule[:S] for r in drains]
            res = joint_removal_feasibility_spread(
                tensors,
                _on(tensors, cand_idx),
                _on(tensors, pod_slots),
                _on(tensors, excluded),
                spread8,
                static_counts,
                _on(tensors, _cand_sub_matrix(sp_match_np, meta, pods_per_cand)),
            )
        else:
            res = joint_removal_feasibility(
                tensors,
                _on(tensors, cand_idx),
                _on(tensors, pod_slots),
                _on(tensors, excluded),
            )
        feasible = res.feasible.cpu().numpy()
        dests = res.destinations.cpu().numpy()

        valid: List[NodeToRemove] = []
        for ci, r in enumerate(drains):
            if feasible[ci]:
                destinations = {
                    pod.key(): meta.nodes[dests[ci, si]].name
                    for si, pod in enumerate(r.pods_to_reschedule[:S])
                    if dests[ci, si] >= 0
                }
                valid.append(
                    NodeToRemove(
                        r.node, r.pods_to_reschedule, destinations, r.daemonset_pods
                    )
                )
            else:
                rejected.append(
                    UnremovableNode(r.node, UnremovableReason.NO_PLACE_TO_MOVE_PODS)
                )
        return valid, rejected
