"""Host-side cluster snapshot with O(1) fork / O(delta) revert / O(1)
commit: the counterpart of ``autoscaler_tpu/snapshot/cluster_snapshot.py``.

It keeps the contract of the reference's ClusterSnapshot interface
(cluster-autoscaler/simulator/clustersnapshot/clustersnapshot.go:29:
AddNode/AddPod/RemovePod/RemoveNode/Fork/Revert/Commit/Clear) and the
complexity profile of its DeltaClusterSnapshot (delta.go:43,448-469): a
live effective index (nodes, pods, assignments, and a node → pod-keys
index) mutated in place, plus a per-fork undo log of inverse operations.
Fork pushes an empty log; revert replays the top log backwards; commit
splices the top log into the parent's. Every read is O(result).

``tensors()`` packs the effective state into ``SnapshotTensors`` on the
snapshot's device (None = the first CUDA card), cached per version. With
``packer=`` (an ``IncrementalPacker`` carried across loops, on the same
device) every materialization is an O(delta) diff against the packer's
previous state instead of a full ``pack``: the tensor-side analog of the
reference's DeltaClusterSnapshot (delta.go:26-42). The packer diffs by
object identity, so the snapshot hands it the very objects it was given.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.kube.objects import Node, Pod
from autoscaler_tpu_torch.snapshot.packer import SnapshotMeta, pack
from autoscaler_tpu_torch.snapshot.tensors import SnapshotTensors


class SnapshotError(Exception):
    pass


# Undo opcodes (op, *payload) — applied in reverse order on revert.
_DEL_NODE = 0   # (name,)                — undo of add_node
_PUT_NODE = 1   # (name, node)           — undo of remove_node
_DEL_POD = 2    # (key,)                 — undo of add_pod
_PUT_POD = 3    # (key, pod, assign)     — undo of remove_pod
_ASSIGN = 4     # (key, old_assign)      — undo of schedule_pod


class ClusterSnapshot:
    def __init__(self, device=None, packer=None) -> None:
        # resolved now, so a snapshot meant for the card fails at once
        # without one rather than at its first tensors(); with a packer and
        # no device, the packer's device
        if device is None and packer is not None:
            device = packer.device
        self.device = resolve_device(device)
        if packer is not None and packer.device != self.device:
            raise ValueError(
                f"the packer serves {packer.device}, the snapshot {self.device}"
            )
        self._nodes: Dict[str, Node] = {}
        self._pods: Dict[str, Pod] = {}
        self._assign: Dict[str, str] = {}          # pod key -> node name
        self._by_node: Dict[str, Dict[str, None]] = {}  # node -> ordered pod keys
        self._undo: List[List[Tuple]] = [[]]       # one log per fork level
        self._fork_versions: List[int] = []        # version at each fork()
        self._version = 0
        self._cache: Optional[Tuple[int, SnapshotTensors, SnapshotMeta]] = None
        self._cached_group_map: Optional[Dict[str, str]] = None
        # an IncrementalPacker carried across loops (snapshot/incremental.py)
        self._packer = packer

    # -- mutation -----------------------------------------------------------
    def _bump(self) -> None:
        self._version += 1

    def _log(self, entry: Tuple) -> None:
        # The base level can never be reverted (revert at depth 0 raises), so
        # logging there would only pin dead objects — the every-loop snapshot
        # rebuild adds O(nodes+pods) entries that nothing could ever replay.
        if len(self._undo) > 1:
            self._undo[-1].append(entry)

    def _set_assign(self, key: str, node_name: str) -> None:
        old = self._assign.get(key, "")
        if old:
            self._by_node.get(old, {}).pop(key, None)
        if node_name:
            self._assign[key] = node_name
            self._by_node.setdefault(node_name, {})[key] = None
        else:
            self._assign.pop(key, None)

    def add_node(self, node: Node) -> None:
        if node.name in self._nodes:
            raise SnapshotError(f"node {node.name} already in snapshot")
        self._nodes[node.name] = node
        self._by_node.setdefault(node.name, {})
        self._log((_DEL_NODE, node.name))
        self._bump()

    def remove_node(self, name: str) -> None:
        node = self._nodes.get(name)
        if node is None:
            raise SnapshotError(f"node {name} not in snapshot")
        for key in list(self._by_node.get(name, ())):
            self.remove_pod(key)
        del self._nodes[name]
        # the bucket is empty now (every member was just removed) — pop it so
        # node-name churn doesn't accumulate dead buckets
        self._by_node.pop(name, None)
        self._log((_PUT_NODE, name, node))
        self._bump()

    def add_pod(self, pod: Pod, node_name: str = "") -> None:
        key = pod.key()
        if key in self._pods:
            raise SnapshotError(f"pod {key} already in snapshot")
        if node_name and node_name not in self._nodes:
            raise SnapshotError(f"node {node_name} not in snapshot")
        assign = node_name or pod.node_name
        self._pods[key] = pod
        self._set_assign(key, assign)
        self._log((_DEL_POD, key))
        self._bump()

    def remove_pod(self, pod_key: str) -> None:
        pod = self._pods.get(pod_key)
        if pod is None:
            raise SnapshotError(f"pod {pod_key} not in snapshot")
        assign = self._assign.get(pod_key, "")
        del self._pods[pod_key]
        self._set_assign(pod_key, "")
        self._log((_PUT_POD, pod_key, pod, assign))
        self._bump()

    def schedule_pod(self, pod_key: str, node_name: str) -> None:
        if pod_key not in self._pods:
            raise SnapshotError(f"pod {pod_key} not in snapshot")
        if node_name not in self._nodes:
            raise SnapshotError(f"node {node_name} not in snapshot")
        old = self._assign.get(pod_key, "")
        self._set_assign(pod_key, node_name)
        self._log((_ASSIGN, pod_key, old))
        self._bump()

    def clear(self) -> None:
        self._nodes.clear()
        self._pods.clear()
        self._assign.clear()
        self._by_node.clear()
        self._undo = [[]]
        self._fork_versions = []
        self._bump()

    # -- fork/revert/commit (reference: delta.go:448,454,462) ---------------
    def fork(self) -> None:
        self._undo.append([])
        self._fork_versions.append(self._version)

    def revert(self) -> None:
        if len(self._undo) == 1:
            raise SnapshotError("revert with no fork")
        for entry in reversed(self._undo.pop()):
            op = entry[0]
            if op == _DEL_NODE:
                _, name = entry
                self._nodes.pop(name, None)
                # Keep a non-empty bucket: pods added before the fork with a
                # node_name referencing this (then-absent) node still belong
                # to it — the pre-fork index state had that ghost membership.
                if not self._by_node.get(name):
                    self._by_node.pop(name, None)
            elif op == _PUT_NODE:
                _, name, node = entry
                self._nodes[name] = node
                self._by_node.setdefault(name, {})
            elif op == _DEL_POD:
                _, key = entry
                del self._pods[key]
                self._set_assign(key, "")
            elif op == _PUT_POD:
                _, key, pod, assign = entry
                self._pods[key] = pod
                self._set_assign(key, assign)
            else:  # _ASSIGN
                _, key, old = entry
                self._set_assign(key, old)
        # Revert restores the exact fork-time state, so restore the fork-time
        # version too: a tensors() cache built before the fork stays valid
        # (saves one full re-pack per loop in the fork→filter→revert pattern).
        # A cache built *inside* the fork holds now-dead state whose version
        # numbers are about to be reused — drop it.
        saved = self._fork_versions.pop()
        if self._cache is not None and self._cache[0] > saved:
            self._cache = None
        self._version = saved

    def commit(self) -> None:
        if len(self._undo) == 1:
            return
        top = self._undo.pop()
        self._fork_versions.pop()
        if len(self._undo) > 1:
            self._undo[-1].extend(top)
        self._bump()

    @property
    def fork_depth(self) -> int:
        return len(self._undo) - 1

    # -- reads --------------------------------------------------------------
    def get_node(self, name: str) -> Optional[Node]:
        return self._nodes.get(name)

    def get_pod(self, key: str) -> Optional[Pod]:
        return self._pods.get(key)

    def nodes(self) -> List[Node]:
        return list(self._nodes.values())

    def pods(self) -> List[Pod]:
        return list(self._pods.values())

    def assignment(self, pod_key: str) -> str:
        return self._assign.get(pod_key, "")

    def pods_on_node(self, node_name: str) -> List[Pod]:
        return [self._pods[k] for k in self._by_node.get(node_name, ())]

    def pending_pods(self) -> List[Pod]:
        return [p for k, p in self._pods.items() if k not in self._assign]

    # -- tensor materialization --------------------------------------------
    def tensors(
        self, group_of_node: Optional[Dict[str, str]] = None
    ) -> Tuple[SnapshotTensors, SnapshotMeta]:
        """Pack the effective object state into padded tensors on the
        snapshot's device. Cached per (version, group map): one pack per
        mutation generation."""
        if (
            self._cache is not None
            and self._cache[0] == self._version
            and self._cached_group_map == (group_of_node or {})
        ):
            return self._cache[1], self._cache[2]
        if self._packer is not None:
            tensors, meta = self._packer.update(
                list(self._nodes.values()),
                self._pods.items(),
                self._assign,
                group_of_node,
            )
            self._cache = (self._version, tensors, meta)
            self._cached_group_map = dict(group_of_node or {})
            return tensors, meta
        pods = []
        for key, pod in self._pods.items():
            assigned = self._assign.get(key, "")
            if assigned != pod.node_name:
                # shallow copy + setattr, not dataclasses.replace: replace()
                # re-runs __init__ over every field (~2x the per-pod cost,
                # ~0.1s of a 100k-pod pack)
                pod = copy.copy(pod)
                pod.node_name = assigned
            pods.append(pod)
        tensors, meta = pack(self.nodes(), pods, group_of_node, device=self.device)
        self._cache = (self._version, tensors, meta)
        self._cached_group_map = dict(group_of_node or {})
        return tensors, meta
