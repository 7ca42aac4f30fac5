"""Hinting scheduling simulator: the host wrapper over the greedy loop,
with a generational hint map (the port of
``autoscaler_tpu/simulator/hinting.py``).

Reference: cluster-autoscaler/simulator/scheduling/ — hinting_simulator.go:58
(TrySchedulePods), hints.go:39,68 (the generational hint map: successful
placements remembered across loops, stale entries dropped by generation),
similar_pods.go (memoized verdicts for equivalent pods, subsumed here
because the whole batch is one ``greedy_schedule`` call).

The loop runs on the snapshot tensors' device: the pod rows and hints go
there once, and the host reads the placements back once, after the loop.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autoscaler_tpu_torch.kube.objects import Pod
from autoscaler_tpu_torch.ops import schedule
from autoscaler_tpu_torch.snapshot.affinity import build_spread_context_from_meta
from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot


class Hints:
    """pod key → node name, with generation-based eviction (hints.go:39)."""

    def __init__(self, max_generations: int = 2):
        self._store: Dict[str, Tuple[str, int]] = {}
        self._generation = 0
        self.max_generations = max_generations

    def get(self, pod_key: str) -> Optional[str]:
        entry = self._store.get(pod_key)
        return entry[0] if entry else None

    def set(self, pod_key: str, node_name: str) -> None:
        self._store[pod_key] = (node_name, self._generation)

    def next_generation(self) -> None:
        self._generation += 1
        cutoff = self._generation - self.max_generations
        self._store = {k: v for k, v in self._store.items() if v[1] > cutoff}


class HintingSimulator:
    def __init__(self) -> None:
        self.hints = Hints()

    def try_schedule_pods(
        self,
        snapshot: ClusterSnapshot,
        pods: Sequence[Pod],
        commit: bool = True,
    ) -> Tuple[List[Pod], Dict[str, str]]:
        """→ (scheduled_pods, assignments pod key → node name). With
        ``commit`` the placements are applied to the snapshot, as
        TrySchedulePods does on its working snapshot."""
        if not pods:
            return [], {}
        tensors, meta = snapshot.tensors()
        K = len(pods)
        slots = np.full(K, -1, np.int32)
        hint_idx = np.full(K, -1, np.int32)
        for i, pod in enumerate(pods):
            slots[i] = meta.pod_index[pod.key()]
            hinted = self.hints.get(pod.key())
            if hinted is not None and hinted in meta.node_index:
                hint_idx[i] = meta.node_index[hinted]
        # within-wave topology spread: placements in this wave raise their
        # domain's count for later pods
        spread_ctx = build_spread_context_from_meta(pods, meta, tensors)
        res = schedule.greedy_schedule(
            tensors,
            torch.tensor(slots, device=tensors.device),
            torch.tensor(hint_idx, device=tensors.device),
            spread=spread_ctx,
        )
        placed = res.placed.cpu().numpy()
        dest = res.dest.cpu().numpy()

        scheduled: List[Pod] = []
        assignments: Dict[str, str] = {}
        for i, pod in enumerate(pods):
            if placed[i]:
                node_name = meta.nodes[dest[i]].name
                scheduled.append(pod)
                assignments[pod.key()] = node_name
                self.hints.set(pod.key(), node_name)
                if commit:
                    snapshot.schedule_pod(pod.key(), node_name)
        self.hints.next_generation()
        return scheduled, assignments
