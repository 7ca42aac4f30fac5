"""Pod list processing before scale-up: drop the pods that already fit
existing capacity (the port of ``autoscaler_tpu/core/podlistprocessor.py``).

Reference: cluster-autoscaler/core/podlistprocessor/ — the default pipeline
is currently-drained-nodes injection + filter-out-schedulable
(filter_out_schedulable.go:46,95: priority-sorted hinted packing of pending
pods onto existing free capacity; whatever fits is removed from the scale-up
trigger list). The packing is one ``greedy_schedule`` loop on the
snapshot's device.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from autoscaler_tpu_torch.kube.objects import Pod
from autoscaler_tpu_torch.simulator.hinting import HintingSimulator
from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot


class FilterOutSchedulablePodListProcessor:
    def __init__(self, hinting: HintingSimulator | None = None):
        self.hinting = hinting or HintingSimulator()

    def process(
        self, snapshot: ClusterSnapshot, pending: Sequence[Pod]
    ) -> Tuple[List[Pod], List[Pod]]:
        """→ (still_pending, filtered_as_schedulable). Pods are packed in
        priority order, highest first (filter_out_schedulable.go:95), onto
        the snapshot (the caller's fork); each placement is committed to it
        so later pods see the consumed capacity."""
        if not pending:
            return [], []
        # a total order: equal priorities break ties on the pod key, so the
        # outcome is a function of the pod set, not of the listing's order
        ordered = sorted(pending, key=lambda p: (-p.priority, p.key()))
        scheduled, _ = self.hinting.try_schedule_pods(snapshot, ordered, commit=True)
        scheduled_keys = {p.key() for p in scheduled}
        still_pending = [p for p in pending if p.key() not in scheduled_keys]
        return still_pending, scheduled
