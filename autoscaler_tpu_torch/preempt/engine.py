"""PreemptionEngine: one snapshot in, one PreemptionPlan out.

The engine is a thin host shell: it packs nothing itself (the snapshot's
tensors already carry the priority channels), computes the victim-
eligibility mask (policy.py), and hands the dispatch to the estimator's
kernel ladder (BinpackingNodeEstimator.estimate_preemption), which runs
ops/preempt.ffd_binpack_preempt on the estimator's device with the numpy
oracle as its host twin. The plan maps tensor rows back to pod keys and
node names — everything downstream (explain ledger, expander churn score,
actual evictions) speaks in object keys, sorted wherever order reaches a
ledger (graftlint GL010).

The port's copy of ``autoscaler_tpu/preempt/engine.py``; the validity
and node rows are fetched from the snapshot's device once a plan.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from autoscaler_tpu_torch.kube.objects import Pod
from autoscaler_tpu_torch.preempt.policy import evictable_mask


@dataclass
class PreemptionPlan:
    """What one eviction-packing pass decided.

    - admitted: pending pod keys placeable on the EXISTING cluster
      (directly or by evicting), sorted
    - placements: admitted pod key → node name
    - victims: victim pod key → evictor (pending) pod key — every evicted
      pod names its evictor; the explain ledger's ``preempted_by`` rows
      are rendered straight from this map
    - victim_pods: victim pod key → Pod object (the actuation handle)
    - route: which kernel rung served the dispatch (provenance)
    """

    admitted: List[str] = field(default_factory=list)
    placements: Dict[str, str] = field(default_factory=dict)
    victims: Dict[str, str] = field(default_factory=dict)
    victim_pods: Dict[str, Pod] = field(default_factory=dict)
    route: str = ""

    @property
    def eviction_count(self) -> int:
        return len(self.victims)

    def evictions_by_pod(self) -> Dict[str, List[str]]:
        """evictor key → sorted victim keys (only evictors with victims)."""
        by: Dict[str, List[str]] = {}
        for victim in sorted(self.victims):
            by.setdefault(self.victims[victim], []).append(victim)
        return by

    def churn(self, covered: Set[str]) -> int:
        """Evictions this plan charges to pods NOT in ``covered`` — the
        expander's churn score for a scale-up option: pods the option
        would give new capacity (covered) stop needing their evictions,
        so an option leaving eviction-heavy pods uncovered scores worse
        (expander/core.py PreemptionChurnFilter)."""
        return sum(
            1 for evictor in self.victims.values() if evictor not in covered
        )


class PreemptionEngine:
    """Plans priority-aware evictions against the current snapshot."""

    def __init__(self, estimator, metrics=None):
        self.estimator = estimator
        self.metrics = metrics

    def plan(self, snapshot, eligible: Optional[Set[str]] = None) -> PreemptionPlan:
        """Run one eviction-packing pass over the snapshot's pending pods.
        Read-only on the snapshot: admission here informs the tick's
        decisions (ledger, churn scores, evictions) but scale-up still
        estimates against the full pending set — preemption is a bridge
        until capacity arrives, not a substitute for it.

        ``eligible`` (pod keys) restricts which PENDING pods compete for
        admission: the control loop passes its post-filter pending set so
        expendable drops and filter-out-schedulable absorptions — settled
        before this pass — neither pack nor preempt here. Residents are
        unaffected; None = every pending pod competes."""
        tensors, meta = snapshot.tensors()
        plan = PreemptionPlan()
        if not meta.pods:
            return plan
        mask = evictable_mask(meta.pods, tensors.num_pods)
        valid = None
        if eligible is not None:
            valid = tensors.pod_valid.cpu().numpy().copy()
            pod_node = tensors.pod_node.cpu().numpy()
            for i, pod in enumerate(meta.pods):
                if valid[i] and pod_node[i] < 0 and pod.key() not in eligible:
                    valid[i] = False
        scheduled, placed, victim_of, route = (
            self.estimator.estimate_preemption(tensors, mask, pod_valid=valid)
        )
        plan.route = route
        scheduled = np.asarray(scheduled)
        placed = np.asarray(placed)
        victim_of = np.asarray(victim_of)
        admitted = []
        for i, pod in enumerate(meta.pods):
            if scheduled[i]:
                admitted.append(pod.key())
                node_row = int(placed[i])
                if 0 <= node_row < len(meta.nodes):
                    plan.placements[pod.key()] = meta.nodes[node_row].name
            evictor = int(victim_of[i])
            if evictor >= 0:
                plan.victims[pod.key()] = meta.pods[evictor].key()
                plan.victim_pods[pod.key()] = pod
        plan.admitted = sorted(admitted)
        if self.metrics is not None:
            self.metrics.preemption_planned_evictions.set(
                plan.eviction_count
            )
        return plan
