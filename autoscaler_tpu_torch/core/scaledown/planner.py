"""Scale-down planner: decide which nodes are unneeded and which to delete.

Reference: cluster-autoscaler/core/scaledown/planner/planner.go — Planner :62,
UpdateClusterState :103 (fork → inject recently-evicted pods → categorize),
categorizeNodes :252 (eligibility filter then per-node SimulateNodeRemoval
under ScaleDownSimulationTimeout), NodesToDelete :134 (limits + unneeded-time
gates + parallelism caps), and the candidate-pool bounds of the legacy path
(legacy.go:152-180: 30 non-empty candidates, pool ratio 0.1, pool min 50).
The per-node removal simulation is batched into one device dispatch
(simulator/removal.py), so the simulation-timeout knob bounds one call, not a
loop. The counterpart of ``autoscaler_tpu/core/scaledown/planner.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.cloudprovider.interface import CloudProvider
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.core.scaledown.eligibility import EligibilityChecker
from autoscaler_tpu_torch.core.scaledown.limits import LimitsFinder, build_resource_limiter
from autoscaler_tpu_torch.core.scaleup.resource_manager import ResourceDelta
from autoscaler_tpu_torch.core.scaledown.tracking import (
    NodeDeletionTracker,
    RemainingPdbTracker,
    UnneededNodes,
    UnremovableNodesCache,
)
from autoscaler_tpu_torch.kube.objects import Node, PodDisruptionBudget
from autoscaler_tpu_torch.simulator.drain import daemonset_pods_of
from autoscaler_tpu_torch.simulator.removal import (
    NodeToRemove,
    RemovalSimulator,
    UnremovableNode,
    UnremovableReason,
)
from autoscaler_tpu_torch.simulator.tracker import UsageTracker
from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot
from autoscaler_tpu_torch import trace


@dataclass
class ScaleDownPlan:
    empty: List[NodeToRemove] = field(default_factory=list)
    drain: List[NodeToRemove] = field(default_factory=list)
    unremovable: List[UnremovableNode] = field(default_factory=list)


class ScaleDownPlanner:
    def __init__(
        self,
        provider: CloudProvider,
        options: AutoscalingOptions,
        deletion_tracker: Optional[NodeDeletionTracker] = None,
        removal_simulator: Optional[RemovalSimulator] = None,
        set_processor=None,
    ):
        self.provider = provider
        self.options = options
        self.eligibility = EligibilityChecker(options, provider)
        self.unneeded = UnneededNodes()
        self.unremovable_cache = UnremovableNodesCache(
            options.unremovable_node_recheck_timeout_s
        )
        self.deletion_tracker = deletion_tracker or NodeDeletionTracker()
        if removal_simulator is None:
            from autoscaler_tpu_torch.simulator.drain import DrainabilityRules

            # drain policy knobs flow from options (they were silently
            # defaulted before — --skip-nodes-with-* and --min-replica-count
            # had no effect on the default path)
            removal_simulator = RemovalSimulator(
                rules=DrainabilityRules(
                    skip_nodes_with_system_pods=options.skip_nodes_with_system_pods,
                    skip_nodes_with_local_storage=options.skip_nodes_with_local_storage,
                    skip_nodes_with_custom_controller_pods=(
                        options.skip_nodes_with_custom_controller_pods
                    ),
                    min_replica_count=options.min_replica_count,
                )
            )
        self.simulator = removal_simulator
        self._adaptive_candidate_limit: Optional[int] = None
        self.limits_finder = LimitsFinder(build_resource_limiter(options, provider))
        self.set_processor = set_processor
        self.usage_tracker = UsageTracker()
        self._last_unremovable: List[UnremovableNode] = []
        self._utilization: Dict[str, float] = {}

    # -- per-loop update (reference planner.go:103) --------------------------
    def update_cluster_state(
        self,
        snapshot: ClusterSnapshot,
        scale_down_candidates: Sequence[Node],
        pdbs: Sequence[PodDisruptionBudget],
        now_ts: float,
    ) -> None:
        eligible, utilization, unremovable = self.eligibility.filter_out_unremovable(
            snapshot, scale_down_candidates, now_ts, self.unremovable_cache
        )
        self._utilization = utilization

        # Empty nodes are detected over ALL eligible nodes — they need no
        # drain simulation, and the reference finds them before the pool
        # heuristics kick in (legacy.go:101 phase order: utilization filter →
        # empty nodes → candidate pools). The pool bounds (legacy.go:152-180)
        # only cap the expensive non-empty (drain-simulation) candidates.
        empty_names = set(self.simulator.find_empty_nodes(snapshot, eligible))
        pool = self._bound_candidates([n for n in eligible if n not in empty_names])
        non_empty = pool
        limit = self.options.scale_down_non_empty_candidates_count
        if limit > 0:
            non_empty = non_empty[:limit]
        # ScaleDownSimulationTimeout (planner.go:262-272) adapted to the
        # batched dispatch: one device call can't stop mid-way, so the bound
        # is enforced across loops — a dispatch that blows the budget halves
        # the next loop's candidate width (AIMD), growing back while under
        # half-budget. 0 disables.
        if self._adaptive_candidate_limit is not None:
            non_empty = non_empty[: self._adaptive_candidate_limit]

        # the timeline clock, not the wall clock: the AIMD clamp below FEEDS BACK
        # into next tick's candidate width, so a wall-clock measurement here
        # would make replayed decision logs diverge on a slow host
        sim_start = trace.timeline_now()
        to_remove, not_removable = self.simulator.find_nodes_to_remove(
            snapshot, non_empty, pdbs
        )
        sim_s = trace.timeline_now() - sim_start
        budget = self.options.scale_down_simulation_timeout_s
        if budget > 0:
            if non_empty and sim_s > budget and len(non_empty) > 1:
                self._adaptive_candidate_limit = max(1, len(non_empty) // 2)
            elif self._adaptive_candidate_limit is not None and (
                not non_empty or sim_s < budget / 2
            ):
                # decay the clamp on fast dispatches AND on loops with no
                # non-empty candidates — a clamp from one past slow dispatch
                # must not throttle scale-down indefinitely
                widened = self._adaptive_candidate_limit * 2
                self._adaptive_candidate_limit = (
                    None if widened >= max(len(pool), 1) else widened
                )
        # remember the simulated moves so an actual deletion later can reset
        # the unneeded clocks of its destination nodes (simulator/tracker.go)
        for r in to_remove:
            for dest in set(r.destinations.values()):
                self.usage_tracker.register_usage(r.node.name, dest, now_ts)
        self.usage_tracker.cleanup(
            now_ts - max(2 * self.options.node_group_defaults.scale_down_unneeded_time_s, 600.0)
        )
        for u in not_removable:
            if u.node is not None:
                self.unremovable_cache.add(u.node.name, now_ts)
        unremovable.extend(not_removable)
        self._last_unremovable = unremovable

        # sorted(): empty_names is a SET, and this list's order becomes the
        # UnneededNodes insertion order, which is the order nodes_to_delete
        # walks when it crops to max_empty_bulk_delete — iterating the set
        # raw would let PYTHONHASHSEED pick WHICH empty nodes die
        unneeded_nodes = [snapshot.get_node(n) for n in sorted(empty_names)]
        unneeded_nodes += [r.node for r in to_remove]
        self.unneeded.update([n for n in unneeded_nodes if n is not None], now_ts)
        self._empty_names = empty_names
        self._drainable = {r.node.name: r for r in to_remove}

    def _bound_candidates(self, eligible: List[str]) -> List[str]:
        ratio = self.options.scale_down_candidates_pool_ratio
        min_count = self.options.scale_down_candidates_pool_min_count
        if ratio >= 1.0:
            return eligible
        pool_size = max(int(len(eligible) * ratio), min_count)
        return eligible[:pool_size]

    # -- decision (reference planner.go:134) ---------------------------------
    def nodes_to_delete(self, snapshot: ClusterSnapshot, now_ts: float) -> ScaleDownPlan:
        plan = ScaleDownPlan(unremovable=list(self._last_unremovable))
        deletions_per_group: Dict[str, int] = {}
        # Cluster-wide floors (planner.go:145 LimitsFinder.LimitsLeft): how
        # much cores/memory/gpu scale-down may still remove before breaching
        # min_*_total. Nodes already mid-deletion don't count toward totals.
        limits_left = self.limits_finder.limits_left(
            snapshot.nodes(), self.deletion_tracker.is_being_deleted
        )

        def group_of(node: Node):
            g = self.provider.node_group_for_node(node)
            return g.id() if g else None

        for name in self.unneeded.names():
            node = snapshot.get_node(name)
            if node is None or self.deletion_tracker.is_being_deleted(name):
                continue
            gid = group_of(node)
            if gid is None:
                continue  # node outside any group is never deleted by us
            in_group = self.deletion_tracker.deletions_in_group(
                gid
            ) + deletions_per_group.get(gid, 0)
            if not self.unneeded.removable_at(
                node, now_ts, self.options, self.provider, in_group
            ):
                continue
            if name in self._empty_names:
                if len(plan.empty) < self.options.max_empty_bulk_delete:
                    if limits_left.try_decrement(ResourceDelta.for_node(node)):
                        plan.unremovable.append(
                            UnremovableNode(
                                node, UnremovableReason.MINIMAL_RESOURCE_LIMIT_EXCEEDED
                            )
                        )
                        continue
                    ds = daemonset_pods_of(snapshot.pods_on_node(name))
                    plan.empty.append(NodeToRemove(node, daemonset_pods=ds))
                    deletions_per_group[gid] = deletions_per_group.get(gid, 0) + 1
            elif name in self._drainable:
                if len(plan.drain) < self.options.max_drain_parallelism:
                    if limits_left.try_decrement(ResourceDelta.for_node(node)):
                        plan.unremovable.append(
                            UnremovableNode(
                                node, UnremovableReason.MINIMAL_RESOURCE_LIMIT_EXCEEDED
                            )
                        )
                        continue
                    plan.drain.append(self._drainable[name])
                    deletions_per_group[gid] = deletions_per_group.get(gid, 0) + 1
        # Final-selection seam (reference planner.go:151
        # ScaleDownSetProcessor.GetNodesToRemove); the default processor
        # crops to max_scale_down_parallelism, empty nodes first.
        cap = self.options.max_scale_down_parallelism
        if self.set_processor is not None:
            picked = self.set_processor.get_nodes_to_remove(
                plan.empty + plan.drain, cap
            )
            picked_set = {id(r) for r in picked}
            plan.empty = [r for r in plan.empty if id(r) in picked_set]
            plan.drain = [r for r in plan.drain if id(r) in picked_set]
        else:
            total = len(plan.empty) + len(plan.drain)
            if cap > 0 and total > cap:
                keep_empty = min(len(plan.empty), cap)
                plan.empty = plan.empty[:keep_empty]
                plan.drain = plan.drain[: max(0, cap - keep_empty)]
        # Joint re-validation: the per-candidate simulation above evaluated
        # each drain against the same base state; the picked set must also
        # hold *together* (no double-booked capacity, no destinations on
        # nodes that are themselves leaving). Mirrors the reference's
        # fresh-snapshot re-check during actuation (actuator.go:371).
        if plan.drain:
            empty_names = [r.node.name for r in plan.empty]
            valid, rejected = self.simulator.validate_removal_set(
                snapshot, plan.drain, also_removed=empty_names
            )
            plan.drain = valid
            plan.unremovable.extend(rejected)
        return plan

    def node_deleted(self, node_name: str, now_ts: float) -> List[str]:
        """A node was actually removed: reset the unneeded clocks of the
        nodes its drain simulation used as destinations (their utilization is
        about to rise when the real evictions land). Returns the reset names."""
        destinations = self.usage_tracker.remove_node(node_name)
        for dest in destinations:
            self.unneeded.reset_since(dest, now_ts)
        return destinations

    def utilization_of(self, node_name: str) -> Optional[float]:
        return self._utilization.get(node_name)

    def unneeded_names(self) -> List[str]:
        return self.unneeded.names()

    def last_unremovable(self) -> List[UnremovableNode]:
        """The previous update's rejection list (metrics + status surface)."""
        return list(self._last_unremovable)
