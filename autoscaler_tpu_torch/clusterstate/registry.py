"""Cluster state registry: readiness accounting, scale-up request tracking,
acceptable ranges, health gates, upcoming nodes, unregistered-node detection.

Reference: cluster-autoscaler/clusterstate/clusterstate.go — struct :112,
UpdateNodes :290, updateScaleRequests :232 (fulfillment = no upcoming nodes,
timeout → RegisterFailedScaleUp), updateAcceptableRanges :493 (target minus
in-flight scale-up increases / plus in-flight scale-downs, minus
long-unregistered), updateReadinessStats :543 (ready/unready/not-started/
deleted + unregistered/long-unregistered buckets, MaxNodeStartupTime :44),
updateIncorrectNodeGroupSizes :616 (registered outside the acceptable range,
first-observed preserved for fixNodeGroupSize), GetUpcomingNodes :921,
IsClusterHealthy :353, IsNodeGroupHealthy :368, IsNodeGroupSafeToScaleUp
:419, instance-error handling :1015-1099.

The port's copy of ``autoscaler_tpu/clusterstate/registry.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from autoscaler_tpu_torch.cloudprovider.interface import (
    CloudProvider,
    Instance,
    InstanceState,
)
from autoscaler_tpu_torch.clusterstate.backoff import ExponentialBackoff
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.kube.objects import Node

# reference clusterstate.go:44 — registration → ready grace period
MAX_NODE_STARTUP_TIME_S = 15 * 60.0
# reference clusterstate.go:48 MaxCloudProviderNodeDeletionTime
MAX_NODE_DELETION_TIME_S = 5 * 60.0


@dataclass
class ScaleUpRequest:
    group_id: str
    start_ts: float
    expected_delta: int
    expected_target: int


@dataclass
class ScaleDownRequest:
    """One in-flight node deletion (reference clusterstate.go ScaleDownRequest):
    widens the group's acceptable range until the cloud finishes deleting."""

    group_id: str
    node_name: str
    start_ts: float
    expected_delete_ts: float


@dataclass
class ScaleUpFailure:
    group_id: str
    reason: str
    ts: float


@dataclass
class AcceptableRange:
    """reference clusterstate.go:479 — how many registered nodes a group may
    legitimately have right now. A recent scale-up of 5 puts the group
    between target-5 and target; 3 in-flight deletions put it between
    target and target+3."""

    min_nodes: int = 0
    max_nodes: int = 0
    current_target: int = 0


@dataclass
class IncorrectNodeGroupSize:
    """reference clusterstate.go:616 — registered count outside the
    acceptable range; first_observed feeds fixNodeGroupSize's timeout."""

    current_size: int
    expected_size: int
    first_observed: float


@dataclass
class Readiness:
    ready: int = 0
    unready: int = 0
    not_started: int = 0
    deleted: int = 0
    registered: int = 0
    unregistered: int = 0        # cloud instance exists, no Node object yet
    long_unregistered: int = 0   # unregistered past the provision timeout

    @property
    def total(self) -> int:
        return self.registered


class ClusterStateRegistry:
    def __init__(
        self,
        provider: CloudProvider,
        options: AutoscalingOptions,
        backoff: Optional[ExponentialBackoff] = None,
    ):
        self.provider = provider
        self.options = options
        self.backoff = backoff or ExponentialBackoff(
            initial_s=options.initial_node_group_backoff_duration_s,
            max_s=options.max_node_group_backoff_duration_s,
            reset_timeout_s=options.node_group_backoff_reset_timeout_s,
        )
        self.scale_up_requests: Dict[str, ScaleUpRequest] = {}
        self.scale_down_requests: List[ScaleDownRequest] = []
        self.scale_up_failures: List[ScaleUpFailure] = []
        self.last_scale_down_ts: float = 0.0
        self._readiness: Dict[str, Readiness] = {}
        self._total: Readiness = Readiness()
        self._acceptable: Dict[str, AcceptableRange] = {}
        self._incorrect: Dict[str, IncorrectNodeGroupSize] = {}
        self._unregistered_since: Dict[str, float] = {}  # instance id → first seen
        self._deleted_node_names: set = set()
        self._nodes: List[Node] = []
        self._last_update_ts: float = 0.0

    # -- scale-up lifecycle (reference clusterstate.go:232-288) --------------
    def register_or_update_scale_up(self, group_id: str, delta: int, now_ts: float) -> None:
        group = self._group(group_id)
        target = group.target_size() if group else delta
        req = self.scale_up_requests.get(group_id)
        if req is None:
            if delta <= 0:
                return
            self.scale_up_requests[group_id] = ScaleUpRequest(
                group_id=group_id,
                start_ts=now_ts,
                expected_delta=delta,
                expected_target=target,
            )
            return
        if req.expected_delta + delta <= 0:
            # no remaining scale-up intent (clusterstate.go:210)
            del self.scale_up_requests[group_id]
            return
        req.expected_delta += delta
        req.expected_target = target
        if delta > 0:
            # actually adding nodes restarts the provision clock
            req.start_ts = now_ts

    def register_failed_scale_up(self, group_id: str, reason: str, now_ts: float) -> None:
        self.scale_up_failures.append(ScaleUpFailure(group_id, reason, now_ts))
        self.backoff.backoff(group_id, now_ts)
        self.scale_up_requests.pop(group_id, None)

    def register_scale_down(
        self, now_ts: float, group_id: str = "", node_name: str = ""
    ) -> None:
        self.last_scale_down_ts = now_ts
        if group_id:
            self.scale_down_requests.append(
                ScaleDownRequest(
                    group_id=group_id,
                    node_name=node_name,
                    start_ts=now_ts,
                    expected_delete_ts=now_ts + MAX_NODE_DELETION_TIME_S,
                )
            )

    def register_deleted_nodes(self, node_names: Sequence[str]) -> None:
        """Nodes mid cloud-deletion: still registered in the control plane
        but no longer counted toward target (clusterstate.go:675)."""
        self._deleted_node_names = set(node_names)

    # -- per-loop state update (reference clusterstate.go:290) ---------------
    def update_nodes(self, nodes: Sequence[Node], now_ts: float) -> None:
        self._nodes = list(nodes)
        self._last_update_ts = now_ts
        # drop backoff entries idle past the reset timeout: they can never
        # influence is_backed_off again (a new failure restarts at the
        # initial duration), so keeping them only grows the map without
        # bound across group churn on long-lived processes
        self.backoff.remove_stale(now_ts)
        self._update_unregistered(now_ts)
        self._recalculate_readiness(now_ts)
        # acceptable ranges feed the scale-request fulfillment check, then
        # get recomputed once timed-out requests are gone (the reference
        # updates them twice for the same reason, clusterstate.go:317-323)
        self._update_acceptable_ranges()
        self._update_scale_requests(now_ts)
        self._update_acceptable_ranges()
        self._update_incorrect_sizes(now_ts)

    def _update_unregistered(self, now_ts: float) -> None:
        """Track when each cloud instance without a Node object was first
        seen (clusterstate.go:650 keeps the earlier observation)."""
        registered_ids = {n.provider_id for n in self._nodes if n.provider_id}
        registered_names = {n.name for n in self._nodes}
        current: Dict[str, float] = {}
        for group in self.provider.node_groups():
            for inst in group.nodes():
                if (
                    inst.id not in registered_ids
                    and inst.id not in registered_names
                    and inst.state != InstanceState.DELETING
                ):
                    current[inst.id] = self._unregistered_since.get(inst.id, now_ts)
        self._unregistered_since = current

    def _recalculate_readiness(self, now_ts: float) -> None:
        per_group: Dict[str, Readiness] = {}
        total = Readiness()

        def bucket(r: Readiness, node: Node) -> None:
            r.registered += 1
            if node.name in self._deleted_node_names:
                r.deleted += 1
            elif node.ready:
                r.ready += 1
            elif now_ts - node.creation_ts < MAX_NODE_STARTUP_TIME_S:
                r.not_started += 1
            else:
                r.unready += 1

        for node in self._nodes:
            group = self.provider.node_group_for_node(node)
            gid = group.id() if group else ""
            bucket(per_group.setdefault(gid, Readiness()), node)
            bucket(total, node)

        # unregistered buckets come from the cloud side (clusterstate.go:583)
        id_to_group: Dict[str, str] = {}
        for group in self.provider.node_groups():
            for inst in group.nodes():
                id_to_group[inst.id] = group.id()
        provision_timeout = self.options.max_node_provision_time_s
        for inst_id, since in self._unregistered_since.items():
            gid = id_to_group.get(inst_id, "")
            r = per_group.setdefault(gid, Readiness())
            if now_ts - since > provision_timeout:
                r.long_unregistered += 1
                total.long_unregistered += 1
            else:
                r.unregistered += 1
                total.unregistered += 1
        self._readiness = per_group
        self._total = total

    def _update_acceptable_ranges(self) -> None:
        """clusterstate.go:493."""
        result: Dict[str, AcceptableRange] = {}
        for group in self.provider.node_groups():
            gid = group.id()
            target = group.target_size()
            r = self._readiness.get(gid, Readiness())
            result[gid] = AcceptableRange(
                min_nodes=target - r.long_unregistered,
                max_nodes=target,
                current_target=target,
            )
        for gid, req in self.scale_up_requests.items():
            if gid in result:
                result[gid].min_nodes -= req.expected_delta
        for sdr in self.scale_down_requests:
            if sdr.group_id in result:
                result[sdr.group_id].max_nodes += 1
        self._acceptable = result

    def _update_incorrect_sizes(self, now_ts: float) -> None:
        """clusterstate.go:616 — keep first_observed stable while the same
        discrepancy persists, so fixNodeGroupSize can time it out."""
        result: Dict[str, IncorrectNodeGroupSize] = {}
        for gid, acceptable in self._acceptable.items():
            r = self._readiness.get(gid)
            if r is None:
                continue
            if r.registered > acceptable.max_nodes or r.registered < acceptable.min_nodes:
                incorrect = IncorrectNodeGroupSize(
                    current_size=r.registered,
                    expected_size=acceptable.current_target,
                    first_observed=now_ts,
                )
                existing = self._incorrect.get(gid)
                if (
                    existing is not None
                    and existing.current_size == incorrect.current_size
                    and existing.expected_size == incorrect.expected_size
                ):
                    incorrect = existing
                result[gid] = incorrect
        self._incorrect = result

    def _update_scale_requests(self, now_ts: float) -> None:
        """clusterstate.go:232 — a scale-up is fulfilled when the group has
        no upcoming nodes left; it fails (→ backoff) on provision timeout.
        Expired scale-down requests just age out."""
        provision_timeout = self.options.max_node_provision_time_s
        for gid, req in list(self.scale_up_requests.items()):
            if not self.are_there_upcoming_nodes(gid):
                del self.scale_up_requests[gid]
                self.backoff.remove_backoff(gid)
            elif now_ts - req.start_ts > provision_timeout:
                self.register_failed_scale_up(gid, "timeout", now_ts)
        self.scale_down_requests = [
            sdr for sdr in self.scale_down_requests if sdr.expected_delete_ts > now_ts
        ]

    # -- sizing queries ------------------------------------------------------
    def _provisioned_and_target(self, group_id: str) -> Optional[tuple]:
        acceptable = self._acceptable.get(group_id)
        if acceptable is None:
            group = self._group(group_id)
            if group is None:
                return None
            return 0, group.target_size()
        r = self._readiness.get(group_id, Readiness())
        provisioned = r.registered - r.not_started
        return provisioned, acceptable.current_target

    def are_there_upcoming_nodes(self, group_id: str) -> bool:
        """clusterstate.go:452."""
        pt = self._provisioned_and_target(group_id)
        return pt is not None and pt[1] > pt[0]

    def is_node_group_at_target_size(self, group_id: str) -> bool:
        pt = self._provisioned_and_target(group_id)
        return pt is not None and pt[1] == pt[0]

    def is_node_group_scaling_up(self, group_id: str) -> bool:
        return self.are_there_upcoming_nodes(group_id) and group_id in self.scale_up_requests

    def acceptable_range(self, group_id: str) -> Optional[AcceptableRange]:
        return self._acceptable.get(group_id)

    def incorrect_node_group_size(self, group_id: str) -> Optional[IncorrectNodeGroupSize]:
        return self._incorrect.get(group_id)

    # -- health gates --------------------------------------------------------
    def is_cluster_healthy(self) -> bool:
        """reference clusterstate.go:353 — too many unready nodes halts
        autoscaling."""
        t = self._total
        unready = t.unready
        if unready <= self.options.ok_total_unready_count:
            return True
        if t.registered == 0:
            return True
        return unready * 100.0 / t.registered <= self.options.max_total_unready_percentage

    def is_node_group_healthy(self, group_id: str) -> bool:
        """reference clusterstate.go:368."""
        r = self._readiness.get(group_id, Readiness())
        unready = r.unready
        if unready <= self.options.ok_total_unready_count:
            return True
        if r.registered == 0:
            return True
        return unready * 100.0 / r.registered <= self.options.max_total_unready_percentage

    def is_node_group_safe_to_scale_up(self, group_id: str, now_ts: float) -> bool:
        """healthy + not backed off (reference clusterstate.go:419)."""
        return self.is_node_group_healthy(group_id) and not self.backoff.is_backed_off(
            group_id, now_ts
        )

    # -- upcoming / unregistered (reference :921, :479) ----------------------
    def get_upcoming_nodes(self) -> Dict[str, int]:
        """Per group: target minus everything provisioned-or-hopeless
        (ready + unready + long-unregistered, clusterstate.go:931) —
        injected as virtual nodes during simulation
        (reference static_autoscaler.go:484-519)."""
        upcoming: Dict[str, int] = {}
        for group in self.provider.node_groups():
            gid = group.id()
            r = self._readiness.get(gid, Readiness())
            acceptable = self._acceptable.get(gid)
            target = acceptable.current_target if acceptable else group.target_size()
            ahead = target - (r.ready + r.unready + r.long_unregistered)
            if ahead > 0:
                upcoming[gid] = ahead
        return upcoming

    def unregistered_instances(self) -> Dict[str, List[Instance]]:
        """Cloud instances with no matching registered Node (candidates for
        removeOldUnregisteredNodes, reference static_autoscaler.go:732)."""
        registered_ids = {n.provider_id for n in self._nodes if n.provider_id}
        registered_names = {n.name for n in self._nodes}
        out: Dict[str, List[Instance]] = {}
        for group in self.provider.node_groups():
            missing = [
                inst
                for inst in group.nodes()
                if inst.id not in registered_ids
                and inst.id not in registered_names
                and inst.state != InstanceState.DELETING
            ]
            if missing:
                out[group.id()] = missing
        return out

    def long_unregistered_instances(self) -> Dict[str, List[Instance]]:
        """Unregistered past the provision timeout — the subset
        removeOldUnregisteredNodes may delete."""
        cutoff = self.options.max_node_provision_time_s
        out: Dict[str, List[Instance]] = {}
        for gid, instances in self.unregistered_instances().items():
            stale = [
                i
                for i in instances
                if self._last_update_ts - self._unregistered_since.get(i.id, self._last_update_ts)
                > cutoff
            ]
            if stale:
                out[gid] = stale
        return out

    def instances_with_errors(self) -> Dict[str, List[Instance]]:
        """Creating instances that reported a cloud error — to be deleted and
        re-tried (reference deleteCreatedNodesWithErrors,
        static_autoscaler.go:773 + clusterstate.go:1015-1099)."""
        out: Dict[str, List[Instance]] = {}
        for group in self.provider.node_groups():
            errored = [i for i in group.nodes() if i.error_info is not None]
            if errored:
                out[group.id()] = errored
        return out

    def registered_nodes(self) -> List[Node]:
        """The node list the current iteration's accounting ran against."""
        return list(self._nodes)

    def readiness(self, group_id: str) -> Readiness:
        return self._readiness.get(group_id, Readiness())

    def total_readiness(self) -> Readiness:
        return self._total

    def _group(self, group_id: str):
        for g in self.provider.node_groups():
            if g.id() == group_id:
                return g
        return None
