"""Human-readable autoscaler status — the status-ConfigMap payload.

Reference: cluster-autoscaler/clusterstate/clusterstate.go:701 (GetStatus →
api/ ClusterAutoscalerStatus written to a ConfigMap every loop,
static_autoscaler.go:389-393): cluster-wide and per-node-group Health /
ScaleUp / ScaleDown conditions with readiness counts and timestamps.

The port's copy of ``autoscaler_tpu/clusterstate/status.py``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

from autoscaler_tpu_torch.clusterstate.registry import ClusterStateRegistry


@dataclass
class GroupStatus:
    group_id: str
    health: str
    ready: int
    unready: int
    registered: int
    target: int
    min_size: int
    max_size: int
    scale_up_status: str


@dataclass
class ClusterStatus:
    time_ts: float
    cluster_health: str
    total_ready: int
    total_registered: int
    groups: List[GroupStatus] = field(default_factory=list)
    cluster_name: str = ""  # --cluster-name, shown in the header when set
    # kernel-ladder rungs whose circuit breaker is open/half-open: the
    # autoscaler is still deciding, on a lower rung (degraded mode)
    degraded_rungs: List[str] = field(default_factory=list)
    # last scale-up decision summary (explain.DecisionExplainer
    # last_decision_summary): chosen group, winning expander score, top
    # rejection reasons — the "why" next to the "what" the groups show
    last_decision: Dict = field(default_factory=dict)

    @property
    def degraded(self) -> bool:
        return bool(self.degraded_rungs)

    def render(self) -> str:
        name = f" [{self.cluster_name}]" if self.cluster_name else ""
        lines = [
            f"Cluster-autoscaler status{name} at {time.strftime('%Y-%m-%d %H:%M:%S', time.gmtime(self.time_ts))}:",
            f"Cluster-wide: Health: {self.cluster_health} "
            f"(ready={self.total_ready} registered={self.total_registered})",
        ]
        if self.degraded_rungs:
            lines.append(
                "Degraded: kernel ladder rungs tripped: "
                + ",".join(self.degraded_rungs)
            )
        if self.last_decision:
            d = self.last_decision
            chosen = d.get("chosen") or "none"
            score = d.get("score")
            score_s = f" score={score}" if score is not None else ""
            top = ",".join(d.get("top_rejections", ())) or "none"
            lines.append(
                f"LastDecision (tick {d.get('tick')}): chosen={chosen}"
                f"{score_s} topRejections={top}"
            )
        for g in self.groups:
            lines.append(
                f"  NodeGroup {g.group_id}: Health: {g.health} "
                f"(ready={g.ready}/{g.registered} target={g.target} "
                f"minSize={g.min_size} maxSize={g.max_size}) "
                f"ScaleUp: {g.scale_up_status}"
            )
        return "\n".join(lines)


def build_status(
    csr: ClusterStateRegistry,
    now_ts: float,
    cluster_name: str = "",
    degraded_rungs=(),
    last_decision=None,
) -> ClusterStatus:
    total = csr.total_readiness()
    status = ClusterStatus(
        time_ts=now_ts,
        cluster_health="Healthy" if csr.is_cluster_healthy() else "Unhealthy",
        total_ready=total.ready,
        total_registered=total.registered,
        cluster_name=cluster_name,
        degraded_rungs=list(degraded_rungs),
        last_decision=dict(last_decision or {}),
    )
    for group in csr.provider.node_groups():
        gid = group.id()
        r = csr.readiness(gid)
        if gid in csr.scale_up_requests:
            up = "InProgress"
        elif csr.backoff.is_backed_off(gid, now_ts):
            up = "Backoff"
        else:
            up = "NoActivity"
        status.groups.append(
            GroupStatus(
                group_id=gid,
                health="Healthy" if csr.is_node_group_healthy(gid) else "Unhealthy",
                ready=r.ready,
                unready=r.unready,
                registered=r.registered,
                target=group.target_size(),
                min_size=group.min_size(),
                max_size=group.max_size(),
                scale_up_status=up,
            )
        )
    return status
