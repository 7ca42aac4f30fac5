"""VPA object model: the VerticalPodAutoscaler CRD analog.

Reference: vertical-pod-autoscaler/pkg/apis/autoscaling.k8s.io/v1/types.go —
VerticalPodAutoscaler (targetRef + updatePolicy + resourcePolicy),
UpdateMode (Off/Initial/Recreate/Auto), ContainerResourcePolicy
(minAllowed/maxAllowed/controlledResources/mode).

The port's copy of ``autoscaler_tpu/vpa/api.py``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from autoscaler_tpu_torch.kube.objects import LabelSelector
from autoscaler_tpu_torch.vpa.recommender import Recommendation


class UpdateMode(enum.Enum):
    OFF = "Off"            # recommend only, never apply
    INITIAL = "Initial"    # apply at pod creation (admission) only
    RECREATE = "Recreate"  # evict + re-admit
    AUTO = "Auto"          # currently equivalent to Recreate


class ContainerScalingMode(enum.Enum):
    AUTO = "Auto"
    OFF = "Off"


@dataclass
class ContainerResourcePolicy:
    """Per-container bounds the recommendation is clamped into
    (types.go ContainerResourcePolicy)."""

    container_name: str = "*"
    mode: ContainerScalingMode = ContainerScalingMode.AUTO
    min_cpu: float = 0.0           # cores
    max_cpu: float = float("inf")
    min_memory: float = 0.0        # bytes
    max_memory: float = float("inf")


@dataclass
class Vpa:
    """One VerticalPodAutoscaler object."""

    name: str
    namespace: str = "default"
    target_selector: LabelSelector = field(default_factory=LabelSelector)
    update_mode: UpdateMode = UpdateMode.AUTO
    resource_policies: List[ContainerResourcePolicy] = field(default_factory=list)

    def policy_for(self, container: str) -> ContainerResourcePolicy:
        wildcard = ContainerResourcePolicy()
        for p in self.resource_policies:
            if p.container_name == container:
                return p
            if p.container_name == "*":
                wildcard = p
        return wildcard

    def clamp(self, container: str, rec: Recommendation) -> Optional[Recommendation]:
        """Recommendation → policy-clamped recommendation; None if scaling is
        off for this container."""
        p = self.policy_for(container)
        if p.mode == ContainerScalingMode.OFF:
            return None

        def _c(v, lo, hi):
            return min(max(v, lo), hi)

        return Recommendation(
            target_cpu=_c(rec.target_cpu, p.min_cpu, p.max_cpu),
            target_memory=_c(rec.target_memory, p.min_memory, p.max_memory),
            lower_cpu=_c(rec.lower_cpu, p.min_cpu, p.max_cpu),
            lower_memory=_c(rec.lower_memory, p.min_memory, p.max_memory),
            upper_cpu=_c(rec.upper_cpu, p.min_cpu, p.max_cpu),
            upper_memory=_c(rec.upper_memory, p.min_memory, p.max_memory),
        )


def match_vpa(vpas: List[Vpa], namespace: str, labels: Dict[str, str]) -> Optional[Vpa]:
    """First VPA whose selector matches the pod's labels in-namespace
    (the admission controller's VPA lookup, resource/pod/handler.go)."""
    for vpa in vpas:
        if vpa.namespace == namespace and vpa.target_selector.matches(labels):
            return vpa
    return None
