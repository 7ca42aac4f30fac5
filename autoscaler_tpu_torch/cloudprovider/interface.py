"""Cloud provider abstraction.

Reference: cluster-autoscaler/cloudprovider/cloud_provider.go:98 (CloudProvider)
and :161 (NodeGroup), Instance/error classes :236-283, PricingModel :307,
ResourceLimiter (cloudprovider/resource_limiter.go). The surface is preserved
so host-side orchestration stays provider-agnostic; concrete providers talk
HTTP to cloud APIs exactly like the reference's 27 adapters — none of that
belongs on the device.

The port's copy of ``autoscaler_tpu/cloudprovider/interface.py``.
"""
from __future__ import annotations

import abc
import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.kube.objects import Node, Pod


class InstanceState(enum.Enum):
    RUNNING = "running"
    CREATING = "creating"
    DELETING = "deleting"


class InstanceErrorClass(enum.Enum):
    """reference: cloud_provider.go:265-283."""

    OUT_OF_RESOURCES = "OutOfResourcesErrorClass"
    QUOTA_EXCEEDED = "QuotaExceededErrorClass"
    OTHER = "OtherErrorClass"


@dataclass
class InstanceErrorInfo:
    error_class: InstanceErrorClass
    error_code: str = ""
    error_message: str = ""


@dataclass
class Instance:
    """reference: cloud_provider.go:236."""

    id: str
    state: InstanceState = InstanceState.RUNNING
    error_info: Optional[InstanceErrorInfo] = None


@dataclass
class ResourceLimiter:
    """Cluster-wide min/max per resource name
    (reference: cloudprovider/resource_limiter.go). Units: cpu in millicores,
    memory in MiB, others in counts."""

    min_limits: Dict[str, float] = field(default_factory=dict)
    max_limits: Dict[str, float] = field(default_factory=dict)

    def get_min(self, resource: str) -> float:
        return self.min_limits.get(resource, 0.0)

    def get_max(self, resource: str) -> float:
        return self.max_limits.get(resource, float("inf"))

    def has_max(self, resource: str) -> bool:
        return resource in self.max_limits


class NodeGroupError(Exception):
    pass


class NodeGroup(abc.ABC):
    """reference: cloud_provider.go:161 — one scalable set of identical nodes
    (MIG / ASG / TPU node pool)."""

    @abc.abstractmethod
    def id(self) -> str: ...

    @abc.abstractmethod
    def min_size(self) -> int: ...

    @abc.abstractmethod
    def max_size(self) -> int: ...

    @abc.abstractmethod
    def target_size(self) -> int:
        """Desired size (may differ from current node count while instances
        are being provisioned/deleted)."""

    @abc.abstractmethod
    def increase_size(self, delta: int) -> None:
        """Cloud-API scale-up request — the actuation boundary."""

    @abc.abstractmethod
    def delete_nodes(self, nodes: Sequence[Node]) -> None:
        """Cloud-API delete of specific instances (also shrinks target)."""

    @abc.abstractmethod
    def decrease_target_size(self, delta: int) -> None:
        """Lower target without deleting existing nodes (failed provisions)."""

    @abc.abstractmethod
    def nodes(self) -> List[Instance]:
        """All instances in the group, including creating/deleting ones."""

    @abc.abstractmethod
    def template_node_info(self) -> Node:
        """A template Node for what a new instance would look like
        (reference TemplateNodeInfo, cloud_provider.go:210)."""

    def exist(self) -> bool:
        return True

    def autoprovisioned(self) -> bool:
        return False

    def create(self) -> "NodeGroup":
        raise NodeGroupError("not implemented")

    def delete(self) -> None:
        raise NodeGroupError("not implemented")

    def get_options(self, defaults):
        """Per-group option overrides (reference cloud_provider.go:230);
        None = use defaults."""
        return None


class PricingModel(abc.ABC):
    """reference: cloud_provider.go:307."""

    @abc.abstractmethod
    def node_price(self, node: Node, start_s: float, end_s: float) -> float: ...

    @abc.abstractmethod
    def pod_price(self, pod: Pod, start_s: float, end_s: float) -> float: ...


class CloudProvider(abc.ABC):
    """reference: cloud_provider.go:98."""

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def node_groups(self) -> List[NodeGroup]: ...

    @abc.abstractmethod
    def node_group_for_node(self, node: Node) -> Optional[NodeGroup]: ...

    def has_instance(self, node: Node) -> bool:
        return self.node_group_for_node(node) is not None

    def pricing(self) -> Optional[PricingModel]:
        return None

    @abc.abstractmethod
    def get_resource_limiter(self) -> ResourceLimiter: ...

    def gpu_label(self) -> str:
        return "cloud.google.com/gke-accelerator"

    def get_available_gpu_types(self) -> List[str]:
        """GPU types this cloud offers (reference GetAvailableGPUTypes,
        cloud_provider.go:130)."""
        return []

    def refresh(self) -> None:
        """Called once per loop before decisions
        (reference static_autoscaler.go:333)."""

    def cleanup(self) -> None:
        pass
