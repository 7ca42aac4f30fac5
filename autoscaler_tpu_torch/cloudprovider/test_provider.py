"""In-memory fake cloud provider for tests and local simulation.

Reference: cluster-autoscaler/cloudprovider/test/test_cloud_provider.go:49
(TestCloudProvider) and :323 (TestNodeGroup), with the OnScaleUpFunc /
OnScaleDownFunc callback seams (:34-46) that nearly every core test uses to
assert actuation without a cloud.

The port's copy of ``autoscaler_tpu/cloudprovider/test_provider.py``.
"""
from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from autoscaler_tpu_torch.cloudprovider.interface import (
    CloudProvider,
    Instance,
    InstanceErrorInfo,
    InstanceState,
    NodeGroup,
    NodeGroupError,
    PricingModel,
    ResourceLimiter,
)
from autoscaler_tpu_torch.kube.objects import Node, Pod


class TestNodeGroup(NodeGroup):
    __test__ = False  # not a pytest class despite the name

    def __init__(
        self,
        name: str,
        min_size: int,
        max_size: int,
        target_size: int,
        template: Node,
        provider: "TestCloudProvider",
        price_per_hour: float = 1.0,
        autoprovisioned: bool = False,
    ):
        self._name = name
        self._min = min_size
        self._max = max_size
        self._target = target_size
        self._template = template
        self._provider = provider
        self.price_per_hour = price_per_hour
        self._autoprovisioned = autoprovisioned

    def autoprovisioned(self) -> bool:
        return self._autoprovisioned

    def delete(self) -> None:
        if not self._autoprovisioned:
            raise NodeGroupError("only autoprovisioned groups can be deleted")
        if self._target > 0 or self._provider._instances.get(self._name):
            raise NodeGroupError("group not empty")
        self._provider.remove_node_group(self._name)

    def id(self) -> str:
        return self._name

    def min_size(self) -> int:
        return self._min

    def max_size(self) -> int:
        return self._max

    def target_size(self) -> int:
        return self._target

    def increase_size(self, delta: int) -> None:
        if delta <= 0:
            raise NodeGroupError("size increase must be positive")
        if self._target + delta > self._max:
            raise NodeGroupError(
                f"size increase too large: {self._target}+{delta} > max {self._max}"
            )
        # callback FIRST: a raising on_scale_up simulates the cloud rejecting
        # the request, and a rejected IncreaseSize must not advance the
        # target — otherwise fault-injection tests "deny" capacity that the
        # fake then quietly provisions anyway (reference OnScaleUpFunc,
        # test_cloud_provider.go:34-46, runs before the size bump too)
        self._provider._on_scale_up(self._name, delta)
        self._target += delta

    def delete_nodes(self, nodes: Sequence[Node]) -> None:
        ids = {i.id for i in self._provider._instances.get(self._name, [])}
        for node in nodes:
            group = self._provider.node_group_for_node(node)
            if group is not None:
                if group is not self:
                    raise NodeGroupError(f"{node.name} belongs to {group.id()}")
            elif node.name not in ids and node.provider_id not in ids:
                # unregistered instance (e.g. stuck provisioning) — accept only
                # if it is one of this group's cloud instances
                raise NodeGroupError(f"{node.name} does not belong to {self._name}")
        self._target -= len(nodes)
        for node in nodes:
            self._provider._remove_instance(self._name, node)
            self._provider._on_scale_down(self._name, node.name)

    def decrease_target_size(self, delta: int) -> None:
        if delta <= 0:
            raise NodeGroupError("decrease must be positive")
        self._target -= delta

    def nodes(self) -> List[Instance]:
        return list(self._provider._instances.get(self._name, []))

    def template_node_info(self) -> Node:
        tmpl = copy.deepcopy(self._template)
        tmpl.name = f"template-{self._name}-{next(self._provider._template_seq)}"
        return tmpl

    def set_target_size(self, target: int) -> None:
        self._target = target

    def get_options(self, defaults):
        """Per-group overrides when set via `options` (reference
        TestNodeGroup.GetOptions); None = defaults."""
        return getattr(self, "options", None)


class TestPricingModel(PricingModel):
    def __init__(self, provider: "TestCloudProvider"):
        self._provider = provider

    def node_price(self, node: Node, start_s: float, end_s: float) -> float:
        group = self._provider.node_group_for_node(node)
        if group is None and node.name.startswith("template-"):
            # template nodes are named template-<group>-<seq> (TestNodeGroup)
            gid = node.name[len("template-"):].rsplit("-", 1)[0]
            group = self._provider._groups.get(gid)
        rate = group.price_per_hour if isinstance(group, TestNodeGroup) else 1.0
        return rate * (end_s - start_s) / 3600.0

    def pod_price(self, pod: Pod, start_s: float, end_s: float) -> float:
        # flat per-pod resource pricing, enough for price-expander tests
        r = pod.requests
        rate = r.cpu_m / 1000.0 * 0.03 + r.memory / (1024**3) * 0.005
        return rate * (end_s - start_s) / 3600.0


class TestCloudProvider(CloudProvider):
    __test__ = False  # not a pytest class despite the name

    def __init__(
        self,
        on_scale_up: Optional[Callable[[str, int], None]] = None,
        on_scale_down: Optional[Callable[[str, str], None]] = None,
        resource_limiter: Optional[ResourceLimiter] = None,
    ):
        self._groups: Dict[str, TestNodeGroup] = {}
        self._node_to_group: Dict[str, str] = {}
        self._instances: Dict[str, List[Instance]] = {}
        self.on_scale_up = on_scale_up
        self.on_scale_down = on_scale_down
        self._limiter = resource_limiter or ResourceLimiter()
        self._template_seq = itertools.count()
        self.scale_up_calls: List[tuple] = []
        self.scale_down_calls: List[tuple] = []
        self.gpu_types: List[str] = []

    # -- test wiring ---------------------------------------------------------
    def add_node_group(
        self,
        name: str,
        min_size: int,
        max_size: int,
        target_size: int,
        template: Node,
        price_per_hour: float = 1.0,
        autoprovisioned: bool = False,
    ) -> TestNodeGroup:
        group = TestNodeGroup(
            name,
            min_size,
            max_size,
            target_size,
            template,
            self,
            price_per_hour,
            autoprovisioned,
        )
        self._groups[name] = group
        self._instances.setdefault(name, [])
        return group

    def create_node_group(
        self,
        name: str,
        template: Node,
        min_size: int = 0,
        max_size: int = 100,
        price_per_hour: float = 1.0,
    ) -> TestNodeGroup:
        """NAP materialization seam (NodeGroup.Create analog) — also the
        server-side hook for NodeGroupCreate over external gRPC."""
        return self.add_node_group(
            name, min_size, max_size, 0, template, price_per_hour, autoprovisioned=True
        )

    def remove_node_group(self, name: str) -> None:
        self._groups.pop(name, None)
        self._instances.pop(name, None)
        self._node_to_group = {
            k: v for k, v in self._node_to_group.items() if v != name
        }

    def add_node(self, group_name: str, node: Node) -> None:
        if group_name not in self._groups:
            raise NodeGroupError(f"unknown group {group_name}")
        self._node_to_group[node.name] = group_name
        self._instances[group_name].append(Instance(id=node.provider_id or node.name))

    def add_instance(self, group_name: str, instance: Instance) -> None:
        self._instances[group_name].append(instance)

    def attach_node(self, group_name: str, node: Node) -> None:
        """Map a Node object to an EXISTING cloud instance of the group —
        the registration step of a boot cycle (loadgen's kubelet analog).
        Unlike add_node, no new instance is minted."""
        if group_name not in self._groups:
            raise NodeGroupError(f"unknown group {group_name}")
        self._node_to_group[node.name] = group_name

    def remove_instance(self, group_name: str, instance_id: str) -> None:
        """Drop one cloud instance by id — the out-of-band reap seam
        (loadgen resize-down); no scale-down callback fires."""
        instances = self._instances.get(group_name, [])
        for i, inst in enumerate(instances):
            if inst.id == instance_id:
                del instances[i]
                return

    def _on_scale_up(self, group: str, delta: int) -> None:
        self.scale_up_calls.append((group, delta))
        if self.on_scale_up:
            self.on_scale_up(group, delta)

    def _remove_instance(self, group: str, node: Node) -> None:
        """Remove at most one instance per deleted node (prefer provider_id)."""
        instances = self._instances.get(group, [])
        for key in (node.provider_id, node.name):
            if not key:
                continue
            for i, inst in enumerate(instances):
                if inst.id == key:
                    del instances[i]
                    return

    def _on_scale_down(self, group: str, node_name: str) -> None:
        self.scale_down_calls.append((group, node_name))
        self._node_to_group.pop(node_name, None)
        if self.on_scale_down:
            self.on_scale_down(group, node_name)

    # -- CloudProvider -------------------------------------------------------
    def name(self) -> str:
        return "test"

    def node_groups(self) -> List[NodeGroup]:
        return list(self._groups.values())

    def node_group_for_node(self, node: Node) -> Optional[NodeGroup]:
        g = self._node_to_group.get(node.name)
        return self._groups.get(g) if g else None

    def group_of_node_map(self) -> Dict[str, str]:
        """node name → group name, the packer's group_of_node input."""
        return dict(self._node_to_group)

    def pricing(self) -> PricingModel:
        return TestPricingModel(self)

    def get_available_gpu_types(self) -> List[str]:
        return list(self.gpu_types)

    def get_resource_limiter(self) -> ResourceLimiter:
        return self._limiter
