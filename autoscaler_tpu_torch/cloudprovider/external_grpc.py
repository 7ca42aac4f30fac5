"""External gRPC cloud provider — run any provider out of process.

Reference: cluster-autoscaler/cloudprovider/externalgrpc/ (4.8k LoC): a
generic client-side CloudProvider speaking the
protos/externalgrpc.proto:29 RPC surface, so operators implement their cloud
integration in any language without forking the autoscaler. Here:

- ExternalGrpcCloudProvider: the client side, plugging into the host control
  plane behind the normal CloudProvider interface, with per-refresh caching
  of the group list (the reference caches similarly to bound RPC chatter).
- serve_cloud_provider(provider): wraps ANY in-process CloudProvider as the
  server side — used for tests and as the adapter harness for real clouds.

The port's copy of ``autoscaler_tpu/cloudprovider/external_grpc.py``.
"""
from __future__ import annotations

import logging
from concurrent import futures
from typing import Dict, List, Optional, Sequence

import numpy as np

import grpc

from autoscaler_tpu_torch.cloudprovider.interface import (
    CloudProvider,
    Instance,
    InstanceErrorClass,
    InstanceErrorInfo,
    InstanceState,
    NodeGroup,
    NodeGroupError,
    PricingModel,
    ResourceLimiter,
)
from autoscaler_tpu_torch.config.options import NodeGroupAutoscalingOptions
from autoscaler_tpu_torch.kube.objects import NUM_RESOURCES, Node, Pod, Resources, Taint
from autoscaler_tpu_torch.rpc import autoscaler_pb2 as pb

logger = logging.getLogger("autoscaler_tpu_torch")

PROVIDER_SERVICE = "autoscaler_tpu.CloudProviderService"

_PROVIDER_METHODS = {
    "NodeGroups": (pb.Empty, pb.NodeGroupsResponse),
    "NodeGroupForNode": (pb.NodeGroupForNodeRequest, pb.NodeGroupForNodeResponse),
    "IncreaseSize": (pb.IncreaseSizeRequest, pb.Empty),
    "DeleteNodes": (pb.DeleteNodesRequest, pb.Empty),
    "DecreaseTargetSize": (pb.DecreaseTargetSizeRequest, pb.Empty),
    "TemplateNodeInfo": (pb.TemplateRequest, pb.TemplateResponse),
    "Instances": (pb.InstancesRequest, pb.InstancesResponse),
    "Refresh": (pb.Empty, pb.Empty),
    "PricingNodePrice": (pb.NodePriceRequest, pb.PriceResponse),
    "PricingPodPrice": (pb.PodPriceRequest, pb.PriceResponse),
    "GPULabel": (pb.Empty, pb.GpuLabelResponse),
    "GetAvailableGPUTypes": (pb.Empty, pb.GpuTypesResponse),
    "GetResourceLimits": (pb.Empty, pb.ResourceLimitsResponse),
    "NodeGroupCreate": (pb.NodeGroupCreateRequest, pb.NodeGroupCreateResponse),
    "NodeGroupDelete": (pb.NodeGroupIdRequest, pb.Empty),
    "NodeGroupGetOptions": (pb.GroupOptionsRequest, pb.GroupOptionsResponse),
    "Cleanup": (pb.Empty, pb.Empty),
}


def _spec_for(g: NodeGroup) -> "pb.NodeGroupSpec":
    return pb.NodeGroupSpec(
        id=g.id(),
        min_size=g.min_size(),
        max_size=g.max_size(),
        target_size=g.target_size(),
        exist=g.exist(),
        autoprovisioned=g.autoprovisioned(),
    )


# ---------------------------------------------------------------------------
# server side: expose an in-process provider over the wire
class _ProviderServicer:
    def __init__(self, provider: CloudProvider):
        self.provider = provider

    def _group(self, gid: str) -> NodeGroup:
        for g in self.provider.node_groups():
            if g.id() == gid:
                return g
        raise NodeGroupError(f"unknown group {gid}")

    def NodeGroups(self, request, context):
        return pb.NodeGroupsResponse(
            groups=[_spec_for(g) for g in self.provider.node_groups()]
        )

    def NodeGroupForNode(self, request, context):
        node = Node(name=request.node_name, provider_id=request.provider_id)
        group = self.provider.node_group_for_node(node)
        return pb.NodeGroupForNodeResponse(group_id=group.id() if group else "")

    def IncreaseSize(self, request, context):
        self._group(request.group_id).increase_size(request.delta)
        return pb.Empty()

    def DeleteNodes(self, request, context):
        nodes = [Node(name=n, provider_id=n) for n in request.node_names]
        self._group(request.group_id).delete_nodes(nodes)
        return pb.Empty()

    def DecreaseTargetSize(self, request, context):
        self._group(request.group_id).decrease_target_size(request.delta)
        return pb.Empty()

    def TemplateNodeInfo(self, request, context):
        tmpl = self._group(request.group_id).template_node_info()
        alloc = np.array(tmpl.allocatable.as_tuple(), "<f4")
        return pb.TemplateResponse(
            allocatable=alloc.tobytes(),
            labels=dict(tmpl.labels),
            taints=[
                pb.TaintMsg(key=t.key, value=t.value, effect=t.effect)
                for t in tmpl.taints
            ],
        )

    def Instances(self, request, context):
        out = []
        for inst in self._group(request.group_id).nodes():
            out.append(
                pb.InstanceMsg(
                    id=inst.id,
                    state=inst.state.value,
                    error_class=(
                        inst.error_info.error_class.value if inst.error_info else ""
                    ),
                    error_message=(
                        inst.error_info.error_message if inst.error_info else ""
                    ),
                )
            )
        return pb.InstancesResponse(instances=out)

    def Refresh(self, request, context):
        self.provider.refresh()
        return pb.Empty()

    def PricingNodePrice(self, request, context):
        model = self.provider.pricing()
        if model is None:
            return pb.PriceResponse(error="pricing not implemented")
        alloc = np.frombuffer(request.allocatable, "<f4")
        node = Node(
            name=request.node_name,
            provider_id=request.provider_id,
            labels=dict(request.labels),
            allocatable=Resources.from_tuple(alloc[:NUM_RESOURCES])
            if len(alloc)
            else Resources(),
        )
        try:
            return pb.PriceResponse(
                price=model.node_price(node, request.start_s, request.end_s)
            )
        except Exception as e:  # noqa: BLE001 — price errors travel as data
            return pb.PriceResponse(error=str(e) or type(e).__name__)

    def PricingPodPrice(self, request, context):
        model = self.provider.pricing()
        if model is None:
            return pb.PriceResponse(error="pricing not implemented")
        req = np.frombuffer(request.requests, "<f4")
        pod = Pod(
            name=request.pod_name,
            requests=Resources.from_tuple(req[:NUM_RESOURCES])
            if len(req)
            else Resources(),
        )
        try:
            return pb.PriceResponse(
                price=model.pod_price(pod, request.start_s, request.end_s)
            )
        except Exception as e:  # noqa: BLE001
            return pb.PriceResponse(error=str(e) or type(e).__name__)

    def GPULabel(self, request, context):
        return pb.GpuLabelResponse(label=self.provider.gpu_label())

    def GetAvailableGPUTypes(self, request, context):
        return pb.GpuTypesResponse(types=list(self.provider.get_available_gpu_types()))

    def GetResourceLimits(self, request, context):
        lim = self.provider.get_resource_limiter()
        return pb.ResourceLimitsResponse(
            min_limits=dict(lim.min_limits), max_limits=dict(lim.max_limits)
        )

    def NodeGroupCreate(self, request, context):
        creator = getattr(self.provider, "create_node_group", None)
        if creator is None:
            context.abort(
                grpc.StatusCode.UNIMPLEMENTED, "provider does not support NAP"
            )
        alloc = np.frombuffer(request.template_allocatable, "<f4")
        template = Node(
            name=f"{request.spec.id}-template",
            allocatable=Resources.from_tuple(alloc[:NUM_RESOURCES]),
            labels=dict(request.template_labels),
            taints=[
                Taint(t.key, t.value, t.effect) for t in request.template_taints
            ],
        )
        group = creator(
            request.spec.id,
            template,
            min_size=request.spec.min_size,
            max_size=request.spec.max_size,
            price_per_hour=request.price_per_hour,
        )
        return pb.NodeGroupCreateResponse(created=_spec_for(group))

    def NodeGroupDelete(self, request, context):
        self._group(request.group_id).delete()
        return pb.Empty()

    def NodeGroupGetOptions(self, request, context):
        defaults = NodeGroupAutoscalingOptions(
            scale_down_utilization_threshold=(
                request.default_scale_down_utilization_threshold
            ),
            scale_down_gpu_utilization_threshold=(
                request.default_scale_down_gpu_utilization_threshold
            ),
            scale_down_unneeded_time_s=request.default_scale_down_unneeded_time_s,
            scale_down_unready_time_s=request.default_scale_down_unready_time_s,
            max_node_provision_time_s=request.default_max_node_provision_time_s,
        )
        opts = self._group(request.group_id).get_options(defaults)
        if opts is None:
            return pb.GroupOptionsResponse(has=False)
        return pb.GroupOptionsResponse(
            has=True,
            scale_down_utilization_threshold=opts.scale_down_utilization_threshold,
            scale_down_gpu_utilization_threshold=(
                opts.scale_down_gpu_utilization_threshold
            ),
            scale_down_unneeded_time_s=opts.scale_down_unneeded_time_s,
            scale_down_unready_time_s=opts.scale_down_unready_time_s,
            max_node_provision_time_s=opts.max_node_provision_time_s,
        )

    def Cleanup(self, request, context):
        self.provider.cleanup()
        return pb.Empty()


def serve_cloud_provider(provider: CloudProvider, address: str = "127.0.0.1:0"):
    """→ (server, port)."""
    servicer = _ProviderServicer(provider)
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req.FromString,
            response_serializer=lambda m: m.SerializeToString(),
        )
        for name, (req, _resp) in _PROVIDER_METHODS.items()
    }
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(PROVIDER_SERVICE, handlers),)
    )
    port = server.add_insecure_port(address)
    server.start()
    return server, port


# ---------------------------------------------------------------------------
# client side: the provider the host control plane uses
class _RemoteNodeGroup(NodeGroup):
    def __init__(self, provider: "ExternalGrpcCloudProvider", spec: pb.NodeGroupSpec):
        self._provider = provider
        self._spec = spec

    def id(self) -> str:
        return self._spec.id

    def min_size(self) -> int:
        return self._spec.min_size

    def max_size(self) -> int:
        return self._spec.max_size

    def target_size(self) -> int:
        return self._spec.target_size

    def increase_size(self, delta: int) -> None:
        self._provider._call(
            "IncreaseSize", pb.IncreaseSizeRequest(group_id=self._spec.id, delta=delta)
        )
        self._spec.target_size += delta

    def delete_nodes(self, nodes: Sequence[Node]) -> None:
        self._provider._call(
            "DeleteNodes",
            pb.DeleteNodesRequest(
                group_id=self._spec.id, node_names=[n.name for n in nodes]
            ),
        )
        self._spec.target_size -= len(nodes)

    def decrease_target_size(self, delta: int) -> None:
        self._provider._call(
            "DecreaseTargetSize",
            pb.DecreaseTargetSizeRequest(group_id=self._spec.id, delta=delta),
        )
        self._spec.target_size -= delta

    def nodes(self) -> List[Instance]:
        resp = self._provider._call(
            "Instances", pb.InstancesRequest(group_id=self._spec.id)
        )
        out = []
        for m in resp.instances:
            error = None
            if m.error_class:
                error = InstanceErrorInfo(
                    InstanceErrorClass(m.error_class), error_message=m.error_message
                )
            out.append(
                Instance(id=m.id, state=InstanceState(m.state), error_info=error)
            )
        return out

    def template_node_info(self) -> Node:
        resp = self._provider._call(
            "TemplateNodeInfo", pb.TemplateRequest(group_id=self._spec.id)
        )
        alloc = np.frombuffer(resp.allocatable, "<f4")
        return Node(
            name=f"template-{self._spec.id}",
            allocatable=Resources.from_tuple(alloc[:NUM_RESOURCES]),
            labels=dict(resp.labels),
            taints=[Taint(t.key, t.value, t.effect) for t in resp.taints],
        )

    def exist(self) -> bool:
        # absent field (legacy server predating `exist`) = the group exists
        return self._spec.exist if self._spec.HasField("exist") else True

    def autoprovisioned(self) -> bool:
        return self._spec.autoprovisioned

    def create(self) -> NodeGroup:
        """Materialize a server-advertised NAP placeholder (exist=false) via
        NodeGroupCreate — the remote half of NodeGroup.Create
        (cloud_provider.go:219)."""
        return self._provider.group_factory(self)

    def delete(self) -> None:
        self._provider._call(
            "NodeGroupDelete", pb.NodeGroupIdRequest(group_id=self._spec.id)
        )
        self._provider._groups = [
            g for g in self._provider._groups if g.id() != self._spec.id
        ]

    def get_options(self, defaults):
        try:
            resp = self._provider._call(
                "NodeGroupGetOptions",
                pb.GroupOptionsRequest(
                    group_id=self._spec.id,
                    default_scale_down_utilization_threshold=(
                        defaults.scale_down_utilization_threshold
                    ),
                    default_scale_down_gpu_utilization_threshold=(
                        defaults.scale_down_gpu_utilization_threshold
                    ),
                    default_scale_down_unneeded_time_s=(
                        defaults.scale_down_unneeded_time_s
                    ),
                    default_scale_down_unready_time_s=(
                        defaults.scale_down_unready_time_s
                    ),
                    default_max_node_provision_time_s=(
                        defaults.max_node_provision_time_s
                    ),
                ),
            )
        except grpc.RpcError as e:
            # reference semantics: an RPC error means "use defaults"
            # (externalgrpc.proto:111) — but log first, as the reference
            # client does (klog.V(1)), so a persistently broken provider
            # endpoint degrades visibly instead of silently
            logger.warning(
                "NodeGroupGetOptions(%s) failed, using defaults: %s",
                self._spec.id, e,
            )
            return None
        if not resp.has:
            return None
        return NodeGroupAutoscalingOptions(
            scale_down_utilization_threshold=resp.scale_down_utilization_threshold,
            scale_down_gpu_utilization_threshold=(
                resp.scale_down_gpu_utilization_threshold
            ),
            scale_down_unneeded_time_s=resp.scale_down_unneeded_time_s,
            scale_down_unready_time_s=resp.scale_down_unready_time_s,
            max_node_provision_time_s=resp.max_node_provision_time_s,
        )


class _RemotePricingModel(PricingModel):
    """Client-side PricingModel delegating to the server's
    (externalgrpc.proto:45-51). A server without pricing returns an error
    field; that surfaces as NodeGroupError like the reference's ErrNotImplemented."""

    def __init__(self, provider: "ExternalGrpcCloudProvider"):
        self._provider = provider

    def node_price(self, node: Node, start_s: float, end_s: float) -> float:
        resp = self._provider._call(
            "PricingNodePrice",
            pb.NodePriceRequest(
                node_name=node.name,
                provider_id=node.provider_id,
                labels=dict(node.labels),
                allocatable=np.array(node.allocatable.as_tuple(), "<f4").tobytes(),
                start_s=start_s,
                end_s=end_s,
            ),
        )
        if resp.error:
            raise NodeGroupError(resp.error)
        return resp.price

    def pod_price(self, pod: Pod, start_s: float, end_s: float) -> float:
        resp = self._provider._call(
            "PricingPodPrice",
            pb.PodPriceRequest(
                pod_name=pod.name,
                requests=np.array(pod.requests.as_tuple(), "<f4").tobytes(),
                start_s=start_s,
                end_s=end_s,
            ),
        )
        if resp.error:
            raise NodeGroupError(resp.error)
        return resp.price


class ExternalGrpcCloudProvider(CloudProvider):
    def __init__(self, target: str, resource_limiter: Optional[ResourceLimiter] = None):
        self._channel = grpc.insecure_channel(target)
        self._host_limiter = resource_limiter   # sticky operator override
        self._limiter: Optional[ResourceLimiter] = None  # server-derived cache
        self._groups: List[_RemoteNodeGroup] = []
        self._node_group_cache: Dict[str, str] = {}
        self._gpu_label: Optional[str] = None

    def _call(self, method: str, request):
        req_cls, resp_cls = _PROVIDER_METHODS[method]
        rpc = self._channel.unary_unary(
            f"/{PROVIDER_SERVICE}/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString,
        )
        return rpc(request)

    def name(self) -> str:
        return "externalgrpc"

    def refresh(self) -> None:
        self._call("Refresh", pb.Empty())
        resp = self._call("NodeGroups", pb.Empty())
        self._groups = [_RemoteNodeGroup(self, spec) for spec in resp.groups]
        self._node_group_cache.clear()
        # server-derived limits refetch next read so runtime cap changes on
        # the provider side propagate within one loop (host-provided limits
        # stay sticky); same for the GPU label
        self._limiter = None
        self._gpu_label = None

    def pricing(self) -> Optional[PricingModel]:
        return _RemotePricingModel(self)

    def gpu_label(self) -> str:
        if self._gpu_label is None:
            self._gpu_label = self._call("GPULabel", pb.Empty()).label
        return self._gpu_label

    def get_available_gpu_types(self) -> List[str]:
        return list(self._call("GetAvailableGPUTypes", pb.Empty()).types)

    def group_factory(self, candidate: NodeGroup) -> NodeGroup:
        """NAP factory: materialize a host-side candidate group on the remote
        provider (plug as AutoprovisioningNodeGroupListProcessor's
        group_factory). reference: orchestrator.go:217 CreateNodeGroup."""
        return self.create_node_group(
            candidate.id(),
            candidate.template_node_info(),
            min_size=candidate.min_size(),
            max_size=candidate.max_size(),
            price_per_hour=getattr(candidate, "price_per_hour", 0.0),
        )

    def create_node_group(
        self,
        name: str,
        template: Node,
        min_size: int = 0,
        max_size: int = 100,
        price_per_hour: float = 0.0,
    ) -> NodeGroup:
        """Same keyword contract as the server-side provider hook, so
        serve_cloud_provider(ExternalGrpcCloudProvider(...)) chains — the
        servicer's NodeGroupCreate can call straight through this proxy."""
        resp = self._call(
            "NodeGroupCreate",
            pb.NodeGroupCreateRequest(
                spec=pb.NodeGroupSpec(
                    id=name,
                    min_size=min_size,
                    max_size=max_size,
                    target_size=0,
                    autoprovisioned=True,
                ),
                template_allocatable=np.array(
                    template.allocatable.as_tuple(), "<f4"
                ).tobytes(),
                template_labels=dict(template.labels),
                template_taints=[
                    pb.TaintMsg(key=t.key, value=t.value, effect=t.effect)
                    for t in template.taints
                ],
                price_per_hour=price_per_hour,
            ),
        )
        group = _RemoteNodeGroup(self, resp.created)
        self._groups = [g for g in self._groups if g.id() != name] + [group]
        return group

    def node_groups(self) -> List[NodeGroup]:
        if not self._groups:
            self.refresh()
        return list(self._groups)

    def node_group_for_node(self, node: Node) -> Optional[NodeGroup]:
        gid = self._node_group_cache.get(node.name)
        if gid is None:
            resp = self._call(
                "NodeGroupForNode",
                pb.NodeGroupForNodeRequest(
                    node_name=node.name, provider_id=node.provider_id
                ),
            )
            gid = resp.group_id
            self._node_group_cache[node.name] = gid
        if not gid:
            return None
        for g in self.node_groups():
            if g.id() == gid:
                return g
        return None

    def get_resource_limiter(self) -> ResourceLimiter:
        # explicit host-side limits win; otherwise ask the server
        # (externalgrpc analog of cloud_provider.go:127 GetResourceLimiter)
        if self._host_limiter is not None:
            return self._host_limiter
        if self._limiter is not None:
            return self._limiter
        try:
            resp = self._call("GetResourceLimits", pb.Empty())
        except grpc.RpcError:
            # transient server failure: return unlimited for THIS call but do
            # not cache it — the next loop retries instead of silently running
            # without the operator's caps forever
            return ResourceLimiter()
        self._limiter = ResourceLimiter(
            min_limits=dict(resp.min_limits), max_limits=dict(resp.max_limits)
        )
        return self._limiter

    def cleanup(self) -> None:
        try:
            self._call("Cleanup", pb.Empty())
        except grpc.RpcError:
            pass  # server already gone — closing the channel is the point
        self._channel.close()
