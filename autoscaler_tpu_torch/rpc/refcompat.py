"""Wire-compatible adapters for the reference's public gRPC plugin protocols.

The reference ships two out-of-process plugin protocols third parties build
against:

  * the external cloud provider —
    cluster-autoscaler/cloudprovider/externalgrpc/protos/externalgrpc.proto:29
    (service ``clusterautoscaler.cloudprovider.v1.externalgrpc.CloudProvider``)
  * the expander plugin —
    cluster-autoscaler/expander/grpcplugin/protos/expander.proto:10
    (service ``grpcplugin.Expander``)

This module makes those binaries plug into THIS framework unmodified, and
exposes this framework's components to reference autoscalers, in both
directions:

  * :class:`RefProtocolCloudProvider` — our ``CloudProvider`` interface
    backed by a remote server speaking the REFERENCE provider protocol (an
    operator's existing externalgrpc provider binary just works).
  * :class:`RefExpanderClient` — calls an operator's existing gRPC expander
    plugin with reference-format ``BestOptionsRequest``s.
  * :func:`serve_ref_provider` / :func:`serve_ref_expander` — serve the
    reference wire formats backed by our provider/expander implementations,
    so a stock reference autoscaler can consume this framework's components
    (``--cloud-provider=externalgrpc`` / ``--grpc-expander-url``).

Why a hand-rolled codec: the reference messages embed ``k8s.io.api.core.v1``
objects, whose generated clients are enormous and which this framework
deliberately does not vendor (SURVEY.md scopes generated clients out). The
autoscaler touches a narrow, stable subset — object name/labels/annotations,
allocatable/capacity quantity maps, taints, container resource requests — so
the codec speaks exactly that subset at the protobuf wire level and ignores
unknown fields, which is precisely proto3's compatibility contract. Field
numbers are re-derived from the public schemas (not copied code):

  externalgrpc.proto messages as cited per function below;
  vendor/k8s.io/api/core/v1/generated.proto — Node{metadata=1,spec=2,
  status=3} (:2209), NodeSpec{providerID=3,unschedulable=4,taints=5}
  (:2420-2440), NodeStatus{capacity=1,allocatable=2} (:2453), Taint{key=1,
  value=2,effect=3} (:5441), Pod{metadata=1,spec=2} (:3058),
  PodSpec{containers=2,nodeSelector=7} (:3544,3593), Container{name=1,
  resources=8} (:723), ResourceRequirements{limits=1,requests=2} (:4500);
  apimachinery resource Quantity{string=1} (:96), meta/v1
  ObjectMeta{name=1,namespace=3,labels=11,annotations=12} (:650-761),
  Duration{duration=1, nanoseconds} (:315).

Byte-level compatibility is locked by tests/test_refcompat.py, which
protoc-compiles the reference .proto files at test time and round-trips
messages between the generated oracle and this codec.

The port's copy of ``autoscaler_tpu/rpc/refcompat.py``.
"""
from __future__ import annotations

import struct
from concurrent import futures
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import grpc

from autoscaler_tpu_torch.cloudprovider.interface import (
    CloudProvider,
    Instance,
    InstanceErrorClass,
    InstanceErrorInfo,
    InstanceState,
    NodeGroup,
    PricingModel,
    ResourceLimiter,
)
from autoscaler_tpu_torch.config.options import NodeGroupAutoscalingOptions
from autoscaler_tpu_torch.kube.convert import GPU_RESOURCE, TPU_RESOURCE, parse_quantity
from autoscaler_tpu_torch.kube.objects import Node, Pod, Resources, Taint

PROVIDER_SERVICE = "clusterautoscaler.cloudprovider.v1.externalgrpc.CloudProvider"
EXPANDER_SERVICE = "grpcplugin.Expander"

# ---------------------------------------------------------------------------
# protobuf wire primitives (proto3): varint (wt 0), 64-bit (wt 1),
# length-delimited (wt 2), 32-bit (wt 5)


def _varint(n: int) -> bytes:
    if n < 0:  # proto3 int32/int64: negatives sign-extend to 64 bits
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(no: int, wt: int) -> bytes:
    return _varint((no << 3) | wt)


def _len_f(no: int, payload: bytes) -> bytes:
    return _tag(no, 2) + _varint(len(payload)) + payload


def _str_f(no: int, s: str) -> bytes:
    return _len_f(no, s.encode()) if s else b""


def _int_f(no: int, n: int) -> bytes:
    return (_tag(no, 0) + _varint(int(n))) if n else b""


def _bool_f(no: int, v: bool) -> bytes:
    return (_tag(no, 0) + _varint(1)) if v else b""


def _double_f(no: int, x: float) -> bytes:
    return (_tag(no, 1) + struct.pack("<d", float(x))) if x else b""


def _map_ss_f(no: int, d: Dict[str, str]) -> bytes:
    out = b""
    for k, v in d.items():
        out += _len_f(no, _str_f(1, k) + _str_f(2, v))
    return out


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    n = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _decode(buf: bytes) -> Dict[int, list]:
    """Parse one message into {field_no: [raw values]} (varints as int,
    len-delimited as bytes, fixed64/32 as raw bytes). Unknown fields are
    retained here and simply never read — proto3 forward compatibility."""
    fields: Dict[int, list] = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        no, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
        elif wt == 1:
            val, i = buf[i : i + 8], i + 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            val, i = buf[i : i + ln], i + ln
        elif wt == 5:
            val, i = buf[i : i + 4], i + 4
        else:  # wire types 3/4 (groups) do not appear in proto3 schemas
            raise ValueError(f"unsupported wire type {wt}")
        fields.setdefault(no, []).append(val)
    return fields


def _get_str(f: Dict[int, list], no: int, default: str = "") -> str:
    return f[no][-1].decode() if no in f else default


def _get_int(f: Dict[int, list], no: int, default: int = 0) -> int:
    if no not in f:
        return default
    n = f[no][-1]
    return n - (1 << 64) if n >= (1 << 63) else n  # undo 64-bit sign-extend


def _get_bytes(f: Dict[int, list], no: int) -> bytes:
    return f[no][-1] if no in f else b""


def _get_double(f: Dict[int, list], no: int, default: float = 0.0) -> float:
    return struct.unpack("<d", f[no][-1])[0] if no in f else default


def _get_map_ss(f: Dict[int, list], no: int) -> Dict[str, str]:
    out = {}
    for entry in f.get(no, ()):
        e = _decode(entry)
        out[_get_str(e, 1)] = _get_str(e, 2)
    return out


# ---------------------------------------------------------------------------
# k8s core/v1 object subset <-> our object model


def _quantity_msg(s: str) -> bytes:
    return _str_f(1, s)


def _resources_to_qmap(res: Resources) -> Dict[str, str]:
    """Our dense vector -> k8s quantity strings (canonical integer forms:
    cpu in millicores 'Nm', byte and count quantities as plain integers)."""
    out: Dict[str, str] = {}
    if res.cpu_m:
        out["cpu"] = f"{int(res.cpu_m)}m"
    if res.memory:
        out["memory"] = str(int(res.memory))
    if res.ephemeral:
        out["ephemeral-storage"] = str(int(res.ephemeral))
    if res.gpu:
        out[GPU_RESOURCE] = str(int(res.gpu))
    if res.tpu:
        out[TPU_RESOURCE] = str(int(res.tpu))
    if res.pods:
        out["pods"] = str(int(res.pods))
    return out


def _qmap_to_resources(f: Dict[int, list], no: int) -> Resources:
    vals = {"cpu": 0.0, "memory": 0.0, "ephemeral-storage": 0.0,
            GPU_RESOURCE: 0.0, TPU_RESOURCE: 0.0, "pods": 0.0}
    for entry in f.get(no, ()):
        e = _decode(entry)
        name = _get_str(e, 1)
        q = _get_str(_decode(_get_bytes(e, 2)), 1)
        if name in vals:
            vals[name] = parse_quantity(q)
    return Resources(
        cpu_m=vals["cpu"] * 1000.0,
        memory=vals["memory"],
        ephemeral=vals["ephemeral-storage"],
        gpu=vals[GPU_RESOURCE],
        tpu=vals[TPU_RESOURCE],
        pods=vals["pods"],
    )


def _qmap_f(no: int, qmap: Dict[str, str]) -> bytes:
    out = b""
    for name, q in qmap.items():
        out += _len_f(no, _str_f(1, name) + _len_f(2, _quantity_msg(q)))
    return out


def _objectmeta(name: str, labels: Dict[str, str],
                annotations: Dict[str, str], namespace: str = "") -> bytes:
    return (
        _str_f(1, name)
        + _str_f(3, namespace)
        + _map_ss_f(11, labels)
        + _map_ss_f(12, annotations)
    )


def encode_v1_node(node: Node) -> bytes:
    """Our Node -> k8s.io.api.core.v1.Node wire bytes (subset)."""
    qmap = _resources_to_qmap(node.allocatable)
    taints = b"".join(
        _len_f(5, _str_f(1, t.key) + _str_f(2, t.value) + _str_f(3, t.effect))
        for t in node.taints
    )
    spec = _str_f(3, node.provider_id) + _bool_f(4, node.unschedulable) + taints
    status = _qmap_f(1, qmap) + _qmap_f(2, qmap)  # capacity + allocatable
    return (
        _len_f(1, _objectmeta(node.name, node.labels, node.annotations))
        + _len_f(2, spec)
        + _len_f(3, status)
    )


def decode_v1_node(buf: bytes) -> Node:
    """k8s.io.api.core.v1.Node wire bytes -> our Node (subset; allocatable
    preferred, falling back to capacity as the kubelet does)."""
    f = _decode(buf)
    meta = _decode(_get_bytes(f, 1))
    spec = _decode(_get_bytes(f, 2))
    status = _decode(_get_bytes(f, 3))
    alloc = _qmap_to_resources(status, 2)
    if alloc == Resources():
        alloc = _qmap_to_resources(status, 1)
    taints = []
    for t in spec.get(5, ()):
        tf = _decode(t)
        taints.append(
            Taint(key=_get_str(tf, 1), value=_get_str(tf, 2),
                  effect=_get_str(tf, 3))
        )
    return Node(
        name=_get_str(meta, 1),
        allocatable=alloc,
        labels=_get_map_ss(meta, 11),
        annotations=_get_map_ss(meta, 12),
        taints=taints,
        unschedulable=bool(_get_int(spec, 4)),
        provider_id=_get_str(spec, 3),
    )


def encode_v1_pod(pod: Pod) -> bytes:
    """Our Pod -> k8s.io.api.core.v1.Pod wire bytes (one container carrying
    the pod's aggregate requests — the shape the reference's expander and
    pricing consumers read back via PodRequests)."""
    requests = _qmap_f(2, _resources_to_qmap(pod.requests))
    container = _str_f(1, "main") + _len_f(8, requests)
    spec = _len_f(2, container) + _map_ss_f(7, dict(pod.node_selector or {}))
    return (
        _len_f(1, _objectmeta(pod.name, dict(pod.labels), {}, pod.namespace))
        + _len_f(2, spec)
    )


def decode_v1_pod(buf: bytes) -> Pod:
    f = _decode(buf)
    meta = _decode(_get_bytes(f, 1))
    spec = _decode(_get_bytes(f, 2))
    total = Resources()
    for c in spec.get(2, ()):
        cf = _decode(c)
        rr = _decode(_get_bytes(cf, 8))
        total = total + _qmap_to_resources(rr, 2)
    return Pod(
        name=_get_str(meta, 1),
        namespace=_get_str(meta, 3, "default") or "default",
        labels=_get_map_ss(meta, 11),
        requests=total,
        node_selector=_get_map_ss(spec, 7),
    )


def _duration_f(no: int, seconds: float) -> bytes:
    # meta.v1.Duration wraps Go time.Duration: int64 nanoseconds, field 1
    return _len_f(no, _int_f(1, int(seconds * 1e9)))


def _duration_get(f: Dict[int, list], no: int) -> float:
    return _get_int(_decode(_get_bytes(f, no)), 1) / 1e9


# ---------------------------------------------------------------------------
# externalgrpc.proto message helpers (field numbers per the reference file)


def _ext_node_msg(node: Node) -> bytes:
    # ExternalGrpcNode{providerID=1, name=2, labels=3, annotations=4}
    return (
        _str_f(1, node.provider_id)
        + _str_f(2, node.name)
        + _map_ss_f(3, node.labels)
        + _map_ss_f(4, node.annotations)
    )


def _decode_ext_node(buf: bytes) -> Node:
    f = _decode(buf)
    return Node(
        name=_get_str(f, 2),
        provider_id=_get_str(f, 1),
        labels=_get_map_ss(f, 3),
        annotations=_get_map_ss(f, 4),
    )


def _options_msg(o: NodeGroupAutoscalingOptions) -> bytes:
    # NodeGroupAutoscalingOptions{1 double, 2 double, 3 Duration, 4 Duration}
    return (
        _double_f(1, o.scale_down_utilization_threshold)
        + _double_f(2, o.scale_down_gpu_utilization_threshold)
        + _duration_f(3, o.scale_down_unneeded_time_s)
        + _duration_f(4, o.scale_down_unready_time_s)
    )


def _decode_options(buf: bytes) -> NodeGroupAutoscalingOptions:
    f = _decode(buf)
    return NodeGroupAutoscalingOptions(
        scale_down_utilization_threshold=_get_double(f, 1),
        scale_down_gpu_utilization_threshold=_get_double(f, 2),
        scale_down_unneeded_time_s=_duration_get(f, 3),
        scale_down_unready_time_s=_duration_get(f, 4),
        # not part of the reference protocol; callers keep their default
        max_node_provision_time_s=0.0,
    )


_STATE_TO_WIRE = {
    InstanceState.RUNNING: 1,
    InstanceState.CREATING: 2,
    InstanceState.DELETING: 3,
}
_WIRE_TO_STATE = {v: k for k, v in _STATE_TO_WIRE.items()}
# reference cloud_provider.go:278-283: OutOfResourcesErrorClass=1 (covers
# stockout AND quota-exceeded), OtherErrorClass=99 — our finer-grained
# QUOTA_EXCEEDED folds onto the out-of-resources wire value both ways
_ERRCLASS_TO_WIRE = {
    InstanceErrorClass.OUT_OF_RESOURCES: 1,
    InstanceErrorClass.QUOTA_EXCEEDED: 1,
    InstanceErrorClass.OTHER: 99,
}
_WIRE_TO_ERRCLASS = {
    1: InstanceErrorClass.OUT_OF_RESOURCES,
    99: InstanceErrorClass.OTHER,
}


# ---------------------------------------------------------------------------
# Client adapter: our CloudProvider interface over the reference protocol


def _raw_rpc(channel: grpc.Channel, service: str, method: str):
    return channel.unary_unary(
        f"/{service}/{method}",
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )


class _RefRemoteNodeGroup(NodeGroup):
    """NodeGroup view over the reference NodeGroup* RPCs."""

    def __init__(self, provider: "RefProtocolCloudProvider", gid: str,
                 min_size: int, max_size: int, debug: str):
        self._p = provider
        self._id = gid
        self._min = min_size
        self._max = max_size
        self._debug = debug

    def id(self) -> str:
        return self._id

    def min_size(self) -> int:
        return self._min

    def max_size(self) -> int:
        return self._max

    def debug(self) -> str:
        return self._debug

    def target_size(self) -> int:
        # NodeGroupTargetSizeRequest{id=1} -> Response{targetSize=1}
        resp = self._p._call("NodeGroupTargetSize", _str_f(1, self._id))
        return _get_int(_decode(resp), 1)

    def increase_size(self, delta: int) -> None:
        # NodeGroupIncreaseSizeRequest{delta=1, id=2}
        self._p._call(
            "NodeGroupIncreaseSize", _int_f(1, delta) + _str_f(2, self._id)
        )

    def delete_nodes(self, nodes: Sequence[Node]) -> None:
        # NodeGroupDeleteNodesRequest{nodes=1 repeated ExternalGrpcNode, id=2}
        req = b"".join(_len_f(1, _ext_node_msg(n)) for n in nodes)
        self._p._call("NodeGroupDeleteNodes", req + _str_f(2, self._id))

    def decrease_target_size(self, delta: int) -> None:
        # NodeGroupDecreaseTargetSizeRequest{delta=1, id=2}; the reference
        # contract passes delta negative
        self._p._call(
            "NodeGroupDecreaseTargetSize",
            _int_f(1, delta if delta < 0 else -delta) + _str_f(2, self._id),
        )

    def nodes(self) -> List[Instance]:
        # NodeGroupNodesRequest{id=1} -> {instances=1 repeated Instance}
        resp = _decode(self._p._call("NodeGroupNodes", _str_f(1, self._id)))
        out: List[Instance] = []
        for ib in resp.get(1, ()):
            f = _decode(ib)
            st = _decode(_get_bytes(f, 2))
            state = _WIRE_TO_STATE.get(_get_int(st, 1), InstanceState.RUNNING)
            err = None
            ei = _decode(_get_bytes(st, 2))
            if _get_str(ei, 1):
                err = InstanceErrorInfo(
                    error_class=_WIRE_TO_ERRCLASS.get(
                        _get_int(ei, 3), InstanceErrorClass.OTHER
                    ),
                    error_code=_get_str(ei, 1),
                    error_message=_get_str(ei, 2),
                )
            out.append(Instance(id=_get_str(f, 1), state=state, error_info=err))
        return out

    def template_node_info(self) -> Node:
        # NodeGroupTemplateNodeInfoResponse{nodeInfo=1 v1.Node}
        resp = _decode(
            self._p._call("NodeGroupTemplateNodeInfo", _str_f(1, self._id))
        )
        return decode_v1_node(_get_bytes(resp, 1))

    def exist(self) -> bool:
        return True

    def autoprovisioned(self) -> bool:
        return False

    def get_options(self, defaults: NodeGroupAutoscalingOptions):
        # NodeGroupAutoscalingOptionsRequest{id=1, defaults=2}; a grpc error
        # means "use defaults" (reference contract), absent message too
        try:
            resp = _decode(
                self._p._call(
                    "NodeGroupGetOptions",
                    _str_f(1, self._id) + _len_f(2, _options_msg(defaults)),
                )
            )
        except grpc.RpcError:
            return None
        if 1 not in resp:
            return None
        opts = _decode_options(_get_bytes(resp, 1))
        # the reference protocol carries no provision-time override
        opts.max_node_provision_time_s = defaults.max_node_provision_time_s
        return opts


class _RefPricing(PricingModel):
    def __init__(self, provider: "RefProtocolCloudProvider"):
        self._p = provider

    def node_price(self, node: Node, start_s: float, end_s: float) -> float:
        # PricingNodePriceRequest{node=1 ExternalGrpcNode, start=2, end=3 Time}
        t1 = _len_f(2, _int_f(1, int(start_s)))
        t2 = _len_f(3, _int_f(1, int(end_s)))
        resp = self._p._call(
            "PricingNodePrice", _len_f(1, _ext_node_msg(node)) + t1 + t2
        )
        return _get_double(_decode(resp), 1)

    def pod_price(self, pod: Pod, start_s: float, end_s: float) -> float:
        # PricingPodPriceRequest{pod=1 v1.Pod, start=2, end=3}
        t1 = _len_f(2, _int_f(1, int(start_s)))
        t2 = _len_f(3, _int_f(1, int(end_s)))
        resp = self._p._call(
            "PricingPodPrice", _len_f(1, encode_v1_pod(pod)) + t1 + t2
        )
        return _get_double(_decode(resp), 1)


class RefProtocolCloudProvider(CloudProvider):
    """Our CloudProvider interface over an operator's EXISTING reference
    externalgrpc provider binary — no changes on their side. Resource limits
    are host-side (the reference protocol has no limiter RPC)."""

    def __init__(self, target: str,
                 resource_limiter: Optional[ResourceLimiter] = None):
        self._channel = grpc.insecure_channel(target)
        self._limiter = resource_limiter or ResourceLimiter({}, {})
        self._groups: List[_RefRemoteNodeGroup] = []

    def _call(self, method: str, request: bytes) -> bytes:
        return _raw_rpc(self._channel, PROVIDER_SERVICE, method)(request)

    def name(self) -> str:
        return "externalgrpc-ref"

    def node_groups(self) -> List[NodeGroup]:
        if not self._groups:
            self.refresh()
        return list(self._groups)

    def node_group_for_node(self, node: Node) -> Optional[NodeGroup]:
        # NodeGroupForNodeRequest{node=1} -> {nodeGroup=1}; id "" = no group
        resp = _decode(
            self._call("NodeGroupForNode", _len_f(1, _ext_node_msg(node)))
        )
        g = _decode(_get_bytes(resp, 1))
        gid = _get_str(g, 1)
        if not gid:
            return None
        for known in self._groups:
            if known.id() == gid:
                return known
        return _RefRemoteNodeGroup(
            self, gid, _get_int(g, 2), _get_int(g, 3), _get_str(g, 4)
        )

    def pricing(self) -> Optional[PricingModel]:
        return _RefPricing(self)

    def gpu_label(self) -> str:
        return _get_str(_decode(self._call("GPULabel", b"")), 1)

    def get_available_gpu_types(self) -> List[str]:
        # GetAvailableGPUTypesResponse{gpuTypes=1 map<string, Any>}
        resp = _decode(self._call("GetAvailableGPUTypes", b""))
        return [
            _get_str(_decode(e), 1) for e in resp.get(1, ())
        ]

    def get_resource_limiter(self) -> ResourceLimiter:
        return self._limiter

    def refresh(self) -> None:
        self._call("Refresh", b"")
        resp = _decode(self._call("NodeGroups", b""))
        groups = []
        for gb in resp.get(1, ()):
            f = _decode(gb)
            groups.append(
                _RefRemoteNodeGroup(
                    self, _get_str(f, 1), _get_int(f, 2), _get_int(f, 3),
                    _get_str(f, 4),
                )
            )
        self._groups = groups

    def cleanup(self) -> None:
        try:
            self._call("Cleanup", b"")
        finally:
            self._channel.close()


# ---------------------------------------------------------------------------
# Expander plugin client (reference grpcplugin.Expander consumer)


@dataclass
class RefExpanderOption:
    """expander.proto Option{nodeGroupId=1, nodeCount=2, debug=3, pod=4}."""

    group_id: str
    node_count: int
    debug: str = ""
    pods: List[Pod] = field(default_factory=list)


class RefExpanderClient:
    """Call an operator's existing reference gRPC expander plugin. Every
    call carries a deadline so a hung plugin fails open in the caller
    instead of blocking the scale-up loop."""

    def __init__(self, target: str, timeout_s: float = 5.0):
        self._channel = grpc.insecure_channel(target)
        self._timeout_s = timeout_s

    def close(self) -> None:
        self._channel.close()

    def best_options(
        self,
        options: Sequence[RefExpanderOption],
        node_map: Dict[str, Node],
    ) -> List[RefExpanderOption]:
        # BestOptionsRequest{options=1 repeated, nodeMap=2 map<str, v1.Node>}
        req = b"".join(_len_f(1, self._opt_msg(o)) for o in options)
        for gid, node in node_map.items():
            req += _len_f(2, _str_f(1, gid) + _len_f(2, encode_v1_node(node)))
        resp = _decode(
            _raw_rpc(self._channel, EXPANDER_SERVICE, "BestOptions")(
                req, timeout=self._timeout_s
            )
        )
        out = []
        for ob in resp.get(1, ()):
            f = _decode(ob)
            out.append(
                RefExpanderOption(
                    group_id=_get_str(f, 1),
                    node_count=_get_int(f, 2),
                    debug=_get_str(f, 3),
                    pods=[decode_v1_pod(p) for p in f.get(4, ())],
                )
            )
        return out

    @staticmethod
    def _opt_msg(o: RefExpanderOption) -> bytes:
        return (
            _str_f(1, o.group_id)
            + _int_f(2, o.node_count)
            + _str_f(3, o.debug)
            + b"".join(_len_f(4, encode_v1_pod(p)) for p in o.pods)
        )


# ---------------------------------------------------------------------------
# Server bridges: serve the reference wire formats over OUR implementations


def serve_ref_provider(provider: CloudProvider, address: str = "127.0.0.1:0",
                       max_workers: int = 4):
    """Serve the reference externalgrpc CloudProvider protocol backed by any
    of our CloudProvider implementations — a stock reference autoscaler's
    --cloud-provider=externalgrpc can point here. → (server, port)."""

    def _group_by_id(gid: str) -> NodeGroup:
        for g in provider.node_groups():
            if g.id() == gid:
                return g
        raise KeyError(gid)

    def NodeGroups(req: bytes) -> bytes:
        out = b""
        for g in provider.node_groups():
            out += _len_f(
                1,
                _str_f(1, g.id()) + _int_f(2, g.min_size())
                + _int_f(3, g.max_size()),
            )
        return out

    def NodeGroupForNode(req: bytes) -> bytes:
        node = _decode_ext_node(_get_bytes(_decode(req), 1))
        g = provider.node_group_for_node(node)
        if g is None:
            return _len_f(1, b"")
        return _len_f(
            1,
            _str_f(1, g.id()) + _int_f(2, g.min_size()) + _int_f(3, g.max_size()),
        )

    def PricingNodePrice(req: bytes) -> bytes:
        f = _decode(req)
        model = provider.pricing()
        node = _decode_ext_node(_get_bytes(f, 1))
        start = _get_int(_decode(_get_bytes(f, 2)), 1)
        end = _get_int(_decode(_get_bytes(f, 3)), 1)
        return _double_f(1, model.node_price(node, start, end)) if model else b""

    def PricingPodPrice(req: bytes) -> bytes:
        f = _decode(req)
        model = provider.pricing()
        pod = decode_v1_pod(_get_bytes(f, 1))
        start = _get_int(_decode(_get_bytes(f, 2)), 1)
        end = _get_int(_decode(_get_bytes(f, 3)), 1)
        return _double_f(1, model.pod_price(pod, start, end)) if model else b""

    def GPULabel(req: bytes) -> bytes:
        return _str_f(1, provider.gpu_label())

    def GetAvailableGPUTypes(req: bytes) -> bytes:
        out = b""
        for t in provider.get_available_gpu_types():
            # map<string, google.protobuf.Any>: empty Any value
            out += _len_f(1, _str_f(1, t) + _len_f(2, b""))
        return out

    def Cleanup(req: bytes) -> bytes:
        provider.cleanup()
        return b""

    def Refresh(req: bytes) -> bytes:
        provider.refresh()
        return b""

    def NodeGroupTargetSize(req: bytes) -> bytes:
        g = _group_by_id(_get_str(_decode(req), 1))
        return _int_f(1, g.target_size())

    def NodeGroupIncreaseSize(req: bytes) -> bytes:
        f = _decode(req)
        _group_by_id(_get_str(f, 2)).increase_size(_get_int(f, 1))
        return b""

    def NodeGroupDeleteNodes(req: bytes) -> bytes:
        f = _decode(req)
        nodes = [_decode_ext_node(nb) for nb in f.get(1, ())]
        _group_by_id(_get_str(f, 2)).delete_nodes(nodes)
        return b""

    def NodeGroupDecreaseTargetSize(req: bytes) -> bytes:
        f = _decode(req)
        _group_by_id(_get_str(f, 2)).decrease_target_size(_get_int(f, 1))
        return b""

    def NodeGroupNodes(req: bytes) -> bytes:
        g = _group_by_id(_get_str(_decode(req), 1))
        out = b""
        for inst in g.nodes():
            status = _int_f(1, _STATE_TO_WIRE[inst.state])
            if inst.error_info is not None:
                status += _len_f(
                    2,
                    _str_f(1, inst.error_info.error_code or "Error")
                    + _str_f(2, inst.error_info.error_message)
                    + _int_f(3, _ERRCLASS_TO_WIRE[inst.error_info.error_class]),
                )
            out += _len_f(1, _str_f(1, inst.id) + _len_f(2, status))
        return out

    def NodeGroupTemplateNodeInfo(req: bytes) -> bytes:
        g = _group_by_id(_get_str(_decode(req), 1))
        return _len_f(1, encode_v1_node(g.template_node_info()))

    def NodeGroupGetOptions(req: bytes) -> bytes:
        f = _decode(req)
        defaults = _decode_options(_get_bytes(f, 2))
        opts = _group_by_id(_get_str(f, 1)).get_options(defaults)
        if opts is None:
            return b""
        return _len_f(1, _options_msg(opts))

    # Explicit wire surface (every reference CloudProvider RPC, greppable):
    methods = {
        "NodeGroups": NodeGroups,
        "NodeGroupForNode": NodeGroupForNode,
        "PricingNodePrice": PricingNodePrice,
        "PricingPodPrice": PricingPodPrice,
        "GPULabel": GPULabel,
        "GetAvailableGPUTypes": GetAvailableGPUTypes,
        "Cleanup": Cleanup,
        "Refresh": Refresh,
        "NodeGroupTargetSize": NodeGroupTargetSize,
        "NodeGroupIncreaseSize": NodeGroupIncreaseSize,
        "NodeGroupDeleteNodes": NodeGroupDeleteNodes,
        "NodeGroupDecreaseTargetSize": NodeGroupDecreaseTargetSize,
        "NodeGroupNodes": NodeGroupNodes,
        "NodeGroupTemplateNodeInfo": NodeGroupTemplateNodeInfo,
        "NodeGroupGetOptions": NodeGroupGetOptions,
    }

    def _wrap(fn):
        def handler(req, ctx):
            try:
                return fn(req)
            except KeyError as e:  # unknown node group id
                ctx.abort(grpc.StatusCode.NOT_FOUND, f"node group {e} unknown")

        return handler

    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            _wrap(fn),
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )
        for name, fn in methods.items()
    }
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(PROVIDER_SERVICE, handlers),)
    )
    port = server.add_insecure_port(address)
    server.start()
    return server, port


def serve_ref_expander(
    choose: Callable[[List[RefExpanderOption], Dict[str, Node]],
                     List[RefExpanderOption]],
    address: str = "127.0.0.1:0",
):
    """Serve grpcplugin.Expander backed by one of our expander strategies —
    a stock reference autoscaler's --grpc-expander-url can point here.
    → (server, port)."""

    def BestOptions(req: bytes, ctx) -> bytes:
        f = _decode(req)
        options = []
        for ob in f.get(1, ()):
            of = _decode(ob)
            options.append(
                RefExpanderOption(
                    group_id=_get_str(of, 1),
                    node_count=_get_int(of, 2),
                    debug=_get_str(of, 3),
                    pods=[decode_v1_pod(p) for p in of.get(4, ())],
                )
            )
        node_map = {}
        for e in f.get(2, ()):
            ef = _decode(e)
            node_map[_get_str(ef, 1)] = decode_v1_node(_get_bytes(ef, 2))
        best = choose(options, node_map)
        return b"".join(
            _len_f(1, RefExpanderClient._opt_msg(o)) for o in best
        )

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers(
        (
            grpc.method_handlers_generic_handler(
                EXPANDER_SERVICE,
                {
                    "BestOptions": grpc.unary_unary_rpc_method_handler(
                        BestOptions,
                        request_deserializer=lambda b: b,
                        response_serializer=lambda b: b,
                    )
                },
            ),
        )
    )
    port = server.add_insecure_port(address)
    server.start()
    return server, port
