"""Fleet-serving protobuf messages (protos/autoscaler_fleet.proto).

Built PROGRAMMATICALLY: the FileDescriptorProto is assembled field by field
at import time and registered in the default descriptor pool — no protoc
dependency (the container has none) and nothing for the hack/verify.sh
proto-freshness check to drift against. protos/autoscaler_fleet.proto is
the reviewable source of truth; tests/test_fleet.py asserts this module's
runtime descriptor matches its declared message/field layout, which is the
programmatic analog of the protoc freshness diff.

Depends on autoscaler.proto (PackedPods), so autoscaler_pb2 must be — and
is — imported first to seed the pool.
"""
from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

from autoscaler_tpu_torch.rpc import autoscaler_pb2 as _base_pb  # noqa: F401 — pool seed

_F = descriptor_pb2.FieldDescriptorProto

# (name, number, type, extra) — extra: label override or message type name
_REQUEST_FIELDS = (
    ("pods", 1, _F.TYPE_MESSAGE, ".autoscaler_tpu.PackedPods"),
    ("pod_masks", 2, _F.TYPE_BYTES, None),
    ("template_allocs", 3, _F.TYPE_BYTES, None),
    ("group_ids", 4, _F.TYPE_STRING, "repeated"),
    ("node_caps", 5, _F.TYPE_BYTES, None),
    ("max_nodes", 6, _F.TYPE_INT32, None),
    ("tenant_id", 7, _F.TYPE_STRING, None),
    ("prices", 8, _F.TYPE_BYTES, None),
    ("trace_context", 9, _F.TYPE_STRING, None),
)
_RESPONSE_FIELDS = (
    ("node_counts", 1, _F.TYPE_BYTES, None),
    ("scheduled", 2, _F.TYPE_BYTES, None),
    ("bucket", 3, _F.TYPE_STRING, None),
    ("batch_size", 4, _F.TYPE_INT32, None),
    ("padding_waste", 5, _F.TYPE_DOUBLE, None),
    ("route", 6, _F.TYPE_STRING, None),
    ("best_group", 7, _F.TYPE_INT32, None),
    ("best_cost", 8, _F.TYPE_DOUBLE, None),
)

MESSAGE_LAYOUT = {
    "BatchEstimateRequest": _REQUEST_FIELDS,
    "BatchEstimateResponse": _RESPONSE_FIELDS,
}


def _build_file_proto() -> descriptor_pb2.FileDescriptorProto:
    fdp = descriptor_pb2.FileDescriptorProto()
    fdp.name = "autoscaler_fleet.proto"
    fdp.package = "autoscaler_tpu"
    fdp.syntax = "proto3"
    fdp.dependency.append("autoscaler.proto")
    for msg_name, fields in MESSAGE_LAYOUT.items():
        msg = fdp.message_type.add()
        msg.name = msg_name
        for name, number, ftype, extra in fields:
            f = msg.field.add()
            f.name = name
            f.number = number
            f.type = ftype
            f.label = (
                _F.LABEL_REPEATED if extra == "repeated" else _F.LABEL_OPTIONAL
            )
            if ftype == _F.TYPE_MESSAGE:
                f.type_name = extra
    return fdp


def _register():
    pool = descriptor_pool.Default()
    try:
        # a prior registration (this module imported under a second name,
        # e.g. by test collection) wins — but only after the layout check
        # below proves it IS this file, not a conflicting namesake
        fd = pool.FindFileByName("autoscaler_fleet.proto")
    except KeyError:
        fd = pool.Add(_build_file_proto())
    for msg_name, fields in MESSAGE_LAYOUT.items():
        desc = fd.message_types_by_name[msg_name]
        got = {(f.name, f.number) for f in desc.fields}
        want = {(name, number) for name, number, _, _ in fields}
        if got != want:
            raise ImportError(
                f"descriptor pool already holds autoscaler_fleet.proto with "
                f"a DIFFERENT {msg_name} layout ({sorted(got ^ want)}); wire "
                "fields would decode under wrong numbers"
            )
    return (
        message_factory.GetMessageClass(
            fd.message_types_by_name["BatchEstimateRequest"]
        ),
        message_factory.GetMessageClass(
            fd.message_types_by_name["BatchEstimateResponse"]
        ),
    )


BatchEstimateRequest, BatchEstimateResponse = _register()

__all__ = ["BatchEstimateRequest", "BatchEstimateResponse", "MESSAGE_LAYOUT"]
