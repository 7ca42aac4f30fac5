"""External gRPC expander — delegate the BestOptions choice to an
out-of-process service.

Reference: cluster-autoscaler/expander/grpcplugin/ (grpc_client.go, proto
expander/grpcplugin/protos/expander.proto:10): CA ships pending options to an
operator-owned gRPC service and acts on its pick.

The port's copy of ``autoscaler_tpu/expander/grpc_.py``, with
``RefGRPCFilter`` (the reference's expander.proto) only: the native
``GRPCFilter`` speaks through the simulation sidecar's client
(``rpc/service.py``), which comes with ROADMAP queue 1 item 4.
"""
from __future__ import annotations

from typing import List

from autoscaler_tpu_torch.expander.core import Filter, Option


class RefGRPCFilter(Filter):
    """Same seam, speaking the REFERENCE expander wire format
    (expander/grpcplugin/protos/expander.proto:10 via rpc/refcompat.py) so
    an operator's existing grpcplugin expander binary plugs in unmodified —
    including the nodeMap of template v1.Nodes the reference client ships
    (grpc_client.go BestOptions)."""

    def __init__(self, target: str, timeout_s: float = 5.0):
        from autoscaler_tpu_torch.rpc.refcompat import RefExpanderClient

        self.client = RefExpanderClient(target, timeout_s=timeout_s)

    def best_options(self, options: List[Option]) -> List[Option]:
        from autoscaler_tpu_torch.rpc.refcompat import RefExpanderOption

        if not options:
            return []
        by_id = {o.node_group.id(): o for o in options}
        wire = [
            RefExpanderOption(
                group_id=o.node_group.id(),
                node_count=o.node_count,
                pods=list(o.pods),
            )
            for o in options
        ]
        node_map = {}
        for o in options:
            try:
                node_map[o.node_group.id()] = o.node_group.template_node_info()
            except Exception:  # noqa: BLE001 — template is advisory here
                pass
        try:
            best = self.client.best_options(wire, node_map)
        except Exception:
            return list(options)  # fail open: let the next filter decide
        picked = [by_id[b.group_id] for b in best if b.group_id in by_id]
        return picked or list(options)
