"""External gRPC expander — delegate the BestOptions choice to an
out-of-process service.

Reference: cluster-autoscaler/expander/grpcplugin/ (grpc_client.go, proto
expander/grpcplugin/protos/expander.proto:10): CA ships pending options to an
operator-owned gRPC service and acts on its pick. ``GRPCFilter`` speaks
the simulation sidecar's Option message (``rpc/service.py``'s client, the
JAX package's wire protocol); ``RefGRPCFilter`` the reference's
expander.proto.

The port's copy of ``autoscaler_tpu/expander/grpc_.py``. Both import
``grpc`` and ``google.protobuf`` only when built.
"""
from __future__ import annotations

from typing import List, Optional

from autoscaler_tpu_torch.expander.core import Filter, Option


class GRPCFilter(Filter):
    def __init__(
        self,
        target: str,
        timeout_s: Optional[float] = None,
        default_deadline_s: Optional[float] = None,
        failover_targets: Optional[List[str]] = None,
        hedge: bool = False,
    ):
        from autoscaler_tpu_torch.rpc.service import TpuSimulationClient

        # default_deadline_s (AutoscalingOptions.rpc_default_deadline_s /
        # --rpc-default-deadline) seeds the client's default so every RPC
        # on it carries a deadline. The expander decision itself stays
        # bounded by an additional hard 5s per-send cap (the historical
        # behavior; best_options fails open to the local filters);
        # lowering the flag below 5s tightens it, raising it does not
        # widen it. Worst case per tick is 2x the cap: the client's single
        # reconnect-and-resend on UNAVAILABLE pays the deadline once more.
        #
        # failover_targets (AutoscalingOptions.rpc_addresses /
        # --rpc-address, repeatable) are additional endpoints serving the
        # same surface: the client fails over on UNAVAILABLE/drain with
        # jittered bounded backoff, and hedge=True (--rpc-hedge) hedges
        # idempotent calls against the next endpoint.
        targets = [target] + [
            t for t in (failover_targets or []) if t and t != target
        ]
        self.client = TpuSimulationClient(
            targets, default_timeout_s=default_deadline_s, hedge=hedge
        )
        if timeout_s is None:
            timeout_s = (
                min(default_deadline_s, 5.0)
                if default_deadline_s is not None
                else 5.0
            )
        self.timeout_s = timeout_s

    def best_options(self, options: List[Option]) -> List[Option]:
        from autoscaler_tpu_torch.rpc import autoscaler_pb2 as pb

        if not options:
            return []
        by_id = {o.node_group.id(): o for o in options}
        wire = [
            pb.Option(
                group_id=o.node_group.id(),
                node_count=o.node_count,
                pod_keys=[p.key() for p in o.pods],
            )
            for o in options
        ]
        try:
            best = self.client.best_options(wire, timeout=self.timeout_s)
        except Exception:
            return list(options)  # fail open: let the next filter decide
        picked = [by_id[b.group_id] for b in best if b.group_id in by_id]
        return picked or list(options)


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
