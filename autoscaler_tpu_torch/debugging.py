"""Debugging snapshot: capture the autoscaler's working state on demand —
the counterpart of ``autoscaler_tpu/debugging.py``.

Reference: cluster-autoscaler/debuggingsnapshot/ — DebuggingSnapshotter
state machine :56,72, the /snapshotz HTTP trigger :113, captured payload
(NodeInfos, template nodes, "unscheduled pods that could schedule")
debugging_snapshot.go:36-135. Here the capture additionally dumps the packed
tensor shapes/stats, since the tensors ARE the decision state. The
"pending pods fitting free capacity" field is ``ops/fit.fits_any_node`` over
the packed snapshot, which on a factored snapshot past the dense-cell limit
runs the tiled fit kernel K4.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np


class DebuggingSnapshotter:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._requested = False
        self._payload: Optional[Dict[str, Any]] = None

    def request(self) -> None:
        """Arm capture for the next loop iteration (the /snapshotz trigger)."""
        with self._lock:
            self._requested = True

    def is_data_collection_allowed(self) -> bool:
        with self._lock:
            return self._requested

    def capture(
        self, autoscaler, snapshot, pending_pods, result, filtered_pods=(),
        now: Optional[float] = None,
    ) -> None:
        """Called at the end of a loop iteration when armed. filtered_pods:
        the pods filter-out-schedulable absorbed this loop — the reference's
        'unscheduled pods that could be scheduled' population. ``now`` is
        the capture timestamp (run_once passes its tick's now_ts, keeping
        replayed snapshots deterministic); wall time is only the fallback
        for bare invocations."""
        with self._lock:
            if not self._requested:
                return
            self._requested = False
            tensors, meta = snapshot.tensors()
            free = tensors.free().cpu().numpy()
            nodes = []
            for node in snapshot.nodes():
                j = meta.node_index[node.name]
                nodes.append(
                    {
                        "name": node.name,
                        "ready": node.ready,
                        "pods": len(snapshot.pods_on_node(node.name)),
                        "free_cpu_m": float(free[j, 0]),
                        "free_mem_mib": float(free[j, 1]),
                        "taints": [t.key for t in node.taints],
                    }
                )
            # "unscheduled pods that could be scheduled" — the reference's
            # debugging_snapshot.go:36-135 headline field IS the set filter-
            # out-schedulable absorbed this loop (filter_out_schedulable.go
            # feeds it). Additionally report still-pending pods that fit raw
            # free capacity individually but lost the greedy packing race —
            # the "why is this pod pending" answer an operator wants next.
            could_schedule = [p.key() for p in filtered_pods]
            lost_packing_race = []
            if pending_pods:
                from autoscaler_tpu_torch.ops.fit import fits_any_node

                any_fit = fits_any_node(tensors).cpu().numpy()
                for p in pending_pods:
                    i = meta.pod_index.get(p.key())
                    if i is not None and any_fit[i]:
                        lost_packing_race.append(p.key())
            if now is None:
                now = time.time()  # graftlint: disable=GL001 — operator-artifact fallback; replay-reachable callers inject now
            self._payload = {
                "captured_at": now,
                "node_count": len(nodes),
                "pod_count": len(snapshot.pods()),
                "pending_pods": [p.key() for p in pending_pods],
                "unscheduled_pods_can_be_scheduled": could_schedule,
                "pending_pods_fitting_free_capacity": lost_packing_race,
                "tensor_shapes": {
                    "pods": list(tensors.pod_req.shape),
                    "nodes": list(tensors.node_alloc.shape),
                    # stable schema across mask modes: always an object
                    "mask": (
                        {"form": "dense", "shape": list(tensors.sched_mask.shape)}
                        if tensors.sched_mask is not None
                        else {
                            "form": "factored",
                            "class_mask": list(tensors.class_mask.shape),
                            "exc_rows": list(tensors.exc_rows.shape),
                            "cell_overrides": int(tensors.cell_pod.shape[0]),
                        }
                    ),
                },
                "nodes": nodes,
                "templates": [
                    {"group": g.id(), "template": g.template_node_info().name}
                    for g in autoscaler.provider.node_groups()
                ],
                "last_result": {
                    "scaled_up": bool(result.scale_up and result.scale_up.scaled_up),
                    "pending": result.pending_pods,
                    "unneeded": result.unneeded_nodes,
                },
            }

    def get(self) -> Optional[str]:
        with self._lock:
            return (
                json.dumps(self._payload, indent=2, sort_keys=True)
                if self._payload else None
            )

    @staticmethod
    def dump_tensors(snapshot, path: str) -> List[str]:
        """Write the packed decision tensors to a compressed .npz — the exact
        arrays the kernels consumed, for offline replay of a decision. The
        reference's /snapshotz captures NodeInfos; here the tensors ARE the
        state. Returns the saved array names."""
        tensors, _meta = snapshot.tensors()
        arrays: Dict[str, np.ndarray] = {}
        for name in (
            "node_alloc",
            "node_used",
            "node_valid",
            "node_group",
            "pod_req",
            "pod_valid",
            "pod_node",
            "sched_mask",
            "pod_class",
            "node_class",
            "class_mask",
            "exc_rows",
            "pod_exc",
            "cell_pod",
            "cell_node",
            "cell_val",
        ):
            value = getattr(tensors, name)
            if value is not None:
                arrays[name] = value.cpu().numpy()
        np.savez_compressed(path, **arrays)
        return sorted(arrays)
