"""Semantic state diff between two reconstructed ticks.

Renders what an on-call human asks first — which pods appeared, vanished
or moved, which nodes flipped, how capacity drifted — instead of a raw
tensor delta. Everything is keyed by object names (sorted wherever a list
reaches output, graftlint GL010) so the diff reads the same regardless of
row placement: two states that pack the same cluster into different rows
diff empty.

The port's copy of ``autoscaler_tpu/journal/diff.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from autoscaler_tpu_torch.journal.reader import ReconstructedState


def _pod_node_names(state: ReconstructedState) -> Dict[str, str]:
    """pod key → node name ("" = pending) for every named pod row."""
    pod_node = np.asarray(state.fields["pod_node"])
    nodes = state.names.get("nodes", [])
    out: Dict[str, str] = {}
    for row, key in enumerate(state.names.get("pods", [])):
        if key is None:
            continue
        idx = int(pod_node[row]) if row < pod_node.shape[0] else -1
        name = nodes[idx] if 0 <= idx < len(nodes) else None
        out[key] = name or ""
    return out


def _node_rows(state: ReconstructedState) -> Dict[str, int]:
    return {
        name: row
        for row, name in enumerate(state.names.get("nodes", []))
        if name is not None
    }


def semantic_diff(
    a: ReconstructedState, b: ReconstructedState
) -> Dict[str, Any]:
    """What changed between tick ``a`` and tick ``b``, in object terms."""
    pods_a = _pod_node_names(a)
    pods_b = _pod_node_names(b)
    moved = [
        {"pod": key, "from": pods_a[key], "to": pods_b[key]}
        for key in sorted(set(pods_a) & set(pods_b))
        if pods_a[key] != pods_b[key]
    ]
    nodes_a = _node_rows(a)
    nodes_b = _node_rows(b)
    flips: List[Dict[str, Any]] = []
    drift_nodes = 0
    alloc_delta: Optional[np.ndarray] = None
    used_delta: Optional[np.ndarray] = None
    na, nb = a.fields["node_alloc"], b.fields["node_alloc"]
    ua, ub = a.fields["node_used"], b.fields["node_used"]
    ga, gb = a.fields["node_group"], b.fields["node_group"]
    for name in sorted(set(nodes_a) & set(nodes_b)):
        ra, rb = nodes_a[name], nodes_b[name]
        if int(ga[ra]) != int(gb[rb]):
            flips.append({
                "node": name,
                "field": "node_group",
                "from": int(ga[ra]),
                "to": int(gb[rb]),
            })
        d_alloc = np.asarray(nb[rb], dtype=np.float64) - np.asarray(
            na[ra], dtype=np.float64
        )
        d_used = np.asarray(ub[rb], dtype=np.float64) - np.asarray(
            ua[ra], dtype=np.float64
        )
        if d_alloc.any() or d_used.any():
            drift_nodes += 1
            alloc_delta = d_alloc if alloc_delta is None else alloc_delta + d_alloc
            used_delta = d_used if used_delta is None else used_delta + d_used
    zeros = np.zeros(np.asarray(na).shape[-1], dtype=np.float64)
    return {
        "ticks": [a.tick, b.tick],
        "pods_added": sorted(set(pods_b) - set(pods_a)),
        "pods_removed": sorted(set(pods_a) - set(pods_b)),
        "pods_moved": moved,
        "nodes_added": sorted(set(nodes_b) - set(nodes_a)),
        "nodes_removed": sorted(set(nodes_a) - set(nodes_b)),
        "node_flips": flips,
        "capacity_drift": {
            "nodes_changed": drift_nodes,
            "alloc_delta": [
                float(x)
                for x in (alloc_delta if alloc_delta is not None else zeros)
            ],
            "used_delta": [
                float(x)
                for x in (used_delta if used_delta is not None else zeros)
            ],
        },
        "options_changed": a.options_fp != b.options_fp,
    }
