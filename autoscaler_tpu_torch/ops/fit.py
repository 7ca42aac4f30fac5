"""The predicate fit, the counterpart of ``autoscaler_tpu/ops/fit.py``: the
batched replacement for the reference's per-(pod, node) scheduler-framework
walk (predicatechecker/schedulerbased.go:109-163). The whole (pod × node)
space is one elementwise reduction:

    fits[P, N] = all_r(pod_req[P, r] <= free[N, r]) & sched_mask[P, N]

The non-resource predicates were precomputed by the packer; the resource
comparison stays dynamic, because node usage changes during simulation.
Factored snapshots past the packer's dense-cell limit route to the tiled
kernel K4 (``ops/fit_reduce.fit_reduce_exact``) instead of holding [P, N].

``fit_reason_matrix`` and ``pending_fit_reasons`` keep what ``fit_matrix``
reduces away: why each pod does not fit each node, in the estimator's
attribution vocabulary (``explain/reasons.py``). They are torch code on
the snapshot's device, as the JAX package's are XLA code (no Pallas
kernel, so no hand kernel here).
"""
from __future__ import annotations

from typing import Tuple

import torch

from autoscaler_tpu_torch.explain.reasons import REASON_TOPOLOGY
from autoscaler_tpu_torch.ops import fit_reduce
from autoscaler_tpu_torch.ops.binpack import attribute_unschedulable
from autoscaler_tpu_torch.ops.fit_reduce import _resource_fits
from autoscaler_tpu_torch.snapshot import packer
from autoscaler_tpu_torch.snapshot.tensors import SnapshotTensors


def _factored_too_big(snap: SnapshotTensors) -> bool:
    # the limit is read at call time: tests lower it to route small worlds
    return (
        snap.sched_mask is None
        and snap.num_pods * snap.num_nodes > packer.DENSE_MASK_CELL_LIMIT
    )


def _bf16_ceil(x: torch.Tensor) -> torch.Tensor:
    """Smallest bf16 value >= x (x >= 0). Round-to-nearest can land below
    x; step one ulp up when it did (a bit increment, monotone for positive
    floats; int16 has the same bits as the uint16 step)."""
    b = x.to(torch.bfloat16)
    up = (b.view(torch.int16) + 1).view(torch.bfloat16)
    return torch.where(b.to(torch.float32) < x, up, b)


def _bf16_floor(x: torch.Tensor) -> torch.Tensor:
    """Largest bf16 value <= x (x >= 0)."""
    b = x.to(torch.bfloat16)
    down = (b.view(torch.int16) - 1).view(torch.bfloat16)
    return torch.where(b.to(torch.float32) > x, down, b)


def bf16_compare_operands(
    pod_req: torch.Tensor, free: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conservative bf16 quantization for the fit compare: requests round
    UP to the bf16 grid and free capacity rounds DOWN, so `req_b <= free_b`
    implies the exact f32 `req <= free` — the bf16 verdict can only
    under-admit, never put a pod on a node that lacks room."""
    return _bf16_ceil(pod_req), _bf16_floor(torch.clamp(free, min=0.0))


def fit_matrix(snap: SnapshotTensors, precision: str = "f32") -> torch.Tensor:
    """[P, N] bool — pod i fits node j right now (capacity + predicates).
    Padding rows and columns are False. precision="bf16" compares in
    bfloat16 with one-sided conservative rounding; "f32" is exact.
    Refused on factored snapshots past the packer's dense-cell limit: use
    ``ops.fit_reduce.fit_reduce_exact`` there."""
    if _factored_too_big(snap):
        raise ValueError(
            f"fit_matrix would materialize {snap.num_pods * snap.num_nodes} "
            "cells from a factored-mask snapshot; use "
            "ops.fit_reduce.fit_reduce_exact on the snapshot instead"
        )
    free = snap.free()  # [N, R], 0 on invalid rows
    if precision == "bf16":
        fits = _resource_fits(*bf16_compare_operands(snap.pod_req, free))
    elif precision == "f32":
        fits = _resource_fits(snap.pod_req, free)
    else:
        raise ValueError(f"unknown precision {precision!r} (f32|bf16)")
    return (
        fits
        & snap.dense_sched()  # guarded above: small worlds only when factored
        & snap.pod_valid[:, None]
        & snap.node_valid[None, :]
    )


def fits_any_node(snap: SnapshotTensors) -> torch.Tensor:
    """[P] bool — the FitsAnyNodeMatching analog (schedulerbased.go:90).
    Huge factored-mask worlds route through the tiled kernel."""
    if _factored_too_big(snap):
        return fit_reduce.fit_reduce_exact(snap).any_fit
    return fit_matrix(snap).any(dim=1)


def first_fit_node(snap: SnapshotTensors) -> torch.Tensor:
    """[P] i32 — the lowest-index node each pod fits on, -1 if none (the
    deterministic analog of CheckPredicates over a candidate list). Huge
    factored-mask worlds route through the tiled kernel."""
    if _factored_too_big(snap):
        return fit_reduce.fit_reduce_exact(snap).first_fit
    fits = fit_matrix(snap)
    node_ids = torch.arange(fits.shape[1], dtype=torch.int32, device=fits.device)
    first = torch.where(fits, node_ids, fit_reduce.BIG_I32).amin(dim=1)
    return torch.where(fits.any(dim=1), first, -1)


def fit_reason_matrix(snap: SnapshotTensors) -> torch.Tensor:
    """[P, N] i32 — WHY pod i does not fit node j right now, as a reason
    code from explain/reasons.py (REASON_NONE where it fits): the
    per-constraint violation mask ``fit_matrix`` reduces away, kept. The
    estimator's attribution (``ops/binpack.attribute_unschedulable``) with
    the nodes' free capacity in place of the templates' and the fit verdict
    in place of the binpack's, so "why is this pod pending" and "why would
    a new node not help" speak one vocabulary. Refuses factored-mask
    worlds past the dense-cell limit, like fit_matrix."""
    if _factored_too_big(snap):
        raise ValueError(
            f"fit_reason_matrix would materialize "
            f"{snap.num_pods * snap.num_nodes} cells from a factored-mask "
            "snapshot; attribute against group templates instead "
            "(ops.binpack.attribute_unschedulable)"
        )
    free = snap.free()                                           # [N, R]
    mask = (
        snap.dense_sched()
        & snap.pod_valid[:, None]
        & snap.node_valid[None, :]
    )                                                            # [P, N]
    fits = _resource_fits(snap.pod_req, free) & mask
    involved = torch.zeros(snap.pod_req.shape[0], dtype=torch.bool, device=fits.device)
    return attribute_unschedulable(snap.pod_req, mask.T, free, fits.T, involved).T


def pending_fit_reasons(snap: SnapshotTensors) -> torch.Tensor:
    """[P] i32 — each pod's dominant no-fit reason against the CURRENT
    cluster: the MIN code over nodes (reasons.py orders codes by severity,
    nearest-to-schedulable first). REASON_NONE means some node fits now;
    a world with no valid nodes attributes everything to the predicate
    mask (there is no node to measure resources against)."""
    codes = fit_reason_matrix(snap)
    if codes.shape[1] == 0:
        return torch.full((codes.shape[0],), REASON_TOPOLOGY, dtype=torch.int32,
                          device=codes.device)
    return torch.clamp(codes.amin(dim=1), max=REASON_TOPOLOGY)
