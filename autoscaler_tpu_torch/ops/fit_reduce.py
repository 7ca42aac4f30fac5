"""The tiled predicate fit with an online reduction, on a hand-written CUDA
kernel — the counterpart of ``autoscaler_tpu/ops/pallas_fit.py``.

For each pod p, over every node n,

    fits[p, n] = all_r(pod_req[p, r] <= free[n, r])
                 & class_mask[pod_class[p], node_class[n]] & node_valid[n]

(a pod class outside [0, CP) or a node class outside [0, CN) never fits),
reduced to ``any_fit [P]``, ``fit_count [P]`` and ``first_fit [P]`` (the
lowest node, -1 if none) without materializing [P, N].

``fit_reduce_cuda`` is the counterpart of ``pallas_fit_reduce``: for CUDA
tensors it launches K4 from ``csrc/fit_reduce.cu`` and counts the launch
in ``LAUNCHES``; for CPU tensors it runs the plain PyTorch version
``_fit_reduce_plain``, chunked over pods so that it never holds
[P, N, R]. There is no fallback from one to the other. The Pallas tile
arguments (``tp``, ``tn``) were the TPU's tiling and have no counterpart.

``fit_reduce_exact`` gives a ``SnapshotTensors`` the dense path's exact
verdicts: K4 reduces the class-structured bulk of a factored snapshot, and
the few pods whose rows the class factors get wrong (exception-row pods
and the targets of the single-cell overrides) are reduced again from their
true rows, in one batched pass, and patched in.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from autoscaler_tpu_torch.ops import _build

BIG_I32 = 2**31 - 1
# pairs the plain version tests at once: pods a chunk = this // N
PLAIN_CHUNK_PAIRS = 1 << 24

# Launch count of the kernel: the wrapper adds one where it launches it,
# and nowhere else.
LAUNCHES = {"fit_reduce": 0}


class FitReduction(NamedTuple):
    any_fit: torch.Tensor    # [P] bool
    fit_count: torch.Tensor  # [P] i32
    first_fit: torch.Tensor  # [P] i32 node index, -1 if none


def _check_operands(pod_req, free, pod_class, node_class, class_mask, node_valid):
    if not isinstance(pod_req, torch.Tensor) or pod_req.dim() != 2:
        raise ValueError("pod_req must be a 2-d tensor")
    P, R = pod_req.shape
    N = free.shape[0] if isinstance(free, torch.Tensor) and free.dim() == 2 else -1
    for name, t, dtype, shape in (
        ("pod_req", pod_req, torch.float32, (P, R)),
        ("free", free, torch.float32, (N, R)),
        ("pod_class", pod_class, torch.int32, (P,)),
        ("node_class", node_class, torch.int32, (N,)),
        ("node_valid", node_valid, torch.bool, (N,)),
    ):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a {dtype} tensor of shape {shape}")
        if t.device != pod_req.device:
            raise ValueError(f"{name} is on {t.device}, pod_req on {pod_req.device}")
    if (
        not isinstance(class_mask, torch.Tensor) or class_mask.dtype != torch.bool
        or class_mask.dim() != 2 or class_mask.device != pod_req.device
    ):
        raise ValueError(f"class_mask must be a 2-d bool tensor on {pod_req.device}")


def _resource_fits(req: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """[S, R] × [N, R] → [S, N] bool: all_r(req <= free), one resource axis
    at a time so [S, N, R] is never held."""
    fits = torch.ones((req.shape[0], free.shape[0]), dtype=torch.bool, device=req.device)
    for r in range(req.shape[1]):
        fits &= req[:, r, None] <= free[None, :, r]
    return fits


def _reduce(fits: torch.Tensor) -> FitReduction:
    """[S, N] bool verdicts → their FitReduction."""
    count = fits.sum(dim=1, dtype=torch.int32)
    node_ids = torch.arange(fits.shape[1], dtype=torch.int32, device=fits.device)
    first = torch.where(fits, node_ids, BIG_I32).amin(dim=1)
    any_fit = count > 0
    return FitReduction(any_fit, count, torch.where(any_fit, first, -1))


def _empty(P: int, device) -> FitReduction:
    return FitReduction(
        any_fit=torch.zeros((P,), dtype=torch.bool, device=device),
        fit_count=torch.zeros((P,), dtype=torch.int32, device=device),
        first_fit=torch.full((P,), -1, dtype=torch.int32, device=device),
    )


def _fit_reduce_plain(
    pod_req, free, pod_class, node_class, class_mask, node_valid,
    stats: Optional[dict] = None,
) -> FitReduction:
    """Plain version of K4 on K4's operands, chunked over pods. ``stats``,
    when given, gets the work the data needs: ``class_tests`` (one per live
    pair: pod class in range, node valid with its class in range) and
    ``compares`` (the resource compares of each pair that passed its class
    test, up to and including the first that fails; R when all pass)."""
    P, R = pod_req.shape
    N = free.shape[0]
    CP, CN = class_mask.shape
    dev = pod_req.device
    if P == 0 or N == 0 or CP == 0 or CN == 0:
        if stats is not None:
            stats.setdefault("class_tests", 0)
            stats.setdefault("compares", 0)
        return _empty(P, dev)
    node_ok = node_valid & (node_class >= 0) & (node_class < CN)
    nc = node_class.clamp(0, CN - 1).long()
    outs = []
    class_tests = torch.zeros((), dtype=torch.int64, device=dev)
    compares = torch.zeros((), dtype=torch.int64, device=dev)
    chunk = max(1, PLAIN_CHUNK_PAIRS // N)
    for s in range(0, P, chunk):
        pc = pod_class[s:s + chunk]
        req = pod_req[s:s + chunk]
        live = ((pc >= 0) & (pc < CP))[:, None] & node_ok[None, :]
        fits = class_mask[pc.clamp(0, CP - 1).long()][:, nc] & live
        if stats is not None:
            class_tests += live.sum()
        for r in range(R):
            if stats is not None:
                compares += fits.sum()
            fits &= req[:, r, None] <= free[None, :, r]
        outs.append(_reduce(fits))
    if stats is not None:
        stats["class_tests"] = stats.get("class_tests", 0) + int(class_tests)
        stats["compares"] = stats.get("compares", 0) + int(compares)
    return FitReduction(*(torch.cat(parts) for parts in zip(*outs)))


def smem_bytes(R: int, CP: int, CN: int) -> int:
    """The dynamic shared memory a K4 launch requests a block, as
    ``csrc/fit_reduce.cu`` computes it for the launch."""
    return int(_build.load("fit_reduce").fit_reduce_smem_bytes(R, CP, CN))


def fit_reduce_cuda(
    pod_req: torch.Tensor,     # [P, R] f32
    free: torch.Tensor,        # [N, R] f32 (alloc - used; 0 rows for invalid)
    pod_class: torch.Tensor,   # [P] i32 (-1 = never schedulable)
    node_class: torch.Tensor,  # [N] i32 (-1 = invalid node)
    class_mask: torch.Tensor,  # [CP, CN] bool
    node_valid: torch.Tensor,  # [N] bool
) -> FitReduction:
    """K4: the tiled fit reduction, the counterpart of ``pallas_fit_reduce``.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    _check_operands(pod_req, free, pod_class, node_class, class_mask, node_valid)
    dev = pod_req.device
    if dev.type == "cpu":
        return _fit_reduce_plain(pod_req, free, pod_class, node_class, class_mask, node_valid)
    if dev.type != "cuda":
        raise ValueError(f"fit_reduce runs on CUDA or CPU tensors, got {dev}")
    operands = (pod_req, free, pod_class, node_class, class_mask, node_valid)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("fit_reduce's operands must be contiguous")
    P, R = pod_req.shape
    N = free.shape[0]
    CP, CN = class_mask.shape
    if P == 0 or N == 0:
        return _empty(P, dev)
    count = torch.zeros((P,), dtype=torch.int32, device=dev)
    first = torch.full((P,), BIG_I32, dtype=torch.int32, device=dev)
    lib = _build.load("fit_reduce")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fit_reduce(
            *(t.data_ptr() for t in operands), count.data_ptr(), first.data_ptr(),
            P, N, R, CP, CN, stream,
        )
    _build.check(err, "fit_reduce")
    LAUNCHES["fit_reduce"] += 1
    any_fit = count > 0
    return FitReduction(any_fit, count, torch.where(any_fit, first, -1))


def fit_reduce_exact(snap) -> FitReduction:
    """Tiled (P × N) fit reduction over a SnapshotTensors with the dense
    path's exact verdicts, never holding [P, N] for a factored snapshot.
    Dense-mask snapshots reduce their mask directly in PyTorch."""
    free = snap.free()
    if snap.sched_mask is not None:
        fits = _resource_fits(snap.pod_req, free)
        fits &= snap.sched_mask & snap.pod_valid[:, None] & snap.node_valid[None, :]
        return _reduce(fits)

    base = fit_reduce_cuda(
        snap.pod_req, free, snap.pod_class.to(torch.int32),
        snap.node_class.to(torch.int32), snap.class_mask, snap.node_valid,
    )
    # The pods the class factors get wrong: exception-row holders and the
    # targets of the single-cell overrides (padding cells carry -1). Their
    # true rows are gathered and reduced together, then patched in.
    special = torch.cat([
        torch.nonzero(snap.pod_exc >= 0).flatten(),
        snap.cell_pod.long(),
    ])
    special = special[special >= 0]
    if special.numel() == 0:
        return base
    rows = snap.sched_rows(special)
    rows &= snap.node_valid[None, :] & snap.pod_valid[special][:, None]
    patch = _reduce(_resource_fits(snap.pod_req[special], free) & rows)
    out = []
    for whole, part in zip(base, patch):
        whole = whole.clone()
        whole[special] = part
        out.append(whole)
    return FitReduction(*out)


def reference_fit_reduce(pod_req, free, pod_class, node_class, class_mask, node_valid):
    """Dense numpy oracle for the parity tests."""
    P, N = pod_req.shape[0], free.shape[0]
    fits = np.all(pod_req[:, None, :] <= free[None, :, :], axis=-1)
    pc = np.asarray(pod_class)
    nc = np.asarray(node_class)
    cm = np.asarray(class_mask)
    ok_class = np.zeros((P, N), bool)
    valid_p = pc >= 0
    valid_n = (nc >= 0) & np.asarray(node_valid)
    ok_class[np.ix_(valid_p, valid_n)] = cm[np.ix_(pc[valid_p], nc[valid_n])]
    fits = fits & ok_class
    any_fit = fits.any(axis=1)
    count = fits.sum(axis=1).astype(np.int32)
    first = np.where(any_fit, fits.argmax(axis=1), -1).astype(np.int32)
    return any_fit, count, first
