"""Delta scatter-apply for the resident device arena: the port of
``autoscaler_tpu/ops/arena_apply.py``.

The arena (snapshot/arena.py) keeps the packed snapshot tensors resident
on their device across reconcile ticks; the host ships only (row-index,
payload) batches for the rows the incremental packer dirtied. These
functions apply one such batch to one resident buffer.

In the JAX package they are XLA-jitted scatters with ``donate_argnums=0``:
the input's device memory is reused for the output. Here they write IN
PLACE into the buffer they are given (``index_copy_``) and return that
same buffer; the arena decides beforehand whether the buffer may be
written or must be cloned first (the copy-on-write twin). No kernel is
written for them: a row scatter is a library copy, not a TPU kernel.

Index padding contract (kept from the JAX package): a batch may be padded
with entries whose index equals the axis length; those entries are
dropped. Real indices are unique. CUDA is never handed an out-of-range
index (a device-side assert would kill the context): padding is dropped by
a selection before the scatter, on the host when the indices live there.
The arena itself passes unpadded batches, so its steady state never
selects on the card.
"""
from __future__ import annotations

import numpy as np
import torch

# Machine-readable kernel contracts: the operand spec, as in the JAX
# package. The buffers are dtype-polymorphic (f32 rows, bool masks, i32
# vectors), so no dtype is declared for them. AK is the delta-batch axis;
# out-of-range indices (== AN) are padding and drop.
KERNEL_CONTRACTS = {
    "arena_scatter_rows": {
        "args": {
            "arena_buf": {"dims": ["AN", "AR"]},
            "arena_idx": {"dims": ["AK"], "dtype": "i32"},
            "arena_rows": {"dims": ["AK", "AR"]},
        },
        "notes": "row scatter on axis 0; idx unique, padding idx == AN drops",
    },
    "arena_scatter_vec": {
        "args": {
            "arena_buf1": {"dims": ["AN"]},
            "arena_idx": {"dims": ["AK"], "dtype": "i32"},
            "arena_vals": {"dims": ["AK"]},
        },
        "notes": "element scatter on a rank-1 buffer; same index contract",
    },
    "arena_scatter_cols": {
        "args": {
            "arena_mat": {"dims": ["AP", "AN"]},
            "arena_idx": {"dims": ["AK"], "dtype": "i32"},
            "arena_cols": {"dims": ["AP", "AK"]},
        },
        "notes": "column scatter on axis 1 (mask node-column refresh)",
    },
}


def _operands(buf: torch.Tensor, idx, payload, axis: int):
    """(int64 indices, payload) on ``buf``'s device with the padding
    dropped: the entries whose index is below the axis length, with their
    slices of the payload along ``axis``. int32 indices are widened here,
    at the call (``index_copy_`` takes int64 only)."""
    n = buf.shape[axis]
    if isinstance(idx, torch.Tensor) and idx.device.type != "cpu":
        pos = None
        keep = idx < n              # a padded batch already on the card
        if not bool(keep.all()):
            pos = keep.nonzero().squeeze(1)
            idx = idx.index_select(0, pos)
        idx = idx.to(torch.int64)
    else:
        idx_np = np.asarray(idx.numpy() if isinstance(idx, torch.Tensor) else idx)
        keep = idx_np < n
        pos = None if keep.all() else np.flatnonzero(keep)
        if pos is not None:
            idx_np = idx_np[pos]
        idx = torch.tensor(idx_np, dtype=torch.int64, device=buf.device)
    if isinstance(payload, torch.Tensor):
        payload = payload.to(device=buf.device, dtype=buf.dtype)
    else:
        payload = torch.tensor(np.asarray(payload), dtype=buf.dtype, device=buf.device)
    if pos is not None:
        payload = payload.index_select(axis, torch.as_tensor(pos, device=buf.device))
    return idx, payload


def arena_scatter_rows(
    arena_buf: torch.Tensor,   # [AN, AR] resident buffer, written in place
    arena_idx,                 # [AK] i32 unique row indices; AN = padding
    arena_rows,                # [AK, AR] replacement rows
) -> torch.Tensor:
    idx, rows = _operands(arena_buf, arena_idx, arena_rows, 0)
    return arena_buf.index_copy_(0, idx, rows)


def arena_scatter_vec(
    arena_buf1: torch.Tensor,  # [AN] resident rank-1 buffer, written in place
    arena_idx,                 # [AK] i32 unique indices; AN = padding
    arena_vals,                # [AK] replacement elements
) -> torch.Tensor:
    idx, vals = _operands(arena_buf1, arena_idx, arena_vals, 0)
    return arena_buf1.index_copy_(0, idx, vals)


def arena_scatter_cols(
    arena_mat: torch.Tensor,   # [AP, AN] resident matrix, written in place
    arena_idx,                 # [AK] i32 unique column indices; AN = padding
    arena_cols,                # [AP, AK] replacement columns
) -> torch.Tensor:
    idx, cols = _operands(arena_mat, arena_idx, arena_cols, 1)
    return arena_mat.index_copy_(1, idx, cols)
