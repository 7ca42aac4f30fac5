"""The ordered scatter-add of the VPA's histogram bank, on a hand-written
CUDA kernel (K5, ``csrc/histogram.cu``).

``ordered_scatter_add(target, index, values)`` adds ``values[k]`` into
``target[index[k]]`` in place, the duplicates of a cell in the order of k,
with f32 subnormals flushed as XLA:CPU flushes them (DAZ and FTZ):
``ftz(ftz(ftz(t) + v_a) + v_b) + ...``, every operand read with subnormals
as zeros of their sign and every partial sum flushed. That is what XLA:CPU's
scatter-add (``.at[flat].add`` in ``autoscaler_tpu/vpa/histogram.py:111-119``)
computes, a serial loop over the updates, so the port's bank keeps the JAX
package's bits: ``tests/test_torch_vpa_histogram.py`` holds it against
``jnp.zeros(N).at[idx].add(vals)`` on runs whose partial sums cross below
2^-126 and come back. Indices outside [0, N) are dropped and touch nothing
(``.at[]`` itself wraps negative indices before XLA sees them; the bank
makes none). Cells no pair names keep their bits.

For CUDA tensors the wrapper allocates the grouping's scratch with
``torch.empty``, launches K5 on the current stream (a counting grouping of
the pairs by cell, then a warp or a block a cell: its runs put back in pair
order, one thread's chain; no sort of the K pairs, no float atomics) without
synchronising, and counts the call in ``LAUNCHES``. For CPU tensors it runs the plain version,
``_ordered_scatter_add_plain``: a stable sort of the pairs, then the chains
one rank at a time, every cell's r-th add at once, each add flushed. There
is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from autoscaler_tpu_torch.ops import _build
from autoscaler_tpu_torch.trace.device import device_annotation

# K5's launch count: the wrapper adds one where it launches the kernel, and
# nowhere else.
LAUNCHES = {"ordered_scatter_add": 0}

# K5's shape contract, read by AST and never imported (GL007,
# autoscaler_tpu_torch/analysis/contracts.py). K5's grids and its shared
# memory (32 KB a warp-chain block, 64 KB a block-chain block) are fixed in
# csrc/histogram.cu.
KERNEL_CONTRACTS = {
    "ordered_scatter_add": {
        "args": {
            "target": {"dims": ["N"], "dtype": "f32"},
            "index": {"dims": ["K"]},
            "values": {"dims": ["K"], "dtype": "f32"},
        },
        "pad_value": "an index outside [0, N): the pair is dropped",
        "notes": "index i32 or i64; target contiguous; N and K under 2**31",
    },
}

# the smallest normal f32: XLA:CPU reads and writes anything smaller as zero
F32_TINY = np.float32(np.finfo(np.float32).tiny)


def _check_operands(target, index, values):
    if not isinstance(target, torch.Tensor) or target.dtype != torch.float32 \
            or target.dim() != 1 or not target.is_contiguous():
        raise ValueError("target must be a contiguous 1-d float32 tensor")
    if not isinstance(index, torch.Tensor) or index.dim() != 1 \
            or index.dtype not in (torch.int32, torch.int64):
        raise ValueError("index must be a 1-d int32 or int64 tensor")
    if not isinstance(values, torch.Tensor) or values.dtype != torch.float32 \
            or tuple(values.shape) != tuple(index.shape):
        raise ValueError(f"values must be a float32 tensor of shape {tuple(index.shape)}")
    for name, t in (("index", index), ("values", values)):
        if t.device != target.device:
            raise ValueError(f"{name} is on {t.device}, target on {target.device}")
    if target.numel() >= 2**31 or index.numel() >= 2**31:
        raise ValueError("ordered_scatter_add takes fewer than 2**31 cells and pairs")


def _flush(x: np.ndarray) -> np.ndarray:
    """f32 subnormals → zeros of their sign; every other value as it is."""
    return np.where(np.abs(x) < F32_TINY, x * np.float32(0.0), x)


def _ordered_scatter_add_plain(target, index, values):
    """Plain version of K5 on CPU tensors. The pairs are sorted stably by
    cell; the cells are taken longest run first, so the runs still going at
    rank r are a prefix, and rank by rank every such cell adds its r-th
    value, flushed as XLA:CPU flushes."""
    out = target.numpy()
    idx = index.numpy().astype(np.int64)
    vals = _flush(values.numpy())
    keep = (idx >= 0) & (idx < out.size)
    idx, vals = idx[keep], vals[keep]
    if idx.size == 0:
        return target
    order = np.argsort(idx, kind="stable")
    idx, vals = idx[order], vals[order]
    starts = np.flatnonzero(np.r_[True, idx[1:] != idx[:-1]])
    runs = np.diff(np.r_[starts, idx.size])
    longest = np.argsort(-runs, kind="stable")
    starts, runs = starts[longest], runs[longest]
    cells = idx[starts]
    # going[r]: how many runs are longer than r
    going = np.searchsorted(-runs, -np.arange(runs[0]), side="left")
    acc = _flush(out[cells])
    for r, n in enumerate(going.tolist()):
        acc[:n] = _flush(acc[:n] + vals[starts[:n] + r])
    out[cells] = acc
    return target


def _launch(target, index, values):
    """K5 on contiguous CUDA operands already checked: its scratch (uninitialised
    bytes on their card), one call on the current stream, counted."""
    lib = _build.load("histogram")
    dev = target.device
    nbytes = ctypes.c_longlong(0)
    lib.ordered_scatter_add_scratch(index.numel(), target.numel(), ctypes.byref(nbytes))
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    # the range names the kernel on a captured profile (trace/device.py)
    with torch.cuda.device(dev), device_annotation("ordered_scatter_add"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ordered_scatter_add(
            target.data_ptr(), index.data_ptr(), index.element_size(), values.data_ptr(),
            scratch.data_ptr(), index.numel(), target.numel(), stream,
        )
    _build.check(err, "ordered_scatter_add")
    LAUNCHES["ordered_scatter_add"] += 1
    return target


def ordered_scatter_add(target: torch.Tensor, index: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
    """K5: ``target[index[k]] += values[k]`` in place, duplicates in the
    order of k, subnormals flushed as XLA:CPU flushes them; → ``target``.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    _check_operands(target, index, values)
    dev = target.device
    if dev.type == "cpu":
        return _ordered_scatter_add_plain(target, index, values)
    if dev.type != "cuda":
        raise ValueError(f"ordered_scatter_add runs on CUDA or CPU tensors, got {dev}")
    if index.numel() == 0:
        return target
    index, values = index.contiguous(), values.contiguous()
    return _launch(target, index, values)
