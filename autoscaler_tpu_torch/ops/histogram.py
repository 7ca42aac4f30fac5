"""The ordered scatter-add of the VPA's histogram bank, on a hand-written
CUDA kernel (K5, ``csrc/histogram.cu``).

``ordered_scatter_add(target, index, values)`` adds ``values[k]`` into
``target[index[k]]`` in place, the duplicates of a cell in the order of k:
``((t + v_a) + v_b) + ...``. That is the order XLA:CPU's scatter-add
(``.at[flat].add`` in ``autoscaler_tpu/vpa/histogram.py:111-119``) adds
them in, so the port's bank keeps the JAX package's bits. Indices outside
[0, N) are dropped, as XLA's scatter drops them.

For CUDA tensors the wrapper sorts the indices stably on the card, launches
K5 (one thread a segment of equal indices adds its values in order) and
counts the launch in ``LAUNCHES``; it never calls ``index_add_`` there,
whose atomics add duplicates in no fixed order. For CPU tensors it runs the
plain version, ``_ordered_scatter_add_plain``: ``index_add_`` on the CPU,
which adds in index order (a test holds it against a Python loop). There is
no fallback from one to the other.
"""
from __future__ import annotations

import torch

from autoscaler_tpu_torch.ops import _build
from autoscaler_tpu_torch.trace.device import device_annotation

# K5's launch count: the wrapper adds one where it launches the kernel, and
# nowhere else.
LAUNCHES = {"ordered_scatter_add": 0}

# K5's shape contract, read by AST and never imported (GL007,
# autoscaler_tpu_torch/analysis/contracts.py). K5 launches with no dynamic
# shared memory, and its grid is computed in csrc/histogram.cu.
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


def _ordered_scatter_add_plain(target, index, values):
    """Plain version of K5 on CPU tensors: ``index_add_``, which adds the
    pairs in index order, after dropping the indices outside [0, N)."""
    index = index.long()
    keep = (index >= 0) & (index < target.numel())
    if not bool(keep.all()):
        index, values = index[keep], values[keep]
    return target.index_add_(0, index, values)


def sort_pairs(index):
    """K5's glue: (keys [K] i32 sorted stably, order [K] i64: sorted slot →
    pair)."""
    return torch.sort(index.to(torch.int32), stable=True)


def launch_sorted(target, keys, order, values):
    """K5 on operands already sorted by ``sort_pairs``: one launch, counted."""
    lib = _build.load("histogram")
    dev = target.device
    # the range names the kernel on a captured profile (trace/device.py)
    with torch.cuda.device(dev), device_annotation("ordered_scatter_add"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ordered_scatter_add(
            target.data_ptr(), keys.data_ptr(), order.data_ptr(), values.data_ptr(),
            keys.numel(), target.numel(), stream,
        )
    _build.check(err, "ordered_scatter_add")
    LAUNCHES["ordered_scatter_add"] += 1
    return target


def ordered_scatter_add(target: torch.Tensor, index: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
    """K5: ``target[index[k]] += values[k]`` in place, duplicates in the
    order of k; → ``target``. CUDA tensors launch the kernel; CPU tensors
    run the plain version."""
    _check_operands(target, index, values)
    dev = target.device
    if dev.type == "cpu":
        return _ordered_scatter_add_plain(target, index, values)
    if dev.type != "cuda":
        raise ValueError(f"ordered_scatter_add runs on CUDA or CPU tensors, got {dev}")
    if index.numel() == 0:
        return target
    keys, order = sort_pairs(index)
    return launch_sorted(target, keys, order, values.contiguous())
