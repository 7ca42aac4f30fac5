"""Boolean bit-packing for one cheap device→host fetch of an estimator
result (the port of ``autoscaler_tpu/ops/bits.py``).

``pack_result_blob`` fuses counts [G] i32 and scheduled [G, P] bool into
ONE flat uint8 tensor on the result's device: [G*4 little-endian count
bytes][G*ceil(P/8) packed bits, most significant bit first], the layout
``np.unpackbits`` reads. ``unpack_result_blob`` is its host-side inverse.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # MSB-first


def pack_bool_bits(x: torch.Tensor) -> torch.Tensor:
    """[..., P] bool → [..., ceil(P/8)] uint8 (np.unpackbits-compatible)."""
    P = x.shape[-1]
    pad = (-P) % 8
    if pad:
        x = torch.nn.functional.pad(x.to(torch.uint8), (0, pad))
    grouped = x.reshape(*x.shape[:-1], (P + pad) // 8, 8).to(torch.int32)
    weights = torch.tensor(_WEIGHTS, dtype=torch.int32, device=x.device)
    return (grouped * weights).sum(dim=-1).to(torch.uint8)


def unpack_bool_bits(packed: np.ndarray, length: int) -> np.ndarray:
    """Host-side inverse: [..., B] uint8 → [..., length] bool."""
    flat = np.unpackbits(np.ascontiguousarray(packed), axis=-1)
    return flat[..., :length].astype(bool)


def pack_result_blob(node_count: torch.Tensor, scheduled: torch.Tensor) -> torch.Tensor:
    """Counts [G] + scheduled [G, P] → one flat uint8 tensor. The count
    bytes are the int32 values reinterpreted in place, which is
    little-endian on every host and CUDA device PyTorch runs on; a
    big-endian host raises rather than emit a blob the '<i4' decode
    would corrupt."""
    if sys.byteorder != "little":
        raise RuntimeError("pack_result_blob needs a little-endian host")
    cnt_bytes = node_count.to(torch.int32).contiguous().view(torch.uint8)
    packed = pack_bool_bits(scheduled)
    return torch.cat([cnt_bytes.reshape(-1), packed.reshape(-1)])


def unpack_result_blob(buf: np.ndarray, G: int, P: int):
    """Host-side inverse of pack_result_blob → (counts [G] i32 array,
    scheduled [G, P] bool)."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    counts = buf[: 4 * G].view("<i4").copy()
    B = (P + 7) // 8
    bits = unpack_bool_bits(buf[4 * G : 4 * G + G * B].reshape(G, B), P)
    return counts, bits
