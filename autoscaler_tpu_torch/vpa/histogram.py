"""Decaying-exponential histograms, vectorized across all containers.

Reference: vertical-pod-autoscaler/pkg/recommender/util/histogram.go:34,159
(exponential buckets: first bucket 0.01 cores / 10MB, ratio 1.05; weighted
percentile) and decaying_histogram.go:53,108 (half-life decay 24h: new
samples are scaled by 2^((t-ref)/half_life) and the bank is periodically
re-referenced to keep weights in float range), plus the checkpoint
(de)serialization at util/histogram.go:224,249.

The port of ``autoscaler_tpu/vpa/histogram.py``: a HistogramBank holds every
(VPA, container) histogram of one resource as one [C, B] f32 weight matrix
and a [C] f32 total on a torch device (the first CUDA card unless the
caller asks for another), updated in place. It gives the JAX package's bits
on the CPU and on the card, which takes the JAX package's f32 arithmetic
in the JAX package's order:

- sample ingestion is one ordered scatter-add a matrix (K5,
  ``ops/histogram.ordered_scatter_add``): the duplicates of a cell are
  added in sample order, as XLA's scatter adds them, each touched cell
  read and written flushed and each partial sum flushed, as XLA:CPU
  flushes them (a partial that falls below 2^-126 inside a run becomes a
  zero of its sign, and the run goes on from there);
- a percentile's cumulative sum is XLA:CPU's blocked scan (``xla_cumsum``),
  spelled out as slice adds; ``torch.cumsum`` sums in another order;
- XLA:CPU flushes f32 subnormals to zero, in its inputs and its results
  (DAZ and FTZ), so every f32 value this arithmetic reads or makes is
  flushed the same way (``flush_subnormals``; inside K5, its flushed add).

Bucket arithmetic, decay factors and checkpoint (re)normalisation stay in
numpy on the host, in f64 where the JAX package has them in f64.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.ops.histogram import ordered_scatter_add

# reference constants (histogram_options for cpu / memory)
CPU_FIRST_BUCKET = 0.01      # cores
MEMORY_FIRST_BUCKET = 1e7    # bytes (10MB)
BUCKET_RATIO = 1.05
NUM_BUCKETS = 176            # covers ~0.01..~50 cores / 10MB..~50TB
DEFAULT_HALF_LIFE_S = 24 * 3600.0
EPSILON = 1e-15

# the smallest normal f32: XLA:CPU reads and writes anything smaller as zero
F32_TINY = float(np.finfo(np.float32).tiny)
# XLA:CPU's scan block along the summed axis
SCAN_BLOCK = 16


@dataclass(frozen=True)
class HistogramSpec:
    first_bucket: float
    ratio: float = BUCKET_RATIO
    num_buckets: int = NUM_BUCKETS

    def bucket_of(self, values: np.ndarray) -> np.ndarray:
        v = np.maximum(np.asarray(values, np.float64), EPSILON)
        idx = np.floor(np.log(v / self.first_bucket) / np.log(self.ratio)) + 1.0
        # values below first_bucket land in bucket 0
        return np.clip(idx, 0, self.num_buckets - 1).astype(np.int32)

    def bucket_start(self, idx) -> np.ndarray:
        i = np.asarray(idx, np.float64)
        return np.where(i <= 0, 0.0, self.first_bucket * self.ratio ** (i - 1.0))


CPU_SPEC = HistogramSpec(CPU_FIRST_BUCKET)
MEMORY_SPEC = HistogramSpec(MEMORY_FIRST_BUCKET)


def flush_subnormals(t: torch.Tensor) -> torch.Tensor:
    """f32 subnormals → zeros of their sign, as XLA:CPU reads and writes
    them; every other value (NaN and the infinities too) as it is."""
    return torch.where(t.abs() < F32_TINY, t * 0.0, t)


def _flush_np(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) < np.float32(F32_TINY), x * np.float32(0.0), x).astype(np.float32)


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return flush_subnormals(a + b)


def _serial_scan(v: torch.Tensor, from_zero: bool = False) -> torch.Tensor:
    """Inclusive prefix sums along the last axis, one column at a time, the
    first column taken as it is or (``from_zero``) added to +0.0."""
    out = v.clone()
    if from_zero:
        out[..., 0] = _add(torch.zeros_like(v[..., 0]), v[..., 0])
    for j in range(1, v.shape[-1]):
        out[..., j] = _add(out[..., j - 1], v[..., j])
    return out


def xla_cumsum(w: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum(w, axis=1)`` of a [C, B] f32 matrix as XLA:CPU sums it:
    an axis of up to SCAN_BLOCK entries is summed serially from +0.0 (one
    entry is copied); a longer one in blocks of SCAN_BLOCK: a serial prefix
    inside each block, the block totals' inclusive prefix by this same
    scan, then each block's exclusive prefix (+0.0 for the first block)
    added to its entries. The inputs are read with subnormals flushed."""
    return _blocked(flush_subnormals(w))


def _blocked(w: torch.Tensor) -> torch.Tensor:
    C, B = w.shape
    if B <= 1:
        return w.clone()
    if B <= SCAN_BLOCK:
        return _serial_scan(w, from_zero=True)
    nb = -(-B // SCAN_BLOCK)
    v = torch.nn.functional.pad(w, (0, nb * SCAN_BLOCK - B)).view(C, nb, SCAN_BLOCK)
    inside = _serial_scan(v)
    totals = _blocked(inside[:, :, -1].contiguous())
    before = torch.cat([torch.zeros_like(totals[:, :1]), totals[:, :-1]], dim=1)
    return _add(inside, before[:, :, None]).reshape(C, nb * SCAN_BLOCK)[:, :B]


class HistogramBank:
    """[C, B] decaying histogram bank for C containers, on ``device``."""

    def __init__(
        self,
        num_series: int,
        spec: HistogramSpec,
        half_life_s: float = DEFAULT_HALF_LIFE_S,
        device=None,
    ):
        self.spec = spec
        self.half_life_s = half_life_s
        self.device = resolve_device(device)
        self.ref_ts = 0.0
        self.weights = torch.zeros((num_series, spec.num_buckets), dtype=torch.float32,
                                   device=self.device)
        self.total = torch.zeros((num_series,), dtype=torch.float32, device=self.device)
        # the bucket ends a percentile reports, as the JAX package rounds them
        self._ends = torch.tensor(
            spec.bucket_start(np.arange(1, spec.num_buckets + 1)).astype(np.float32),
            device=self.device,
        )

    @property
    def num_series(self) -> int:
        return self.weights.shape[0]

    def grow_to(self, num_series: int) -> None:
        if num_series <= self.num_series:
            return
        pad = num_series - self.num_series
        self.weights = torch.nn.functional.pad(self.weights, (0, 0, 0, pad))
        self.total = torch.nn.functional.pad(self.total, (0, pad))

    def _decay_factor(self, ts: np.ndarray) -> np.ndarray:
        return np.power(2.0, (np.asarray(ts) - self.ref_ts) / self.half_life_s)

    def _scale(self, factor: np.float32) -> None:
        """weights, total *= factor (an f32 scalar), in place."""
        f = float(_flush_np(np.asarray(factor, np.float32)))
        for t in (self.weights, self.total):
            t.copy_(flush_subnormals(t * f))

    def add_samples(
        self,
        series_idx: np.ndarray,   # [K] i32
        values: np.ndarray,       # [K]
        weights: np.ndarray,      # [K]
        timestamps: np.ndarray,   # [K] epoch seconds
    ) -> None:
        """One ordered scatter-add a matrix for any number of samples across
        any number of containers (decaying_histogram.go:AddSample,
        vectorized)."""
        if len(series_idx) == 0:
            return
        buckets = self.spec.bucket_of(values)
        # Re-reference BEFORE weighting: with real wall-clock epochs the very
        # first sample sits ~1.7e9s past the initial ref_ts=0 and
        # 2^(dt/half_life) overflows float64, poisoning every weight. Decay
        # the existing mass to the new reference first (0.5^(shift/hl) — 0.0
        # for anything 10+ half-lives stale, which is exact enough), then
        # weight this batch against the fresh reference.
        max_ts = float(np.max(timestamps))
        if max_ts - self.ref_ts > 10 * self.half_life_s:
            self._scale(np.float32(0.5 ** ((max_ts - self.ref_ts) / self.half_life_s)))
            self.ref_ts = max_ts
        w = np.asarray(weights, np.float64) * self._decay_factor(timestamps)
        flat = np.asarray(series_idx, np.int64) * self.spec.num_buckets + buckets
        # K5 reads the weights and the touched cells flushed and writes
        # them flushed, as XLA's scatter does
        w32 = torch.from_numpy(w.astype(np.float32)).to(self.device)
        for target, index in (
            (self.weights.view(-1), flat),
            (self.total, np.asarray(series_idx, np.int64)),
        ):
            index = torch.from_numpy(index.astype(np.int32)).to(self.device)
            ordered_scatter_add(target, index, w32)

    def percentile(self, p: float) -> torch.Tensor:
        """[C] f32 on the bank's device — weighted percentile per series in
        one blocked scan (histogram.go:159 Percentile). Empty series → 0."""
        cum = xla_cumsum(self.weights)
        total = flush_subnormals(self.total)
        p32 = torch.tensor(p, dtype=torch.float32, device=self.device)
        eps = torch.tensor(1e-9, dtype=torch.float32, device=self.device)
        target = flush_subnormals(p32 * total[:, None])
        hit = cum >= flush_subnormals(target - eps)
        # the first bucket whose cumulative weight reaches the target (index
        # 0 when none does); argmax takes no bool tensor
        idx = torch.argmax(hit.to(torch.uint8), dim=1)
        # reference returns the bucket END value (start of next bucket) so the
        # recommendation covers the observed sample
        out = self._ends[idx]
        return torch.where(total > 0, out, torch.zeros((), dtype=torch.float32,
                                                        device=self.device))

    # -- checkpoints (histogram.go:224,249 SaveToChekpoint/LoadFromCheckpoint)
    def checkpoint(self, series: int) -> Dict:
        w = self.weights[series].cpu().numpy().astype(np.float64)
        total = float(w.sum())
        if total <= 0:
            return {"total_weight": 0.0, "bucket_weights": {}, "ref_ts": self.ref_ts}
        maxw = w.max()
        # reference normalizes to ints in 0..10000 relative to max bucket
        norm = {
            int(i): int(round(x / maxw * 10000))
            for i, x in enumerate(w)
            if round(x / maxw * 10000) > 0
        }
        return {"total_weight": total, "bucket_weights": norm, "ref_ts": self.ref_ts}

    def restore(self, series: int, ckpt: Dict) -> None:
        bw = ckpt.get("bucket_weights", {})
        w = np.zeros(self.spec.num_buckets, np.float32)
        norm_sum = sum(bw.values())
        total = float(ckpt.get("total_weight", 0.0))
        if norm_sum > 0:
            for i, x in bw.items():
                w[int(i)] = x
            w = w / w.sum() * total
        # Stored weights are relative to the checkpoint's decay reference.
        # Adopt it (a fresh bank has ref_ts=0; without this, the first live
        # sample at a real epoch would trip the re-reference branch and
        # multiply the restored mass by ~0). If the bank already carries a
        # newer reference, re-base the restored mass onto it instead.
        saved_ref = float(ckpt.get("ref_ts", 0.0))
        if saved_ref > self.ref_ts:
            self._scale(np.float32(0.5 ** ((saved_ref - self.ref_ts) / self.half_life_s)))
            self.ref_ts = saved_ref
        elif saved_ref < self.ref_ts:
            rebase = float(0.5 ** ((self.ref_ts - saved_ref) / self.half_life_s))
            w = w * rebase
            total = total * rebase
        self.weights[series] = torch.from_numpy(np.asarray(w, np.float32)).to(self.device)
        self.total[series] = total


def bank_from_arrays(weights, total, ref_ts: float, spec: HistogramSpec,
                     half_life_s: float = DEFAULT_HALF_LIFE_S, device=None) -> HistogramBank:
    """A bank holding given state: ``weights`` [C, B] and ``total`` [C] as
    f32 arrays (the JAX package's bank's, through ``np.asarray``), its
    decay reference and spec — how both packages start from one state."""
    weights = np.array(weights, np.float32)
    total = np.array(total, np.float32)
    if weights.shape != (total.shape[0], spec.num_buckets):
        raise ValueError(f"weights {weights.shape} and total {total.shape} do not fit {spec}")
    bank = HistogramBank(total.shape[0], spec, half_life_s, device=device)
    bank.weights.copy_(torch.from_numpy(weights))
    bank.total.copy_(torch.from_numpy(total))
    bank.ref_ts = float(ref_ts)
    return bank
