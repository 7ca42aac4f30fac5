"""Vertical pod autoscaling: aggregate container state + percentile
recommender, all containers evaluated in batched array ops.

Reference: vertical-pod-autoscaler/pkg/recommender/ —
- model: ClusterState pkg/recommender/model/cluster.go:41,
  AggregateContainerState model/aggregate_container_state.go:91 (cpu usage
  histogram + memory *peaks* histogram, first/last sample time, counts)
- logic: percentile estimator chain logic/estimator.go:43,70,87 +
  recommender.go:59,104-114 — target p90, lower bound p50, upper bound p95,
  confidence-interval scaling by observation age, safety margin (+15%),
  min-resources floor
- loop: routines/recommender.go:160 RunOnce (feed → update VPAs → maintain
  checkpoints → GC)

The port's copy of ``autoscaler_tpu/vpa/recommender.py``: its model's two
banks live on a torch device (``ClusterStateModel(device=...)``, the first
CUDA card by default), and each percentile comes back to the host once a
pass for the same numpy scalar arithmetic as the JAX package's.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from autoscaler_tpu_torch.vpa.histogram import (
    CPU_SPEC,
    MEMORY_SPEC,
    HistogramBank,
    HistogramSpec,
)

# estimator constants (logic/recommender.go:104-114 and estimator.go)
TARGET_PERCENTILE = 0.9
LOWER_PERCENTILE = 0.5
UPPER_PERCENTILE = 0.95
SAFETY_MARGIN = 1.15
MIN_CPU_CORES = 0.025
MIN_MEMORY_BYTES = 250 * 1024 * 1024
CONFIDENCE_EXPONENT = 1.0
MEM_AGGREGATION_WINDOW_S = 24 * 3600.0  # MemoryAggregationInterval


def instance_key(namespace: str, pod_name: str) -> str:
    """Canonical container-instance identity for memory-window tracking.
    Feeder, OOM observers, and tests must all build it through here."""
    return f"{namespace}/{pod_name}"


@dataclass
class ContainerKey:
    vpa: str
    container: str
    # VPA names are only unique per namespace (a same-named VPA in another
    # namespace is a distinct object) — without this, two teams' histograms
    # blend into one recommendation.
    namespace: str = "default"

    def __hash__(self):
        return hash((self.vpa, self.container, self.namespace))

    def __eq__(self, other):
        return (self.vpa, self.container, self.namespace) == (
            other.vpa,
            other.container,
            other.namespace,
        )


@dataclass
class Recommendation:
    target_cpu: float        # cores
    target_memory: float     # bytes
    lower_cpu: float
    lower_memory: float
    upper_cpu: float
    upper_memory: float


@dataclass
class _AggregateMeta:
    first_sample_ts: float = math.inf
    last_sample_ts: float = -math.inf
    sample_count: int = 0
    oom_observed_ts: Optional[float] = None


class ClusterStateModel:
    """All AggregateContainerStates backed by two HistogramBanks."""

    def __init__(self, capacity: int = 64, half_life_s: float = 24 * 3600.0,
                 device=None):
        self.cpu = HistogramBank(capacity, CPU_SPEC, half_life_s, device=device)
        self.memory = HistogramBank(capacity, MEMORY_SPEC, half_life_s,
                                    device=self.cpu.device)
        self.device = self.cpu.device
        self._index: Dict[ContainerKey, int] = {}
        self._meta: List[_AggregateMeta] = []
        # (series, pod) → (window_idx, peak_bytes, peak_ts): the current
        # memory-aggregation window's running peak per container instance
        self._mem_window: Dict[tuple, tuple] = {}
        # MemoryAggregationInterval — deliberately its own knob, NOT aliased
        # to the decay half-life (both default 24h in the reference but are
        # independently configurable; aliasing them would make a faster
        # decay silently shrink the peak window)
        self.mem_window_s = MEM_AGGREGATION_WINDOW_S
        self._mem_window_seen = 0  # high-water window index, drives GC

    def series(self, key: ContainerKey) -> int:
        if key not in self._index:
            idx = len(self._index)
            self._index[key] = idx
            self._meta.append(_AggregateMeta())
            if idx >= self.cpu.num_series:
                self.cpu.grow_to(self.cpu.num_series * 2)
                self.memory.grow_to(self.memory.num_series * 2)
        return self._index[key]

    def add_cpu_samples(
        self, keys: Sequence[ContainerKey], cores: Sequence[float], ts: Sequence[float]
    ) -> None:
        idx = np.array([self.series(k) for k in keys], np.int64)
        # reference weights cpu samples by max(request, usage) — simplified to
        # usage weighting: heavier samples count more
        weights = np.maximum(np.asarray(cores, np.float64), MIN_CPU_CORES)
        self.cpu.add_samples(idx, np.asarray(cores), weights, np.asarray(ts))
        self._touch(idx, ts)

    def add_memory_peaks(
        self,
        keys: Sequence[ContainerKey],
        peaks: Sequence[float],
        ts: Sequence[float],
        pods: Optional[Sequence[str]] = None,
    ) -> None:
        """Window-peak aggregation (aggregate_container_state.go
        AddMemoryPeak): each container instance contributes exactly ONE
        sample per 24h window — its running peak. A higher observation
        within the window subtracts the previous peak sample and adds the
        new one, so a single spike (e.g. OOM) carries a full sample's
        weight instead of drowning among per-scrape samples."""
        pods = pods if pods is not None else [""] * len(keys)
        add_idx: List[int] = []
        add_val: List[float] = []
        add_w: List[float] = []
        add_ts: List[float] = []
        touch_idx: List[int] = []
        max_widx = self._mem_window_seen
        for key, peak, t, pod in zip(keys, peaks, ts, pods):
            i = self.series(key)
            touch_idx.append(i)
            widx = int(t // self.mem_window_s)
            max_widx = max(max_widx, widx)
            prev = self._mem_window.get((i, pod))
            if prev is not None and prev[0] == widx:
                if peak <= prev[1]:
                    continue
                # replace: subtract the old peak at its original timestamp
                add_idx.append(i); add_val.append(prev[1])
                add_w.append(-1.0); add_ts.append(prev[2])
            add_idx.append(i); add_val.append(float(peak))
            add_w.append(1.0); add_ts.append(float(t))
            self._mem_window[(i, pod)] = (widx, float(peak), float(t))
        if add_idx:
            self.memory.add_samples(
                np.asarray(add_idx, np.int64), np.asarray(add_val),
                np.asarray(add_w), np.asarray(add_ts),
            )
        self._touch(np.asarray(touch_idx, np.int64), ts)
        # GC once per new window: entries whose window has passed can never
        # be replaced again, and dead pods would otherwise accumulate
        # forever under churn (the reference GCs container states similarly)
        if max_widx > self._mem_window_seen:
            self._mem_window_seen = max_widx
            self._mem_window = {
                k: v for k, v in self._mem_window.items() if v[0] >= max_widx - 1
            }

    def observe_oom(
        self, key: ContainerKey, memory_at_oom: float, ts: float, pod: str = ""
    ) -> None:
        """OOM bumps the container's current window peak to a 20%-padded
        sample (reference input/oom/observer.go via model)."""
        idx = self.series(key)
        self.add_memory_peaks([key], [memory_at_oom * 1.2], [ts], [pod])
        self._meta[idx].oom_observed_ts = ts

    def _touch(self, idx: np.ndarray, ts: Sequence[float]) -> None:
        for i, t in zip(idx, ts):
            m = self._meta[int(i)]
            m.first_sample_ts = min(m.first_sample_ts, float(t))
            m.last_sample_ts = max(m.last_sample_ts, float(t))
            m.sample_count += 1

    def meta(self, key: ContainerKey) -> _AggregateMeta:
        return self._meta[self.series(key)]

    def keys(self) -> List[ContainerKey]:
        return list(self._index)


class PercentileRecommender:
    """The estimator chain: percentile → confidence scaling → margin → min
    floor (logic/estimator.go:43,70,87)."""

    def __init__(
        self,
        model: ClusterStateModel,
        target_cpu_percentile: float = TARGET_PERCENTILE,
        safety_margin: float = SAFETY_MARGIN,
        min_cpu_cores: float = MIN_CPU_CORES,
        min_memory_bytes: float = MIN_MEMORY_BYTES,
    ):
        """Knobs mirror the reference recommender flags
        (logic/recommender.go:28-36: --recommendation-margin-fraction,
        --target-cpu-percentile, --pod-recommendation-min-cpu-millicores,
        --pod-recommendation-min-memory-mb). target_cpu_percentile affects
        the CPU target only, exactly like the reference."""
        self.model = model
        self.target_cpu_percentile = target_cpu_percentile
        self.safety_margin = safety_margin
        self.min_cpu_cores = min_cpu_cores
        self.min_memory_bytes = min_memory_bytes

    def recommend(self, now_ts: Optional[float] = None) -> Dict[ContainerKey, Recommendation]:
        now_ts = now_ts if now_ts is not None else time.time()
        keys = self.model.keys()
        if not keys:
            return {}
        # all percentiles across all containers: six scans total, each read
        # back as an f32 array (the scalar arithmetic below stays f32 where
        # the JAX package's does: np.float32 x a Python float is f32)
        cpu_t = np.asarray(
            self.model.cpu.percentile(self.target_cpu_percentile).cpu()
        )
        cpu_l = np.asarray(self.model.cpu.percentile(LOWER_PERCENTILE).cpu())
        cpu_u = np.asarray(self.model.cpu.percentile(UPPER_PERCENTILE).cpu())
        mem_t = np.asarray(self.model.memory.percentile(TARGET_PERCENTILE).cpu())
        mem_l = np.asarray(self.model.memory.percentile(LOWER_PERCENTILE).cpu())
        mem_u = np.asarray(self.model.memory.percentile(UPPER_PERCENTILE).cpu())

        out: Dict[ContainerKey, Recommendation] = {}
        for key in keys:
            i = self.model.series(key)
            meta = self.model.meta(key)
            if meta.sample_count == 0:
                continue
            days = max((now_ts - meta.first_sample_ts) / 86400.0, 1e-3)
            # confidence multipliers (estimator.go:70 confidenceMultiplier):
            # upper shrinks toward target as history grows, lower grows toward it
            upper_mult = (1.0 + 1.0 / days) ** CONFIDENCE_EXPONENT
            lower_mult = (1.0 + 0.001 / days) ** -2.0
            rec = Recommendation(
                target_cpu=self._floor_cpu(cpu_t[i] * self.safety_margin),
                target_memory=self._floor_mem(mem_t[i] * self.safety_margin),
                lower_cpu=self._floor_cpu(cpu_l[i] * self.safety_margin * lower_mult),
                lower_memory=self._floor_mem(mem_l[i] * self.safety_margin * lower_mult),
                upper_cpu=self._floor_cpu(cpu_u[i] * self.safety_margin * upper_mult),
                upper_memory=self._floor_mem(mem_u[i] * self.safety_margin * upper_mult),
            )
            out[key] = rec
        return out

    def _floor_cpu(self, v: float) -> float:
        return max(float(v), self.min_cpu_cores)

    def _floor_mem(self, v: float) -> float:
        return max(float(v), float(self.min_memory_bytes))


@dataclass
class Checkpoint:
    """VerticalPodAutoscalerCheckpoint analog
    (checkpoint/checkpoint_writer.go:36,78)."""

    vpa: str
    container: str
    cpu: Dict = field(default_factory=dict)
    memory: Dict = field(default_factory=dict)
    sample_count: int = 0
    first_sample_ts: float = 0.0
    namespace: str = "default"


class CheckpointManager:
    def __init__(self, model: ClusterStateModel):
        self.model = model

    def store(self) -> List[Checkpoint]:
        out = []
        for key in self.model.keys():
            i = self.model.series(key)
            meta = self.model.meta(key)
            out.append(
                Checkpoint(
                    vpa=key.vpa,
                    container=key.container,
                    namespace=key.namespace,
                    cpu=self.model.cpu.checkpoint(i),
                    memory=self.model.memory.checkpoint(i),
                    sample_count=meta.sample_count,
                    first_sample_ts=meta.first_sample_ts,
                )
            )
        return out

    def load(self, checkpoints: Sequence[Checkpoint]) -> None:
        for ckpt in checkpoints:
            key = ContainerKey(ckpt.vpa, ckpt.container, ckpt.namespace)
            i = self.model.series(key)
            self.model.cpu.restore(i, ckpt.cpu)
            self.model.memory.restore(i, ckpt.memory)
            meta = self.model.meta(key)
            meta.sample_count = ckpt.sample_count
            meta.first_sample_ts = ckpt.first_sample_ts
            meta.last_sample_ts = max(meta.last_sample_ts, ckpt.first_sample_ts)
