"""VPA input pipeline: live metrics feeding + history replay.

Reference: vertical-pod-autoscaler/pkg/recommender/input/ —
ClusterStateFeeder (cluster_feeder.go:67) pulls container usage from the
metrics API every pass and streams samples into the model;
HistoryProvider (input/history/history_provider.go) replays Prometheus
range-query timeseries once at startup so a fresh recommender does not begin
cold; the OOM observer (input/oom/observer.go) turns container OOMKill events
into padded memory samples.

The transport is a protocol (`MetricsSource` / `HistorySource`), so tests and
zero-egress environments use the in-memory fakes; a deploy site plugs a
metrics-server or Prometheus client with the same surface. Samples are
batched into the model's vectorized add_* entry points — one numpy dispatch
per pass, not one per container.

The port's copy of ``autoscaler_tpu/vpa/feeder.py``.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.vpa.api import Vpa, match_vpa
from autoscaler_tpu_torch.vpa.recommender import ClusterStateModel, ContainerKey, instance_key


@dataclass
class ContainerUsage:
    """One scrape: instantaneous cpu (cores) + memory working set (bytes)."""

    namespace: str
    pod_name: str
    container: str
    pod_labels: Dict[str, str] = field(default_factory=dict)
    cpu_cores: float = 0.0
    memory_bytes: float = 0.0


class MetricsSource(abc.ABC):
    """The metrics-API surface the feeder needs (cluster_feeder.go uses
    MetricsClient; same shape)."""

    @abc.abstractmethod
    def container_usage(self, now_ts: float) -> List[ContainerUsage]: ...


class HistorySource(abc.ABC):
    """Range-query surface: per-container (ts, value) series
    (history_provider.go GetClusterHistory)."""

    @abc.abstractmethod
    def cpu_series(self) -> Dict[Tuple[str, str, str], List[Tuple[float, float]]]:
        """(namespace, pod, container) → [(ts, cores)]."""

    @abc.abstractmethod
    def memory_series(self) -> Dict[Tuple[str, str, str], List[Tuple[float, float]]]:
        """(namespace, pod, container) → [(ts, bytes)]."""

    @abc.abstractmethod
    def pod_labels(self) -> Dict[Tuple[str, str], Dict[str, str]]:
        """(namespace, pod) → labels (for VPA matching)."""


class InMemoryMetrics(MetricsSource, HistorySource):
    """Test/hermetic implementation of both surfaces."""

    def __init__(self) -> None:
        self._usage: List[ContainerUsage] = []
        self._cpu: Dict[Tuple[str, str, str], List[Tuple[float, float]]] = {}
        self._mem: Dict[Tuple[str, str, str], List[Tuple[float, float]]] = {}
        self._labels: Dict[Tuple[str, str], Dict[str, str]] = {}

    def set_usage(self, usage: Sequence[ContainerUsage]) -> None:
        self._usage = list(usage)

    def add_history(
        self,
        namespace: str,
        pod: str,
        container: str,
        labels: Dict[str, str],
        cpu: Sequence[Tuple[float, float]] = (),
        memory: Sequence[Tuple[float, float]] = (),
    ) -> None:
        key = (namespace, pod, container)
        self._cpu.setdefault(key, []).extend(cpu)
        self._mem.setdefault(key, []).extend(memory)
        self._labels[(namespace, pod)] = dict(labels)

    def container_usage(self, now_ts: float) -> List[ContainerUsage]:
        return list(self._usage)

    def cpu_series(self):
        return self._cpu

    def memory_series(self):
        return self._mem

    def pod_labels(self):
        return self._labels


class ClusterStateFeeder:
    """Streams metrics into the histogram model, one batched call per pass."""

    def __init__(self, model: ClusterStateModel, vpas: List[Vpa]):
        self.model = model
        self.vpas = vpas

    def _key_for(self, namespace: str, labels: Dict[str, str], container: str) -> Optional[ContainerKey]:
        vpa = match_vpa(self.vpas, namespace, labels)
        if vpa is None:
            return None
        return ContainerKey(vpa.name, container, vpa.namespace)

    def feed_once(self, source: MetricsSource, now_ts: float) -> int:
        """One live scrape → model. Returns samples ingested."""
        keys: List[ContainerKey] = []
        cpu: List[float] = []
        mem: List[float] = []
        pods: List[str] = []
        for u in source.container_usage(now_ts):
            key = self._key_for(u.namespace, u.pod_labels, u.container)
            if key is None:
                continue
            keys.append(key)
            cpu.append(u.cpu_cores)
            mem.append(u.memory_bytes)
            pods.append(instance_key(u.namespace, u.pod_name))
        if not keys:
            return 0
        ts = [now_ts] * len(keys)
        self.model.add_cpu_samples(keys, cpu, ts)
        self.model.add_memory_peaks(keys, mem, ts, pods)
        return len(keys)

    def replay_history(self, source: HistorySource) -> int:
        """Startup backfill (history_provider.go): every stored point becomes
        a sample at its original timestamp, so the decaying histograms weight
        it correctly. Returns samples ingested."""
        labels_of = source.pod_labels()
        count = 0
        keys: List[ContainerKey] = []
        values: List[float] = []
        ts: List[float] = []
        for (ns, pod, container), series in source.cpu_series().items():
            key = self._key_for(ns, labels_of.get((ns, pod), {}), container)
            if key is None:
                continue
            for t, v in series:
                keys.append(key)
                values.append(v)
                ts.append(t)
        if keys:
            self.model.add_cpu_samples(keys, values, ts)
            count += len(keys)
        keys, values, ts, pods = [], [], [], []
        for (ns, pod, container), series in source.memory_series().items():
            key = self._key_for(ns, labels_of.get((ns, pod), {}), container)
            if key is None:
                continue
            for t, v in series:
                keys.append(key)
                values.append(v)
                ts.append(t)
                pods.append(instance_key(ns, pod))
        if keys:
            self.model.add_memory_peaks(keys, values, ts, pods)
            count += len(keys)
        return count
