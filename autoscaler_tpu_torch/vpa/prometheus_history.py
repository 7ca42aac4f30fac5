"""Prometheus history provider for the VPA recommender warm start.

Concrete ``HistorySource`` (vpa/feeder.py) speaking the Prometheus HTTP API,
matching the reference's provider behavior
(vertical-pod-autoscaler/pkg/recommender/input/history/history_provider.go):

- CPU: ``rate(container_cpu_usage_seconds_total{<selector>}[<resolution>])``
  range-queried over the history window (cores).
- Memory: ``container_memory_working_set_bytes{<selector>}`` range-queried
  over the same window (bytes).
- Pod labels: one instant query of the kube-state-metrics series
  (``up{job="kube-state-metrics"}``-style, configurable) whose label set
  carries ``<pod_label_prefix>*`` keys; the freshest sample per pod wins
  (readLastLabels, history_provider.go:225).

Transport is stdlib urllib (zero extra deps, same choice as kube/client.py);
results parse from the standard ``/api/v1/query_range`` / ``/api/v1/query``
JSON envelope. Queries are built exactly like the reference's (selector
structure incl. the cadvisor job matcher, the ``name!="POD"`` pause-container
exclusion, and the optional namespace pin) so a recorded reference-shaped
server answers them — tests/test_vpa_prometheus.py locks the query strings
against the reference's own test expectations (history_provider_test.go:34).

Durations accept the Prometheus forms the reference parses via
``prommodel.ParseDuration``: ``30s``, ``5m``, ``1h``, ``8d``, ``2w``, ``1y``.

The port's copy of ``autoscaler_tpu/vpa/prometheus_history.py``.
"""
from __future__ import annotations

import json
import logging
import re
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Tuple

from autoscaler_tpu_torch.vpa.feeder import HistorySource

log = logging.getLogger("vpa.prometheus")

_DURATION_RE = re.compile(r"(\d+)(ms|s|m|h|d|w|y)")
_DURATION_S = {
    "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0,
    "d": 86400.0, "w": 7 * 86400.0, "y": 365 * 86400.0,
}


def parse_duration_s(s: str) -> float:
    """Prometheus duration string → seconds, incl. compound forms like
    ``1h30m`` / ``1d12h`` (prommodel.ParseDuration grammar: units in
    strictly descending order, each at most once)."""
    text = s.strip()
    if text == "0":
        return 0.0    # prommodel special-cases the bare "0" (no unit)
    pos, total = 0, 0.0
    last_rank = -1
    ranks = {u: r for r, u in enumerate(("y", "w", "d", "h", "m", "s", "ms"))}
    while pos < len(text):
        m = _DURATION_RE.match(text, pos)
        if not m:
            raise ValueError(f"{s!r} is not a valid Prometheus duration")
        rank = ranks[m.group(2)]
        if rank <= last_rank:  # repeated or out-of-order unit
            raise ValueError(f"{s!r} is not a valid Prometheus duration")
        last_rank = rank
        total += int(m.group(1)) * _DURATION_S[m.group(2)]
        pos = m.end()
    if pos == 0:
        raise ValueError(f"{s!r} is not a valid Prometheus duration")
    return total


@dataclass
class PrometheusHistoryConfig:
    """Mirror of PrometheusHistoryProviderConfig (history_provider.go:37),
    defaults matching the reference recommender's flags."""

    address: str                       # e.g. http://prometheus.monitoring:9090
    history_length: str = "8d"
    history_resolution: str = "1h"
    query_timeout_s: float = 5 * 60.0
    pod_label_prefix: str = "pod_label_"
    pod_labels_metric_name: str = (
        'up{job="kube-state-metrics"}[8d]'
    )
    pod_namespace_label: str = "kubernetes_namespace"
    pod_name_label: str = "kubernetes_pod_name"
    ctr_namespace_label: str = "namespace"
    ctr_pod_name_label: str = "pod_name"
    ctr_name_label: str = "name"
    cadvisor_job_name: str = "kubernetes-cadvisor"
    namespace: str = ""                # "" = all namespaces


Series = Dict[Tuple[str, str, str], List[Tuple[float, float]]]


class PrometheusHistorySource(HistorySource):
    """Fetch-on-demand HistorySource: the three queries run once on the
    first accessor and cache (the feeder replays history exactly once at
    startup — cluster_feeder.go InitFromHistoryProvider)."""

    def __init__(self, config: PrometheusHistoryConfig, opener=None):
        self.config = config
        # injectable opener for tests; urllib's default otherwise
        self._open = opener or urllib.request.urlopen
        self._cpu: Series | None = None
        self._mem: Series | None = None
        self._labels: Dict[Tuple[str, str], Dict[str, str]] | None = None

    # -- query construction (GetClusterHistory, history_provider.go:263) ---
    def _pod_selector(self) -> str:
        c = self.config
        parts = []
        if c.cadvisor_job_name:
            parts.append(f'job="{c.cadvisor_job_name}"')
        parts.append(f'{c.ctr_pod_name_label}=~".+"')
        parts.append(f'{c.ctr_name_label}!="POD"')
        parts.append(f'{c.ctr_name_label}!=""')
        if c.namespace:
            parts.append(f'{c.ctr_namespace_label}="{c.namespace}"')
        return ", ".join(parts)

    def cpu_query(self) -> str:
        return (
            f"rate(container_cpu_usage_seconds_total{{{self._pod_selector()}}}"
            f"[{self.config.history_resolution}])"
        )

    def memory_query(self) -> str:
        return f"container_memory_working_set_bytes{{{self._pod_selector()}}}"

    # -- HTTP --------------------------------------------------------------
    def _api(self, path: str, params: Dict[str, str]) -> list:
        url = (
            self.config.address.rstrip("/")
            + path + "?" + urllib.parse.urlencode(params)
        )
        with self._open(url, timeout=self.config.query_timeout_s) as resp:
            body = json.loads(resp.read().decode())
        if body.get("status") != "success":
            raise RuntimeError(
                f"prometheus query failed: {body.get('error', body)}"
            )
        data = body.get("data", {})
        if data.get("resultType") != "matrix":
            raise RuntimeError(
                f"expected a matrix result, got {data.get('resultType')!r}"
            )
        return data.get("result", [])

    def _query_range(self, query: str) -> list:
        end = time.time()
        start = end - parse_duration_s(self.config.history_length)
        # step as plain float seconds: Prometheus accepts that form for any
        # resolution, while a composed duration string like "0.5s" is
        # rejected (decimal durations are invalid duration syntax)
        step = parse_duration_s(self.config.history_resolution)
        return self._api(
            "/api/v1/query_range",
            {"query": query, "start": f"{start:.3f}", "end": f"{end:.3f}",
             "step": f"{step:g}"},
        )

    def _query_instant(self, query: str) -> list:
        return self._api(
            "/api/v1/query", {"query": query, "time": f"{time.time():.3f}"}
        )

    # -- parsing -----------------------------------------------------------
    def _container_series(self, result: list) -> Series:
        c = self.config
        out: Series = {}
        for ts in result:
            metric = ts.get("metric", {})
            try:
                key = (
                    metric[c.ctr_namespace_label],
                    metric[c.ctr_pod_name_label],
                    metric[c.ctr_name_label],
                )
            except KeyError as e:
                # the reference hard-fails here (getContainerIDFromLabels);
                # a permissive skip would hide a mislabeled scrape config
                raise RuntimeError(
                    f"timeseries metric lacks the {e.args[0]!r} label: {metric}"
                ) from e
            points = [
                (float(t), float(v))
                for t, v in ts.get("values", [])
                if v not in ("NaN", "+Inf", "-Inf")
            ]
            out.setdefault(key, []).extend(points)
        for pts in out.values():
            pts.sort(key=lambda p: p[0])
        return out

    def _fetch(self) -> None:
        # guard on the LAST field assigned: a failure mid-way (memory or
        # labels query) must leave the cache unset so a retry re-fetches
        # instead of returning a half-initialized None
        if self._labels is not None:
            return
        t0 = time.monotonic()
        cpu = self._container_series(self._query_range(self.cpu_query()))
        mem = self._container_series(
            self._query_range(self.memory_query())
        )
        c = self.config
        labels: Dict[Tuple[str, str], Dict[str, str]] = {}
        freshest: Dict[Tuple[str, str], float] = {}
        for ts in self._query_instant(c.pod_labels_metric_name):
            metric = ts.get("metric", {})
            ns = metric.get(c.pod_namespace_label)
            pod = metric.get(c.pod_name_label)
            if ns is None or pod is None:
                raise RuntimeError(
                    f"labels series lacks {c.pod_namespace_label}/"
                    f"{c.pod_name_label}: {metric}"
                )
            values = ts.get("values", [])
            if not values:
                continue
            last_ts = float(values[-1][0])
            if last_ts <= freshest.get((ns, pod), -1.0):
                continue
            freshest[(ns, pod)] = last_ts
            labels[(ns, pod)] = {
                k[len(c.pod_label_prefix):]: v
                for k, v in metric.items()
                if k.startswith(c.pod_label_prefix)
            }
        # all three queries succeeded: publish atomically
        self._cpu, self._mem, self._labels = cpu, mem, labels
        log.info(
            "prometheus history: %d cpu series, %d memory series, %d "
            "labeled pods in %.1fs",
            len(cpu), len(mem), len(labels),
            time.monotonic() - t0,
        )

    # -- HistorySource -----------------------------------------------------
    def cpu_series(self) -> Series:
        self._fetch()
        return self._cpu

    def memory_series(self) -> Series:
        self._fetch()
        return self._mem

    def pod_labels(self) -> Dict[Tuple[str, str], Dict[str, str]]:
        self._fetch()
        return self._labels
