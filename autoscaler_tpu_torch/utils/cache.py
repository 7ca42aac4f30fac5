"""Expiring cache + quota-limited logging.

Reference: cluster-autoscaler/utils/expiring/ (time-bounded cache used for
template NodeInfos etc.) and utils/klogx/ (quota-limited verbose logging: at
most N log lines per loop for high-cardinality messages like per-pod
scheduling verdicts).

The port's copy of ``autoscaler_tpu/utils/cache.py``.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Generic, Optional, Tuple, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class ExpiringCache(Generic[K, V]):
    def __init__(self, ttl_s: float, clock: Callable[[], float] = time.monotonic):
        self.ttl_s = ttl_s
        self._clock = clock
        self._store: Dict[K, Tuple[V, float]] = {}

    def get(self, key: K) -> Optional[V]:
        entry = self._store.get(key)
        if entry is None:
            return None
        value, ts = entry
        if self._clock() - ts > self.ttl_s:
            del self._store[key]
            return None
        return value

    def put(self, key: K, value: V) -> None:
        self._store[key] = (value, self._clock())

    def invalidate(self, key: Optional[K] = None) -> None:
        if key is None:
            self._store.clear()
        else:
            self._store.pop(key, None)

    def __len__(self) -> int:
        now = self._clock()
        self._store = {
            k: (v, ts) for k, (v, ts) in self._store.items() if now - ts <= self.ttl_s
        }
        return len(self._store)


class QuotaLogger:
    """At most `quota` messages per loop iteration; the rest are summarized
    (utils/klogx/ NewLoggingQuota pattern)."""

    def __init__(self, quota: int = 50, logger: Optional[logging.Logger] = None):
        self.quota = quota
        self.logger = logger or logging.getLogger("autoscaler_tpu_torch")
        self._used = 0
        self._dropped = 0

    def reset(self) -> None:
        if self._dropped:
            self.logger.info("... and %d more messages (quota %d)", self._dropped, self.quota)
        self._used = 0
        self._dropped = 0

    def log(self, msg: str, *args: Any) -> None:
        if self._used < self.quota:
            self._used += 1
            self.logger.info(msg, *args)
        else:
            self._dropped += 1

    @property
    def dropped(self) -> int:
        return self._dropped
