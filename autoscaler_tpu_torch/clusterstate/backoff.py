"""Per-node-group exponential backoff after failed scale-ups.

Reference: cluster-autoscaler/utils/backoff/backoff.go (interface) and
exponential_backoff.go:28,69 (initial 5m, max 30m, doubling, reset after
3h idle).

The port's copy of ``autoscaler_tpu/clusterstate/backoff.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class _Entry:
    until_ts: float = 0.0
    duration_s: float = 0.0
    last_failure_ts: float = 0.0


@dataclass
class ExponentialBackoff:
    initial_s: float = 300.0       # 5m  (--initial-node-group-backoff-duration)
    max_s: float = 1800.0          # 30m (--max-node-group-backoff-duration)
    reset_timeout_s: float = 10800.0  # 3h (--node-group-backoff-reset-timeout)
    _entries: Dict[str, _Entry] = field(default_factory=dict)

    def backoff(self, group_id: str, now_ts: float) -> float:
        """Record a failure; returns the timestamp the group is backed off
        until (reference exponential_backoff.go:69 Backoff)."""
        e = self._entries.get(group_id)
        if e is None or now_ts - e.last_failure_ts > self.reset_timeout_s:
            duration = self.initial_s
        else:
            duration = min(e.duration_s * 2, self.max_s) if e.duration_s else self.initial_s
        self._entries[group_id] = _Entry(
            until_ts=now_ts + duration, duration_s=duration, last_failure_ts=now_ts
        )
        return now_ts + duration

    def is_backed_off(self, group_id: str, now_ts: float) -> bool:
        e = self._entries.get(group_id)
        return e is not None and now_ts < e.until_ts

    def remove_backoff(self, group_id: str) -> None:
        self._entries.pop(group_id, None)

    def remove_stale(self, now_ts: float) -> None:
        """Drop entries that are both idle past the reset timeout AND no
        longer backing anything off. The second condition matters when an
        operator configures reset_timeout below the backoff duration:
        an entry can be 'stale' by idle time while its until_ts is still in
        the future, and deleting it would lift an active backoff early."""
        stale = [
            g
            for g, e in self._entries.items()
            if now_ts - e.last_failure_ts > self.reset_timeout_s
            and now_ts >= e.until_ts
        ]
        for g in stale:
            del self._entries[g]
