"""UsageTracker: cross-loop memory of simulated pod moves between nodes.

Reference: cluster-autoscaler/simulator/tracker.go — UsageTracker :38 records,
per drain simulation, which destination nodes received pods from which
removal candidate (RegisterUsage), and on actual deletion of a candidate
reports the destinations so their "unneeded since" timers reset (their
utilization is about to rise when the evicted pods really land there);
stale records expire via CleanUp.

The port's copy of ``autoscaler_tpu/simulator/tracker.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set


@dataclass
class UsageRecord:
    """Per-node view of the simulated-move graph (reference tracker.go:25)."""

    # nodes this node's simulated pods were placed onto → last sim timestamp
    using: Dict[str, float] = field(default_factory=dict)
    # nodes whose simulated pods landed on this node → last sim timestamp
    used_by: Dict[str, float] = field(default_factory=dict)


class UsageTracker:
    def __init__(self) -> None:
        self._records: Dict[str, UsageRecord] = {}

    def _record(self, name: str) -> UsageRecord:
        rec = self._records.get(name)
        if rec is None:
            rec = self._records[name] = UsageRecord()
        return rec

    def register_usage(self, using: str, used: str, now_ts: float) -> None:
        """Candidate `using`'s simulated pods were placed on node `used`
        (reference tracker.go:51)."""
        self._record(using).using[used] = now_ts
        self._record(used).used_by[using] = now_ts

    def get(self, name: str) -> UsageRecord:
        return self._records.get(name, UsageRecord())

    def remove_node(self, name: str) -> List[str]:
        """Node `name` was actually deleted: drop its records and return the
        destinations its simulation used — callers reset those nodes'
        unneeded-since timers (reference tracker.go:67 Unmark semantics)."""
        rec = self._records.pop(name, None)
        if rec is None:
            return []
        destinations: Set[str] = set(rec.using)
        for other in rec.using:
            other_rec = self._records.get(other)
            if other_rec:
                other_rec.used_by.pop(name, None)
        for other in rec.used_by:
            other_rec = self._records.get(other)
            if other_rec:
                other_rec.using.pop(name, None)
        return sorted(destinations)

    def cleanup(self, cutoff_ts: float) -> None:
        """Expire entries last touched before cutoff (reference tracker.go:89)."""
        empty = []
        for name, rec in self._records.items():
            rec.using = {k: t for k, t in rec.using.items() if t >= cutoff_ts}
            rec.used_by = {k: t for k, t in rec.used_by.items() if t >= cutoff_ts}
            if not rec.using and not rec.used_by:
                empty.append(name)
        for name in empty:
            del self._records[name]
