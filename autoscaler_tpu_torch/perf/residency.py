"""Device-buffer residency accounting by pool.

Pools are coarse ownership classes, not allocations: ``snapshot`` (the
incremental packer's persistent device tensors), ``kernel_operands`` (the
arrays of the in-flight estimator dispatch), ``scenario_batches`` (the rpc
sidecar's what-if batch tensors). Each (pool, owner key) holds the CURRENT
byte count of one owner; the pool gauge is the sum over its owners.

Byte counts are pure functions of world shapes (array nbytes), so the
residency figures stamped into perf tick records replay byte-identically —
the same determinism contract as the rest of ``autoscaler_tpu_torch/perf``.

The port's copy of ``autoscaler_tpu/perf/residency.py``.
``torch.Tensor.nbytes`` and ``numpy.ndarray.nbytes`` both count, so the
one model covers the packer's tensors, the arena's generations and the
operand cache alike. No pool reads ``torch.cuda`` memory statistics: those
would differ between two replays.
"""
from __future__ import annotations

import threading
from typing import Any, Dict

POOL_SNAPSHOT = "snapshot"
POOL_KERNEL_OPERANDS = "kernel_operands"
POOL_SCENARIO_BATCHES = "scenario_batches"
# the resident device arena (snapshot/arena.py): BOTH double-buffer
# generations plus the factored-mask aux pool, and the estimator's
# content-addressed operand cache
POOL_ARENA = "arena"


class ResidencyLedger:
    """Thread-safe live device-buffer accounting by pool. The control loop
    writes while ``/metrics``/``/perfz`` HTTP threads read — every mutation
    happens under the instance lock."""

    def __init__(self, metrics: Any = None):
        self._lock = threading.Lock()
        self.metrics = metrics
        self._pools: Dict[str, Dict[str, int]] = {}

    def set(self, pool: str, key: str, nbytes: int) -> None:
        """Seat (or resize) one owner's live bytes in a pool."""
        with self._lock:
            self._pools.setdefault(pool, {})[key] = int(nbytes)
            self._feed_locked(pool)

    def drop(self, pool: str, key: str) -> None:
        """Release one owner's bytes (freed device buffers). A pool with no
        remaining owners is removed outright so idle ticks record no entry
        for it (rather than a stale ``0``)."""
        with self._lock:
            owners = self._pools.get(pool, {})
            owners.pop(key, None)
            if not owners:
                self._pools.pop(pool, None)
            self._feed_locked(pool)

    def _feed_locked(self, pool: str) -> None:
        if self.metrics is not None:
            self.metrics.device_resident_bytes.set(
                float(sum(self._pools.get(pool, {}).values())), pool=pool
            )

    def pool_bytes(self, pool: str) -> int:
        with self._lock:
            return sum(self._pools.get(pool, {}).values())

    def snapshot(self) -> Dict[str, int]:
        """{pool: total bytes}, key-sorted — ledger-stable."""
        with self._lock:
            return {
                pool: sum(owners.values())
                for pool, owners in sorted(self._pools.items())
            }


def array_bytes(obj: Any) -> int:
    """Total ``nbytes`` over the array leaves of a (possibly nested)
    value — the one byte model every pool shares."""
    if isinstance(obj, (tuple, list)):
        return sum(array_bytes(item) for item in obj)
    if isinstance(obj, dict):
        return sum(array_bytes(item) for item in obj.values())
    return int(getattr(obj, "nbytes", 0) or 0)
