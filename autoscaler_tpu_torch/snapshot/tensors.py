"""Shape bucketing for the estimator's packed operands (the port's copy of
``bucket_size`` from ``autoscaler_tpu/snapshot/tensors.py``).
``SnapshotTensors`` itself arrives with the packer (ROADMAP queue 1,
item 1)."""
from __future__ import annotations


def bucket_size(n: int, minimum: int = 8) -> int:
    """Round n up to the next power of two (>= minimum) so operand shapes
    come from a small set."""
    size = minimum
    while size < n:
        size *= 2
    return size
