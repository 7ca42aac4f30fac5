"""Device-buffer residency accounting: the byte model only.

The port's copy of ``array_bytes`` from ``autoscaler_tpu/perf/residency.py``
(the ``ResidencyLedger`` pools are not ported). ``torch.Tensor.nbytes``
and ``numpy.ndarray.nbytes`` both count, so the one model covers the
packer's tensors, the arena's generations and the operand cache alike.
"""
from __future__ import annotations

from typing import Any


def array_bytes(obj: Any) -> int:
    """Total ``nbytes`` over the array leaves of a (possibly nested)
    value — the one byte model every pool shares."""
    if isinstance(obj, (tuple, list)):
        return sum(array_bytes(item) for item in obj)
    if isinstance(obj, dict):
        return sum(array_bytes(item) for item in obj.values())
    return int(getattr(obj, "nbytes", 0) or 0)
