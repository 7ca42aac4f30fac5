"""The table of peaks, and a scan kernel's share of its roofline.

A kernel's least time on one request is the larger of two terms against
the card's published peaks:

- bytes: each operand of the estimate read once and each answer written
  once (``World.operand_bytes`` and ``World.answer_bytes``: the request as
  the caller packs it, whatever layout the glue builds from it);
- operations: the fit tests that first-fit decreasing needs on these
  inputs by its own definition, counted by the plain reference from its
  placements (``fit_tests``): a pod in a group is compared with each open
  node up to the one it takes, or with every open node when it fits none
  (then a new node is opened, or it is left out); each test counts once
  for every resource axis that some pod requests, one compare an axis.
  Masked pods are tested
  nowhere. The count never reads the kernel's own counts, so it is the
  same whatever implements the scan.

The share is the least time summed over the requests whose worlds the
reference counted, divided by the kernel's device time on those requests.
"""
from __future__ import annotations

from typing import Optional

# NVIDIA H100 SXM at its 700 W limit: HBM3 bandwidth from the data sheet;
# the fit test's operation is a 32-bit compare, which the card issues at 64
# a clock on each of its 132 SMs (the CUDA C++ Programming Guide's
# arithmetic-instruction throughput table, compute capability 9.0) at the
# 1 980 MHz maximum SM clock: 16.7 T compares a second.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "ops_per_s": 132 * 64 * 1.98e9},
}


def least_s(kind: str, ops: float, nbytes: float) -> Optional[float]:
    """The least time on the card named ``kind``; None off the table."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(ops / peak["ops_per_s"], nbytes / peak["bytes_per_s"])


def kernel_share(ctx: dict, *fragments: str) -> Optional[float]:
    """The kernel's share of its roofline in %, over the requests on worlds
    that the reference counted; None where the trace holds no such kernel
    or the card has no peaks."""
    from portbench.trace import seconds_of

    summary = ctx["trace"]
    if summary is None:
        return None
    least = took = 0.0
    for request, w in zip(summary.requests, ctx["request_worlds"]):
        kernel = seconds_of(request, *fragments)
        counted = ctx["counted"].get(w)
        if kernel <= 0 or counted is None:
            continue
        world = ctx["pool"][w]
        t = least_s(ctx["kind"], counted, world.operand_bytes() + world.answer_bytes())
        if t is None:
            return None
        least += t
        took += kernel
    return 100.0 * least / took if took > 0 else None

