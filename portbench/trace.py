"""The traced run: a ``torch.profiler`` session over the window, reduced in
memory to what the per-layer readers take. No trace file is written.

The benchmark marks its own calls with ranges (``RANGES``): the window,
each request, and in a request the upload, the estimate and the fetch.
A device activity (kernel, copy or set) belongs to the request whose range
it starts in: the loop is closed, so a request's device work ends before
its answer is on the host. ``busy_s`` is the union of the device
activities inside the window; an idle gap is charged to the innermost
host range or op running on the benchmark's thread at the gap's middle.
"""
from __future__ import annotations

import bisect
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional

WINDOW = "portbench.window"
REQUEST = "portbench.request"
RANGES = (WINDOW, REQUEST, "portbench.upload", "portbench.estimate", "portbench.fetch")
TOP = 10  # entries of each breakdown list


class Ev(NamedTuple):
    name: str
    start_us: float
    end_us: float
    device: bool       # ran on the card (kernel, copy, set)
    thread: int


def session():
    """A profiler session of the host and the card; nothing kept but the
    events in memory."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def annotate(name: str, on: bool):
    if not on:
        return nullcontext()
    import torch

    return torch.profiler.record_function(name)


def events(prof) -> List[Ev]:
    """The session's events; ranges as the card sees them (user
    annotations on the device) are left out, since they only restate the
    host's ranges."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        on_device = e.device_type == cuda
        if on_device and (getattr(e, "is_user_annotation", False)
                          or e.name in RANGES
                          or getattr(e, "activity_type", None) == "gpu_user_annotation"):
            continue
        out.append(Ev(e.name, e.time_range.start, e.time_range.end, on_device, e.thread))
    return out


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    requests: List[Dict[str, float]]   # per request: device seconds by activity name
    device_ops: List[list]             # [name, seconds], most time first
    idle_gaps: List[list]              # [host activity, seconds], most time first


def _union(intervals) -> List[list]:
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _charge_gaps(gaps, host: List[Ev]) -> Dict[str, float]:
    """Each gap [start, end] (µs) to the innermost host event covering its
    middle: one sweep over the host events in start order, keeping the
    open ones as a stack (the events of one thread nest)."""
    points = sorted(((s + e) / 2, e - s) for s, e in gaps)
    evs = sorted(host, key=lambda ev: (ev.start_us, -ev.end_us))
    out: Dict[str, float] = {}
    stack: List[Ev] = []
    i = 0
    for mid, length in points:
        while i < len(evs) and evs[i].start_us <= mid:
            while stack and stack[-1].end_us <= evs[i].start_us:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1].end_us < mid:
            stack.pop()
        name = stack[-1].name if stack else "(no host activity)"
        out[name] = out.get(name, 0.0) + length / 1e6
    return out


def summarize(evs: List[Ev]) -> Optional[Summary]:
    """None where the session holds no window or no device activity."""
    windows = [e for e in evs if not e.device and e.name == WINDOW]
    if not windows:
        return None
    win = windows[0]
    lo, hi = win.start_us, win.end_us
    dev = [e for e in evs if e.device and e.end_us > lo and e.start_us < hi]
    if not dev:
        return None
    busy = _union((max(e.start_us, lo), min(e.end_us, hi)) for e in dev)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    host = [e for e in evs if not e.device and e.thread == win.thread
            and e.end_us > lo and e.start_us < hi and e.name != WINDOW]

    starts = sorted(e.start_us for e in host if e.name == REQUEST)
    requests: List[Dict[str, float]] = [{} for _ in starts]
    totals: Dict[str, float] = {}
    for e in dev:
        seconds = (min(e.end_us, hi) - max(e.start_us, lo)) / 1e6
        totals[e.name] = totals.get(e.name, 0.0) + seconds
        k = bisect.bisect_right(starts, e.start_us) - 1
        if k >= 0:
            requests[k][e.name] = requests[k].get(e.name, 0.0) + seconds
    charged = _charge_gaps(gaps, host)
    return Summary(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6,
        requests=requests,
        device_ops=sorted(([n, s] for n, s in totals.items()), key=lambda x: -x[1])[:TOP],
        idle_gaps=sorted(([n, s] for n, s in charged.items()), key=lambda x: -x[1])[:TOP],
    )


def seconds_of(request: Dict[str, float], *fragments: str) -> float:
    """A request's device seconds in activities whose name holds every
    fragment."""
    return sum(s for n, s in request.items() if all(f in n for f in fragments))


def kernel_ms(summary: Optional[Summary], *fragments: str) -> Optional[float]:
    """The kernel's mean device time a request in ms, over the requests
    that launched it; None where none did."""
    if summary is None:
        return None
    times = [t for t in (seconds_of(r, *fragments) for r in summary.requests) if t > 0]
    return 1e3 * sum(times) / len(times) if times else None
