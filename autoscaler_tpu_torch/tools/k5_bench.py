"""K5 (the VPA bank's ordered scatter-add) timed on the card on the warm
start's four sample batches: chip_smoke's 4t numbers.

    python3 autoscaler_tpu_torch/tools/k5_bench.py capture build/k5_batches.pt
    python3 autoscaler_tpu_torch/tools/k5_bench.py capture build/k5_20k.pt --history-pods 20000
    python3 autoscaler_tpu_torch/tools/k5_bench.py time build/k5_batches.pt

``capture`` runs ``tools/vpa_probe``'s warm start at a tenth (``TENTH``:
10 000 pods, 192 hourly CPU samples and memory peaks each), or with
``--history-pods`` pods of history (the world's pods and nodes scaled with
them), on the CPU and saves every call of K5's wrapper: (target before,
index, values, target after), the CPU bank's weights and total, then the
memory bank's. ``time`` prints one JSON line: the card's name and power
limit; a feed's card time, the four targets updated as
``HistogramBank.add_samples`` updates them; on the largest batch the whole
call, its grouping (count, scan, place and the scratch's memset) and its
chains (the warp and block chain kernels) from torch.profiler's kernel
times, and ``index_add_`` (the library call, in no fixed order); each
batch's longest run of one cell (Lmax); the whole call and the bound
(bytes, adds, the longest chain's dependent adds) on the largest batch, on
the batch with the longest run and on the one-cell world (every pair of
the largest batch sent to one cell); and whether the card's feed gave the
captured bits. Every time is the mean of ``--reps`` calls between CUDA
events, queued behind ~10 ms of ``torch.cuda._sleep`` so that the events
time the card and not the host's launches.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HOST_LEAD_CYCLES = 20_000_000
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
ADD_CYCLES = 4            # the latency of one dependent f32 add
# K5's kernels by the part of the call they do (csrc/histogram.cu)
GROUPING = ("count_kernel", "scan_kernel", "place_kernel", "Memset")
CHAINS = ("warp_chain_kernel", "block_chain_kernel")


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``reps`` calls of ``fn``, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_LEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled_ms(fn, reps: int, parts: dict) -> dict:
    """Device ms a call of ``fn`` spends in each of ``parts`` ({name: kernel
    name fragments}), from the device events torch.profiler records over
    ``reps`` calls; "not measured" where it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(parts, 0.0)
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        for part, names in parts.items():
            if any(name in event.name for name in names):
                us[part] += event.time_range.elapsed_us()
    return {part: (t / reps / 1e3 if t > 0 else "not measured") for part, t in us.items()}


def nvidia_smi(query: str) -> str:
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def sm_clock_hz() -> float:
    """The card's highest SM clock as nvidia-smi reports it: the bound's
    chain runs at the fastest clock the card can take."""
    text = nvidia_smi("clocks.max.sm").split("\n")[0].split()
    return float(text[0]) * 1e6 if text and text[0].isdigit() else float("nan")


def lmax(index: torch.Tensor, n: int) -> int:
    """The longest run of one cell among the in-range pairs."""
    keep = index[(index >= 0) & (index < n)].long()
    return int(torch.bincount(keep, minlength=1).max()) if keep.numel() else 0


def bound(K: int, cells: int, longest: int, clock_hz: float) -> dict:
    """The least time the card could take: each index and value read once,
    each touched cell read and written once, over the memory rate; one add
    a pair over the f32 rate; the longest chain's dependent adds at the SM
    clock. → each term and the largest, in ms."""
    terms = {"bytes": (8 * K + 8 * cells) / HBM_BYTES_PER_S * 1e3,
             "operations": K / FP32_OPS_PER_S * 1e3,
             "chain": longest * ADD_CYCLES / clock_hz * 1e3}
    by = max(terms, key=terms.get)
    return {**{f"{k}_ms": v for k, v in terms.items()}, "bound_ms": terms[by], "bound_by": by}


def one_cell(values: torch.Tensor):
    """The one-cell world: every pair of a batch sent to cell 1 of three →
    (target, index, values) on the batch's device."""
    target = torch.zeros(3, dtype=torch.float32, device=values.device)
    return target, torch.ones(values.numel(), dtype=torch.int32, device=values.device), values


def call_times(scatter_add, calls, reps: int) -> dict:
    """The whole call of ``scatter_add(target, index, values)`` (the public
    entry, whatever the version) on each captured batch and on the one-cell
    world of the largest, with each one's pairs, touched cells, Lmax and
    bound → {"batches": [...], "one_cell": {...}}."""
    clock = sm_clock_hz()

    def timed(target, index, values):
        cells = int(torch.unique(index[(index >= 0) & (index < target.numel())]).numel())
        scratch = target.clone()
        longest = lmax(index, target.numel())
        return {"pairs": index.numel(), "cells": cells, "lmax": longest,
                "call_ms": event_ms(lambda: scatter_add(scratch, index, values), reps),
                **bound(index.numel(), cells, longest, clock)}

    largest = max(calls, key=lambda c: c[1].numel())
    return {"batches": [timed(before, index, values) for before, index, values, _ in calls],
            "one_cell": timed(*one_cell(largest[2]))}


def measure(batches, reps: int = 20) -> dict:
    """K5's numbers on the card (see the module docstring); ``batches`` as
    ``capture`` saves them."""
    from autoscaler_tpu_torch.ops.histogram import ordered_scatter_add

    dev = torch.device("cuda", 0)
    calls = [tuple(t.to(dev) for t in call) for call in batches]

    def feed(targets):
        for target, (_, index, values, _) in zip(targets, calls):
            ordered_scatter_add(target, index, values)

    fresh = [before.clone() for before, _, _, _ in calls]
    feed(fresh)
    torch.cuda.synchronize()
    equal = all(torch.equal(got.view(torch.int32), after.view(torch.int32))
                for got, (_, _, _, after) in zip(fresh, calls))
    out = {"equal": equal, "feed_ms": event_ms(lambda: feed(fresh), reps),
           **call_times(ordered_scatter_add, calls, reps)}
    out["lmax"] = [b["lmax"] for b in out["batches"]]
    out["largest"] = max(out["batches"], key=lambda b: b["pairs"])
    out["longest"] = max(out["batches"], key=lambda b: b["lmax"])
    out["call_ms"] = out["largest"]["call_ms"]
    before, index, values, _ = max(calls, key=lambda c: c[1].numel())
    scratch = before.clone()
    parts = profiled_ms(lambda: ordered_scatter_add(scratch, index, values), reps,
                        {"group_ms": GROUPING, "chain_ms": CHAINS})
    out.update(parts)
    index_long = index.long()
    out["index_add_ms"] = event_ms(lambda: scratch.index_add_(0, index_long, values), reps)
    return out


def capture(path: Path, history_pods: int | None) -> None:
    from autoscaler_tpu_torch.tools import vpa_probe

    world = dict(vpa_probe.TENTH)
    if history_pods:
        scale = history_pods / world["P"]
        world.update(N=round(world["N"] * scale), P=history_pods,
                     port_nodes=round(world["port_nodes"] * scale), history_pods=history_pods)
    calls = []
    vpa_probe.run_vpa(vpa_probe.vpa_world(**world), "cpu", passes=0, capture=calls)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(calls, path)
    print(json.dumps({"captured": [c[1].numel() for c in calls], "path": str(path)}))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("command", choices=["capture", "time"])
    p.add_argument("batches", type=Path)
    p.add_argument("--history-pods", type=int, default=None,
                   help="capture: pods of history (default: vpa_probe.TENTH's)")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    if args.command == "capture":
        capture(args.batches, args.history_pods)
        return 0
    if not torch.cuda.is_available():
        print("k5_bench: no CUDA card", file=sys.stderr)
        return 1
    result = measure(torch.load(args.batches), args.reps)
    print(json.dumps({"device": nvidia_smi("name,power.limit"),
                      "torch_device": torch.cuda.get_device_name(0), **result}))
    return 0 if result["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
