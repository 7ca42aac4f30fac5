"""One run of one cell: set-up, the measured window, then the check.

Set-up builds the cell's pool of worlds from the seed, loads the entry's
kernel libraries (built on the first run in a checkout, into its
``build/kernels/``), and sends the traffic's warm requests, so that the
window compiles and loads nothing. A traced run also opens and closes one
profiler session in set-up: a process's first session pays the profiler's
own start.

After the window: the memory peak is read, the program's answers are
freed but for the sample, and the plain reference solves the sampled
requests' worlds. Nothing of the check is timed.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Callable, Optional

import numpy as np
import torch

from portbench import check, trace
from portbench.loop import Client, closed_loop
from portbench.spec import Spec
from portbench.worlds import build_pool


def _launches(entry) -> dict:
    return {name: n for counter in entry.COUNTERS for name, n in counter.items()}


def run_cell(spec: Spec, workload: str, seed: int, seconds: float, traced: bool,
             device, t0: float, log: Callable[[str], None] = print) -> dict:
    """The result line's object, keys in the order the line prints them,
    the numbers compared last. ``t0`` is the process's start on
    ``time.monotonic``'s clock."""
    cell = spec.cell(workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("the generator drives one client in a closed loop")
    entry = spec.entry(config["estimate"])
    reference = spec.reference(config["estimate"])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from autoscaler_tpu_torch.ops import _build

        _build.preload(*entry.LIBRARIES)

    pool = build_pool(config, traffic, seed, device)
    client = Client(entry, device, traced)
    for i in range(traffic["warm_requests"]):
        client.send(pool[i % len(pool)])
    if traced:
        with trace.session():
            client.send(pool[0])
    client.events.clear()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    log(f"portbench: {workload} seed {seed}: set-up {setup_s:.3f} s, pool of {len(pool)}")

    before = _launches(entry)
    rng = np.random.default_rng([seed % 2**64, 1])
    with trace.session() if traced else nullcontext() as prof:
        with trace.annotate(trace.WINDOW, traced):
            window = closed_loop(client.send, pool, seconds, traffic["check_requests"], rng)
    launches = {n: c - before[n] for n, c in _launches(entry).items()}
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    transfer = client.transfer_ms()
    summary: Optional[trace.Summary] = trace.summarize(trace.events(prof)) if traced else None
    del client, prof
    if on_card:
        torch.cuda.empty_cache()

    refs = {}
    for _, w, _ in window.sample:
        if w not in refs:
            t = time.monotonic()
            refs[w] = reference.solve(pool[w], device)
            log(f"portbench: reference on {pool[w].name}: {time.monotonic() - t:.3f} s")
    numbers = check.compare((answer, refs[w]) for _, w, answer in window.sample)
    log(f"portbench: {len(window.sample)} answers checked: {numbers['groups_off']} node counts "
        f"and {numbers['verdicts_off']} verdicts off")
    correct = bool(window.sample) and window.failed == 0 and check.passes(numbers)

    ctx = {
        "setup_s": setup_s, "window": window, "pool": pool, "trace": summary,
        "transfer_ms": transfer, "request_worlds": window.worlds,
        "counted": {w: ref.fit_tests for w, ref in refs.items()},
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
    }
    wanted = spec.per_layer(workload) if traced else spec.end_to_end()
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": ctx["kind"],
           "count": cell["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(window.worlds), "failed": window.failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in summary.device_ops],
            "idle_gaps": [[n[:160], s] for n, s in summary.idle_gaps],
        }
    result["launches"] = launches
    result["checked"] = check.judged(numbers)
    return result
