"""How long the answers' copy to the host takes, as the timed path makes it
(``.cpu()`` into fresh pageable memory) and into a reused pinned buffer,
on one cell's worlds, on the card:

    python3 -m portbench.fetch_diag --workload burst.k2 --seed 5 --requests 100

Each request runs the cell's upload and estimate, waits for the card, then
copies the answers both ways in turn, each copy timed on the host's clock
from its start until the answer is on the host. It prints one JSON line:
the 5th, 50th and 95th percentiles of each in ms, and of the whole
request as the timed path makes it. The benchmark's own runs never run
this; it shows where a request's fetch goes, not what a run measures.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench.spec import ROOT, Spec
from portbench.worlds import build_pool

DEVICE = "cuda:0"


def _ms(values) -> dict:
    p5, p50, p95 = np.percentile(np.asarray(values) * 1e3, [5, 50, 95])
    return {"p5": float(p5), "p50": float(p50), "p95": float(p95)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--requests", type=int, default=100)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("fetch_diag: needs a CUDA card", file=sys.stderr)
        return 3
    from autoscaler_tpu_torch.ops import _build

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    entry = spec.entry(config["estimate"])
    with _build.build_dir(ROOT / "build" / "kernels"):
        _build.preload(*entry.LIBRARIES)
        pool = build_pool(config, traffic, args.seed, DEVICE)
        G, P = pool[0].masks.shape
        counts_buf = torch.empty(G, dtype=torch.int32, pin_memory=True)
        verdicts_buf = torch.empty((G, P), dtype=torch.bool, pin_memory=True)
        request, pageable, pinned = [], [], []
        for i in range(args.requests + 2):
            world = pool[i % len(pool)]
            t = time.perf_counter()
            entry.fetch(entry.estimate(entry.upload(world, DEVICE), world))
            whole = time.perf_counter() - t
            result = entry.estimate(entry.upload(world, DEVICE), world)
            torch.cuda.synchronize()
            t = time.perf_counter()
            a = entry.fetch(result)
            t_pageable = time.perf_counter() - t
            t = time.perf_counter()
            counts_buf.copy_(result.node_count, non_blocking=True)
            verdicts_buf.copy_(result.scheduled, non_blocking=True)
            torch.cuda.current_stream().synchronize()
            b = counts_buf.numpy(), verdicts_buf.numpy()
            t_pinned = time.perf_counter() - t
            if not all((x == y).all() for x, y in zip(a, b)):
                print("fetch_diag: the two copies differ", file=sys.stderr)
                return 1
            if i >= 2:  # the first two warm up
                request.append(whole)
                pageable.append(t_pageable)
                pinned.append(t_pinned)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "requests": args.requests,
                      "answer_bytes": G * 4 + G * P, "request_ms": _ms(request),
                      "fetch_pageable_ms": _ms(pageable), "fetch_pinned_ms": _ms(pinned),
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
