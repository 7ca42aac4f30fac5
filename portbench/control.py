"""The two readings a limit of ``check`` is set from, at a cell's own size,
on the card, several seeds in one process:

- lower: the program's answer on each seed's first world (the timed
  path's calls, as a run makes them) against the float32 reference;
- upper: the control, the reference put in the program's place and
  computed in bfloat16 (the precision below the configuration's float32),
  against the same float32 reference.

    python3 -m portbench.control --workload burst.k2 --seeds 1,2,3

One JSON line a seed. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check
from portbench.spec import ROOT, Spec
from portbench.worlds import build_pool

DEVICE = "cuda:0"
CONTROL = torch.bfloat16  # the precision below the configurations' float32


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    entry, reference = spec.entry(config["estimate"]), spec.reference(config["estimate"])
    for seed in (int(s) for s in args.seeds.split(",")):
        world = build_pool(config, dict(traffic, pool=1), seed, DEVICE)[0]
        t = time.monotonic()
        answer = entry.fetch(entry.estimate(entry.upload(world, DEVICE), world))
        t_program = time.monotonic() - t
        t = time.monotonic()
        ref = reference.solve(world, DEVICE)
        t_ref = time.monotonic() - t
        control = reference.solve(world, DEVICE, CONTROL)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "world": world.name,
            "program": check.compare([(answer, ref)]),
            "control": check.compare([((control.node_count, control.scheduled), ref)]),
            "fit_tests": ref.fit_tests,
            "node_counts": [int(ref.node_count.min()), int(ref.node_count.max())],
            "placed_share": float(ref.scheduled.mean()),
            "program_s": t_program, "reference_s": t_ref,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
