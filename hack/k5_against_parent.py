"""Times K5's public call, ``ordered_scatter_add``, of the port in one
checkout on captured warm-start batches and on the one-cell world of the
largest, with ``autoscaler_tpu_torch/tools/k5_bench.call_times``: run it on
two checkouts in one call on one card to compare two versions of K5.

    python3 autoscaler_tpu_torch/tools/k5_bench.py capture build/k5_batches.pt
    python3 hack/k5_against_parent.py build/k5_batches.pt --tree build/parent

``--tree`` is the checkout whose ``autoscaler_tpu_torch`` is timed (this
one by default); the timer is always this checkout's. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batches", type=Path)
    p.add_argument("--tree", type=Path, default=HERE)
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_against_parent: no CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "k5_bench", HERE / "autoscaler_tpu_torch" / "tools" / "k5_bench.py")
    k5_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k5_bench)
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    from autoscaler_tpu_torch.ops.histogram import ordered_scatter_add

    dev = torch.device("cuda", 0)
    calls = [tuple(t.to(dev) for t in call) for call in torch.load(args.batches)]
    print(json.dumps({"tree": str(tree), "device": k5_bench.nvidia_smi("name,power.limit"),
                      **k5_bench.call_times(ordered_scatter_add, calls, args.reps)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
