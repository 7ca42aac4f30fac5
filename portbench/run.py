"""Run one cell of ``BENCHMARK.json`` once, on the card, from the root of a
checkout:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It prints its log and, as the last lines of standard error, each number
compared with its limit; the last line of standard output is the result's
JSON object. With ``--trace 0`` its metrics are the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, read from a profiler
session over the window.

It exits non-zero and prints no result when no CUDA card is present (or
fewer than the cell asks for), when the port is not beside it in the
checkout, or when JAX or the JAX package is loaded once the window has
closed. Every build and kernel cache stays inside the checkout, at fixed
paths under ``build/``.
"""
import time

T0 = time.monotonic()  # the process's start, as near as Python reaches it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that may not be loaded, compared whole: the port's
# own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "autoscaler_tpu")


def forbidden(modules) -> list:
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN))


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cache = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)

    import torch

    from portbench.spec import Spec

    spec = Spec(ROOT)
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"portbench: {args.workload} needs {chips} CUDA card(s); "
             f"this host has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    import autoscaler_tpu_torch
    from autoscaler_tpu_torch.ops import _build

    if Path(autoscaler_tpu_torch.__file__).resolve().parent.parent != ROOT:
        _log(f"portbench: the port is not in this checkout ({autoscaler_tpu_torch.__file__})")
        return 3

    from portbench.bench import run_cell

    with _build.build_dir(ROOT / "build" / "kernels"):
        result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", T0, _log)
    found = forbidden(sys.modules)
    if found:
        _log(f"portbench: loaded after the window: {', '.join(found)}")
        return 4
    for name, c in result["checked"].items():
        _log(f"checked {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
