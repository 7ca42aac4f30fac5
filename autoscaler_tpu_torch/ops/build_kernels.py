"""Builds every kernel library of the port ahead of time.

    python -m autoscaler_tpu_torch.ops.build_kernels [--out DIR]

compiles the native rung's ``csrc/ffd_serial.cpp`` with ``g++`` and then
each CUDA source of ``ops/_build.SIGNATURES`` with ``nvcc`` for ``sm_90a``,
all at once, into DIR (default: the kernels' default directory, see
``ops/_build.py``; the native library goes into its ``native/``). It
needs ``nvcc`` and ``g++`` and no card: an image build runs it so that the
runtime image carries the libraries and no CUDA toolkit, and a process
started with ``--compile-cache-dir=DIR`` compiles nothing. It prints each
library's path and the CUDA ones' ptxas reports (registers, shared memory,
spills), and exits non-zero if any build fails.
"""
from __future__ import annotations

import argparse
import sys
import time

from autoscaler_tpu_torch import native_bridge
from autoscaler_tpu_torch.ops import _build


def build_all() -> dict:
    """Every library into the current ``_build.BUILD_DIR``: the native one
    with ``g++`` unless it is there, then the CUDA sources through
    ``_build.build``. → {name: path}; raises on a failure."""
    native = native_bridge.lib_path()
    if not native.exists():
        native_bridge.build(native)
    return {**_build.build(), "ffd_serial": native}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m autoscaler_tpu_torch.ops.build_kernels",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory of the libraries (default: the kernels' default "
                         "directory)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    with _build.build_dir(args.out or _build.BUILD_DIR) as out:
        try:
            libs = build_all()
        except RuntimeError as e:
            print(f"build_kernels: {e}", file=sys.stderr)
            return 1
        print(f"build_kernels: {len(libs)} libraries in {out}, {_build.COMPILERS_STARTED} "
              f"nvcc started, {time.perf_counter() - t0:.3f} s", flush=True)
        for name, path in libs.items():
            print(f"{name}: {path}")
            for line in _build.BUILD_LOGS.get(name, "").splitlines():
                if line.strip():
                    print(f"  {line.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
