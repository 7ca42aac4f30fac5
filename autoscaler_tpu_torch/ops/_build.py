"""Builds and loads the port's CUDA kernels.

Each source ``autoscaler_tpu_torch/csrc/<name>.cu`` has a plain C
interface and is compiled with ``nvcc`` into a shared library of its own,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds):

- ``ffd_scan``: the plain FFD scans K1 and K2 (``ops/ffd_scan.py``);
- ``ffd_scan_affinity``: the affinity and spread scan K3
  (``ops/ffd_scan_affinity.py``);
- ``fit_reduce``: the tiled predicate fit K4 and its rows entry
  (``ops/fit_reduce.py``).

A source is built at first use, into ``build/kernels/`` at the root of the
checkout (a directory git ignores), under a name keyed by a hash of the
source and the flags, so a changed source is rebuilt and an unchanged one
is reused. ``build(*names)`` starts one ``nvcc`` for each source that is
not built yet, all at once, and waits for them. Nothing here runs at
import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
# C signatures of the entry points, per source
SIGNATURES: Dict[str, Dict[str, list]] = {
    "ffd_scan": {
        "ffd_scan_f32": [_VOID_P] * 6 + [_INT] * 4 + [_VOID_P],
        "ffd_scan_swar": [_VOID_P] * 7 + [_INT] * 4 + [_VOID_P],
        "ffd_scan_smem_bytes": [_INT, _INT],
    },
    "ffd_scan_affinity": {
        "ffd_scan_aff": [_VOID_P] * 10 + [_INT] * 6 + [_VOID_P],
        "ffd_scan_aff_smem_bytes": [_INT] * 4,
    },
    "fit_reduce": {
        "fit_reduce": [_VOID_P] * 8 + [_INT] * 5 + [_VOID_P],
        "fit_reduce_smem_bytes": [_INT] * 3,
        "fit_reduce_rows": [_VOID_P] * 6 + [_INT] * 3 + [_VOID_P],
        "fit_reduce_rows_smem_bytes": [_INT],
        "fit_reduce_geometry": [_INT] * 6 + [_VOID_P],
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each source's build
BUILD_LOGS: Dict[str, str] = {}


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    key = hashlib.sha256(source(name).read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile the named sources (all of them when none is named) into
    their keyed shared libraries, those not built yet all at once, and
    return each library's path. Each compiler's ptxas report lands in
    BUILD_LOGS and beside its library as ``.log``."""
    names = names or tuple(SIGNATURES)
    out = {name: _lib_path(name) for name in names}
    running = []
    for name, lib in out.items():
        log = lib.with_suffix(".log")
        if lib.exists():
            if name not in BUILD_LOGS and log.exists():
                BUILD_LOGS[name] = log.read_text()
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd: List[str] = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        running.append((name, lib, tmp, proc))
    failures = []
    for name, lib, tmp, proc in running:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        report = stdout + stderr
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{report}")
            continue
        lib.with_suffix(".log").write_text(report)
        os.replace(tmp, lib)
        BUILD_LOGS[name] = report
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The named source's loaded library, built on first use, with argtypes
    and restype set for every entry point."""
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(build(name)[name]))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")
