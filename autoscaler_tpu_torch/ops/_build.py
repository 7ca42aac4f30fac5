"""Builds and loads the port's CUDA kernels.

The source ``autoscaler_tpu_torch/csrc/ffd_scan.cu`` has a plain C
interface and is compiled with ``nvcc`` into a shared library, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The build runs
at first use, into ``build/kernels/`` at the root of the checkout (a
directory git ignores), under a name keyed by a hash of the source and the
flags, so a changed source is rebuilt and an unchanged one is reused.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ffd_scan.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# ptxas report (registers, shared memory, spills) of the build
BUILD_LOG: Optional[str] = None

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
# C signatures of the entry points
SIGNATURES = {
    "ffd_scan_f32": [_VOID_P] * 6 + [_INT] * 4 + [_VOID_P],
    "ffd_scan_swar": [_VOID_P] * 7 + [_INT] * 4 + [_VOID_P],
    "ffd_scan_smem_bytes": [_INT, _INT],
}


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


def _lib_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{SOURCE.stem}-{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source into its keyed shared library (if not yet built)
    and return the library's path. The compiler's ptxas report lands in
    BUILD_LOG and beside the library as ``.log``."""
    global BUILD_LOG
    out = _lib_path()
    log = out.with_suffix(".log")
    if out.exists():
        if BUILD_LOG is None and log.exists():
            BUILD_LOG = log.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd: List[str] = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {SOURCE.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, out)
    BUILD_LOG = report
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built on first use, with argtypes and restype
    set for every entry point."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")
