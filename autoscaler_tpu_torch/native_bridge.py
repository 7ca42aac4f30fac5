"""ctypes bridge to the port's native serial FFD (csrc/ffd_serial.cpp): the
estimator's native rung.

The port of ``autoscaler_tpu/native_bridge.py``, with one change: the
library is built at first use with
``g++ -O3 -shared -fPIC -ffp-contract=off -std=c++17`` into the
``native/`` subdirectory of the kernels' directory (``ops/_build.py``:
``build/kernels/native/`` in a checkout, the installed default or
``--compile-cache-dir`` otherwise; ``ops/build_kernels`` prebuilds it
there), under a name keyed by a hash of the source and the flags, as
``ops/_build.py`` keys the CUDA kernels. It is never built beside its
source, and nothing is built at import. When there is no ``g++`` or the
build fails, ``available()`` is false and ``build_error()`` says why.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from autoscaler_tpu_torch.ops import _build

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "ffd_serial.cpp"
# IEEE per-op rounding: the FFD score spec must be bit-identical to numpy
# and the kernels (no FMA contraction)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def lib_path() -> Path:
    """The keyed library in ``native/`` of ``_build.BUILD_DIR``, read now."""
    key = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return _build.BUILD_DIR / "native" / f"libffd_serial-{key.hexdigest()[:16]}.so"


def build(lib: Path) -> None:
    """Compile the library into ``lib`` (the prebuild calls this too)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native rung cannot be built")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed on {SRC.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)


def _ensure_built() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib_file = lib_path()
            if not lib_file.exists():
                build(lib_file)
            lib = ctypes.CDLL(str(lib_file))
            lib.ffd_binpack_serial.restype = ctypes.c_int32
            lib.ffd_binpack_serial.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.ffd_binpack_serial_affinity.restype = ctypes.c_int32
            lib.ffd_binpack_serial_affinity.argtypes = [
                ctypes.POINTER(ctypes.c_float), u8p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                u8p, u8p, u8p, u8p, u8p, u8p,
            ]
            lib.first_fit_serial.restype = None
            lib.first_fit_serial.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
        except Exception as e:  # compiler missing / build failure
            _build_error = str(e)
    return _lib


def available() -> bool:
    return _ensure_built() is not None


def build_error() -> Optional[str]:
    _ensure_built()
    return _build_error


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _require() -> ctypes.CDLL:
    lib = _ensure_built()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    return lib


def ffd_binpack_native(
    pod_req: np.ndarray,        # [P, R] f32
    pod_mask: np.ndarray,       # [P] bool
    template_alloc: np.ndarray,  # [R] f32
    max_nodes: int,
    cpu_axis: int = 0,
    mem_axis: int = 1,
) -> Tuple[int, np.ndarray]:
    """→ (node_count, scheduled[P] bool). Same contract as
    estimator.reference_impl.ffd_binpack_reference."""
    lib = _require()
    req = np.ascontiguousarray(pod_req, np.float32)
    mask = np.ascontiguousarray(pod_mask, np.uint8)
    alloc = np.ascontiguousarray(template_alloc, np.float32)
    P, R = req.shape
    out = np.zeros(P, np.uint8)
    count = lib.ffd_binpack_serial(
        _fptr(req), _u8(mask), _fptr(alloc),
        P, R, max_nodes, cpu_axis, mem_axis, _u8(out),
    )
    if count < 0:
        raise RuntimeError("ffd_binpack_serial failed")
    return int(count), out.astype(bool)


def ffd_binpack_affinity_native(
    pod_req: np.ndarray,        # [P, R] f32
    pod_mask: np.ndarray,       # [P] bool
    template_alloc: np.ndarray,  # [R] f32
    max_nodes: int,
    match: np.ndarray,          # [T, P] bool
    aff_of: np.ndarray,         # [T, P] bool
    anti_of: np.ndarray,        # [T, P] bool
    node_level: np.ndarray,     # [T] bool
    has_label: np.ndarray,      # [T] bool (this group's template)
    cpu_axis: int = 0,
    mem_axis: int = 1,
) -> Tuple[int, np.ndarray]:
    """→ (node_count, scheduled[P] bool). Same contract as
    estimator.reference_impl.ffd_binpack_reference_affinity."""
    lib = _require()
    req = np.ascontiguousarray(pod_req, np.float32)
    mask = np.ascontiguousarray(pod_mask, np.uint8)
    alloc = np.ascontiguousarray(template_alloc, np.float32)
    P, R = req.shape
    T = match.shape[0]
    m = np.ascontiguousarray(match, np.uint8)
    a = np.ascontiguousarray(aff_of, np.uint8)
    x = np.ascontiguousarray(anti_of, np.uint8)
    nl = np.ascontiguousarray(node_level, np.uint8)
    hl = np.ascontiguousarray(has_label, np.uint8)
    out = np.zeros(P, np.uint8)
    count = lib.ffd_binpack_serial_affinity(
        _fptr(req), _u8(mask), _fptr(alloc),
        P, R, max_nodes, cpu_axis, mem_axis, T,
        _u8(m), _u8(a), _u8(x), _u8(nl), _u8(hl), _u8(out),
    )
    if count < 0:
        raise RuntimeError("ffd_binpack_serial_affinity failed")
    return int(count), out.astype(bool)


def first_fit_native(
    pod_req: np.ndarray,  # [P, R] f32
    free: np.ndarray,     # [N, R] f32
    mask: np.ndarray,     # [P, N] bool
) -> np.ndarray:
    """→ first-fit node index per pod, -1 when none."""
    lib = _require()
    req = np.ascontiguousarray(pod_req, np.float32)
    fr = np.ascontiguousarray(free, np.float32)
    m = np.ascontiguousarray(mask, np.uint8)
    P, R = req.shape
    N = fr.shape[0]
    out = np.zeros(P, np.int32)
    lib.first_fit_serial(
        _fptr(req), _fptr(fr), _u8(m), P, N, R,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
