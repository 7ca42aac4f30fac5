"""Builds and loads the port's CUDA kernels.

Each source ``autoscaler_tpu_torch/csrc/<name>.cu`` has a plain C
interface and is compiled with ``nvcc`` into a shared library of its own,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds):

- ``ffd_scan``: the plain FFD scans K1 and K2 (``ops/ffd_scan.py``);
- ``ffd_scan_affinity``: the affinity and spread scan K3
  (``ops/ffd_scan_affinity.py``);
- ``fit_reduce``: the tiled predicate fit K4 and its rows entry
  (``ops/fit_reduce.py``);
- ``histogram``: the ordered scatter-add K5 of the VPA's histogram bank
  (``ops/histogram.py``).

Every library lives in one directory, ``BUILD_DIR``, read at call time,
under a name keyed by a hash of the source and the flags, so a changed
source is rebuilt and an unchanged one is reused. Its default depends on
where the package sits:

- in a checkout (``pyproject.toml`` beside the package), ``build/kernels/``
  at its root, a directory git ignores;
- installed, ``<sys.prefix>/share/autoscaler_tpu_torch/kernels``: a fixed
  place outside the package, which never writes into its own install
  location. An image fills it ahead of time with
  ``python -m autoscaler_tpu_torch.ops.build_kernels``.

``build_dir(path)`` selects another directory for a block (the entry
point's ``--compile-cache-dir``), the native rung's library
(``native_bridge.py``) following it into its ``native/`` subdirectory.
``build(*names)`` starts one ``nvcc`` for each source whose library is not
there yet, all at once, counts them in ``COMPILERS_STARTED`` and waits
for them; a missing library with no ``nvcc`` raises, naming the directory,
the source and the key it looked for. ``preload`` builds what is missing
and loads the libraries a process launches, before its first tick.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"


def default_dir() -> Path:
    """``build/kernels/`` of the checkout the package sits in, else the
    installed default outside the package (see the module docstring)."""
    if (_PKG.parent / "pyproject.toml").is_file():
        return _PKG.parent / "build" / "kernels"
    return Path(sys.prefix) / "share" / "autoscaler_tpu_torch" / "kernels"


BUILD_DIR = default_dir()

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
        "ffd_scan_f32": [_VOID_P] * 7 + [_INT] * 4 + [_VOID_P],
        "ffd_scan_swar": [_VOID_P] * 8 + [_INT] * 4 + [_VOID_P],
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
    "histogram": {
        "ordered_scatter_add": [_VOID_P] * 4 + [_INT] * 2 + [_VOID_P],
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each source's build
BUILD_LOGS: Dict[str, str] = {}
# nvcc processes build() has started in this process
COMPILERS_STARTED = 0
# the sources the reconcile loop launches: K1/K2, K3, K4 and its rows entry
LOOP_SOURCES = ("ffd_scan", "ffd_scan_affinity", "fit_reduce")


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


def _key(name: str) -> str:
    digest = hashlib.sha256(source(name).read_bytes() + " ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_key(name)}.so"


@contextlib.contextmanager
def build_dir(path) -> Iterator[Path]:
    """Within the block, the kernel libraries live in ``path`` and the
    native rung's in its ``native/``; the previous directory comes back
    after it."""
    global BUILD_DIR
    before = BUILD_DIR
    BUILD_DIR = Path(path).absolute()
    try:
        yield BUILD_DIR
    finally:
        BUILD_DIR = before


def _compiler(missing: List[str]) -> str:
    """nvcc, or an error naming what ``BUILD_DIR`` lacks."""
    try:
        return _nvcc()
    except RuntimeError as e:
        wanted = "; ".join(f"{name}-{_key(name)}.so (source {source(name)}, key {_key(name)})"
                           for name in missing)
        raise RuntimeError(f"{e}, and {BUILD_DIR} holds no prebuilt library for "
                           f"{wanted}") from None


def build(*names: str) -> Dict[str, Path]:
    """Compile the named sources (all of them when none is named) into
    their keyed shared libraries, those not built yet all at once, and
    return each library's path. Each compiler's ptxas report lands in
    BUILD_LOGS and beside its library as ``.log``."""
    global COMPILERS_STARTED
    names = names or tuple(SIGNATURES)
    out = {name: _lib_path(name) for name in names}
    missing = [name for name, lib in out.items() if not lib.exists()]
    for name in out.keys() - set(missing):
        log = out[name].with_suffix(".log")
        if name not in BUILD_LOGS and log.exists():
            BUILD_LOGS[name] = log.read_text()
    running = []
    if missing:
        nvcc = _compiler(missing)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in missing:
        lib = out[name]
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd: List[str] = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        COMPILERS_STARTED += 1
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


def preload(*names: str) -> Tuple[float, int]:
    """Build what is missing of the named sources, all at once, then load
    each: what a process on a card runs before its first tick, so that no
    tick compiles. → (seconds taken, compilers started)."""
    t0 = time.perf_counter()
    before = COMPILERS_STARTED
    build(*names)
    for name in names:
        load(name)
    return time.perf_counter() - t0, COMPILERS_STARTED - before


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")
