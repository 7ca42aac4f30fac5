"""Times design variants of the FFD scan source (``csrc/ffd_scan.cu``,
kernels K1 and K2) against each other on one CUDA card, at the headline
shapes.

    python3 -m autoscaler_tpu_torch.tools.scan_variants \\
        [--variant NAME ...] [--source NAME=PATH ...] [--reps 3] [--out FILE]

The variants are the checkout's own source ("this"); each committed
variant, a unified diff against that source in ``ffd_scan_variants/``
(NAME is the file's stem; all of them unless ``--variant`` names some;
the first line of each says what it changes); and each ``--source``,
another version of the whole file with the same C entry points, for
example an older commit's, unpacked with ``git show``. Each is compiled
with the flags of ``ops/_build.py`` into ``build/variants/`` (all
compilers at once) and launched through its own library on the headline
operands of both routes: integral requests (K2) and fractional memory
(K1). Each launch is held against the plain version exactly (free,
opened, placed); then each variant is timed with CUDA events in turns
(every variant, then all again in reverse order), on the headline stream
and on an all-zero stream, where every pod fits node 0 (the floor of the
chain of dependent steps). Prints one line per variant and route and a
JSON object last; ``--out`` also writes the JSON there.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import List

import torch

from autoscaler_tpu_torch.ops import _build, ffd_scan
from autoscaler_tpu_torch.utils.workload import HEADLINE_MAX_NODES, build_workload

PATCH_DIR = Path(__file__).resolve().parent / "ffd_scan_variants"
VARIANT_DIR = _build.BUILD_DIR.parent / "variants"
HUNK = re.compile(r"^@@[^\n]*\n", re.M)


def _find(lines: List[str], block: List[str], start: int) -> int:
    for at in range(start, len(lines) - len(block) + 1):
        if lines[at:at + len(block)] == block:
            return at
    raise ValueError("a hunk's lines do not occur in the source: " + "".join(block[:3]))


def apply_patch(text: str, patch: str) -> str:
    """``text`` with the unified diff ``patch`` applied. Each hunk's old
    lines must occur in order, after the previous hunk's; line numbers and
    anything before the first hunk are ignored."""
    lines = text.splitlines(keepends=True)
    out, pos = [], 0
    for hunk in HUNK.split(patch)[1:]:
        old, new = [], []
        for line in hunk.splitlines(keepends=True):
            tag, body = (line[:1], line[1:]) if line != "\n" else (" ", line)
            if tag in " -":
                old.append(body)
            if tag in " +":
                new.append(body)
        at = _find(lines, old, pos)
        out += lines[pos:at] + new
        pos = at + len(old)
    return "".join(out + lines[pos:])


def _variant_sources(args):
    this = _build.source("ffd_scan")
    sources = {"this": this}
    text = this.read_text()
    patches = sorted(PATCH_DIR.glob("*.patch"))
    names = args.variant or [p.stem for p in patches]
    known = {p.stem: p for p in patches}
    for name in names:
        if name not in known:
            raise SystemExit(f"no variant {name!r}; the variants are {sorted(known)}")
        src = VARIANT_DIR / f"{name}.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(apply_patch(text, known[name].read_text()))
        sources[name] = src
    for spec in args.source:
        name, _, path = spec.partition("=")
        sources[name] = Path(path)
    return sources


def _build_all(sources):
    """One nvcc a source, all at once → {name: loaded library}."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = VARIANT_DIR / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ))
    libs = {}
    for name, (path, proc) in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{out}{err}")
        for line in (out + err).splitlines():
            if "Used" in line or "spill" in line:
                print(f"# {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in _build.SIGNATURES["ffd_scan"].items():
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _launch(lib, ops, stream):
    """One launch of the route's kernel from ``lib`` on ``stream`` (the
    prepared operands otherwise) → (free, opened, placed)."""
    G, P_pad, NP = stream.shape
    M = ops.max_nodes
    free = torch.empty((G, NP, M), dtype=stream.dtype, device=stream.device)
    opened = torch.empty((G,), dtype=torch.int32, device=stream.device)
    placed = torch.empty((G, P_pad), dtype=torch.uint8, device=stream.device)
    ptrs = [stream.data_ptr(), ops.allocs.data_ptr(), ops.caps.data_ptr()]
    name = "ffd_scan_f32"
    if ops.plan is not None:
        ptrs.append(ops.guards.data_ptr())
        name = "ffd_scan_swar"
    ptrs += [free.data_ptr(), opened.data_ptr(), placed.data_ptr()]
    cuda_stream = torch.cuda.current_stream().cuda_stream
    _build.check(getattr(lib, name)(*ptrs, G, P_pad, NP, M, cuda_stream), name)
    return free, opened, placed.view(torch.bool)


def _event_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", default=[], metavar="NAME")
    parser.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = _build_all(_variant_sources(args))

    req, masks, allocs, caps = build_workload()
    req_frac = req.copy()
    req_frac[:, 1] += 0.5                 # fractional memory refuses the SWAR plan
    result = {"device": smi, "reps": args.reps, "variants": list(libs), "routes": {}}
    for route, r in (("swar", req), ("f32", req_frac)):
        t_ops = ffd_scan.operands_from_numpy(r, masks, allocs, caps, dev)
        ops = ffd_scan.prepare_scan(*t_ops[:3], HEADLINE_MAX_NODES, t_ops[3])
        assert (ops.plan is not None) == (route == "swar")
        plain_args = (ops.stream, ops.allocs, ops.caps) + (
            (ops.guards,) if ops.plan is not None else ()
        ) + (HEADLINE_MAX_NODES,)
        plain = (ffd_scan._scan_plain_swar if ops.plan is not None
                 else ffd_scan._scan_plain_f32)
        want = plain(*plain_args)
        zeros = torch.zeros_like(ops.stream)
        rows = {}
        for name, lib in libs.items():
            got = _launch(lib, ops, ops.stream)
            torch.cuda.synchronize()
            exact = all(torch.equal(a, b) for a, b in zip(want, got))
            rows[name] = {"exact": exact, "ms": [], "floor_ms": []}
        order = list(libs) + list(reversed(libs))
        for name in order:
            lib = libs[name]
            rows[name]["ms"].append(_event_ms(lambda: _launch(lib, ops, ops.stream), args.reps))
            rows[name]["floor_ms"].append(_event_ms(lambda: _launch(lib, ops, zeros), args.reps))
        P_pad = ops.stream.shape[1]
        for name, row in rows.items():
            ms = sum(row["ms"]) / len(row["ms"])
            floor = sum(row["floor_ms"]) / len(row["floor_ms"])
            row.update(mean_ms=ms, us_per_step=ms * 1e3 / P_pad, mean_floor_ms=floor)
            print(
                f"# {route} {name}: {ms:.3f} ms ({row['ms'][0]:.3f}, {row['ms'][1]:.3f}), "
                f"{ms * 1e3 / P_pad:.4f} us a step, chain floor {floor:.3f} ms, "
                f"{'exact' if row['exact'] else 'DIFFERS from the plain version'}",
                flush=True,
            )
        result["routes"][route] = rows
        del want, zeros, ops, t_ops
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0 if all(row["exact"] for rows in result["routes"].values()
                    for row in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
