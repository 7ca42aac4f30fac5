"""Times design variants of a kernel's source against each other on one
CUDA card, at the shapes of its main-path launches.

    python3 -m autoscaler_tpu_torch.tools.scan_variants [--kernel scan|aff|fit] \\
        [--variant NAME ...] [--source NAME=PATH ...] [--reps 3] [--out FILE]

``--kernel scan`` (the default) takes ``csrc/ffd_scan.cu`` (K1 and K2) and
its variants in ``ffd_scan_variants/``, on the headline operands of both
routes: integral requests (K2) and fractional memory (K1). ``--kernel
aff`` takes ``csrc/ffd_scan_affinity.cu`` (K3) and its variants in
``ffd_scan_affinity_variants/``, on the operands of K3's three main-path
launches: the affinity workload, and the operands that ``estimate_many``
hands K3 on the zone and hostname spread worlds (captured from the call).
``--kernel fit`` takes ``csrc/fit_reduce.cu`` (K4) and its variants in
``fit_reduce_variants/``, on the fit bench's operands (fit-K4), on the
operands that the snapshot probe's ``first_fit_node`` hands K4 (captured
from the call on the packed 15k-node world), and, for the sources that
have the rows entry, on the probe's special rows.

The variants are the checkout's own source ("this"); each committed
variant, a unified diff against that source (NAME is the file's stem; all
of them unless ``--variant`` names some; the first line of each says what
it changes); and each ``--source``, another version of the whole file with
the same C entry points, for example an older commit's, unpacked with
``git show``. Each is compiled with the flags of ``ops/_build.py`` into
``build/variants/<kernel>/`` (all compilers at once) and launched through
its own library. Each launch is held against the plain version exactly
(free, opened, placed for the scans; any, count, first for the fit); then
each variant is timed with CUDA events in turns (every variant, then all
again in reverse order), on the real operands and, for the scans, on
all-zero requests (and bits), where every pod fits node 0 (the floor of
the chain of dependent steps). Prints one line per variant and operand
set and a JSON object last; ``--out`` also writes the JSON there.
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

from autoscaler_tpu_torch.ops import _build, ffd_scan, ffd_scan_affinity, fit_reduce

TOOLS = Path(__file__).resolve().parent
PATCH_DIR = TOOLS / "ffd_scan_variants"
AFF_PATCH_DIR = TOOLS / "ffd_scan_affinity_variants"
FIT_PATCH_DIR = TOOLS / "fit_reduce_variants"
# --kernel → (the source's name in ops/_build.py, its variants' directory)
KERNELS = {
    "scan": ("ffd_scan", PATCH_DIR),
    "aff": ("ffd_scan_affinity", AFF_PATCH_DIR),
    "fit": ("fit_reduce", FIT_PATCH_DIR),
}


HUNK = re.compile(r"^@@[^\n]*\n", re.M)


def variant_dir() -> Path:
    """Where the variants build: beside the kernels' directory, read at
    call time (``--compile-cache-dir`` or a test may have moved it)."""
    return _build.BUILD_DIR.parent / "variants"


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


def _variant_sources(args, out_dir: Path):
    src_name, patch_dir = KERNELS[args.kernel]
    this = _build.source(src_name)
    sources = {"this": this}
    text = this.read_text()
    patches = sorted(patch_dir.glob("*.patch"))
    names = args.variant or [p.stem for p in patches]
    known = {p.stem: p for p in patches}
    for name in names:
        if name not in known:
            raise SystemExit(f"no variant {name!r}; the variants are {sorted(known)}")
        src = out_dir / f"{name}.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(apply_patch(text, known[name].read_text()))
        sources[name] = src
    for spec in args.source:
        name, _, path = spec.partition("=")
        sources[name] = Path(path)
    return sources


def _build_all(sources, src_name: str, out_dir: Path):
    """One nvcc a source, all at once → {name: loaded library}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = out_dir / f"{name}.so"
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
        for fn_name, argtypes in _build.SIGNATURES[src_name].items():
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _launch_scan(lib, ops):
    """One launch of the route's K1/K2 from ``lib`` on prepared operands
    → (free, opened, placed)."""
    stream = ops.stream
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
    ptrs += [free.data_ptr(), opened.data_ptr(), placed.data_ptr(), None]
    cuda_stream = torch.cuda.current_stream().cuda_stream
    _build.check(getattr(lib, name)(*ptrs, G, P_pad, NP, M, cuda_stream), name)
    return free, opened, placed.view(torch.bool)


def _launch_aff(lib, ops):
    """One launch of K3 from ``lib`` on prepared operands → (free, opened,
    placed)."""
    stream = ops.stream
    G, P_pad, R = stream.shape
    M = ops.max_nodes
    free = torch.empty((G, R, M), dtype=torch.float32, device=stream.device)
    opened = torch.empty((G,), dtype=torch.int32, device=stream.device)
    placed = torch.empty((G, P_pad), dtype=torch.uint8, device=stream.device)
    cuda_stream = torch.cuda.current_stream().cuda_stream
    err = lib.ffd_scan_aff(
        stream.data_ptr(), ops.bits.data_ptr(), ops.allocs.data_ptr(), ops.caps.data_ptr(),
        ops.nl.data_ptr(), ops.hl.data_ptr(),
        ops.spstat.data_ptr() if ops.spstat is not None else None,
        free.data_ptr(), opened.data_ptr(), placed.data_ptr(),
        G, P_pad, R, ops.num_planes, ops.num_spread, M, cuda_stream,
    )
    _build.check(err, "ffd_scan_aff")
    return free, opened, placed.view(torch.bool)


def _scan_cases(dev):
    """K1/K2's operand sets: (label, operands, plain result, all-zero
    operands, launcher), one at a time."""
    from autoscaler_tpu_torch.utils.workload import HEADLINE_MAX_NODES, build_workload

    req, masks, allocs, caps = build_workload()
    req_frac = req.copy()
    req_frac[:, 1] += 0.5                 # fractional memory refuses the SWAR plan
    for route, r in (("swar", req), ("f32", req_frac)):
        t_ops = ffd_scan.operands_from_numpy(r, masks, allocs, caps, dev)
        ops = ffd_scan.prepare_scan(*t_ops[:3], HEADLINE_MAX_NODES, t_ops[3])
        assert (ops.plan is not None) == (route == "swar")
        if ops.plan is not None:
            want = ffd_scan._scan_plain_swar(
                ops.stream, ops.allocs, ops.caps, ops.guards, HEADLINE_MAX_NODES
            )
        else:
            want = ffd_scan._scan_plain_f32(ops.stream, ops.allocs, ops.caps, HEADLINE_MAX_NODES)
        zeros = ops._replace(stream=torch.zeros_like(ops.stream))
        yield route, ops, want, zeros, _launch_scan


def _plain_aff(ops):
    return ffd_scan_affinity._scan_plain_aff(
        ops.stream, ops.bits, ops.allocs, ops.caps, ops.nl, ops.hl, ops.spstat,
        ops.num_planes, ops.num_spread, ops.max_nodes,
    )


def _aff_cases(dev):
    """K3's operand sets, as chip_smoke.py drives them: the affinity
    workload, and what ``estimate_many`` hands K3 on each spread world
    (the estimate runs with K3's plain version in its place, whose result
    is kept as the reference)."""
    from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
    from autoscaler_tpu_torch.estimator.limiter import ThresholdBasedEstimationLimiter
    from autoscaler_tpu_torch.utils import workload as w

    aff_np = w.build_affinity_workload(w.AFFINITY_PODS, w.AFFINITY_GROUPS, w.AFFINITY_TERMS)
    ops = ffd_scan_affinity.prepare_scan_aff(
        **ffd_scan_affinity.affinity_operands_from_numpy(*aff_np, device=dev),
        max_nodes=w.AFFINITY_MAX_NODES,
    )
    cases = [("affinity", ops, _plain_aff(ops))]
    estimator = BinpackingNodeEstimator(
        ThresholdBasedEstimationLimiter(max_nodes=w.SPREAD_MAX_NODES), device=dev
    )
    real = ffd_scan_affinity.ffd_scan_aff
    for label, key in (("spread-zone", w.ZONE), ("spread-hostname", w.HOSTNAME)):
        pods, templates = w.build_spread_world(
            w.SPREAD_PODS, w.SPREAD_GROUPS, w.SPREAD_APPS, topology_key=key
        )
        seen = []

        def capture(ops):
            seen.append((ops, _plain_aff(ops)))
            return seen[-1][1]

        ffd_scan_affinity.ffd_scan_aff = capture
        try:
            estimator.estimate_many(pods, templates)
        finally:
            ffd_scan_affinity.ffd_scan_aff = real
        if len(seen) != 1:
            raise SystemExit(f"{label}: estimate_many launched K3 {len(seen)} times, not once")
        cases.append((label, *seen[0]))
    for label, ops, want in cases:
        zeros = ops._replace(
            stream=torch.zeros_like(ops.stream), bits=torch.zeros_like(ops.bits)
        )
        yield label, ops, want, zeros, _launch_aff


def _launch_fit(lib, ops):
    """One launch of K4 from ``lib`` → FitReduction."""
    P, R = ops[0].shape
    N = ops[1].shape[0]
    CP, CN = ops[4].shape
    count = torch.zeros((P,), dtype=torch.int32, device=ops[0].device)
    first = torch.full((P,), fit_reduce.BIG_I32, dtype=torch.int32, device=ops[0].device)
    err = lib.fit_reduce(*(t.data_ptr() for t in ops), count.data_ptr(), first.data_ptr(),
                         P, N, R, CP, CN, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fit_reduce")
    any_fit = count > 0
    return fit_reduce.FitReduction(any_fit, count, torch.where(any_fit, first, -1))


def _launch_rows(lib, ops):
    """One launch of K4's rows entry from ``lib`` → FitReduction."""
    req, free, rows, slots = ops
    S, R = req.shape
    N = free.shape[0]
    count = torch.zeros((S,), dtype=torch.int32, device=req.device)
    first = torch.full((S,), fit_reduce.BIG_I32, dtype=torch.int32, device=req.device)
    err = lib.fit_reduce_rows(req.data_ptr(), free.data_ptr(), rows.data_ptr(),
                              slots.data_ptr(), count.data_ptr(), first.data_ptr(), S, N, R,
                              torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fit_reduce_rows")
    any_fit = count > 0
    return fit_reduce.FitReduction(any_fit, count, torch.where(any_fit, first, -1))


def _fit_cases(dev):
    """K4's operand sets: the fit bench's (fit-K4), those the snapshot
    probe's ``first_fit_node`` hands K4 (captured from the call), and the
    probe's special rows for the rows entry."""
    from autoscaler_tpu_torch.ops import fit
    from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot
    from autoscaler_tpu_torch.utils.workload import build_fit_workload, build_snapshot_world

    ops = tuple(torch.tensor(a, device=dev) for a in build_fit_workload())
    yield "fit-K4", ops, fit_reduce._fit_reduce_plain(*ops), None, _launch_fit
    del ops
    nodes, pods = build_snapshot_world()
    snapshot = ClusterSnapshot(device=dev)
    for node in nodes:
        snapshot.add_node(node)
    for pod in pods:
        snapshot.add_pod(pod)
    tensors, _ = snapshot.tensors()
    seen = []
    real = fit_reduce.fit_reduce_cuda

    def capture(*operands):
        seen.append(operands)
        return real(*operands)

    fit_reduce.fit_reduce_cuda = capture
    try:
        fit.first_fit_node(tensors)
    finally:
        fit_reduce.fit_reduce_cuda = real
    if len(seen) != 1:
        raise SystemExit(f"first_fit_node launched K4 {len(seen)} times, not once")
    yield "probe", seen[0], fit_reduce._fit_reduce_plain(*seen[0]), None, _launch_fit
    special = fit_reduce.special_pods(tensors)
    rows_ops = (tensors.pod_req[special.clamp(min=0)].contiguous(), tensors.free(),
                fit_reduce.special_rows(tensors), special.to(torch.int32))
    yield "probe-rows", rows_ops, fit_reduce._fit_reduce_rows_plain(*rows_ops), None, _launch_rows


def _event_ms(fn, reps):
    """Mean device time of ``reps`` calls after one warm-up, queued behind
    ~10 ms of a spinning card so that the events time the card, not the
    host's launches."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(KERNELS), default="scan")
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
    out_dir = variant_dir() / args.kernel
    libs = _build_all(_variant_sources(args, out_dir), KERNELS[args.kernel][0], out_dir)

    cases = {"scan": _scan_cases, "aff": _aff_cases, "fit": _fit_cases}[args.kernel](dev)
    result = {"device": smi, "kernel": args.kernel, "reps": args.reps,
              "variants": list(libs), "routes": {}}
    for label, ops, want, zeros, launch in cases:
        entry = "fit_reduce_rows" if launch is _launch_rows else None
        here = {name: lib for name, lib in libs.items() if entry is None or hasattr(lib, entry)}
        rows = {}
        for name, lib in here.items():
            got = launch(lib, ops)
            torch.cuda.synchronize()
            exact = all(torch.equal(a, b) for a, b in zip(want, got))
            rows[name] = {"exact": exact, "ms": [], "floor_ms": []}
        order = list(here) + list(reversed(here))
        for name in order:
            lib = here[name]
            rows[name]["ms"].append(_event_ms(lambda: launch(lib, ops), args.reps))
            if zeros is not None:
                rows[name]["floor_ms"].append(_event_ms(lambda: launch(lib, zeros), args.reps))
        for name, row in rows.items():
            ms = sum(row["ms"]) / len(row["ms"])
            row["mean_ms"] = ms
            line = f"# {label} {name}: {ms:.3f} ms ({row['ms'][0]:.3f}, {row['ms'][1]:.3f})"
            if zeros is not None:
                P_pad = ops.stream.shape[1]
                floor = sum(row["floor_ms"]) / len(row["floor_ms"])
                row.update(us_per_step=ms * 1e3 / P_pad, mean_floor_ms=floor)
                line += f", {ms * 1e3 / P_pad:.4f} us a step, chain floor {floor:.3f} ms"
            print(f"{line}, {'exact' if row['exact'] else 'DIFFERS from the plain version'}",
                  flush=True)
        result["routes"][label] = rows
        del want, zeros, ops
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0 if all(row["exact"] for rows in result["routes"].values()
                    for row in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
