"""The port as it is installed and started (chip_smoke's 3s2).

(a) ``python -m autoscaler_tpu_torch.ops.build_kernels --out DIR`` in a
subprocess: every library prebuilt, each one's registers and spills from
its ptxas report, and ``ldd``'s view of one library (nothing of the CUDA
toolkit beyond the driver); (b) an installed copy of the package outside
the checkout, holding only what the wheel ships (the ``.py`` files and
``pyproject.toml``'s package-data globs), runs 3s's gce ``main`` from
that copy with ``--compile-cache-dir=DIR``: no compiler starts and
nothing is written into the copy; (c) the same run with an empty
``--compile-cache-dir``: the start builds the loop's libraries before the
first tick.

    python3 -m autoscaler_tpu_torch.tools.install_probe    # one card

runs the three at 4l's tenth of 3o's world and prints what chip_smoke
prints for them.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import tomllib
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE = "autoscaler_tpu_torch"
# main's line once the loop's libraries are loaded (main.preload_kernels)
START_LINE = re.compile(r"^tpu-autoscaler: kernel libraries .* loaded from (?P<dir>\S+) in "
                        r"(?P<seconds>[0-9.]+) s, (?P<compilers>\d+) compilers ran$", re.M)


def package_data(root) -> Dict[str, List[str]]:
    """``pyproject.toml``'s package-data globs for the port's packages."""
    with open(Path(root) / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    return {pkg: globs for pkg, globs in data.items()
            if pkg == PACKAGE or pkg.startswith(PACKAGE + ".")}


def shipped(root) -> List[str]:
    """The port's files a wheel built from ``root`` holds, relative to
    ``root``: every ``.py`` of the package and the package-data globs."""
    root = Path(root)
    files = {p for p in (root / PACKAGE).rglob("*.py") if "__pycache__" not in p.parts}
    for pkg, globs in package_data(root).items():
        base = root.joinpath(*pkg.split("."))
        for pattern in globs:
            files.update(p for p in base.glob(pattern) if p.is_file())
    return sorted(p.relative_to(root).as_posix() for p in files)


def installed_copy(root, dest) -> Path:
    """A copy of what the wheel ships under ``dest`` (which must not
    exist); → ``dest``, the directory to put on ``PYTHONPATH``."""
    root, dest = Path(root), Path(dest)
    for rel in shipped(root):
        target = dest / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(root / rel, target)
    return dest


def tree_state(path) -> Dict[str, tuple]:
    """Every file under ``path`` with its size and modification time."""
    path = Path(path)
    return {p.relative_to(path).as_posix(): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(path.rglob("*")) if p.is_file()}


def prebuild(root, out, timeout_s: float = 600.0) -> dict:
    """(a): the prebuild in a subprocess from ``root``. → {"rc", "stdout",
    "stderr", "seconds", "libraries": {name: path}, "reports": {name:
    [ptxas lines]}}."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.ops.build_kernels", "--out", str(out)],
        cwd=str(root), env={**os.environ, "PYTHONPATH": str(root)}, capture_output=True,
        text=True, timeout=timeout_s)
    secs = time.perf_counter() - t0
    libraries, reports, name = {}, {}, None
    for line in proc.stdout.splitlines():
        m = re.match(r"^(\w+): (/\S+)$", line)
        if m:
            name = m.group(1)
            libraries[name], reports[name] = m.group(2), []
        elif line.startswith("  ") and name is not None:
            reports[name].append(line.strip())
    return {"rc": proc.returncode, "stdout": proc.stdout, "stderr": proc.stderr,
            "seconds": secs, "libraries": libraries, "reports": reports}


def register_lines(report: List[str]) -> List[str]:
    """The ptxas lines that give registers and spills."""
    return [line for line in report if "Used" in line or "spill" in line]


def toolkit_needs(ldd_out: str) -> List[str]:
    """Lines of ``ldd``'s output that need the CUDA toolkit (its runtime
    or any library under a CUDA directory) or are not found; the driver,
    ``libcuda.so``, is what a card's host has."""
    return [line.strip() for line in ldd_out.splitlines()
            if "not found" in line or "cudart" in line
            or ("/cuda" in line.lower() and "libcuda.so" not in line)]


def start_of(stdout: str) -> Optional[dict]:
    """main's start line: {"dir", "seconds", "compilers", "before_first_tick"}."""
    m = START_LINE.search(stdout)
    if m is None:
        return None
    first_tick = re.search(r"^TICK 0$", stdout, re.M)
    return {"dir": m.group("dir"), "seconds": float(m.group("seconds")),
            "compilers": int(m.group("compilers")),
            "before_first_tick": first_tick is not None and first_tick.start() > m.start()}


def run_installed(copy, kernel_dir, nodes, pods, burst, device: str = "") -> dict:
    """(b) and (c): 3s's gce main from the installed ``copy`` with
    ``--compile-cache-dir=kernel_dir``, run from an empty directory with no
    bytecode written. → run_gce_main's dict plus "start" (``start_of``)
    and "written": the copy's files added, removed or changed."""
    from autoscaler_tpu_torch.tools import bound_loop

    before = tree_state(copy)
    with tempfile.TemporaryDirectory() as cwd:
        out = bound_loop.run_gce_main(
            nodes, pods, burst, str(copy), device=device, cwd=cwd,
            env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"},
            extra_argv=[f"--compile-cache-dir={kernel_dir}"])
    after = tree_state(copy)
    out["written"] = sorted(k for k in before.keys() | after.keys()
                            if before.get(k) != after.get(k))
    out["start"] = start_of(out["stdout"])
    return out


def resizes(run: dict) -> List[str]:
    return [path for _, path, _ in run["compute_writes"] if "/resize?" in path]


def problems(run: dict, compilers: int, want_resizes: List[str], copy,
             card: bool = True) -> List[str]:
    """What (b) or (c) got wrong: exit, package location, compilers,
    writes into the copy, the decisions, and on a ``card`` a start line
    missing or after the first tick, or no K1/K2 or K4 launch."""
    out = []
    if run["rc"] != 0:
        out.append(f"exit {run['rc']}: {run['stderr'][-2000:]}")
    if run["package"] is None or not Path(run["package"]).resolve().is_relative_to(
            Path(copy).resolve()):
        out.append(f"imported the package from {run['package']}, not the copy")
    if run["compilers"] != compilers:
        out.append(f"{run['compilers']} compilers started, not {compilers}")
    if run["written"]:
        out.append(f"wrote into the copy: {run['written'][:5]}")
    start, launched = run["start"], run["launches"]
    if card and (start is None or not start["before_first_tick"]):
        out.append(f"the kernels did not load before the first tick: {start}")
    if card and (launched.get("ffd_scan_swar", 0) + launched.get("ffd_scan_f32", 0) < 1
                 or launched.get("fit_reduce", 0) < 2):
        out.append(f"its estimate or journal probes launched no K1/K2 or K4: {launched}")
    if not card and start is not None:
        out.append(f"kernels loaded off the card: {start}")
    if resizes(run) != want_resizes:
        out.append(f"resizes {resizes(run)} differ from {want_resizes}")
    return out


def run_3s2(root, world, want_resizes: List[str]) -> dict:
    """chip_smoke's 3s2 on the card, from the checkout at ``root`` with
    ``world`` = (nodes, pods, burst): (a) the prebuild into a fresh
    ``build/prebuilt-<pid>`` and ``ldd``'s view of one library, (b) the
    installed copy's run on that directory, (c) the same on an empty one.
    → {"prebuilt", "prebuild", "ldd", "runs": {"b", "c"}, "problems",
    "seconds"}; the prebuilt directory and the copy are removed after."""
    from autoscaler_tpu_torch.ops import _build

    t0 = time.perf_counter()
    root = Path(root)
    prebuilt = root / "build" / f"prebuilt-{os.getpid()}"
    out = {"prebuilt": str(prebuilt), "prebuild": None, "ldd": "", "runs": {}, "problems": []}
    bad = out["problems"]
    with tempfile.TemporaryDirectory(prefix="autoscaler-installed-") as tmp:
        try:
            pre = out["prebuild"] = prebuild(root, prebuilt)
            built = {name: path for name, path in pre["libraries"].items()
                     if os.path.isfile(path)}
            if pre["rc"] != 0 or set(built) != set(_build.SIGNATURES) | {"ffd_serial"}:
                bad.append(f"(a) the prebuild exited {pre['rc']} and left {sorted(built)}: "
                           f"{pre['stderr'][-3000:]}")
                return out
            out["ldd"] = subprocess.run(["ldd", built["fit_reduce"]], capture_output=True,
                                        text=True, timeout=60, check=True).stdout
            needs = toolkit_needs(out["ldd"])
            if needs:
                bad.append(f"(a) a prebuilt library needs the CUDA toolkit: {needs}")
            copy = installed_copy(root, Path(tmp) / "site")
            for label, kdir, compilers in (("b", prebuilt, 0),
                                           ("c", Path(tmp) / "empty", len(_build.LOOP_SOURCES))):
                run = out["runs"][label] = run_installed(copy, kdir, *world)
                run["want_compilers"] = compilers
                bad += [f"({label}) {p}" for p in problems(run, compilers, want_resizes, copy)]
        finally:
            shutil.rmtree(prebuilt, ignore_errors=True)
            out["seconds"] = time.perf_counter() - t0
    return out


def report(result: dict, smi: str) -> List[str]:
    """``run_3s2``'s result as the lines chip_smoke and ``main`` print."""
    lines = []
    pre = result["prebuild"]
    if pre is not None:
        lines.append(f"(a) prebuild: exit {pre['rc']}, {pre['seconds']:.3f} s, "
                     f"{sorted(pre['libraries'])} in {result['prebuilt']}; {smi}")
        for name, rep in sorted(pre["reports"].items()):
            lines += [f"(a) {name}: {line}" for line in register_lines(rep)]
        lines += [f"(a) ldd fit_reduce: {line.strip()}" for line in result["ldd"].splitlines()]
    for label, run in result["runs"].items():
        start = run["start"] or {}
        lines.append(f"({label}) {'prebuilt' if run['want_compilers'] == 0 else 'empty'} "
                     f"directory: exit {run['rc']}, {run['seconds']:.3f} s; start "
                     f"{start.get('seconds')} s with {run['compilers']} compilers, before "
                     f"tick 0 {start.get('before_first_tick')}; launches {run['launches']}; "
                     f"resizes {resizes(run)}; files written into the copy "
                     f"{len(run['written'])}; {smi}")
    lines.append(f"{result['seconds']:.3f} s host clock")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("install_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from autoscaler_tpu_torch.tools import bound_loop, loop_probe

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    root = Path(__file__).resolve().parents[2]
    nodes, pods, burst, _ = loop_probe.loop_world(tenth=True)
    base = bound_loop.run_gce_main(nodes, pods, burst, str(root))
    print(f"# checkout run: exit {base['rc']}, {base['seconds']:.3f} s, compilers "
          f"{base['compilers']}, launches {base['launches']}", flush=True)
    result = run_3s2(root, (nodes, pods, burst), resizes(base))
    for line in report(result, smi):
        print(f"# {line}", flush=True)
    bad = ([f"checkout run: exit {base['rc']}"] if base["rc"] != 0 else []) + result["problems"]
    print(json.dumps({"problems": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
