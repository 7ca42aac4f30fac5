"""Run one cell several times, each run its own process, and report each
metric's median and spread: what a bound is set from.

    python3 -m portbench.sets --workload burst.k2 --seeds 11,12,13,14,15,16 \\
        --seconds 51 --trace 0 --out runs/burst.k2.jsonl

The spread is the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median; the
range, the distance between the least and the greatest value as a share
of the median, is printed beside it. Each
run's record (seed, exit code, wall seconds, its result line, the end of
its standard error) is appended to ``--out``. The card's name and power
limit are printed first. Runs go one after another, never two at once.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUN_LIMIT_S = 1200  # a checkout's first run compiles


def spread(values) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float("nan")


def value_range(values) -> float:
    med = statistics.median(values)
    return (max(values) - min(values)) / med if med else float("nan")


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e!r}"


def run_once(workload, seed, seconds, traced) -> dict:
    cmd = [sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(traced)]
    t = time.monotonic()
    try:
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=RUN_LIMIT_S)
        rc, stdout, stderr = out.returncode, out.stdout, out.stderr
    except subprocess.TimeoutExpired as e:
        rc, stdout, stderr = 124, e.stdout or "", e.stderr or ""
        stdout = stdout if isinstance(stdout, str) else stdout.decode(errors="replace")
        stderr = stderr if isinstance(stderr, str) else stderr.decode(errors="replace")
    wall = time.monotonic() - t
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    try:
        result = json.loads(lines[-1]) if rc == 0 and lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": traced, "rc": rc, "wall_s": wall,
            "result": result, "stderr": stderr[-3000:]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    print(f"card: {card()}", flush=True)
    records = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = run_once(args.workload, seed, args.seconds, args.trace)
        records.append(rec)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as f:
                f.write(json.dumps(rec) + "\n")
        r = rec["result"] or {}
        values = {k: v["value"] for k, v in r.get("metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": rec["rc"], "wall_s": round(rec["wall_s"], 3),
                          "correct": r.get("correct"), "attempted": r.get("attempted"),
                          "metrics": values, "checked": r.get("checked")}), flush=True)
        if rec["result"] is None:
            print(rec["stderr"][-2000:], flush=True)
    metrics = {}
    for rec in records:
        for k, v in ((rec["result"] or {}).get("metrics") or {}).items():
            metrics.setdefault(k, []).append(v["value"])
    for k, vals in metrics.items():
        if len(vals) >= 2:
            print(f"{k}: n {len(vals)} median {statistics.median(vals)!r} "
                  f"spread {spread(vals) if len(vals) >= 3 else float('nan')!r} "
                  f"range {value_range(vals)!r} "
                  f"min {min(vals)!r} max {max(vals)!r}", flush=True)
    return 0 if all(r["rc"] == 0 for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
