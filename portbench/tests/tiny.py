"""A checkout's benchmark at a size the CPU holds: the repo's configs, mixes,
readers, entries and references copied into a temporary root, each
configuration cut to ``PODS`` pods, ``GROUPS`` groups, ``MAX_NODES`` nodes
and ``TERMS`` terms, with the repo's ``BENCHMARK.json``. The port runs its
kernels' plain versions on the CPU."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from portbench.bench import run_cell
from portbench.spec import ROOT, Spec

PODS, GROUPS, MAX_NODES, TERMS = 1000, 6, 48, 5
CELLS = ("burst.k2", "affinity.k3", "burst.k1")


def tiny_root(tmp: Path) -> Path:
    data = tmp / "portbench"
    for sub in ("configs", "traffic", "metrics", "entries", "reference"):
        shutil.copytree(ROOT / "portbench" / sub, data / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        path = tmp / entry["file"]
        config = json.loads(path.read_text())
        config.update(pods=PODS, groups=GROUPS, max_nodes=MAX_NODES)
        if config["terms"]:
            config["terms"] = TERMS
        path.write_text(json.dumps(config))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run(spec: Spec, cell: str, seed: int = 2**33 + 1, seconds: float = 0.5, traced=False) -> dict:
    return run_cell(spec, cell, seed, seconds, traced, "cpu", time.monotonic(), log=lambda _: None)
