"""The port's tree under the port's graftlint, as ``hack/verify.sh`` holds
the JAX package's: the whole of ``autoscaler_tpu_torch/`` scans clean with
no baseline (and none exists), the analysis package scans clean over
itself, and a plain run, a cold-cache run and a warm-cache run of the CLI
print byte-identical JSON. In a file of its own: a scan of the tree takes
about half a minute on one core."""
from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path

from autoscaler_tpu_torch.analysis import scan_paths
from autoscaler_tpu_torch.analysis.cli import main as cli_main

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "autoscaler_tpu_torch"


def _cli(argv) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = cli_main(argv)
    return rc, out.getvalue()


def test_analysis_package_scans_clean_over_itself():
    assert scan_paths([str(PORT / "analysis")]) == []


def test_port_tree_scans_clean_without_a_baseline_byte_identically(tmp_path, monkeypatch):
    """``python -m autoscaler_tpu_torch.analysis autoscaler_tpu_torch/
    --no-baseline`` exits 0 with no finding; the default run (baseline
    discovery finds none) agrees; plain, cold-cache and warm-cache JSON are
    the same bytes."""
    monkeypatch.chdir(REPO)
    assert not (PORT / "analysis" / "lint-baseline.json").exists()
    args = ["autoscaler_tpu_torch", "--no-baseline", "--format=json"]
    rc, plain = _cli(args)
    doc = json.loads(plain)
    assert rc == 0 and doc["findings"] == [] and doc["stale"] == []
    assert doc["files"] > 200
    cache = ["--cache", "--cache-dir", str(tmp_path / "cache")]
    rc_cold, cold = _cli(args + cache)
    rc_warm, warm = _cli(args + cache)
    assert rc_cold == rc_warm == 0
    assert plain == cold == warm
    assert any((tmp_path / "cache").iterdir())
    assert _cli(["autoscaler_tpu_torch"])[0] == 0
