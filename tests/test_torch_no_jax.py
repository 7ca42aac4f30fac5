"""The port stands alone: no module of autoscaler_tpu_torch/, and not
chip_smoke.py, imports jax or the JAX package; the package imports and
estimates with jax blocked; entry points raise without a card unless asked
for the CPU; and chip_smoke.py refuses to run without a card or outside a
checkout."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "autoscaler_tpu_torch"
PORT_FILES = sorted(
    p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py") if "__pycache__" not in p.parts
) + ["chip_smoke.py"]


def _forbidden(module: str) -> bool:
    """jax and the JAX package, exact or dotted. autoscaler_tpu_torch
    shares the prefix 'autoscaler_tpu' and must not match."""
    return any(
        module == name or module.startswith(name + ".")
        for name in ("jax", "jaxlib", "autoscaler_tpu")
    )


def test_forbidden_matcher_keeps_the_port_apart():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("autoscaler_tpu")
    assert _forbidden("autoscaler_tpu.kube.objects")
    assert not _forbidden("autoscaler_tpu_torch") and not _forbidden("autoscaler_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_import(path):
    tree = ast.parse((REPO / path).read_text(encoding="utf-8"), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            names = [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


_BLOCKED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import autoscaler_tpu_torch
for info in pkgutil.walk_packages(autoscaler_tpu_torch.__path__, "autoscaler_tpu_torch."):
    importlib.import_module(info.name)
from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
from autoscaler_tpu_torch.utils.test_utils import build_test_node, build_test_pod
pods = [build_test_pod(f"p{i}", cpu_m=100 + 37 * i) for i in range(12)]
res = BinpackingNodeEstimator(device="cpu").estimate_many(
    pods, {"g": build_test_node("t", cpu_m=1000)}
)
assert len(res["g"][1]) == 12, res["g"]
loaded = [m for m in sys.modules if m == "autoscaler_tpu" or m.startswith("autoscaler_tpu.")]
assert not loaded, loaded
print("OK", res["g"][0])
"""


def test_port_imports_and_estimates_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "OK 4"  # 3642 millicores on four 1000m nodes


def test_entry_points_raise_without_a_card(monkeypatch):
    from autoscaler_tpu_torch.device import resolve_device
    from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
    from autoscaler_tpu_torch.ops.ffd_scan import operands_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        BinpackingNodeEstimator()
    with pytest.raises(RuntimeError, match="CUDA"):
        operands_from_numpy([[1.0]], [[True]], [[1.0]])
    assert resolve_device("cpu") == torch.device("cpu")
    assert BinpackingNodeEstimator(device="cpu").device.type == "cpu"


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""   # no card, whatever the host has
    return subprocess.run(
        [sys.executable, str(cwd / "chip_smoke.py")], cwd=str(cwd), env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
