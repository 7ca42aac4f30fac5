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
from autoscaler_tpu_torch.ops.fit import first_fit_node, fits_any_node
from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot
from autoscaler_tpu_torch.snapshot.packer import pack
nodes = [build_test_node(f"n{j}", cpu_m=1000) for j in range(3)]
placed = [build_test_pod(f"q{j}", cpu_m=800, node_name=f"n{j}") for j in range(2)]
small = [build_test_pod(f"s{i}", cpu_m=150 * (i + 1)) for i in range(4)]
fits = [fits_any_node(pack(nodes, placed + small, dense_mask=d, device="cpu")[0])
        for d in (True, False)]
assert fits[0].tolist() == fits[1].tolist(), fits
snap = ClusterSnapshot(device="cpu")
for n in nodes:
    snap.add_node(n)
for p in placed + small:
    snap.add_pod(p)
first = first_fit_node(snap.tensors()[0])
loaded = [m for m in sys.modules if m == "autoscaler_tpu" or m.startswith("autoscaler_tpu.")]
assert not loaded, loaded
print("OK", res["g"][0], sum(fits[0].tolist()), first[:6].tolist())
"""


def test_port_imports_and_estimates_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    # 3642 millicores on four 1000m nodes; every pod fits somewhere: the
    # two placed 800m pods and the 300-600m ones only on the empty node 2,
    # the 150m pod first on node 0 (200m free)
    assert proc.stdout.strip() == "OK 4 6 [2, 2, 0, 2, 2, 2]"


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


def test_snapshot_entry_points_raise_without_a_card(monkeypatch):
    from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot
    from autoscaler_tpu_torch.snapshot.packer import pack
    from autoscaler_tpu_torch.snapshot.tensors import empty_snapshot, tensors_from_numpy
    from autoscaler_tpu_torch.utils.test_utils import build_test_node, build_test_pod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes, pods = [build_test_node("n0")], [build_test_pod("p0")]
    with pytest.raises(RuntimeError, match="CUDA"):
        pack(nodes, pods)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterSnapshot().tensors()
    with pytest.raises(RuntimeError, match="CUDA"):
        empty_snapshot(8, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tensors_from_numpy({"pod_valid": [True]})
    assert pack(nodes, pods, device="cpu")[0].pod_req.device.type == "cpu"


def test_fit_kernel_builds_or_raises(monkeypatch, tmp_path):
    """K4's launch path has no fallback: with no CUDA compiler the build
    raises (the wrapper takes the plain version only for CPU tensors)."""
    import shutil

    import torch.utils.cpp_extension as cpp_ext

    from autoscaler_tpu_torch.ops import _build

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("fit_reduce")


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
