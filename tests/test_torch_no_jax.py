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
from autoscaler_tpu_torch.snapshot.arena import DeviceArena
from autoscaler_tpu_torch.snapshot.incremental import IncrementalPacker
pk = IncrementalPacker(device="cpu", arena=DeviceArena(device="cpu"))
for listing in (placed + small, placed + small[1:]):
    snap2 = ClusterSnapshot(packer=pk)
    for n in nodes:
        snap2.add_node(n)
    for p in listing:
        snap2.add_pod(p)
    t2, m2 = snap2.tensors()
# both updates fit the packer's first 8 x 8 buckets: no full pack at all
assert (pk.full_packs, pk.incremental_updates) == (0, 2), pk.full_packs
assert m2.num_pods == 5 and t2.pod_req.device.type == "cpu"
stats = pk.arena.take_stats()
assert stats["applies"] == 2 and stats["full_uploads"] > 0 and stats["rollbacks"] == 0, stats
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


# the modules of the scale-up half of a tick (filter-out-schedulable and the
# orchestrator with what it runs on), each at its JAX counterpart's path
TICK_MODULES = (
    "ops/schedule.py", "simulator/hinting.py", "core/podlistprocessor.py",
    "core/scaleup/orchestrator.py", "core/scaleup/resource_manager.py",
    "processors/pipeline.py", "processors/nodegroupset.py", "processors/nodeinfos.py",
    "cloudprovider/interface.py", "cloudprovider/test_provider.py",
    "clusterstate/backoff.py", "clusterstate/registry.py", "config/options.py",
    "explain/reasons.py", "utils/errors.py",
)

_TICK_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.path.insert(0, "tests")
import autoscaler_tpu_torch.cloudprovider.test_provider as prov
import autoscaler_tpu_torch.kube.objects as obj
import autoscaler_tpu_torch.snapshot.cluster_snapshot as cs
import autoscaler_tpu_torch.utils.test_utils as tu
from autoscaler_tpu_torch.clusterstate.registry import ClusterStateRegistry
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.core.podlistprocessor import FilterOutSchedulablePodListProcessor
from autoscaler_tpu_torch.core.scaleup.orchestrator import ScaleUpOrchestrator
from autoscaler_tpu_torch.snapshot.affinity import build_spread_context_from_meta
from torch_parity import tick_world
snap, pending, provider = tick_world(tu, obj, prov, cs, True, device="cpu")
snap.fork()
still, filtered = FilterOutSchedulablePodListProcessor().process(snap, pending)
snap.revert()
opts = AutoscalingOptions(expander="least-waste", expander_random_seed=0)
res = ScaleUpOrchestrator(provider, opts, ClusterStateRegistry(provider, opts),
                          device="cpu").scale_up(still, snap.nodes(), 5.0,
                                                 pods_of_node=snap.pods_on_node)
loaded = [m for m in sys.modules if m == "autoscaler_tpu" or m.startswith("autoscaler_tpu.")]
assert not loaded, loaded
print("OK", len(filtered), len(still), res.chosen_group, res.new_nodes)
"""


# the modules of the incremental packer and the resident arena, and the
# jax-free ones they run on, each at its JAX counterpart's path
PACKER_MODULES = (
    "snapshot/incremental.py", "snapshot/arena.py", "ops/arena_apply.py",
    "fleet/buckets.py", "perf/residency.py", "trace/tracer.py", "trace/recorder.py",
)


# the modules of the scale-down half of a tick (utilization, empty nodes, the
# removal refit, the simulator, eligibility, planner, actuator and the
# jax-free ones they run on), each at its JAX counterpart's path
SCALEDOWN_MODULES = (
    "ops/utilization.py", "ops/scaledown.py", "simulator/removal.py", "simulator/drain.py",
    "simulator/tracker.py", "core/scaledown/tracking.py", "core/scaledown/limits.py",
    "core/scaledown/eligibility.py", "core/scaledown/planner.py",
    "core/scaledown/actuator.py", "kube/api.py", "utils/klogx.py",
)


def test_tick_modules_are_ported():
    for rel in TICK_MODULES + PACKER_MODULES + SCALEDOWN_MODULES:
        assert (PORT / rel).is_file(), rel
        assert (REPO / "autoscaler_tpu" / rel).is_file(), rel
        assert f"autoscaler_tpu_torch/{rel}" in PORT_FILES
    from autoscaler_tpu_torch.snapshot import affinity

    assert callable(affinity.build_spread_schedule_context)
    assert callable(affinity.build_spread_context_from_meta)


def test_tick_runs_with_jax_blocked():
    """Filter-out-schedulable and scale_up on the CPU with jax blocked: the
    tick of tests/torch_parity.tick_world (spread in play) imports nothing
    of the JAX package."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _TICK_BLOCKED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok, n_filtered, n_still, group, new_nodes = proc.stdout.split()
    assert ok == "OK" and int(n_filtered) > 0 and int(n_still) > 0
    assert group.startswith("ng-") and int(new_nodes) > 0


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


_SCALEDOWN_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from autoscaler_tpu_torch.tools import scaledown_probe as sp
from autoscaler_tpu_torch.utils.workload import build_snapshot_world
nodes, pods = build_snapshot_world(N=60, P=400, port_nodes=20, apps=12)
nodes, pods = sp.scale_in_listing(nodes, pods, removed_apps=4, spread_apps=4)
rec = sp.run_scale_down(nodes, pods, "cpu", sp.WIDE_REFIT)
loaded = [m for m in sys.modules if m == "autoscaler_tpu" or m.startswith("autoscaler_tpu.")]
assert not loaded, loaded
act = rec["out"]["actuation"]
print("OK", len(act["deleted_empty"]), len(act["deleted_drain"]))
"""


def test_scale_down_runs_with_jax_blocked():
    """Both loops of a scale-down (3n's options: the spread refit, the
    joint pass, the actuator) on the CPU with jax blocked import nothing
    of the JAX package."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _SCALEDOWN_BLOCKED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok, n_empty, n_drain = proc.stdout.split()
    assert ok == "OK" and int(n_empty) > 0 and int(n_drain) > 0


def test_scale_down_entry_points_raise_without_a_card(monkeypatch):
    from autoscaler_tpu_torch.tools import scaledown_probe
    from autoscaler_tpu_torch.utils.test_utils import build_test_node

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        scaledown_probe.run_scale_down([build_test_node("n0")], [])
    with pytest.raises(RuntimeError, match="CUDA"):
        scaledown_probe.main([])
