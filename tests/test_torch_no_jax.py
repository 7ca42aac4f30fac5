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


# the estimator's services: the kernel ladder, its native and Python rungs,
# the kernel-entry observer seam and the perf observatory, each at its JAX
# counterpart's path
ESTIMATOR_SERVICE_MODULES = (
    "utils/circuit.py", "estimator/ladder.py", "estimator/reference_impl.py",
    "native_bridge.py", "ops/telemetry.py", "perf/costmodel.py", "perf/ledger.py",
    "perf/observatory.py", "perf/__init__.py",
)

_SERVICES_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from autoscaler_tpu_torch import native_bridge
from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
from autoscaler_tpu_torch.estimator.ladder import KernelLadder
from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics
from autoscaler_tpu_torch.ops.fit import pending_fit_reasons
from autoscaler_tpu_torch.perf import PerfObservatory, validate_records
from autoscaler_tpu_torch.snapshot.packer import pack
from autoscaler_tpu_torch.utils.test_utils import build_test_node, build_test_pod
pods = [build_test_pod(f"p{i}", cpu_m=100 + 37 * i) for i in range(12)]
tmpl = {"g": build_test_node("t", cpu_m=1000)}
m = AutoscalerMetrics()
obs = PerfObservatory(metrics=m, cost_model=True)
ladder = KernelLadder(failure_threshold=1)
ladder.fault_hook = lambda rung: "kernel_fault" if rung == "torch" else None
est = BinpackingNodeEstimator(metrics=m, ladder=ladder, observatory=obs, device="cpu")
obs.begin_tick(0, 0.0)
res = est.estimate_many(pods, tmpl)
rec = obs.end_tick()
served = "native" if native_bridge.available() else "python_ref"
assert m.estimator_kernel_route_total.get(route=served, reason="kernel_fault") == 1
assert ladder.degraded() == ["torch"] and validate_records([rec]) == []
hog = build_test_pod("hog", cpu_m=5000)
codes = pending_fit_reasons(pack([build_test_node("n", cpu_m=1000)], pods + [hog],
                                 device="cpu")[0])[:13]
loaded = [m for m in sys.modules if m == "autoscaler_tpu" or m.startswith("autoscaler_tpu.")]
assert not loaded, loaded
print("OK", res["g"][0], rec["dispatches"][0]["route"], sorted(set(codes.tolist())))
"""


def test_estimator_services_run_with_jax_blocked():
    """The ladder descending past a faulted torch rung to a host rung, the
    observatory's record with the cost model, the fit reasons: with jax
    blocked, nothing of the JAX package loaded."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _SERVICES_BLOCKED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok, count, route, codes = proc.stdout.split(maxsplit=3)
    assert ok == "OK" and int(count) == 4 and route in ("native", "python_ref")
    assert codes.strip() == "[0, 6]"


def test_tick_modules_are_ported():
    for rel in TICK_MODULES + PACKER_MODULES + SCALEDOWN_MODULES + ESTIMATOR_SERVICE_MODULES:
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


# the modules of the reconcile loop and the process around it (the loop,
# main.py, and the jax-free ones they run on), each at its JAX
# counterpart's path
LOOP_MODULES = (
    "core/static_autoscaler.py", "main.py", "metrics/metrics.py", "metrics/healthcheck.py",
    "explain/record.py", "explain/ledger.py", "explain/__init__.py", "slo/spec.py",
    "slo/ledger.py", "slo/engine.py", "slo/__init__.py", "perf/ledger.py",
    "clusterstate/status.py", "journal/ledger.py", "journal/codec.py",
    "journal/recorder.py", "journal/reader.py", "journal/diff.py", "journal/__init__.py",
    "preempt/policy.py", "utils/pprof.py", "utils/tpu.py",
)


def test_loop_modules_are_ported():
    for rel in LOOP_MODULES:
        assert (PORT / rel).is_file(), rel
        assert (REPO / "autoscaler_tpu" / rel).is_file(), rel
        assert f"autoscaler_tpu_torch/{rel}" in PORT_FILES


_LOOP_BLOCKED = r"""
import contextlib, io, runpy, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.argv = ["autoscaler_tpu_torch.main", "--help"]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    try:
        runpy.run_module("autoscaler_tpu_torch.main", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
assert "--device" in out.getvalue() and "--scan-interval" in out.getvalue()
from autoscaler_tpu_torch import main
with contextlib.redirect_stdout(io.StringIO()):
    assert main.main(["--max-iterations=2", "--scan-interval=0", "--address=127.0.0.1:0",
                      "--device=cpu"]) == 0
from autoscaler_tpu_torch.tools import loop_probe as lp
from autoscaler_tpu_torch.utils.workload import build_snapshot_world
nodes, pods = lp.scale_in_listing(*build_snapshot_world(N=120, P=800, port_nodes=40))
templates, burst = lp.burst_operands()
out = lp.run_loop_ticks(nodes, pods, burst[:200], lp.zoned_templates(templates), "cpu",
                        arrive=40)
loaded = [m for m in sys.modules if m == "autoscaler_tpu" or m.startswith("autoscaler_tpu.")]
assert not loaded, loaded
results = [t["result"] for t in out["ticks"]]
probes = [t["probe"]["drift"] for t in out["ticks"]]
print("OK", sum(r.scale_up is not None for r in results), any(probes),
      len(out["autoscaler"].journal.records()))
"""


def test_loop_runs_with_jax_blocked():
    """``python -m autoscaler_tpu_torch.main --help``, a bounded main() on
    the CPU and the three ticks of tools/loop_probe on a small world, with
    jax blocked: nothing of the JAX package is imported."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _LOOP_BLOCKED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok, scale_ups, drift, records = proc.stdout.split()
    assert ok == "OK" and int(scale_ups) >= 1 and drift == "False" and records == "3"


def test_loop_entry_points_raise_without_a_card(monkeypatch):
    from autoscaler_tpu_torch import main
    from autoscaler_tpu_torch.cloudprovider.test_provider import TestCloudProvider
    from autoscaler_tpu_torch.core.static_autoscaler import StaticAutoscaler
    from autoscaler_tpu_torch.journal.reader import tensors_from_fields
    from autoscaler_tpu_torch.kube.api import FakeClusterAPI

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StaticAutoscaler(TestCloudProvider(), FakeClusterAPI())
    with pytest.raises(RuntimeError, match="CUDA"):
        main.main(["--max-iterations=1", "--address=127.0.0.1:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tensors_from_fields({"pod_valid": [True]})


# the cluster bindings: the kube client, the providers, the expanders that
# need a binding, NAP and the gRPC wire modules, each at its JAX
# counterpart's path; the probe and the bound loop of the tools
BINDING_MODULES = (
    "utils/http.py", "utils/cache.py", "utils/leaderelection.py", "kube/convert.py",
    "kube/client.py", "expander/price.py", "expander/priority.py", "cloudprovider/gce.py",
    "cloudprovider/gce_rest.py", "cloudprovider/clusterapi.py", "processors/nodegroups.py",
    "rpc/autoscaler_pb2.py", "cloudprovider/external_grpc.py", "rpc/refcompat.py",
    "expander/grpc_.py",
)


def test_binding_modules_are_ported():
    for rel in BINDING_MODULES:
        assert (PORT / rel).is_file(), rel
        assert (REPO / "autoscaler_tpu" / rel).is_file(), rel
        assert f"autoscaler_tpu_torch/{rel}" in PORT_FILES
    for rel in ("tools/binding_probe.py", "tools/bound_loop.py"):
        assert f"autoscaler_tpu_torch/{rel}" in PORT_FILES


# the modules a card's machine lacks: grpc, protobuf and yaml are imported
# only in the branches that need them
_BINDINGS_BLOCKED = r"""
import sys
for name in ("jax", "jaxlib", "grpc", "google.protobuf", "yaml"):
    sys.modules[name] = None
import autoscaler_tpu_torch.main
from autoscaler_tpu_torch.tools import bound_loop, loop_probe
from autoscaler_tpu_torch.utils.workload import build_snapshot_world
nodes, pods = loop_probe.scale_in_listing(*build_snapshot_world(N=60, P=400, port_nodes=20))
templates, burst = loop_probe.burst_operands()
out = bound_loop.run_gce_in_process(nodes, pods, burst[:100], "cpu", iterations=1)
loaded = [m for m, mod in sys.modules.items() if mod is not None and (
    m == "autoscaler_tpu" or m.startswith(("autoscaler_tpu.", "grpc", "google.protobuf", "yaml")))]
assert not loaded, loaded
resizes = [p for _, p, _ in out["compute_writes"] if "/resize?" in p]
print("OK", out["rc"], len(resizes), len(bound_loop.lease_holders(out["kube_writes"])))
"""


def test_gce_tick_runs_without_grpc_protobuf_or_yaml():
    """As on the card's machine: with grpc, protobuf and yaml (and jax)
    blocked, ``autoscaler_tpu_torch.main`` imports and one gce-and-kube
    tick runs on the CPU against tools/binding_probe's fakes."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _BINDINGS_BLOCKED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1].split() == ["OK", "0", "1", "1"], proc.stdout


# the preemption slice: the pass, the engine, the policy and the journal's
# replay and CLI, each at its JAX counterpart's path
PREEMPT_MODULES = (
    "ops/preempt.py", "preempt/__init__.py", "preempt/engine.py", "preempt/policy.py",
    "journal/replay.py", "journal/__main__.py",
)


def test_preemption_modules_are_ported():
    for rel in PREEMPT_MODULES:
        assert (PORT / rel).is_file(), rel
        assert (REPO / "autoscaler_tpu" / rel).is_file(), rel
        assert f"autoscaler_tpu_torch/{rel}" in PORT_FILES


_PREEMPT_BLOCKED = r"""
import contextlib, io, sys, tempfile
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
from autoscaler_tpu_torch.journal import __main__ as cli
from autoscaler_tpu_torch.preempt import PreemptionEngine
from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot
from autoscaler_tpu_torch.tools import loop_probe as lp, preempt_probe as pp
from autoscaler_tpu_torch.utils.test_utils import build_test_node, build_test_pod
from autoscaler_tpu_torch.utils.workload import build_snapshot_world
snap = ClusterSnapshot(device="cpu")
snap.add_node(build_test_node("n0", cpu_m=4000))
snap.add_pod(build_test_pod("low", cpu_m=4000, node_name="n0", priority=5), "n0")
snap.add_pod(build_test_pod("high", cpu_m=4000, priority=100))
plan = PreemptionEngine(BinpackingNodeEstimator(device="cpu")).plan(snap)
held = pp.hold_plain(pp.storm_worlds(2), "cpu")
nodes, pods = lp.scale_in_listing(*build_snapshot_world(N=120, P=800, port_nodes=40))
templates, burst = lp.burst_operands()
pods, burst = pp.prioritize(pods, burst[:200] + pp.storm_wave(60))
out = pp.run_preempt_ticks(nodes, pods, burst, lp.zoned_templates(templates), "cpu", arrive=40)
with tempfile.TemporaryDirectory() as tmp:
    journal, ledger = pp.write_ledgers(out["autoscaler"], tmp)
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["replay", journal, "--explain-ledger", ledger, "--device", "cpu"])
loaded = [m for m in sys.modules if m == "autoscaler_tpu" or m.startswith("autoscaler_tpu.")]
assert not loaded, loaded
print("OK", plan.route, len(plan.victims), all(h["equal"] for h in held), rc,
      stdout.getvalue().strip().splitlines()[-1])
"""


def test_preemption_runs_with_jax_blocked():
    """An engine's plan, 4p's check on two storm worlds, and the storm's
    three ticks on a small world with their journal replayed through the
    port's CLI, with jax blocked: nothing of the JAX package is imported."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _PREEMPT_BLOCKED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok, route, victims, held, rc, verdict = proc.stdout.split(" ", 5)
    assert (ok, route, victims, held, rc) == ("OK", "torch_preempt", "1", "True", "0")
    assert '"diverged":0' in verdict and '"replayed":0' not in verdict


def test_preemption_entry_points_raise_without_a_card(monkeypatch):
    """The probe, 4p's check and the journal's replay of a tick with a
    preemption pass run on the card unless asked for the CPU."""
    from autoscaler_tpu_torch.cloudprovider.test_provider import TestCloudProvider
    from autoscaler_tpu_torch.config.options import AutoscalingOptions
    from autoscaler_tpu_torch.core.static_autoscaler import StaticAutoscaler
    from autoscaler_tpu_torch.journal import JournalReader
    from autoscaler_tpu_torch.journal.replay import replay_tick
    from autoscaler_tpu_torch.kube.api import FakeClusterAPI
    from autoscaler_tpu_torch.tools import preempt_probe
    from autoscaler_tpu_torch.utils.test_utils import build_test_node, build_test_pod

    provider, api = TestCloudProvider(), FakeClusterAPI()
    node = build_test_node("n0", cpu_m=4000)
    provider.add_node_group("g", 1, 1, 1, node)
    provider.add_node("g", node)
    api.add_node(node)
    api.add_pod(build_test_pod("low", cpu_m=4000, node_name="n0", priority=5))
    api.add_pod(build_test_pod("high", cpu_m=4000, priority=100))
    sa = StaticAutoscaler(provider, api, AutoscalingOptions(preemption_enabled=True),
                          device="cpu")
    sa.run_once(now_ts=0.0)
    reader = JournalReader(sa.journal.records())
    state = reader.reconstruct(reader.ticks()[0])
    record = sa.explainer.records()[0]
    assert replay_tick(state, record, device="cpu")["replayed"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        preempt_probe.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        preempt_probe.hold_plain(preempt_probe.storm_worlds(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        replay_tick(state, record)


# the serving paths and scenario batching: the mesh, the scenario expander,
# the fleet, the estimator's fleet client, the sidecar and the grpc expander,
# each at its JAX counterpart's path
SERVING_MODULES = (
    "parallel/__init__.py", "parallel/mesh.py", "expander/scenario.py", "expander/grpc_.py",
    "fleet/__init__.py", "fleet/admission.py", "fleet/balance.py", "fleet/coalescer.py",
    "fleet/errors.py", "fleet/ledger.py", "fleet/tiers.py", "gym/__init__.py", "gym/env.py",
    "rpc/service.py", "rpc/__main__.py", "rpc/fleet_pb2.py",
)
# the card's machine has no grpc or protobuf: of the serving paths only the
# sidecar, its wire module and the grpc expander may import them
GRPC_MODULES = ("rpc/service.py", "rpc/fleet_pb2.py", "rpc/autoscaler_pb2.py",
                "rpc/refcompat.py", "cloudprovider/external_grpc.py", "expander/grpc_.py")


def test_serving_modules_are_ported():
    for rel in SERVING_MODULES:
        assert (PORT / rel).is_file(), rel
        assert (REPO / "autoscaler_tpu" / rel).is_file(), rel
        assert f"autoscaler_tpu_torch/{rel}" in PORT_FILES
    assert "autoscaler_tpu_torch/tools/fleet_probe.py" in PORT_FILES


@pytest.mark.parametrize("path", [p for p in PORT_FILES if p.startswith("autoscaler_tpu_torch/")])
def test_grpc_imported_only_by_the_wire_modules(path):
    rel = path[len("autoscaler_tpu_torch/"):]
    tree = ast.parse((REPO / path).read_text(encoding="utf-8"), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if n == "grpc" or n.startswith(("grpc.", "google.protobuf"))]
        assert not bad or rel in GRPC_MODULES, f"{path}:{node.lineno} imports {bad}"


_SERVING_BLOCKED = r"""
import sys
for name in ("jax", "jaxlib", "grpc", "google.protobuf", "yaml"):
    sys.modules[name] = None
import numpy as np, torch
from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
from autoscaler_tpu_torch.expander.core import Option
from autoscaler_tpu_torch.expander.scenario import ScenarioStrategy
from autoscaler_tpu_torch.fleet import FleetCoalescer
from autoscaler_tpu_torch.gym.env import FleetEstimatorClient
from autoscaler_tpu_torch.parallel.mesh import make_mesh, whatif_best_options
from autoscaler_tpu_torch.tools import fleet_probe
from autoscaler_tpu_torch.utils.test_utils import GB, build_test_node, build_test_pod
co = FleetCoalescer(buckets="32x8x8", batch_scenarios=4, device="cpu")
reqs = fleet_probe.fleet_tenants(0, 3, pods=(8, 24), groups=(2, 6), adhoc=None)
answers, record = fleet_probe.serve_round(co, reqs, lambda r: fleet_probe.solo(r, "cpu"))
mesh = make_mesh(["cpu"] * 4)
req = reqs[0]
ops = fleet_probe.whatif_operands(req.pod_req, req.pod_masks[:2], req.template_allocs[:2],
                                  req.node_caps[:2], S=4)
res = whatif_best_options(mesh, *(torch.tensor(a) for a in ops), max_nodes=16)
class Group:
    def __init__(self, name, t): self.name, self.t = name, t
    def id(self): return self.name
    def template_node_info(self): return self.t
    def max_size(self): return 10
    def target_size(self): return 0
pods = [build_test_pod(f"p{i}", cpu_m=1000, mem=1 * GB) for i in range(4)]
opts = [Option(Group(g, build_test_node(g, cpu_m=4000, mem=8 * GB)), 2, pods) for g in ("a", "b")]
best = ScenarioStrategy({"a": 0.5, "b": 5.0}, mesh=make_mesh(["cpu"])).best_option(opts)
co.start()
est = BinpackingNodeEstimator(device="cpu", fleet_client=FleetEstimatorClient(co, "t"))
lane = est.estimate_many(pods, {"a": opts[0].node_group.t})
co.stop()
loaded = [m for m, mod in sys.modules.items() if mod is not None and (
    m == "autoscaler_tpu" or m.startswith(("autoscaler_tpu.", "grpc", "google.protobuf", "yaml")))]
assert not loaded, loaded
print("OK", [a.route for a in answers], all(r["match_solo"] for r in record["tenants"]),
      res.node_counts.shape[0], best.node_group.id(), lane["a"][0])
"""


def test_serving_paths_run_without_jax_grpc_protobuf_or_yaml():
    """As on the card's machine: with jax, grpc, protobuf and yaml blocked,
    the coalescer serves a round, the what-if runs on a 4-slot mesh, the
    scenario expander chooses and the estimator's fleet lane estimates,
    all on the CPU."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _SERVING_BLOCKED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == (
        "OK ['fleet_batched', 'fleet_batched', 'fleet_batched'] True 4 a 1"), proc.stdout


# -- the scenario engine and the profiler -----------------------------------------

SCENARIO_MODULES = (
    "trace/device.py", "utils/sharded_worlds.py", "utils/poll.py",
    *(f"loadgen/{m}.py" for m in ("__init__", "__main__", "cli", "driver", "faults",
                                  "fleetdrive", "score", "spec", "suite", "workloads")),
    *(f"gym/{m}.py" for m in ("__init__", "__main__", "cli", "env", "ledger", "policy",
                              "tune")),
)


def test_scenario_modules_are_ported():
    for rel in SCENARIO_MODULES:
        assert (PORT / rel).is_file(), rel
        assert (REPO / "autoscaler_tpu" / rel).is_file(), rel
        assert f"autoscaler_tpu_torch/{rel}" in PORT_FILES
    assert "autoscaler_tpu_torch/tools/drill_probe.py" in PORT_FILES


_SCENARIO_BLOCKED = r"""
import json, os, sys, tempfile
for name in ("jax", "jaxlib", "grpc", "google.protobuf", "yaml"):
    sys.modules[name] = None
from autoscaler_tpu_torch.gym import TuneConfig, tune_suite, SuiteSpec
from autoscaler_tpu_torch.loadgen import ScenarioSpec, run_scenario
from autoscaler_tpu_torch.loadgen.fleetdrive import run_fleet_scenario
from autoscaler_tpu_torch.loadgen.score import build_fleet_report, build_report
from autoscaler_tpu_torch.tools import drill_probe
from autoscaler_tpu_torch.utils import sharded_worlds
from autoscaler_tpu_torch.utils.poll import poll_loop
d = tempfile.mkdtemp()
doc = drill_probe.profile_doc(tenth=True)
spec = ScenarioSpec.from_dict(doc)
spec.options["jax_profiler_dir"] = d
res = run_scenario(spec, device="cpu")
report = build_report(res)
fleet = run_fleet_scenario(ScenarioSpec.from_dict(drill_probe.fleet_doc(ticks=2)), device="cpu")
suite = SuiteSpec.from_dict({"name": "s", "scenarios": [drill_probe.profile_doc(tenth=True)]})
tune = tune_suite(suite, TuneConfig(generations=1, population=1, workers=1, device="cpu"))
world = sharded_worlds.scaledown_world(8, 20, 3, 4, device="cpu")
n = []
assert poll_loop(lambda: n.append(1), 0.0, max_iterations=2) == 0
loaded = [m for m, mod in sys.modules.items() if mod is not None and (
    m == "autoscaler_tpu" or m.startswith(("autoscaler_tpu.", "grpc", "google.protobuf", "yaml")))]
assert not loaded, loaded
print("OK", report["platform"], report["nodes"]["peak"], len(os.listdir(d)),
      build_fleet_report(fleet)["parity"]["certified"], len(tune.records),
      tuple(world[0].sched_mask.shape), len(n))
"""


def test_scenario_engine_runs_without_jax_grpc_protobuf_or_yaml():
    """As on the card's machine: with jax, grpc, protobuf and yaml blocked,
    a scenario runs with a profiler session a tick, a fleet drill certifies,
    a tune writes its ledger, and the sharded worlds and the poll loop run,
    all on the CPU."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _SCENARIO_BLOCKED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "OK cpu 109 4 True 1 (20, 8) 2", proc.stdout


def test_scenario_entry_points_raise_without_a_card(monkeypatch):
    """The drivers, the env and the tuner run on the card unless asked for
    the CPU."""
    from autoscaler_tpu_torch.gym import PolicyGymEnv
    from autoscaler_tpu_torch.loadgen import ScenarioDriver, ScenarioSpec
    from autoscaler_tpu_torch.loadgen.fleetdrive import FleetScenarioDriver
    from autoscaler_tpu_torch.tools import drill_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ScenarioSpec.from_dict(drill_probe.profile_doc(tenth=True))
    for build in (lambda: ScenarioDriver(spec), lambda: PolicyGymEnv(spec).reset(),
                  lambda: FleetScenarioDriver(ScenarioSpec.from_dict(drill_probe.fleet_doc()))):
        with pytest.raises(RuntimeError, match="CUDA|card"):
            build()


# -- the Vertical Pod Autoscaler, the addon resizer and the balancer ----------------

VPA_MODULES = (
    *(f"vpa/{m}.py" for m in ("__init__", "admission", "api", "certs", "feeder", "histogram",
                              "kube_io", "main", "prometheus_history", "recommender",
                              "updater")),
    *(f"addonresizer/{m}.py" for m in ("__init__", "main", "nanny")),
    *(f"balancer/{m}.py" for m in ("__init__", "policy", "summary")),
)


def test_vpa_modules_are_ported():
    for rel in VPA_MODULES:
        assert (PORT / rel).is_file(), rel
        assert (REPO / "autoscaler_tpu" / rel).is_file(), rel
        assert f"autoscaler_tpu_torch/{rel}" in PORT_FILES
    for rel in ("ops/histogram.py", "tools/vpa_probe.py"):
        assert f"autoscaler_tpu_torch/{rel}" in PORT_FILES
    assert (PORT / "csrc" / "histogram.cu").is_file()


# cryptography is blocked too: only vpa/certs.py needs it (the webhook's TLS)
_VPA_BLOCKED = r"""
import contextlib, io, sys
for name in ("jax", "jaxlib", "cryptography"):
    sys.modules[name] = None
from autoscaler_tpu_torch.addonresizer.nanny import LinearEstimator
from autoscaler_tpu_torch.balancer.policy import Target, get_placement
from autoscaler_tpu_torch.tools import vpa_probe
from autoscaler_tpu_torch.vpa import main
world = vpa_probe.vpa_world(**vpa_probe.SMALL)
result = vpa_probe.run_vpa(world, "cpu", passes=2)
hook = vpa_probe.admission_check(result["runner"], https=False)
with contextlib.redirect_stdout(io.StringIO()):
    try:
        main.main(["--help"])
    except SystemExit as e:
        assert e.code == 0
loaded = [m for m, mod in sys.modules.items() if mod is not None and (
    m == "autoscaler_tpu" or m.startswith(("autoscaler_tpu.", "cryptography")))]
assert not loaded, loaded
print("OK", result["series"], vpa_probe.problems(result) == [], hook["equal"], hook["patched"])
"""


def test_vpa_runs_without_jax_or_cryptography():
    """The VPA's warm start and two passes of tools/vpa_probe on a small
    world and its webhook over HTTP, on the CPU, with jax and cryptography
    blocked: nothing of the JAX package is imported."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _VPA_BLOCKED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "OK 12 True True 8", proc.stdout


def test_vpa_entry_points_raise_without_a_card(monkeypatch):
    """The banks, the model, the runner, the probe and ``vpa.main`` run on
    the card unless asked for the CPU."""
    from autoscaler_tpu_torch.tools import vpa_probe
    from autoscaler_tpu_torch.vpa import histogram, main, recommender

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: histogram.HistogramBank(4, histogram.CPU_SPEC),
                  lambda: recommender.ClusterStateModel(),
                  lambda: main.VpaRunner(None, None, None),
                  lambda: vpa_probe.main(["--small"]),
                  lambda: main.main(["--kube-api", "http://127.0.0.1:9"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert recommender.ClusterStateModel(device="cpu").cpu.weights.device.type == "cpu"


ANALYSIS = sorted(
    p.name for p in (REPO / "autoscaler_tpu" / "analysis").iterdir()
    if p.suffix in (".py", ".md")
)


def test_analysis_modules_are_ported():
    """Every module of the JAX package's analysis/ (and RULES.md) has its
    namesake in the port's, and the port keeps no baseline file."""
    for name in ANALYSIS:
        assert (PORT / "analysis" / name).is_file(), name
    assert not (PORT / "analysis" / "lint-baseline.json").exists()
    assert "autoscaler_tpu_torch/tools/analysis_probe.py" in PORT_FILES


@pytest.mark.parametrize("name", [n for n in ANALYSIS if n.endswith(".py")])
def test_analysis_imports_only_the_stdlib_and_itself(name):
    """The port's analysis is stdlib-only like its twin: every import is
    of the standard library or of autoscaler_tpu_torch.analysis."""
    tree = ast.parse((PORT / "analysis" / name).read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert n == "autoscaler_tpu_torch" or n.startswith("autoscaler_tpu_torch.analysis") \
                or top in sys.stdlib_module_names, f"{name}:{node.lineno} imports {n}"


_ANALYSIS_BLOCKED = r"""
import contextlib, io, sys
for name in ("jax", "jaxlib", "autoscaler_tpu", "torch", "numpy"):
    sys.modules[name] = None
from autoscaler_tpu_torch.analysis import scan_paths
from autoscaler_tpu_torch.analysis.cli import main
from autoscaler_tpu_torch.analysis.sanitizer import DeterminismSanitizer
found = scan_paths(["autoscaler_tpu_torch/analysis"])
with DeterminismSanitizer() as san:
    pass
with contextlib.redirect_stdout(io.StringIO()):
    rc = main(["autoscaler_tpu_torch/analysis", "--no-baseline", "--format=json"])
print("OK", len(found), rc, san.events)
"""


def test_analysis_runs_with_jax_the_jax_package_torch_and_numpy_blocked():
    """The linter, its CLI and the sanitizer import and run with jax, the
    JAX package, torch and numpy all blocked (stdlib only)."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _ANALYSIS_BLOCKED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "OK 0 0 []", proc.stdout


def test_analysis_probe_runs_without_jax():
    """tools/analysis_probe's sanitized replay and contract worlds on the
    CPU with jax and the JAX package blocked."""
    code = r"""
import sys
for name in ("jax", "jaxlib", "autoscaler_tpu"):
    sys.modules[name] = None
from autoscaler_tpu_torch.tools import analysis_probe as ap
out = ap.ladder_replay(ap.fault_ladder_doc(), "cpu")
rows = ap.ground_truth(ap.contract_worlds(2), "cpu")
print("OK", ap.replay_problems(out), ap.truth_problems(rows), len(rows))
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "OK [] [] 16", proc.stdout


INSTALL_MODULES = ("ops/build_kernels.py", "tools/install_probe.py")


def test_install_modules_are_ported():
    """The prebuild and chip_smoke's 3s2 probe are modules of the port,
    held by test_no_jax_import like every other."""
    for rel in INSTALL_MODULES:
        assert f"autoscaler_tpu_torch/{rel}" in PORT_FILES


def test_build_kernels_runs_with_jax_blocked(tmp_path):
    """``ops/build_kernels`` with jax and the JAX package blocked and no
    nvcc: the native library builds into the directory's native/, the CUDA
    sources fail naming the directory, and the exit is non-zero."""
    code = r"""
import contextlib, io, sys
for name in ("jax", "jaxlib", "autoscaler_tpu"):
    sys.modules[name] = None
from autoscaler_tpu_torch.ops import _build, build_kernels
def no_nvcc():
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
_build._nvcc = no_nvcc
err = io.StringIO()
with contextlib.redirect_stderr(err):
    rc = build_kernels.main(["--out", sys.argv[1]])
print("OK", rc, sys.argv[1] in err.getvalue(), "nvcc not found" in err.getvalue())
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "k")], cwd=str(REPO),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "OK 1 True True", proc.stdout
    assert [p.name.split("-")[0] for p in (tmp_path / "k" / "native").glob("*.so")] == [
        "libffd_serial"]


# -- the canned scenarios ----------------------------------------------------------


def test_canned_module_is_ported():
    """tools/canned (the canned scenarios in code, chip_smoke's 4v) is a
    module of the port, held by test_no_jax_import like every other."""
    assert "autoscaler_tpu_torch/tools/canned.py" in PORT_FILES


_CANNED_BLOCKED = r"""
import json, os, sys, tempfile
for name in ("jax", "jaxlib", "autoscaler_tpu", "grpc", "google.protobuf", "yaml"):
    sys.modules[name] = None
from autoscaler_tpu_torch.tools import canned, drill_probe
hashes = {n: canned.canonical_sha256(canned.doc(n)) for n in canned.NAMES}
d = tempfile.mkdtemp()
paths = canned.write_all(d)
plain = canned.run(canned.doc("skip_reasons"), "cpu")
fleet = canned.run(canned.doc("fleet_rolling_restart"), "cpu")
views = [drill_probe.comparable(plain["result"]), drill_probe.comparable(fleet["result"])]
seconds, again = canned.cpu_view("skip_reasons")
loaded = [m for m, mod in sys.modules.items() if mod is not None and (
    m == "autoscaler_tpu" or m.startswith(("autoscaler_tpu.", "jax", "grpc", "yaml")))]
assert not loaded, loaded
print("OK", len(hashes), len(os.listdir(d)), len(plain["ticks"]), len(views[1]["log"]),
      again == views[0], seconds > 0)
"""


def test_canned_runs_without_jax_grpc_protobuf_or_yaml():
    """As on the card's machine: with jax, the JAX package, grpc, protobuf
    and yaml blocked, the canned documents build, write and run on the CPU
    (a scenario tick by tick, a fleet scenario, 4v's CPU view)."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", _CANNED_BLOCKED], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "OK 15 15 20 24 True True", proc.stdout
