"""The harness on the CPU, at a tiny size: the result line, files found by
name, the trace's reduction, the worlds, and the guard against JAX.

    python -m pytest -q -p no:cacheprovider portbench/tests
"""
import ast
import json
import subprocess
import sys

import pytest
import torch

from portbench import trace
from portbench.run import FORBIDDEN, forbidden
from portbench.spec import ROOT, Spec
from portbench.tests.tiny import CELLS, run, tiny_root
from portbench.worlds import build_world, world_seed


@pytest.fixture
def spec(tmp_path):
    return Spec(tiny_root(tmp_path))


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_keys(spec, cell):
    result = run(spec, cell)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checked"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end()}
    for m in spec.end_to_end():
        assert result["metrics"][m["name"]]["unit"] == m["unit"]
        assert result["metrics"][m["name"]]["value"] > 0
    assert result["checked"] == {"answers_off": {"value": 0, "limit": 0}}
    json.dumps(result)


def test_traced_run_on_the_cpu_reads_no_device_metric(spec):
    """No card, no device trace: every per-layer reader stays silent."""
    result = run(spec, "burst.k2", traced=True)
    assert result["correct"] is True
    assert result["metrics"] == {}
    assert "busy_s" not in result["device"] and "breakdown" not in result


def test_cell_mix_and_metric_found_by_name(spec):
    """A later cell is new files and new entries: nothing is edited."""
    data = spec.data
    mix = json.loads((data / "traffic" / "closed-pool16-mib.json").read_text())
    mix.update(name="closed-pool2-mib", pool=2)
    (data / "traffic" / "closed-pool2-mib.json").write_text(json.dumps(mix))
    config = json.loads((data / "configs" / "scaleup-burst-30k-500g.json").read_text())
    config.update(name="wide-gpu", gpu_pod_share=0.5)
    (data / "configs" / "wide-gpu.json").write_text(json.dumps(config))
    (data / "metrics" / "requests.done.py").write_text(
        "def read(ctx):\n    return len(ctx['window'].done)\n")
    bench = spec.bench
    bench["configs"].append({"name": "wide-gpu", "source": "x", "file": "portbench/configs/wide-gpu.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "wide.k2", "config": "wide-gpu", "traffic": "closed-pool2-mib",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "requests.done", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "client",
                               "moves": "pod_groups_per_s", "workloads": ["wide.k2"]})
    (spec.root / "BENCHMARK.json").write_text(json.dumps(bench))
    fresh = Spec(spec.root)
    assert "requests.done" in [m["name"] for m in fresh.per_layer("wide.k2")]
    assert "requests.done" not in [m["name"] for m in fresh.per_layer("burst.k1")]
    result = run(fresh, "wide.k2", traced=True)
    assert result["correct"] is True
    assert result["metrics"]["requests.done"] == {"value": result["attempted"], "unit": "requests"}


def test_summarize_a_trace():
    dev = lambda n, s, e: trace.Ev(n, s, e, True, 1)   # noqa: E731
    host = lambda n, s, e: trace.Ev(n, s, e, False, 7)  # noqa: E731
    evs = [
        host(trace.WINDOW, 0, 100), host(trace.REQUEST, 0, 50), host(trace.REQUEST, 50, 100),
        host("portbench.upload", 0, 20), host("aten::copy_", 5, 20),
        dev("Memcpy HtoD (Pageable -> Device)", 10, 20), dev("void k<SwarFit>()", 20, 40),
        dev("void k<SwarFit>()", 70, 90), dev("other", 85, 95),
        dev("outside", 120, 130), trace.Ev("elsewhere", 0, 100, False, 9),
    ]
    s = trace.summarize(evs)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((30 + 25) * 1e-6)   # [10, 40] and [70, 95]
    assert trace.seconds_of(s.requests[0], "SwarFit") == pytest.approx(20e-6)
    assert trace.seconds_of(s.requests[1], "SwarFit") == pytest.approx(20e-6)
    assert trace.kernel_ms(s, "SwarFit") == pytest.approx(20e-3)
    gaps = dict(s.idle_gaps)
    assert gaps["aten::copy_"] == pytest.approx(10e-6)           # [0, 10]: its middle in the copy
    assert gaps[trace.REQUEST] == pytest.approx((30 + 5) * 1e-6)  # [40, 70] and [95, 100]
    assert "elsewhere" not in gaps
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)


def test_worlds_follow_the_seed():
    config = json.loads((ROOT / "portbench/configs/affinity-burst-30k-100g.json").read_text())
    config.update(pods=200, groups=4)
    mix = {"memory_unit": "Mi"}
    a = build_world(config, mix, world_seed(2**40 + 3, 0), "cpu", "a")
    b = build_world(config, mix, world_seed(2**40 + 3, 0), "cpu", "b")
    c = build_world(config, mix, world_seed(2**40 + 3, 1), "cpu", "c")
    assert (a.pod_req == b.pod_req).all() and (a.masks == b.masks).all()
    assert (a.terms["match"] == b.terms["match"]).all()
    assert not (a.pod_req == c.pod_req).all()
    assert world_seed(-5, 0) != world_seed(5, 0)
    assert (a.pod_req[:, 1] == a.pod_req[:, 1].round()).all()
    m = build_world(config, {"memory_unit": "M"}, world_seed(3, 0), "cpu", "m")
    mem = m.pod_req[:, 1]
    assert (mem >= 64).all() and (mem < 8192).all() and (mem != mem.round()).any()


def test_forbidden_compares_whole_top_level_names():
    assert forbidden(["autoscaler_tpu_torch", "autoscaler_tpu_torch.ops.ffd_scan", "jaxtyping",
                      "flaxen.x"]) == []
    assert forbidden(["jaxlib.xla_client", "autoscaler_tpu.ops", "jax", "flax.linen"]) == [
        "autoscaler_tpu", "flax", "jax", "jaxlib"]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sorted((ROOT / "portbench").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"
            # nothing reads the JAX package's benchmark files
            if isinstance(node, ast.Call) and path.name != "test_portbench_harness.py":
                for arg in ast.walk(node):
                    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                        assert not any(old in arg.value for old in
                                       ("benchmarks/", "bench.py", "chip_smoke")), path


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    root = tiny_root(tmp_path)
    code = (
        "import sys\n"
        "from portbench.spec import Spec\n"
        "from portbench.run import forbidden\n"
        "from portbench.tests.tiny import run\n"
        f"spec = Spec({str(root)!r})\n"
        "for cell in ('burst.k2', 'affinity.k3'):\n"
        "    assert run(spec, cell, seconds=0.2)['correct']\n"
        "print(forbidden(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "burst.k2", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and out.stdout == ""
