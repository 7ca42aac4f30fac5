"""The port's graftlint (``autoscaler_tpu_torch/analysis``) against the JAX
package's, on the JAX suite's own cases and on torch-form twins.

- Every case of ``tests/test_analysis.py`` runs on the port through
  ``torch_analysis_parity.AnalysisRebound`` (the package renamed in every
  fixture source, virtual path and expected message), except the ones
  listed in ``TWINNED`` and ``IN_TREE_FILE``.
- ``TWINNED`` cases use JAX call forms (``pallas_call``, ``jax.jit``) that
  the port's device rules do not read: each has a twin here in the port's
  forms (``ops/_build.load`` and calls on its handle; CUDA graph captures:
  ``capture_begin``/``capture_end`` and ``with torch.cuda.graph(...)``),
  and the twin must give the same rule ids on the same lines as the JAX
  fixture gives under the JAX package's analyzer (``same_sites``).
- ``IN_TREE_FILE``: the whole-tree scan runs in
  ``tests/test_torch_analysis_tree.py`` (a file of its own, so a
  distributed run spreads it).
- Planted violations: for each device rule, one violation planted in a copy
  of a real port module in a temporary directory must be found.
"""
from __future__ import annotations

import textwrap
from pathlib import Path

import pytest

import test_analysis
from autoscaler_tpu.analysis import analyze_sources as jax_analyze_sources
from autoscaler_tpu_torch.analysis import analyze_sources, scan_paths
from autoscaler_tpu_torch.analysis import rules as rules_mod
from autoscaler_tpu_torch.analysis.contracts import load_module_contracts
from torch_analysis_parity import AnalysisRebound, case_params, port_text, run_case

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "autoscaler_tpu_torch"

TWINNED = {
    "test_gl003_pallas_call_only_in_ops",
    "test_gl006_flags_print_under_partial_jit_decorator",
    "test_gl006_transitive_local_helper_and_metrics",
    "test_gl006_cross_module_transitive_reach",
    "test_gl006_relative_import_in_package_init_resolves",
    "test_explicit_rules_subset_skips_program_rules",
    "test_gl006_cross_module_respects_import_aliases",
    "test_gl006_nested_def_does_not_shadow_imported_name",
    "test_gl006_bare_call_resolves_to_function_not_method",
    "test_gl007_grid_via_local_variable",
    "test_gl007_real_ops_contracts_scan_clean_and_nonvacuous",
}
IN_TREE_FILE = {"test_repo_scans_clean_without_any_baseline"}

REBOUND = AnalysisRebound(test_analysis)


@pytest.mark.parametrize("name", case_params(test_analysis, TWINNED | IN_TREE_FILE))
def test_jax_case_on_port(name, request):
    run_case(REBOUND, name, request)


def test_every_jax_case_runs_on_the_port_or_has_a_twin():
    cases = set(case_params(test_analysis))
    assert TWINNED | IN_TREE_FILE <= cases
    twins = {n[len("test_twin_"):] for n in globals() if n.startswith("test_twin_")}
    assert {n[len("test_"):] for n in TWINNED} == twins


# -- twins in the port's forms ------------------------------------------------------


def _dedent(sources: dict) -> dict:
    return {p: textwrap.dedent(s) for p, s in sources.items()}


def sites(found) -> list:
    return sorted((port_text(f.path), f.line, f.rule) for f in found)


def same_sites(jax_sources: dict, port_sources: dict, **kw):
    """The JAX fixture under the JAX analyzer and its twin under the port's
    give the same rule ids on the same lines (paths under the port's name);
    → the port's findings."""
    want, _ = jax_analyze_sources(_dedent(jax_sources), **kw)
    got, _ = analyze_sources(_dedent(port_sources), **kw)
    assert sites(got) == sites(want)
    return got


def test_twin_gl003_pallas_call_only_in_ops():
    jax_src = """
        import jax.experimental.pallas as pl

        def f(kernel, x):
            return pl.pallas_call(kernel, out_shape=x)(x)
        """
    port_src = """
        from autoscaler_tpu_torch.ops import _build

        def f(kernel, x):
            return _build.load("ffd_scan").ffd_scan_f32(x.data_ptr())
        """
    found = same_sites({"autoscaler_tpu/estimator/fixture.py": jax_src},
                       {"autoscaler_tpu_torch/estimator/fixture.py": port_src})
    assert [f.rule for f in found] == ["GL003"]
    assert "kernel launch outside ops/" in found[0].message
    same_sites({"autoscaler_tpu/ops/fixture.py": jax_src},
               {"autoscaler_tpu_torch/ops/fixture.py": port_src})
    assert analyze_sources({"autoscaler_tpu_torch/ops/fixture.py": textwrap.dedent(
        port_src)})[0] == []


def test_gl003_reads_the_handle_a_load_returns():
    """A load bound to a name, then a launch on it (and through getattr),
    outside ops/: each line is a finding; a name not bound to a load is
    not."""
    found, _ = analyze_sources({"autoscaler_tpu_torch/core/fixture.py": textwrap.dedent("""
        from autoscaler_tpu_torch.ops import _build as b

        def f(lib_other, name):
            lib = b.load("fit_reduce")
            lib.fit_reduce(1)
            getattr(lib, name)(2)
            lib_other.fit_reduce(3)
        """)})
    assert sorted((f.line, f.rule) for f in found) == [
        (5, "GL003"), (6, "GL003"), (7, "GL003")]


def test_twin_gl006_flags_print_under_partial_jit_decorator():
    found = same_sites(
        {"autoscaler_tpu/ops/fixture.py": """
        from functools import partial
        import jax

        @partial(jax.jit, static_argnames=("n",))
        def kernel(x, n):
            print(x)
            return x * n
        """},
        {"autoscaler_tpu_torch/ops/fixture.py": """
        import torch
        graph = torch.cuda.CUDAGraph()

        # recorded below, in one CUDA graph
        def kernel(x, n):
            print(x)
            return x * n

        with torch.cuda.graph(graph):
            kernel(None, 2)
        """},
    )
    assert [f.rule for f in found] == ["GL006"]
    assert "print()" in found[0].message
    assert "CUDA graph capture" in found[0].message


def test_twin_gl006_transitive_local_helper_and_metrics():
    found = same_sites(
        {"autoscaler_tpu/ops/fixture.py": """
        import jax

        def helper(m, x):
            m.metrics.dispatches.inc()
            return x

        def outer(m, x):
            return jax.jit(traced)(x)

        def traced(x):
            return helper(None, x)
        """},
        {"autoscaler_tpu_torch/ops/fixture.py": """
        import torch

        def helper(m, x):
            m.metrics.dispatches.inc()
            return x

        def outer(m, x, g):
            with torch.cuda.graph(g): traced(x)

        def traced(x):
            return helper(None, x)
        """},
    )
    assert [f.rule for f in found] == ["GL006"]
    assert "metrics" in found[0].message


def test_gl006_host_side_effects_outside_a_capture_ok():
    found, _ = analyze_sources({"autoscaler_tpu_torch/ops/fixture.py": textwrap.dedent("""
        import torch

        def step(x):
            return x + 1

        def host(m, g, x):
            print("capturing")
            m.metrics.dispatches.inc()
            g.capture_begin()
            step(x)
            g.capture_end()
            print("captured")
            g.replay()
        """)})
    assert found == []


_HELPERS_LEAKY = """
    def leaky(x):
        print(x)
        return x
    """


def test_twin_gl006_cross_module_transitive_reach():
    found = same_sites(
        {"autoscaler_tpu/ops/kernel.py": """
            import jax
            from autoscaler_tpu.snapshot.helpers import leaky

            @jax.jit
            def kernel(x):
                return leaky(x)
            """,
         "autoscaler_tpu/snapshot/helpers.py": _HELPERS_LEAKY},
        {"autoscaler_tpu_torch/ops/kernel.py": """
            import torch
            from autoscaler_tpu_torch.snapshot.helpers import leaky

            class Step:
                def kernel(self, x):
                    return leaky(x)

                def capture(self, x):
                    graph = torch.cuda.CUDAGraph()
                    graph.capture_begin(capture_error_mode="thread_local")
                    for _ in range(4):
                        self.kernel(x)
                    graph.capture_end()
                    return graph
            """,
         "autoscaler_tpu_torch/snapshot/helpers.py": _HELPERS_LEAKY},
    )
    assert [f.rule for f in found] == ["GL006"]
    assert found[0].path == "autoscaler_tpu_torch/snapshot/helpers.py"
    assert "print()" in found[0].message


def test_twin_gl006_relative_import_in_package_init_resolves():
    found = same_sites(
        {"autoscaler_tpu/snapshot/__init__.py": """
            import jax
            from .helpers import leaky

            @jax.jit
            def reexported_kernel(x):
                return leaky(x)
            """,
         "autoscaler_tpu/snapshot/helpers.py": _HELPERS_LEAKY},
        {"autoscaler_tpu_torch/snapshot/__init__.py": """
            import torch
            from .helpers import leaky

            def reexported_kernel(x):
                return leaky(x)

            def capture(g, x):
                with torch.cuda.graph(g):
                    reexported_kernel(x)
            """,
         "autoscaler_tpu_torch/snapshot/helpers.py": _HELPERS_LEAKY},
    )
    assert [f.rule for f in found] == ["GL006"]
    assert found[0].path == "autoscaler_tpu_torch/snapshot/helpers.py"


def test_twin_explicit_rules_subset_skips_program_rules():
    jax_src = {"autoscaler_tpu/ops/kernel.py": """
            import jax

            @jax.jit
            def kernel(x):
                print(x)
                return x
            """}
    port_src = {"autoscaler_tpu_torch/ops/kernel.py": """
            import torch

            # captured by capture() below
            def kernel(x):
                print(x)
                return x

            def capture(g, x):
                with torch.cuda.graph(g):
                    kernel(x)
            """}
    from autoscaler_tpu.analysis import rules as jax_rules

    want, _ = jax_analyze_sources(_dedent(jax_src), rules=[jax_rules.WallClockInReplayPath()])
    scoped, _ = analyze_sources(_dedent(port_src), rules=[rules_mod.WallClockInReplayPath()])
    assert scoped == want == []
    default = same_sites(jax_src, port_src)
    assert [f.rule for f in default] == ["GL006"]
    want, _ = jax_analyze_sources(_dedent(jax_src), rules=(),
                                  program_rules=[jax_rules.JitPurity()])
    explicit, _ = analyze_sources(_dedent(port_src), rules=(),
                                  program_rules=[rules_mod.JitPurity()])
    assert sites(explicit) == sites(want) and [f.rule for f in explicit] == ["GL006"]


def test_twin_gl006_cross_module_respects_import_aliases():
    found = same_sites(
        {"autoscaler_tpu/ops/kernel.py": """
            import jax
            from autoscaler_tpu.snapshot.helpers import leaky as quiet

            def outer(x):
                return jax.jit(traced)(x)

            def traced(x):
                return quiet(x)
            """,
         "autoscaler_tpu/snapshot/helpers.py": _HELPERS_LEAKY},
        {"autoscaler_tpu_torch/ops/kernel.py": """
            import torch
            from autoscaler_tpu_torch.snapshot.helpers import leaky as quiet

            def outer(x, g):
                with torch.cuda.graph(g):
                    traced(x)

            def traced(x):
                return quiet(x)
            """,
         "autoscaler_tpu_torch/snapshot/helpers.py": _HELPERS_LEAKY},
    )
    assert [f.rule for f in found] == ["GL006"]


def test_gl006_unreached_cross_module_helper_not_flagged_in_port_forms():
    found, _ = analyze_sources(_dedent({
        "autoscaler_tpu_torch/ops/kernel.py": """
            import torch
            from autoscaler_tpu_torch.snapshot.helpers import leaky

            def step(x):
                return x + 1

            def host(g, x):
                with torch.cuda.graph(g):
                    step(x)
                return leaky(x)
            """,
        "autoscaler_tpu_torch/snapshot/helpers.py": _HELPERS_LEAKY,
    }))
    assert found == []


def test_twin_gl006_nested_def_does_not_shadow_imported_name():
    jax_factory = """
        import jax
        from autoscaler_tpu.snapshot.helpers import {NAME}

        def factory():
            def {NAME}(x):
                {BODY}
                return x
            return {NAME}

        @jax.jit
        def kernel(x):
            return {NAME}(x)
        """
    port_factory = """
        import torch
        from autoscaler_tpu_torch.snapshot.helpers import {NAME}

        def factory():
            def {NAME}(x):
                {BODY}
                return x
            return {NAME}

        def kernel(x):
            return {NAME}(x)

        def capture(g, x):
            with torch.cuda.graph(g):
                kernel(x)
        """
    quiet = """
        def quiet(x):
            return x
        """
    clean = same_sites(
        {"autoscaler_tpu/ops/kernel.py": textwrap.dedent(jax_factory).format(
            NAME="quiet", BODY="print(x)"), "autoscaler_tpu/snapshot/helpers.py": quiet},
        {"autoscaler_tpu_torch/ops/kernel.py": textwrap.dedent(port_factory).format(
            NAME="quiet", BODY="print(x)"), "autoscaler_tpu_torch/snapshot/helpers.py": quiet},
    )
    assert clean == []
    leaky = same_sites(
        {"autoscaler_tpu/ops/kernel.py": textwrap.dedent(jax_factory).format(
            NAME="leaky", BODY="pass"), "autoscaler_tpu/snapshot/helpers.py": _HELPERS_LEAKY},
        {"autoscaler_tpu_torch/ops/kernel.py": textwrap.dedent(port_factory).format(
            NAME="leaky", BODY="pass"),
         "autoscaler_tpu_torch/snapshot/helpers.py": _HELPERS_LEAKY},
    )
    assert [f.rule for f in leaky] == ["GL006"]
    assert leaky[0].path == "autoscaler_tpu_torch/snapshot/helpers.py"


def test_twin_gl006_bare_call_resolves_to_function_not_method():
    found = same_sites(
        {"autoscaler_tpu/ops/kernel.py": """
            import jax

            class B:
                def helper(self):
                    return 1

            def helper(x):
                print(x)
                return x

            @jax.jit
            def kernel(x):
                return helper(x)
            """},
        {"autoscaler_tpu_torch/ops/kernel.py": """
            import torch

            class B:
                def helper(self):
                    return 1

            def helper(x):
                print(x)
                return x

            def kernel(g, x):
                with torch.cuda.graph(g):
                    helper(x)
            """},
    )
    assert [f.rule for f in found] == ["GL006"]


_PORT_KERNEL_MODULE = test_analysis._KERNEL_MODULE.replace(
    "    import jax\n    from jax.experimental import pallas as pl\n",
    "    import torch\n    from autoscaler_tpu_torch.ops import _build\n",
).replace("pl.pallas_call(", "_build.load(\"my_kernel\").launch(")


def test_twin_gl007_grid_via_local_variable():
    """A launch whose grid is a local (``grid = (...)`` then
    ``launch(..., grid=grid)``) is matched against the declared grid, and
    drift between the two is caught."""
    def var_grid(module):
        return module.replace(
            "            grid=(P_pad // chunk,),\n",
            "            grid=grid,\n",
        ).replace("        P_pad = P + (-P) % chunk\n",
                  "        P_pad = P + (-P) % chunk\n        grid = (P_pad // chunk,)\n")

    jax_mod, port_mod = var_grid(test_analysis._KERNEL_MODULE), var_grid(_PORT_KERNEL_MODULE)
    assert "grid = (P_pad // chunk,)" in port_mod and "launch(" in port_mod
    assert same_sites({"autoscaler_tpu/ops/mykernel.py": jax_mod},
                      {"autoscaler_tpu_torch/ops/mykernel.py": port_mod}) == []
    drift = ('"grid": ["P_pad // chunk"],', '"grid": ["P_pad // chunk", "N_pad // chunk"],')
    drifted = same_sites({"autoscaler_tpu/ops/mykernel.py": jax_mod.replace(*drift)},
                         {"autoscaler_tpu_torch/ops/mykernel.py": port_mod.replace(*drift)})
    assert "GL007" in [f.rule for f in drifted]
    assert any("no launch in the module uses it" in f.message for f in drifted)


def test_twin_gl007_real_ops_contracts_scan_clean_and_nonvacuous():
    """The port's ops/ contracts hold over its real dispatch paths (no
    findings), and every kernel entry of the port declares one."""
    contracts, consts = load_module_contracts(str(PORT / "ops" / "ffd_scan.py"))
    assert {"ffd_binpack_groups_cuda", "ffd_binpack_scenarios_cuda", "ffd_scan_f32",
            "ffd_scan_swar"} <= set(contracts)
    assert consts["STEP_BLOCK"] == 32
    entries = {
        "ffd_scan_affinity.py": {"ffd_binpack_groups_affinity_cuda"},
        "fit_reduce.py": {"fit_reduce_cuda", "fit_reduce_rows"},
        "histogram.py": {"ordered_scatter_add"},
    }
    for module, names in entries.items():
        assert names <= set(load_module_contracts(str(PORT / "ops" / module))[0]), module
    assert contracts["ffd_binpack_groups_cuda"]["smem"] == "smem_bytes"
    assert scan_paths([str(PORT / "ops")]) == []


# -- GL014 / GL015 in the port's forms ---------------------------------------------


def test_gl014_torch_sync_forms():
    """.item(), .cpu(), .numpy() and .synchronize() always; .tolist(),
    float() and np.asarray() of a value a torch call built."""
    src = textwrap.dedent("""
        import numpy as np
        import torch


        def run_once(state):
            return _score(state)


        def _score(state):
            total = torch.sum(state.load)
            a = total.item()
            b = state.load.cpu()
            c = state.load.numpy()
            torch.cuda.synchronize()
            state.stream.synchronize()
            d = total.tolist()
            e = float(total)
            f = np.asarray(total)
            g = state.rows.tolist()
            h = float(state.rows)
            return a, b, c, d, e, f, g, h
        """)
    found, _ = analyze_sources({"autoscaler_tpu_torch/core/sync.py": src})
    assert [(f.line, f.rule) for f in found] == [
        (12, "GL014"), (13, "GL014"), (14, "GL014"), (15, "GL014"), (16, "GL014"),
        (17, "GL014"), (18, "GL014"), (19, "GL014")]
    assert "run_once -> _score" in found[0].message
    found, _ = analyze_sources({"autoscaler_tpu_torch/perf/sync.py": src})
    assert found == []


def test_gl015_captured_step_hazards_and_static_forms():
    src = textwrap.dedent("""
        import torch


        class Loop:
            def step(self, j: int, x: torch.Tensor, n, mode):
                y = torch.where(x > 0, x, -x)
                if y.sum() > 0:
                    pass
                if x.any():
                    pass
                while y.max() > 1:
                    y = y / 2
                for _ in range(n):
                    pass
                for _ in range(x.shape[0]):
                    pass
                if self.spread is not None and mode == "zone" and j > 0:
                    pass
                for _ in range(3):
                    pass

            def capture(self, x):
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin()
                for j in range(4):
                    self.step(j, x, 2, "zone")
                graph.capture_end()
                return graph
        """)
    found, _ = analyze_sources({"autoscaler_tpu_torch/ops/loop.py": src})
    assert [(f.line, f.rule) for f in found] == [
        (8, "GL015"), (10, "GL015"), (12, "GL015"), (14, "GL015"), (16, "GL015")]
    assert "captured step()" in found[0].message
    found, _ = analyze_sources({"autoscaler_tpu_torch/core/loop.py": src})
    assert found == []  # GL015's roots live in ops/ and estimator/


# -- planted violations in copies of real port modules ------------------------------


def _plant(tmp_path, module: str, old: str, new: str) -> Path:
    """A copy of the port module ``module`` with ``old`` replaced once by
    ``new``, under ``tmp_path/autoscaler_tpu_torch/``."""
    src = (PORT / module).read_text(encoding="utf-8")
    assert src.count(old) == 1, (module, old)
    out = tmp_path / "autoscaler_tpu_torch" / module
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src.replace(old, new, 1), encoding="utf-8")
    return out


def _copy(tmp_path, module: str) -> Path:
    out = tmp_path / "autoscaler_tpu_torch" / module
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text((PORT / module).read_text(encoding="utf-8"), encoding="utf-8")
    return out


def _line_of(path: Path, text: str) -> int:
    return next(i for i, line in enumerate(path.read_text().splitlines(), 1) if text in line)


def test_planted_gl003_kernel_load_under_core(tmp_path):
    path = _plant(
        tmp_path, "core/static_autoscaler.py",
        "    def run_once(self, now_ts: float) -> RunOnceResult:",
        "    def _planted(self):\n"
        "        from autoscaler_tpu_torch.ops import _build\n"
        "        return _build.load(\"ffd_scan\").ffd_scan_smem_bytes(1, 1)\n\n"
        "    def run_once(self, now_ts: float) -> RunOnceResult:",
    )
    assert scan_paths([str(tmp_path / "autoscaler_tpu_torch" / "ops")]) == []
    found = scan_paths([str(path)])
    assert [(f.line, f.rule) for f in found] == [(_line_of(path, "_build.load("), "GL003")]


def test_planted_gl006_print_in_the_greedy_loops_captured_step(tmp_path):
    path = _plant(tmp_path, "ops/schedule.py", "        self.place[j:j + 1] = place\n",
                  "        print(j)\n        self.place[j:j + 1] = place\n")
    assert scan_paths([str(_copy(tmp_path / "clean", "ops/schedule.py"))]) == []
    found = scan_paths([str(path)])
    assert [(f.line, f.rule) for f in found] == [(_line_of(path, "print(j)"), "GL006")]
    assert "step()" in found[0].message


def test_planted_gl007_pad_multiple_disagrees_with_step_block(tmp_path):
    src = (PORT / "ops/ffd_scan.py").read_text()
    entry = src.index('    "ffd_scan_f32": {')
    pad = '"pad": {"P_pad": ["P", "STEP_BLOCK"]},'
    at = src.index(pad, entry)
    path = tmp_path / "autoscaler_tpu_torch" / "ops" / "ffd_scan.py"
    path.parent.mkdir(parents=True)
    path.write_text(src[:at] + '"pad": {"P_pad": ["P", 16]},' + src[at + len(pad):])
    assert scan_paths([str(_copy(tmp_path / "clean", "ops/ffd_scan.py"))]) == []
    found = scan_paths([str(path)])
    assert [f.rule for f in found] == ["GL007"]
    assert "ffd_scan_f32() declares padding P_pad = pad(P, 16)" in found[0].message


def test_planted_gl014_item_on_the_run_once_path(tmp_path):
    """``.item()`` in ``IncrementalPacker.device_bytes``, which the call
    graph reaches from ``StaticAutoscaler.run_once`` (no estimator function
    is on that reach: the estimate is dispatched through the ladder's
    rung table, which the graph does not follow, as in the JAX package)."""
    _copy(tmp_path, "core/static_autoscaler.py")
    clean = scan_paths([str(tmp_path / "autoscaler_tpu_torch")])
    assert [f for f in clean if f.rule == "GL014"] == []
    src = (PORT / "snapshot/incremental.py").read_text()
    head = src.index("    def device_bytes(self)")
    body = src.index("        return", head)
    path = _plant(tmp_path, "snapshot/incremental.py", src[head:body + len("        return")],
                  src[head:body] + "        torch.zeros(1).item()\n        return")
    found = [f for f in scan_paths([str(tmp_path / "autoscaler_tpu_torch")]) if f.rule == "GL014"]
    assert [(f.path, f.line) for f in found] == [
        ("autoscaler_tpu_torch/snapshot/incremental.py", _line_of(path, "torch.zeros(1).item()"))]
    assert "run_once" in found[0].message and "device_bytes" in found[0].message


def test_planted_gl015_branch_and_loop_in_the_preemption_step(tmp_path):
    path = _plant(tmp_path, "ops/preempt.py", "        self.place[j] = place\n",
                  "        if fit_k.any():\n            pass\n"
                  "        for _ in range(j):\n            pass\n"
                  "        self.place[j] = place\n")
    found = scan_paths([str(path)])
    assert [(f.line, f.rule) for f in found] == [
        (_line_of(path, "if fit_k.any():"), "GL015"),
        (_line_of(path, "for _ in range(j):"), "GL015")]
