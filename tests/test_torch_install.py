"""The port as it is installed and started: a wheel built from the tree
ships every kernel source and the port's rule catalog, its console
scripts' targets import from an install with jax blocked, the kernels'
default directory of an install lies outside it, ``ops/_build`` and
``ops/build_kernels`` with the compiler and ``ctypes.CDLL`` stood in for,
``main``'s start on a card (loads before the first tick, ends before it on
a missing library), and tools/install_probe's installed copy and its runs
on the CPU."""
import ctypes
import json
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import autoscaler_tpu_torch.main as tmain
from autoscaler_tpu_torch import native_bridge
from autoscaler_tpu_torch.ops import _build, build_kernels
from autoscaler_tpu_torch.tools import bound_loop, install_probe, loop_probe
from autoscaler_tpu_torch.utils.workload import build_snapshot_world

REPO = Path(__file__).resolve().parent.parent
PORT_SCRIPTS = {
    "tpu-autoscaler-torch": "autoscaler_tpu_torch.main:main",
    "tpu-autoscaler-torch-vpa": "autoscaler_tpu_torch.vpa.main:main",
    "tpu-autoscaler-torch-nanny": "autoscaler_tpu_torch.addonresizer.main:main",
    "graftlint-torch": "autoscaler_tpu_torch.analysis.cli:main",
}
SOURCES = sorted([f"autoscaler_tpu_torch/csrc/{name}.cu" for name in _build.SIGNATURES]
                 + [native_bridge.SRC.relative_to(REPO).as_posix()])


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """A wheel built offline from a copy of pyproject.toml, README.md and
    both packages (setuptools writes build/ and *.egg-info beside them)."""
    tmp = tmp_path_factory.mktemp("wheel")
    src = tmp / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy2(REPO / name, src / name)
    for pkg in ("autoscaler_tpu", "autoscaler_tpu_torch"):
        shutil.copytree(REPO / pkg, src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__", "lint-baseline.json"))
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "-q", "-w", str(tmp / "dist"), str(src)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (path,) = (tmp / "dist").glob("*.whl")
    return path


@pytest.fixture(scope="module")
def installed(wheel, tmp_path_factory):
    """The wheel installed into a directory of its own (pip --target)."""
    target = tmp_path_factory.mktemp("site") / "lib"
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-deps", "--no-index", "-q",
         "--target", str(target), str(wheel)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return target


def wheel_names(wheel):
    with zipfile.ZipFile(wheel) as z:
        return set(z.namelist())


@pytest.mark.parametrize("rel", SOURCES + ["autoscaler_tpu_torch/analysis/RULES.md"])
def test_wheel_ships_the_kernel_sources_and_the_rules(wheel, rel):
    assert rel in wheel_names(wheel)


def test_wheel_names_the_port_console_scripts(wheel):
    """The port's four console scripts beside the JAX package's, which stay."""
    with zipfile.ZipFile(wheel) as z:
        entry = next(n for n in z.namelist() if n.endswith("entry_points.txt"))
        text = z.read(entry).decode()
    lines = {line.split(" = ")[0]: line.split(" = ")[1]
             for line in text.splitlines() if " = " in line}
    for script, target in PORT_SCRIPTS.items():
        assert lines.get(script) == target, (script, lines)
    assert lines["tpu-autoscaler"] == "autoscaler_tpu.main:main"
    assert lines["graftlint"] == "autoscaler_tpu.analysis.cli:main"


def test_installed_copy_holds_what_the_wheel_ships(wheel, tmp_path):
    """tools/install_probe's copy (chip_smoke's 3s2) holds exactly the
    wheel's files of the port."""
    port = {n for n in wheel_names(wheel) if n.startswith("autoscaler_tpu_torch/")}
    assert set(install_probe.shipped(REPO)) == port
    copy = install_probe.installed_copy(REPO, tmp_path / "site")
    assert set(install_probe.tree_state(copy)) == port


_INSTALLED = r"""
import contextlib, importlib, io, json, sys
for name in ("jax", "jaxlib", "autoscaler_tpu"):
    sys.modules[name] = None
targets = json.loads(sys.argv[1])
for script, target in targets.items():
    module, fn = target.split(":")
    assert callable(getattr(importlib.import_module(module), fn)), script
from autoscaler_tpu_torch import native_bridge
from autoscaler_tpu_torch.analysis import cli
from autoscaler_tpu_torch.ops import _build
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = cli.main(["--explain", "GL001"])
print(json.dumps({"rc": rc, "explain": buf.getvalue(), "module": _build.__file__,
                  "kernels": str(_build.BUILD_DIR), "native": str(native_bridge.lib_path().parent),
                  "default": str(_build.default_dir())}))
"""


def test_installed_console_scripts_run_with_jax_blocked(installed, tmp_path):
    """From the install, with jax and the JAX package blocked: every port
    console script's target imports, ``graftlint-torch --explain GL001``
    prints its section, and the kernels' default directory (and the native
    rung's beside it) lies outside the install location."""

    env = {**os.environ, "PYTHONPATH": str(installed)}
    proc = subprocess.run([sys.executable, "-c", _INSTALLED, json.dumps(PORT_SCRIPTS)],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["rc"] == 0 and out["explain"].startswith("## GL001"), out["explain"][:200]
    assert Path(out["module"]).is_relative_to(installed)
    kernels = Path(out["kernels"])
    assert kernels == Path(out["default"]) == Path(sys.prefix) / "share" / \
        "autoscaler_tpu_torch" / "kernels"
    assert not kernels.is_relative_to(installed)
    assert Path(out["native"]) == kernels / "native"
    # the generated script itself
    script = installed / "bin" / "graftlint-torch"
    run = subprocess.run([sys.executable, str(script), "--explain", "GL001"], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and "## GL001" in run.stdout, run.stderr[-2000:]


# -- ops/_build with the compiler and ctypes.CDLL stood in for


class FakeLib:
    """What ``ctypes.CDLL`` returns: an attribute for every entry point."""
    opened = []

    def __init__(self, path):
        self.path = path
        FakeLib.opened.append(Path(path))

    def __getattr__(self, name):
        fn = SimpleNamespace()
        setattr(self, name, fn)
        return fn


class FakeNvcc:
    """A finished ``nvcc`` that writes its ``-o`` file and a ptxas line."""

    def __init__(self, cmd, **kwargs):
        out = Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"fake library")
        self.returncode = 0

    def communicate(self, timeout=None):
        return "", "ptxas info    : Used 40 registers, used 1 barriers\n"


@pytest.fixture()
def stand_ins(monkeypatch, tmp_path):
    """``BUILD_DIR`` on an empty ``tmp_path``, no library loaded, ``CDLL``
    a FakeLib; → a list the compiler stand-in appends its commands to."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(FakeLib, "opened", [])
    started = []

    def popen(cmd, **kwargs):
        started.append(cmd)
        return FakeNvcc(cmd, **kwargs)

    monkeypatch.setattr(_build.subprocess, "Popen", popen)
    return started


def no_nvcc():
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def prebuilt(names):
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        _build._lib_path(name).write_bytes(b"prebuilt")
        _build._lib_path(name).with_suffix(".log").write_text("ptxas info    : Used 32 registers")


def test_a_present_library_loads_and_no_compiler_starts(stand_ins, monkeypatch):
    prebuilt(_build.LOOP_SOURCES)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    before = _build.COMPILERS_STARTED
    secs, compilers = _build.preload(*_build.LOOP_SOURCES)
    assert compilers == 0 and _build.COMPILERS_STARTED == before and stand_ins == []
    assert FakeLib.opened == [_build._lib_path(n) for n in _build.LOOP_SOURCES]
    assert set(_build._LIBS) == set(_build.LOOP_SOURCES)
    # argtypes and restype set on every entry point of each library
    lib = _build._LIBS["fit_reduce"]
    assert lib.fit_reduce.restype is ctypes.c_int and lib.fit_reduce_rows.argtypes
    assert "Used 32 registers" in _build.BUILD_LOGS["ffd_scan"]


def test_a_missing_library_without_nvcc_raises_naming_the_directory(stand_ins, monkeypatch):
    prebuilt(["ffd_scan"])
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError) as err:
        _build.preload(*_build.LOOP_SOURCES)
    msg = str(err.value)
    assert msg.startswith("nvcc not found") and str(_build.BUILD_DIR) in msg
    for name in ("ffd_scan_affinity", "fit_reduce"):
        assert str(_build.source(name)) in msg and _build._key(name) in msg
    assert "ffd_scan.cu" not in msg.replace("ffd_scan_affinity.cu", "")
    assert _build._LIBS == {} and stand_ins == []


def test_missing_libraries_build_at_once_one_compiler_each(stand_ins, monkeypatch):
    prebuilt(["fit_reduce"])
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc-stand-in")
    before = _build.COMPILERS_STARTED
    secs, compilers = _build.preload(*_build.LOOP_SOURCES)
    assert compilers == 2 == _build.COMPILERS_STARTED - before
    assert [cmd[0] for cmd in stand_ins] == ["nvcc-stand-in"] * 2
    assert [Path(cmd[-1]).name for cmd in stand_ins] == ["ffd_scan.cu", "ffd_scan_affinity.cu"]
    for name in _build.LOOP_SOURCES:
        assert _build._lib_path(name).is_file()
    assert "Used 40 registers" in _build.BUILD_LOGS["ffd_scan_affinity"]
    # a second start finds them all
    monkeypatch.setattr(_build, "_LIBS", {})
    assert _build.preload(*_build.LOOP_SOURCES)[1] == 0


def test_build_dir_moves_both_directories_and_restores_them(tmp_path):
    """The native rung's library follows ``BUILD_DIR`` into its native/."""
    before = _build.BUILD_DIR, native_bridge.lib_path()
    with _build.build_dir(tmp_path / "k") as chosen:
        assert chosen == _build.BUILD_DIR == tmp_path / "k"
        assert native_bridge.lib_path().parent == tmp_path / "k" / "native"
        assert _build._lib_path("histogram").parent == tmp_path / "k"
    assert (_build.BUILD_DIR, native_bridge.lib_path()) == before


def test_default_directory_is_build_kernels_of_the_checkout():
    assert _build.default_dir() == REPO / "build" / "kernels"


def test_build_kernels_builds_every_library(stand_ins, monkeypatch, tmp_path, capsys):
    """``python -m autoscaler_tpu_torch.ops.build_kernels --out DIR``: one
    nvcc a CUDA source and the native library, all into DIR, each path and
    ptxas report printed; the directories come back after it."""
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc-stand-in")
    natives = []

    def gxx(lib):
        natives.append(lib)
        lib.parent.mkdir(parents=True, exist_ok=True)
        lib.write_bytes(b"native")

    monkeypatch.setattr(native_bridge, "build", gxx)
    out = tmp_path / "prebuilt"
    assert build_kernels.main(["--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert [Path(cmd[-1]).stem for cmd in stand_ins] == list(_build.SIGNATURES)
    assert natives == [out / "native" / native_bridge.lib_path().name]
    with _build.build_dir(out):
        for name in _build.SIGNATURES:
            assert f"{name}: {_build._lib_path(name)}" in text
        assert f"ffd_serial: {native_bridge.lib_path()}" in text
    assert "Used 40 registers" in text
    assert _build.BUILD_DIR == tmp_path / "kernels"


def test_build_kernels_fails_without_nvcc(stand_ins, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(native_bridge, "build", lambda lib: None)
    assert build_kernels.main(["--out", str(tmp_path / "none")]) == 1
    err = capsys.readouterr().err
    assert "nvcc not found" in err and str(tmp_path / "none") in err


def test_build_kernels_fails_when_the_native_build_fails(stand_ins, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc-stand-in")

    def broken(lib):
        raise RuntimeError("g++ failed on ffd_serial.cpp (exit 1)")

    monkeypatch.setattr(native_bridge, "build", broken)
    assert build_kernels.main(["--out", str(tmp_path / "k")]) == 1
    assert "g++ failed" in capsys.readouterr().err


# -- main's start on a card, stood in for on the CPU

MAIN_ARGV = ["--max-iterations=2", "--scan-interval=0", "--address=127.0.0.1:0", "--device=cpu"]


@pytest.fixture()
def as_on_a_card(monkeypatch):
    """main's start as on a card (its loop stays on the CPU) and a record
    of the order of library loads and ticks."""
    from autoscaler_tpu_torch.core.static_autoscaler import StaticAutoscaler

    events = []
    real_preload, real_run_once = tmain.preload_kernels, StaticAutoscaler.run_once
    monkeypatch.setattr(tmain, "preload_kernels",
                        lambda device: real_preload(torch.device("cuda", 0)))
    monkeypatch.setattr(FakeLib, "__init__", lambda self, path: events.append("load"))

    def run_once(self, now_ts):
        events.append("tick")
        return real_run_once(self, now_ts)

    monkeypatch.setattr(StaticAutoscaler, "run_once", run_once)
    return events


def test_main_loads_every_loop_library_before_the_first_tick(stand_ins, monkeypatch,
                                                              as_on_a_card, tmp_path, capsys):
    with _build.build_dir(tmp_path / "prebuilt"):
        prebuilt(_build.LOOP_SOURCES)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert tmain.main(MAIN_ARGV + [f"--compile-cache-dir={tmp_path / 'prebuilt'}"]) == 0
    assert as_on_a_card == ["load"] * 3 + ["tick"] * 2
    start = install_probe.START_LINE.search(capsys.readouterr().out)
    assert start and start.group("dir") == str(tmp_path / "prebuilt")
    assert start.group("compilers") == "0" and stand_ins == []


def test_main_builds_the_missing_libraries_at_the_start(stand_ins, monkeypatch, as_on_a_card,
                                                        tmp_path, capsys):
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc-stand-in")
    assert tmain.main(MAIN_ARGV + [f"--compile-cache-dir={tmp_path / 'empty'}"]) == 0
    assert len(stand_ins) == len(_build.LOOP_SOURCES)
    assert as_on_a_card == ["load"] * 3 + ["tick"] * 2
    start = install_probe.START_LINE.search(capsys.readouterr().out)
    assert start.group("compilers") == str(len(_build.LOOP_SOURCES))


def test_main_ends_before_any_tick_on_a_missing_library(stand_ins, monkeypatch, as_on_a_card,
                                                        tmp_path, capsys):
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert tmain.main(MAIN_ARGV + [f"--compile-cache-dir={tmp_path / 'empty'}"]) == 1
    assert as_on_a_card == []
    err = capsys.readouterr().err
    assert "nvcc not found" in err and str(tmp_path / "empty") in err


def test_main_on_the_cpu_builds_and_loads_nothing(stand_ins, monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert tmain.main(MAIN_ARGV + [f"--compile-cache-dir={tmp_path / 'empty'}"]) == 0
    assert stand_ins == [] and FakeLib.opened == [] and _build._LIBS == {}
    assert not (tmp_path / "empty").exists()



# -- the sidecar launcher's start on a card, stood in for on the CPU


class Served(Exception):
    """Raised where the launcher would bind its port."""


@pytest.fixture()
def sidecar_as_on_a_card(monkeypatch):
    """The sidecar launcher's start as on a card, stopped where it would
    serve; → the order of library loads, the coalescer and the bind."""
    from autoscaler_tpu_torch.rpc import __main__ as rpc_main

    events = []
    real_preload = rpc_main.preload_kernels
    monkeypatch.setattr(rpc_main, "preload_kernels",
                        lambda device: real_preload(torch.device("cuda", 0)))
    monkeypatch.setattr(FakeLib, "__init__", lambda self, path: events.append("load"))
    monkeypatch.setattr(rpc_main, "FleetCoalescer", SimpleNamespace(
        from_options=lambda options, device: events.append("fleet")))

    def serve(*args, **kwargs):
        events.append("serve")
        raise Served

    monkeypatch.setattr(rpc_main, "serve", serve)
    return rpc_main, events


SIDECAR_ARGV = ["--address", "127.0.0.1:0", "--device", "cpu", "--health-port", "0"]


def test_sidecar_loads_every_loop_library_before_it_serves(stand_ins, monkeypatch,
                                                           sidecar_as_on_a_card, tmp_path,
                                                           capsys):
    rpc_main, events = sidecar_as_on_a_card
    with _build.build_dir(tmp_path / "prebuilt"):
        prebuilt(_build.LOOP_SOURCES)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    with pytest.raises(Served):
        rpc_main.main(SIDECAR_ARGV + ["--compile-cache-dir", str(tmp_path / "prebuilt")])
    assert events == ["load"] * 3 + ["fleet", "serve"] and stand_ins == []
    start = install_probe.START_LINE.search(capsys.readouterr().out)
    assert start and start.group("dir") == str(tmp_path / "prebuilt")
    assert start.group("compilers") == "0"
    assert _build.BUILD_DIR == tmp_path / "kernels"


def test_sidecar_ends_before_serving_on_a_missing_library(stand_ins, monkeypatch,
                                                          sidecar_as_on_a_card, tmp_path,
                                                          capsys):
    rpc_main, events = sidecar_as_on_a_card
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert rpc_main.main(SIDECAR_ARGV) == 1
    assert events == []
    err = capsys.readouterr().err
    assert "nvcc not found" in err and str(tmp_path / "kernels") in err


def test_sidecar_on_the_cpu_loads_nothing(stand_ins, monkeypatch, sidecar_as_on_a_card, tmp_path):
    rpc_main, events = sidecar_as_on_a_card
    monkeypatch.setattr(rpc_main, "preload_kernels", tmain.preload_kernels)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    with pytest.raises(Served):
        rpc_main.main(SIDECAR_ARGV + ["--compile-cache-dir", str(tmp_path / "empty")])
    assert events == ["fleet", "serve"] and stand_ins == [] and _build._LIBS == {}
    assert not (tmp_path / "empty").exists()

# -- tools/install_probe's runs on the CPU (chip_smoke's 3s2 at a small size)


@pytest.fixture(scope="module")
def small_world():
    nodes, pods = loop_probe.scale_in_listing(*build_snapshot_world(N=120, P=800, port_nodes=40))
    templates, burst = loop_probe.burst_operands()
    return nodes, pods, burst[:200]


def test_installed_copy_runs_the_gce_main_as_the_checkout(small_world, tmp_path):
    """3s's command line from an installed copy on the CPU with
    --compile-cache-dir: the package comes from the copy, nothing is
    written into it or the directory, no compiler starts, and the resizes
    equal the checkout's run."""
    base = bound_loop.run_gce_main(*small_world, str(REPO), device="cpu")
    assert base["rc"] == 0 and base["compilers"] == 0, base["stderr"][-2000:]
    assert base["package"] == str(REPO / "autoscaler_tpu_torch" / "__init__.py")
    assert install_probe.resizes(base)
    copy = install_probe.installed_copy(REPO, tmp_path / "site")
    run = install_probe.run_installed(copy, tmp_path / "kernels", *small_world, device="cpu")
    assert install_probe.problems(run, 0, install_probe.resizes(base), copy, card=False) == []
    assert run["stdout"].count("TICK ") == 2 and not (tmp_path / "kernels").exists()


def test_start_line_and_toolkit_needs_parse():
    out = ("tpu-autoscaler: kernel libraries ffd_scan, ffd_scan_affinity, fit_reduce loaded "
           "from /k in 4.512 s, 3 compilers ran\ntpu-autoscaler: observability on :1\nTICK 0\n")
    assert install_probe.start_of(out) == {"dir": "/k", "seconds": 4.512, "compilers": 3,
                                           "before_first_tick": True}
    assert install_probe.start_of("TICK 0\n" + out)["before_first_tick"] is False
    ldd = ("\tlinux-vdso.so.1 (0x00007ffd)\n\tlibstdc++.so.6 => /lib/libstdc++.so.6 (0x1)\n"
           "\tlibcuda.so.1 => /usr/lib/x86_64-linux-gnu/libcuda.so.1 (0x2)\n")
    assert install_probe.toolkit_needs(ldd) == []
    assert install_probe.toolkit_needs(
        ldd + "\tlibcudart.so.12 => /usr/local/cuda/lib64/libcudart.so.12 (0x3)\n"
        "\tlibfoo.so => not found\n") == [
        "libcudart.so.12 => /usr/local/cuda/lib64/libcudart.so.12 (0x3)",
        "libfoo.so => not found"]
