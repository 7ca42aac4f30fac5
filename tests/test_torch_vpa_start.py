"""The VPA process's start on a card (``autoscaler_tpu_torch/vpa/main.py``),
stood in for on the CPU: K5's library (``histogram``) is loaded before the
first pass, built first when it is missing, and the process ends before any
pass when it is missing and no ``nvcc`` can build it. The passes themselves
run on the CPU against tests/test_vpa_kube.py's fake API server; the
compiler and ``ctypes.CDLL`` are stood in for as in
tests/test_torch_install.py, and ``preload_kernels`` is handed a CUDA
device.
"""
import pytest
import torch

import autoscaler_tpu_torch.vpa.main as vmain
from autoscaler_tpu_torch.ops import _build
from test_kube_client import FakeApiServer
from test_torch_install import FakeLib, no_nvcc, prebuilt, stand_ins  # noqa: F401
from test_torch_vpa_recommender import world

START = "tpu-autoscaler-vpa: kernel library histogram loaded from"


@pytest.fixture()
def server():
    srv = FakeApiServer()
    world(srv)
    yield srv
    srv.close()


def argv(srv):
    return ["--kube-api", srv.url, "--device=cpu", "--no-checkpoints",
            "--max-iterations=2", "--scrape-interval=0"]


@pytest.fixture()
def as_on_a_card(monkeypatch):
    """vpa.main's start as on a card (its banks stay on the CPU) and a
    record of the order of library loads and passes."""
    events = []
    real_preload, real_run_once = vmain.preload_kernels, vmain.VpaRunner.run_once
    monkeypatch.setattr(vmain, "preload_kernels",
                        lambda device: real_preload(torch.device("cuda", 0)))
    monkeypatch.setattr(FakeLib, "__init__", lambda self, path: events.append("load"))

    def run_once(self, *args, **kwargs):
        events.append("pass")
        return real_run_once(self, *args, **kwargs)

    monkeypatch.setattr(vmain.VpaRunner, "run_once", run_once)
    return events


def test_vpa_main_loads_k5_before_the_first_pass(stand_ins, monkeypatch, as_on_a_card,  # noqa: F811
                                                 server, capsys):
    prebuilt(["histogram"])
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert vmain.main(argv(server)) == 0
    assert as_on_a_card == ["load", "pass", "pass"] and stand_ins == []
    out = capsys.readouterr().out
    assert f"{START} {_build.BUILD_DIR} in " in out and ", 0 compilers ran" in out


def test_vpa_main_builds_a_missing_k5_at_the_start(stand_ins, monkeypatch,  # noqa: F811
                                                   as_on_a_card, server, capsys):
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc-stand-in")
    assert vmain.main(argv(server)) == 0
    assert [cmd[-1] for cmd in stand_ins] == [str(_build.source("histogram"))]
    assert as_on_a_card == ["load", "pass", "pass"]
    assert ", 1 compilers ran" in capsys.readouterr().out


def test_vpa_main_ends_before_the_first_pass_without_k5(stand_ins, monkeypatch,  # noqa: F811
                                                        as_on_a_card, server, capsys):
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert vmain.main(argv(server)) == 1
    assert as_on_a_card == [] and server.writes == []
    err = capsys.readouterr().err
    assert "nvcc not found" in err and str(_build.BUILD_DIR) in err


def test_vpa_main_on_the_cpu_builds_and_loads_nothing(stand_ins, monkeypatch,  # noqa: F811
                                                      server, capsys):
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert vmain.main(argv(server)) == 0
    assert stand_ins == [] and FakeLib.opened == [] and _build._LIBS == {}
    assert START not in capsys.readouterr().out
