"""The JAX package's VPA, balancer and addon-resizer suites run on the port
(``torch_parity.Rebound``): every case of tests/test_vpa_admission.py,
test_vpa_balancer.py, test_vpa_e2e.py, test_vpa_kube.py,
test_vpa_prometheus.py and test_nanny_kube.py, each parametrisation its own
case, on the port's namesakes, the histogram banks on the CPU.

The suites' fixtures are rebuilt here on the port (``cluster`` is
test_vpa_e2e's ``HamsterCluster`` rebound); the one case that starts the
VPA as a process runs ``python -m autoscaler_tpu_torch.vpa.main`` with
``--device=cpu`` in its place (``port_process``).
"""
import inspect
import subprocess
import threading
from http.server import HTTPServer

import pytest
import torch

import autoscaler_tpu_torch.vpa.histogram as thistogram
import autoscaler_tpu_torch.vpa.main as tmain
import test_nanny_kube
import test_vpa_admission
import test_vpa_balancer
import test_vpa_e2e
import test_vpa_kube
import test_vpa_prometheus
from test_kube_client import FakeApiServer
from torch_parity import Rebound

SUITES = (test_vpa_admission, test_vpa_balancer, test_vpa_e2e, test_vpa_kube,
          test_vpa_prometheus, test_nanny_kube)
MODULES = {m.__name__: m for m in SUITES}
REBOUND = {m.__name__: Rebound(m) for m in SUITES}
JAX_MAIN, PORT_MAIN = "autoscaler_tpu.vpa.main", "autoscaler_tpu_torch.vpa.main"


def _cpu(device=None):
    return torch.device("cpu") if device is None else torch.device(device)


@pytest.fixture()
def on_cpu(monkeypatch):
    """The port's banks default to the first card, which this host does
    not have: they go to the CPU here."""
    for mod in (thistogram, tmain):
        monkeypatch.setattr(mod, "resolve_device", _cpu)


@pytest.fixture()
def port_process(monkeypatch):
    """A ``python -m autoscaler_tpu.vpa.main ...`` the suite starts runs the
    port's module on the CPU instead."""
    run = subprocess.run

    def port_run(argv, *args, **kw):
        if JAX_MAIN in argv:
            argv = [PORT_MAIN if a == JAX_MAIN else a for a in argv] + ["--device=cpu"]
        return run(argv, *args, **kw)

    monkeypatch.setattr(subprocess, "run", port_run)


# -- the suites' fixtures, on the port ---------------------------------------------


@pytest.fixture()
def srv():
    s = FakeApiServer()
    yield s
    s.close()


@pytest.fixture()
def prom_server():
    handler = REBOUND["test_vpa_prometheus"].globals["_RecordedProm"]
    handler.requests = []
    server = HTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()


@pytest.fixture()
def cluster(on_cpu):
    c = REBOUND["test_vpa_e2e"].globals["HamsterCluster"]()
    yield c
    c.close()


# -- the cases -----------------------------------------------------------------


def _target(module, name):
    target = getattr(module, name.split(".")[0])
    return getattr(target, name.split(".")[1]) if "." in name else target


def _cases():
    """(module, test name, parametrised arguments) of every case, with the
    id pytest gives it in its own suite."""
    out = []
    for module in SUITES:
        names = []
        for key, value in vars(module).items():
            if key.startswith("test_") and callable(value):
                names.append(key)
            elif key.startswith("Test") and isinstance(value, type):
                names += [f"{key}.{m}" for m in vars(value) if m.startswith("test_")]
        for name in names:
            marks = [m for m in getattr(_target(module, name), "pytestmark", [])
                     if m.name == "parametrize"]
            if not marks:
                out.append(pytest.param(module.__name__, name, {},
                                        id=f"{module.__name__}::{name}"))
                continue
            (mark,) = marks
            argnames = [a.strip() for a in mark.args[0].split(",")]
            for k, values in enumerate(mark.args[1]):
                values = values if len(argnames) > 1 else (values,)
                ident = mark.kwargs["ids"][k] if "ids" in mark.kwargs else "-".join(
                    str(v) for v in values)
                out.append(pytest.param(module.__name__, name, dict(zip(argnames, values)),
                                        id=f"{module.__name__}::{name}[{ident}]"))
    return out


CASES = _cases()


@pytest.mark.parametrize("module,name,params", CASES)
def test_jax_vpa_case_on_the_port(module, name, params, request, on_cpu, port_process):
    target = _target(MODULES[module], name)
    fixtures = [p for p in inspect.signature(target).parameters
                if p != "self" and p not in params]
    REBOUND[module].case(name)(**params, **{p: request.getfixturevalue(p) for p in fixtures})


def test_the_cases_cover_the_suites():
    """Every case of the six suites, each parametrisation its own: 85
    functions of the VPA suites (103 cases) and 4 of the nanny suite."""
    per_module = {m.__name__: sum(c.values[0] == m.__name__ for c in CASES) for m in SUITES}
    assert per_module == {"test_vpa_admission": 21, "test_vpa_balancer": 24,
                          "test_vpa_e2e": 8, "test_vpa_kube": 22,
                          "test_vpa_prometheus": 28, "test_nanny_kube": 4}, per_module
    assert len({c.values[:2] for c in CASES}) == 89
