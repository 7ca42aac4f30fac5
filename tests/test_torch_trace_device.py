"""trace/device.py on torch.profiler, on the CPU: the TestDeviceCorrelation
cases of tests/test_trace.py on the port, a tick's session written on the
CPU (``jax_profiler_dir``, the flag named as in the JAX package), one
profiler at a time, and the tick's step and the estimator's range in the
exported trace."""
import json
import os
from contextlib import nullcontext

import pytest
import torch

from autoscaler_tpu_torch import trace
from autoscaler_tpu_torch.cloudprovider.test_provider import TestCloudProvider
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.core.static_autoscaler import StaticAutoscaler
from autoscaler_tpu_torch.kube.api import FakeClusterAPI
from autoscaler_tpu_torch.trace import device as dev
from autoscaler_tpu_torch.utils.test_utils import GB, build_test_node, build_test_pod


def make_autoscaler(pods=(), **opt_kw):
    provider = TestCloudProvider()
    api = FakeClusterAPI()
    provider.add_node_group("g", 0, 10, 1, build_test_node("t", cpu_m=1000, mem=2 * GB))
    node = build_test_node("g-0", cpu_m=1000, mem=2 * GB)
    provider.add_node("g", node)
    api.add_node(node)
    for p in pods:
        api.add_pod(p)
    return StaticAutoscaler(provider, api, AutoscalingOptions(**opt_kw), device="cpu")


@pytest.fixture()
def sessions_on(monkeypatch):
    """Sessions enabled at the start of the case (a failed start in another
    case disables them for the process, as in the JAX package)."""
    monkeypatch.setattr(dev, "_sessions_broken", False)
    monkeypatch.setattr(dev, "_session", None)


def trace_names(path):
    with open(path) as f:
        doc = json.load(f)
    return {e.get("name", "") for e in doc["traceEvents"]}


class TestDeviceCorrelation:
    def test_device_annotation_is_safe_everywhere(self):
        with dev.device_annotation("autoscaler/test"):
            x = 1 + 1
        assert x == 2

    def test_compile_execute_split_attrs(self):
        """First dispatch of a route marks cold; warm dispatches carry the
        estimated compile/execute split (production tracer only)."""
        from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator

        est = BinpackingNodeEstimator(device="cpu")
        tracer = trace.Tracer()  # production mode: wall attrs allowed
        pods = [build_test_pod(f"p{i}", cpu_m=500) for i in range(4)]
        tmpl = build_test_node("tmpl", cpu_m=4000)
        with tracer.tick("main"):
            est.estimate_many(pods, {"g": tmpl})
            est.estimate_many(pods, {"g": tmpl})
        spans = [
            s
            for t in tracer.recorder.traces()
            for s in t.spans
            if s.name == "deviceDispatch" and s.attrs.get("outcome") == "ok"
        ]
        assert len(spans) == 2
        assert spans[0].attrs["cold"] is True
        assert "dispatch_s" in spans[0].attrs
        assert spans[1].attrs["cold"] is False
        assert "execute_est_s" in spans[1].attrs
        assert "compile_est_s" in spans[1].attrs

    def test_jax_profiler_dir_capture(self, tmp_path, sessions_on):
        a = make_autoscaler(
            [build_test_pod("p", cpu_m=900, mem=1 * GB)],
            jax_profiler_dir=str(tmp_path),
        )
        a.run_once(now_ts=0.0)
        # keyed by the tick id of the trace in the flight recorder
        tid = a.tracer.recorder.traces()[0].trace_id
        session = tmp_path / f"tick_{tid:06d}"
        assert session.exists()
        assert any(os.scandir(session))

    def test_session_failure_keeps_annotations_alive(self, monkeypatch, sessions_on):
        """A failed profiler session start disables sessions only — the
        record_function path (device-timeline correlation of dispatches)
        must survive."""

        class FakeProf:
            class ProfilerActivity:
                CPU = "cpu"
                CUDA = "cuda"

            def profile(self, activities):
                raise RuntimeError("dir unwritable")

            def record_function(self, name, args=None):
                return nullcontext("annotated")

        monkeypatch.setattr(dev, "_profiler", lambda: FakeProf())
        assert dev.start_profiler_session("/nonexistent", 1) is False
        assert dev._sessions_broken
        # sessions now refuse fast ...
        assert dev.start_profiler_session("/nonexistent", 2) is False
        # ... but annotations still flow through the profiler
        with dev.device_annotation("autoscaler/x") as tag:
            assert tag == "annotated"


def test_tick_session_written_on_the_cpu(tmp_path, sessions_on):
    """Two ticks, two session directories, each a Chrome trace holding the
    tick's step (``ProfilerStep#<tick id>``, the run_once range) and, on the
    scale-up tick, the estimator's rung range."""
    a = make_autoscaler(
        [build_test_pod(f"p{i}", cpu_m=900, mem=1 * GB) for i in range(3)],
        jax_profiler_dir=str(tmp_path),
    )
    a.run_once(now_ts=0.0)
    a.run_once(now_ts=10.0)
    tids = [t.trace_id for t in a.tracer.recorder.traces()]
    assert len(tids) == 2 and tids[0] != tids[1]
    names = []
    for tid in tids:
        path = tmp_path / f"tick_{tid:06d}" / dev.TRACE_FILE
        assert path.stat().st_size > 0
        names.append(trace_names(path))
        assert f"ProfilerStep#{tid}" in names[-1]
    assert any(n.startswith("autoscaler/estimator/") for n in names[0])
    assert dev._session is None and not torch.autograd.profiler._is_profiler_enabled


def test_one_profiler_at_a_time(tmp_path, sessions_on):
    """A tick session opened while another torch.profiler session runs (a
    probe's own) fails as the JAX package's does: sessions are disabled,
    the running session is left alone, annotations keep working."""
    a = make_autoscaler([build_test_pod(f"p{i}", cpu_m=900, mem=1 * GB) for i in range(3)],
                        jax_profiler_dir=str(tmp_path))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as outer:
        a.run_once(now_ts=0.0)
        assert torch.autograd.profiler._is_profiler_enabled
    assert dev._sessions_broken
    assert not any(tmp_path.iterdir())
    names = {e.name for e in outer.events()}
    assert any(n.startswith("autoscaler/estimator/") for n in names)
    assert not any(n.startswith("ProfilerStep#") for n in names)


def test_disabled_profiler_is_a_no_op(monkeypatch, sessions_on, tmp_path):
    """With torch.profiler unusable every hook is a no-op and the loop runs
    (the JAX package's ``_profiler_broken`` domain)."""
    monkeypatch.setattr(dev, "_profiler_broken", True)
    assert dev.start_profiler_session(str(tmp_path), 1) is False
    with dev.step_annotation("run_once", 1), dev.device_annotation("x"):
        pass
    dev.stop_profiler_session()
    assert not any(tmp_path.iterdir())
