"""``utils/sharded_worlds.py`` and ``utils/poll.py`` on the CPU against the
JAX package: each world's arrays equal the JAX package's (the port's
tensors on the device asked for), and the poll loop runs, survives a
failing pass and stops alike."""
import logging

import numpy as np
import pytest
import torch

import autoscaler_tpu.utils.poll as jpoll
import autoscaler_tpu.utils.sharded_worlds as jw
import autoscaler_tpu_torch.utils.poll as tpoll
import autoscaler_tpu_torch.utils.sharded_worlds as tw
from torch_parity import to_np


def assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif a is None or isinstance(a, (int, float, bool, str)):
        assert a == b, where
    else:
        x, y = to_np(a), to_np(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (where, x.dtype, y.dtype)
        assert np.array_equal(x, y), where


@pytest.mark.parametrize("seed", [9, 3])
def test_affinity_world(seed):
    assert_same(jw.affinity_world(4, 40, 3, 16, seed), tw.affinity_world(4, 40, 3, 16, seed))


def test_spread_world():
    (jk, jsp), (tk, tsp) = jw.spread_world(3, 12, 8), tw.spread_world(3, 12, 8)
    assert_same(jk, tk)
    assert_same(tuple(jsp), tuple(tsp))


def test_scaledown_world_on_the_device_asked():
    jsnap, *jrest = jw.scaledown_world(12, 40, 4, 3)
    tsnap, *trest = tw.scaledown_world(12, 40, 4, 3, device="cpu")
    assert_same(tuple(jrest), tuple(trest))
    for field in ("node_alloc", "node_used", "node_valid", "node_group", "pod_req",
                  "pod_valid", "pod_node", "sched_mask"):
        assert getattr(tsnap, field).device == torch.device("cpu")
        assert_same(getattr(jsnap, field), getattr(tsnap, field), field)


def test_scaledown_spread_world():
    j = jw.scaledown_spread_world()
    t = tw.scaledown_spread_world(device="cpu")
    assert_same(j[1:5], t[1:5])
    assert_same(j[7], t[7])
    for field in ("node_alloc", "node_used", "pod_req", "pod_node"):
        assert_same(getattr(j[0], field), getattr(t[0], field), field)


@pytest.mark.parametrize("mod", [jpoll, tpoll], ids=["jax", "torch"])
def test_poll_loop(mod, caplog):
    calls = []

    def fn():
        calls.append(len(calls))
        if len(calls) == 2:
            raise RuntimeError("transient")

    with caplog.at_level(logging.ERROR):
        assert mod.poll_loop(fn, 0.0, max_iterations=3, logger=logging.getLogger("p")) == 0
    assert calls == [0, 1, 2]
    assert any("pass failed" in r.message for r in caplog.records)
