"""The port's constraint attribution against the JAX package's, on the CPU:
``ops/binpack.attribute_unschedulable`` and ``attribution_summary`` on
seeded operands (bit for bit: every step is an f32 compare or an integer
select, sum or min), and the estimator's ``last_explain`` (per-group fit
counts and reason histograms, each pod's dominant reason) on the worlds of
tests/test_torch_estimator.py: the plain, runs, affinity, spread and
runs-affinity routes of ``estimate_many`` and both routes of ``estimate``,
the port's as it routes on the CPU (the torch loops); and
the attribution's fallback to the serial oracle twin when the device pass
fails."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autoscaler_tpu.ops.binpack as jbin
import autoscaler_tpu_torch.ops.binpack as tbin
import autoscaler_tpu_torch.metrics.metrics as tmetrics
from autoscaler_tpu_torch.estimator import binpacking as tes
from test_torch_estimator import (
    HOST,
    JAX,
    TORCH,
    cluster_of,
    dynamic_spec,
    estimator,
    make_dynamic_pods,
    make_pods,
    make_templates,
    pod_spec,
    routes_of,
    template_spec,
    zoned_templates,
)
from torch_parity import CPU, MEMORY, PODS, assert_bits_equal


def attribution_operands(seed, P=96, G=5, R=6):
    """Requests that overflow each axis of some templates, masks, a
    verdict and term involvement, all seeded."""
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 8, (P, R)).astype(np.float32)
    req[:, CPU] = rng.integers(100, 4000, P)
    req[:, MEMORY] = rng.integers(64, 8192, P)
    req[:, PODS] = 1.0
    allocs = rng.integers(0, 8, (G, R)).astype(np.float32)
    allocs[:, CPU] = rng.integers(1000, 4000, G)
    allocs[:, MEMORY] = rng.integers(2048, 8192, G)
    allocs[:, PODS] = rng.integers(0, 2, G)
    if R > PODS + 1:
        allocs[0, PODS + 1] = np.inf          # an unlimited CSI plane
    masks = rng.random((G, P)) > 0.2
    scheduled = rng.random((G, P)) > 0.7
    involved = rng.random(P) > 0.6
    weights = rng.integers(0, 4, (G, P)).astype(np.int32)
    return req, masks, allocs, scheduled, involved, weights


@pytest.mark.parametrize("R", [6, 9])
@pytest.mark.parametrize("seed", range(3))
def test_attribution_ops_match_jax(seed, R):
    req, masks, allocs, scheduled, involved, weights = attribution_operands(seed, R=R)
    ref = jbin.attribute_unschedulable(*(jnp.asarray(a) for a in
                                         (req, masks, allocs, scheduled, involved)))
    out = tbin.attribute_unschedulable(*(torch.tensor(a) for a in
                                         (req, masks, allocs, scheduled, involved)))
    assert out.dtype == torch.int32
    assert_bits_equal(np.asarray(ref), out)
    assert len(np.unique(np.asarray(ref))) >= 6          # most codes occur
    ref_hist, ref_dom = jbin.attribution_summary(ref, jnp.asarray(weights))
    hist, dom = tbin.attribution_summary(out, torch.tensor(weights))
    assert hist.dtype == dom.dtype == torch.int32
    assert_bits_equal(np.asarray(ref_hist), hist)
    assert_bits_equal(np.asarray(ref_dom), dom)


def explain_both(make, templates_of, call, routes=None):
    """``last_explain`` of each package's estimator after ``call``; the
    port's routes land in ``routes``."""
    out = []
    metrics = tmetrics.AutoscalerMetrics()
    for pkg in (JAX, TORCH):
        est = estimator(pkg, 16, metrics if pkg is TORCH else None)
        call(est, pkg, make(pkg), templates_of(pkg))
        out.append(est.last_explain)
    if routes is not None:
        routes.update(routes_of(metrics))
    return out


def plain(seed, **kw):
    specs, tspecs = pod_spec(seed, 60, **kw), template_spec(seed, 4, extras=kw.get("extras", False))
    return (lambda pkg: make_pods(pkg, specs)), (lambda pkg: make_templates(pkg, tspecs))


def dynamic(spec, seed=0, n_templates=4):
    return (lambda pkg: make_dynamic_pods(pkg, spec)), (lambda pkg: zoned_templates(pkg, seed, n_templates))


WORLDS = {
    "plain": (plain(0), ("torch_scan", "not_cuda")),
    "plain-extras": (plain(3, extras=True), ("torch_scan", "not_cuda")),
    "runs": (plain(4, replicated=True), ("torch_runs", "dedup")),
    "affinity": (dynamic(dynamic_spec(10, 60, anti=0.4, aff=0.2)),
                 ("torch_scan", "not_cuda")),
    "spread": (dynamic(dynamic_spec(11, 60, spread=0.5, anti=0.2, skew=2)),
               ("torch_scan", "not_cuda")),
    "runs-affinity": (dynamic(dynamic_spec(16, 140, replicated=True, apps=7, spread=1.0,
                                           spread_key=HOST)), ("torch_runs", "dedup")),
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_estimate_many_explain_matches_jax(world):
    (make, templates_of), route = WORLDS[world]
    routed = {}
    ref, out = explain_both(make, templates_of,
                            lambda est, pkg, pods, tmpls: est.estimate_many(pods, tmpls),
                            routes=routed)
    assert routed == {route: 1}
    assert out == ref
    assert out["groups"] and len(out["pod_reasons"]) == len(make(TORCH))
    assert any(g["reasons"] for g in out["groups"].values())


@pytest.mark.parametrize("kind", ["plain", "dynamic"])
def test_estimate_explain_matches_jax(kind):
    if kind == "plain":
        make, templates_of = plain(5)
    else:
        make, templates_of = dynamic(dynamic_spec(19, 50, anti=0.3, spread=0.4, apps=3), 19, 2)
    ref, out = explain_both(make, templates_of, lambda est, pkg, pods, tmpls: est.estimate(
        pods, tmpls["ng-0"], max_size_headroom=3, cluster=None))
    assert out == ref and set(out["groups"]) == {"template"}


def test_estimate_with_a_cluster_context_explain_matches_jax():
    make, templates_of = dynamic(dynamic_spec(13, 60, spread=0.7, apps=2, min_domains=3))
    ref, out = explain_both(make, templates_of, lambda est, pkg, pods, tmpls: est.estimate_many(
        pods, tmpls, cluster=cluster_of(pkg)))
    assert out == ref and out["pod_reasons"]


def test_empty_estimate_clears_the_explain():
    est = estimator(TORCH, 16)
    make, templates_of = plain(0)
    est.estimate_many(make(TORCH), templates_of(TORCH))
    assert est.last_explain["pod_reasons"]
    assert est.estimate_many([], templates_of(TORCH)) == {g: (0, []) for g in templates_of(TORCH)}
    assert est.last_explain == {"groups": {}, "pod_reasons": {}}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_attribution_falls_back_to_the_oracle_twin(world, monkeypatch, caplog):
    """When the device pass raises, the serial oracle twin answers from the
    numpy operands: the same ``last_explain`` as the JAX package's, and one
    WARNING on the estimator logger."""
    (make, templates_of), _ = WORLDS[world]

    def broken(*args, **kwargs):
        raise RuntimeError("attribution pass failed")

    ref = explain_both(make, templates_of,
                       lambda est, pkg, pods, tmpls: est.estimate_many(pods, tmpls))[0]
    monkeypatch.setattr(tes, "attribute_unschedulable", broken)
    est = estimator(TORCH, 16)
    with caplog.at_level("WARNING", logger="estimator"):
        est.estimate_many(make(TORCH), templates_of(TORCH))
    assert est.last_explain == ref
    warned = [r for r in caplog.records if r.name == "estimator" and r.levelname == "WARNING"]
    assert len(warned) == 1 and "serial oracle twin" in warned[0].getMessage()
