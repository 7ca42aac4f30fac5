"""The port's scale-up half of a reconcile tick (autoscaler_tpu_torch/
core/scaleup/orchestrator.py and the copies it runs on: cloudprovider/,
clusterstate/, config/, core/scaleup/resource_manager.py, processors/)
against the JAX package's. tests/test_scaleup.py's orchestrator cases run
on both packages, each with its own provider, options and registry built
from the same arguments: the whole ScaleUpResults (canonicalised), the
cloud calls, the target sizes and the registries must be equal. Then the
tick as a whole: fork, filter-out-schedulable, revert, scale_up."""
import types

import pytest
import torch

import autoscaler_tpu.cloudprovider.interface as jiface
import autoscaler_tpu.cloudprovider.test_provider as jprov
import autoscaler_tpu.clusterstate.backoff as jbackoff
import autoscaler_tpu.clusterstate.registry as jreg
import autoscaler_tpu.config.options as jopts
import autoscaler_tpu.core.podlistprocessor as jplp
import autoscaler_tpu.core.scaleup.orchestrator as jorch
import autoscaler_tpu.core.scaleup.resource_manager as jrm
import autoscaler_tpu.explain.reasons as jreasons
import autoscaler_tpu.expander.core as jexp
import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.processors.pipeline as jpipe
import autoscaler_tpu.snapshot.cluster_snapshot as jcs
import autoscaler_tpu.snapshot.packer as jpack
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.cloudprovider.interface as tiface
import autoscaler_tpu_torch.cloudprovider.test_provider as tprov
import autoscaler_tpu_torch.clusterstate.backoff as tbackoff
import autoscaler_tpu_torch.clusterstate.registry as treg
import autoscaler_tpu_torch.config.options as topts
import autoscaler_tpu_torch.core.podlistprocessor as tplp
import autoscaler_tpu_torch.core.scaleup.orchestrator as torch_orch
import autoscaler_tpu_torch.core.scaleup.resource_manager as trm
import autoscaler_tpu_torch.explain.reasons as treasons
import autoscaler_tpu_torch.expander.core as texp
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.processors.pipeline as tpipe
import autoscaler_tpu_torch.snapshot.cluster_snapshot as tcs
import autoscaler_tpu_torch.snapshot.packer as tpack
import autoscaler_tpu_torch.utils.test_utils as ttu
from autoscaler_tpu_torch.estimator import binpacking as tbin
from torch_parity import canon, tick_world

JAX = types.SimpleNamespace(
    name="jax", iface=jiface, prov=jprov, backoff=jbackoff, reg=jreg, opts=jopts,
    plp=jplp, orch=jorch, rm=jrm, reasons=jreasons, obj=jobj, pipe=jpipe, cs=jcs,
    pack=jpack, tu=jtu, exp=jexp, kw={},
)
TORCH = types.SimpleNamespace(
    name="torch", iface=tiface, prov=tprov, backoff=tbackoff, reg=treg, opts=topts,
    plp=tplp, orch=torch_orch, rm=trm, reasons=treasons, obj=tobj, pipe=tpipe, cs=tcs,
    pack=tpack, tu=ttu, exp=texp, kw={"device": "cpu"},
)
PKGS = pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])
GB = 1024**3
MB = 1024**2


def make_provider(pkg, groups=()):
    p = pkg.prov.TestCloudProvider()
    for name, lo, hi, target, cpu, mem in groups:
        p.add_node_group(name, lo, hi, target,
                         pkg.tu.build_test_node(f"{name}-tmpl", cpu_m=cpu, mem=mem))
    return p


def orchestrator(pkg, provider, opts, csr, **kw):
    return pkg.orch.ScaleUpOrchestrator(provider, opts, csr, **pkg.kw, **kw)


# -- the copies: tests/test_scaleup.py's backoff, registry and resource cases


@PKGS
def test_backoff_exponential_growth(pkg):
    b = pkg.backoff.ExponentialBackoff(initial_s=100, max_s=400)
    b.backoff("g", 0.0)
    assert b.is_backed_off("g", 50.0)
    assert not b.is_backed_off("g", 150.0)
    b.backoff("g", 150.0)
    assert b.is_backed_off("g", 300.0)
    b.backoff("g", 400.0)
    b.backoff("g", 900.0)
    assert b.is_backed_off("g", 1250.0)
    assert not b.is_backed_off("g", 1350.0)


@PKGS
def test_backoff_reset_after_idle(pkg):
    b = pkg.backoff.ExponentialBackoff(initial_s=100, max_s=400, reset_timeout_s=1000)
    b.backoff("g", 0.0)
    b.backoff("g", 200.0)
    b.backoff("g", 5000.0)
    assert not b.is_backed_off("g", 5150.0)


@PKGS
def test_registry_readiness_and_health(pkg):
    p = make_provider(pkg, [("g1", 0, 10, 3, 1000, 2 * GB)])
    nodes = [pkg.tu.build_test_node(f"n{i}") for i in range(3)]
    for n in nodes:
        p.add_node("g1", n)
    nodes[2].ready = False
    nodes[2].creation_ts = -10_000
    csr = pkg.reg.ClusterStateRegistry(p, pkg.opts.AutoscalingOptions(ok_total_unready_count=0))
    csr.update_nodes(nodes, now_ts=1000.0)
    r = csr.readiness("g1")
    assert (r.ready, r.unready, r.registered) == (2, 1, 3)
    assert csr.is_cluster_healthy()
    assert csr.is_node_group_healthy("g1")


@PKGS
def test_registry_unhealthy_cluster(pkg):
    p = make_provider(pkg, [("g1", 0, 10, 3, 1000, 2 * GB)])
    nodes = [pkg.tu.build_test_node(f"n{i}", ready=False) for i in range(3)]
    for n in nodes:
        n.creation_ts = -10_000
        p.add_node("g1", n)
    csr = pkg.reg.ClusterStateRegistry(p, pkg.opts.AutoscalingOptions(ok_total_unready_count=0))
    csr.update_nodes(nodes, now_ts=1000.0)
    assert not csr.is_cluster_healthy()


@PKGS
def test_registry_scale_up_expiry_triggers_backoff(pkg):
    p = make_provider(pkg, [("g1", 0, 10, 5, 1000, 2 * GB)])
    csr = pkg.reg.ClusterStateRegistry(p, pkg.opts.AutoscalingOptions(max_node_provision_time_s=900))
    csr.register_or_update_scale_up("g1", 5, now_ts=0.0)
    csr.update_nodes([], now_ts=100.0)
    assert csr.is_node_group_safe_to_scale_up("g1", 100.0)
    csr.update_nodes([], now_ts=1000.0)
    assert len(csr.scale_up_failures) == 1
    assert not csr.is_node_group_safe_to_scale_up("g1", 1000.0)


@PKGS
def test_registry_scale_up_fulfilled_clears_request(pkg):
    p = make_provider(pkg, [("g1", 0, 10, 2, 1000, 2 * GB)])
    csr = pkg.reg.ClusterStateRegistry(p, pkg.opts.AutoscalingOptions())
    csr.register_or_update_scale_up("g1", 2, now_ts=0.0)
    nodes = [pkg.tu.build_test_node(f"n{i}") for i in range(2)]
    for n in nodes:
        p.add_node("g1", n)
    csr.update_nodes(nodes, now_ts=100.0)
    assert csr.scale_up_requests == {}
    assert not csr.scale_up_failures


@PKGS
def test_registry_upcoming_nodes(pkg):
    p = make_provider(pkg, [("g1", 0, 10, 5, 1000, 2 * GB)])
    nodes = [pkg.tu.build_test_node(f"n{i}") for i in range(2)]
    for n in nodes:
        p.add_node("g1", n)
    csr = pkg.reg.ClusterStateRegistry(p, pkg.opts.AutoscalingOptions())
    csr.update_nodes(nodes, now_ts=0.0)
    assert csr.get_upcoming_nodes() == {"g1": 3}


@PKGS
def test_registry_unregistered_instances(pkg):
    p = make_provider(pkg, [("g1", 0, 10, 2, 1000, 2 * GB)])
    n0 = pkg.tu.build_test_node("n0")
    p.add_node("g1", n0)
    p.add_instance("g1", pkg.iface.Instance(id="ghost-1"))
    csr = pkg.reg.ClusterStateRegistry(p, pkg.opts.AutoscalingOptions())
    csr.update_nodes([n0], now_ts=0.0)
    assert [i.id for i in csr.unregistered_instances()["g1"]] == ["ghost-1"]


@PKGS
def test_registry_instances_with_errors(pkg):
    p = make_provider(pkg, [("g1", 0, 10, 2, 1000, 2 * GB)])
    p.add_instance("g1", pkg.iface.Instance(
        id="bad-1", state=pkg.iface.InstanceState.CREATING,
        error_info=pkg.iface.InstanceErrorInfo(pkg.iface.InstanceErrorClass.QUOTA_EXCEEDED),
    ))
    csr = pkg.reg.ClusterStateRegistry(p, pkg.opts.AutoscalingOptions())
    assert [i.id for i in csr.instances_with_errors()["g1"]] == ["bad-1"]


@PKGS
def test_resource_manager_limits(pkg):
    limiter = pkg.iface.ResourceLimiter(max_limits={"cpu": 10_000, "memory": 100 * 1024})
    mgr = pkg.rm.ScaleUpResourceManager(limiter)
    left = mgr.resources_left([pkg.tu.build_test_node("n0", cpu_m=4000, mem=8 * GB)])
    assert left.left["cpu"] == pytest.approx(6000)
    template = pkg.tu.build_test_node("t", cpu_m=2000, mem=4 * GB)
    assert mgr.apply_limits(10, left, template) == 3


@PKGS
def test_resource_manager_exceeded(pkg):
    mgr = pkg.rm.ScaleUpResourceManager(pkg.iface.ResourceLimiter(max_limits={"cpu": 1000}))
    left = mgr.resources_left([pkg.tu.build_test_node("n0", cpu_m=900)])
    delta = pkg.rm.ResourceDelta.for_node(pkg.tu.build_test_node("t", cpu_m=500))
    assert left.exceeded_by(delta) == ["cpu"]


def test_options_keep_the_fleet_defaults():
    """The two fleet/buckets.py defaults the port's options copy."""
    from autoscaler_tpu.fleet import buckets

    o = topts.AutoscalingOptions()
    assert o.fleet_shape_buckets == buckets.DEFAULT_BUCKETS
    assert o.arena_buckets == buckets.DEFAULT_ARENA_BUCKETS
    assert canon(o) == canon(jopts.AutoscalingOptions())


def test_default_processors_match_jax():
    opts = (jopts.AutoscalingOptions(balance_similar_node_groups=True),
            topts.AutoscalingOptions(balance_similar_node_groups=True))
    j, t = jpipe.default_processors(opts[0]), tpipe.default_processors(opts[1])
    assert [type(getattr(j, f)).__name__ for f in vars(j)] == [
        type(getattr(t, f)).__name__ for f in vars(t)
    ]
    assert isinstance(t.pod_list_processor, tplp.FilterOutSchedulablePodListProcessor)
    assert t.node_group_set.ignored_labels == j.node_group_set.ignored_labels


# -- tests/test_scaleup.py's TestOrchestrator cases, on both packages


def setup_two_groups(pkg, expander=True, **opt_kw):
    provider = make_provider(pkg, [("small", 0, 20, 1, 1000, 2 * GB),
                                   ("big", 0, 20, 1, 8000, 16 * GB)])
    n_small = pkg.tu.build_test_node("small-1", cpu_m=1000, mem=2 * GB)
    n_big = pkg.tu.build_test_node("big-1", cpu_m=8000, mem=16 * GB)
    provider.add_node("small", n_small)
    provider.add_node("big", n_big)
    opts = pkg.opts.AutoscalingOptions(expander="least-waste", **opt_kw)
    csr = pkg.reg.ClusterStateRegistry(provider, opts)
    nodes = [n_small, n_big]
    csr.update_nodes(nodes, now_ts=0.0)
    kw = {"expander": pkg.exp.build_strategy(["least-waste"])} if expander else {}
    return provider, csr, orchestrator(pkg, provider, opts, csr, **kw), nodes


def one_group(pkg, hi, target, cpu, mem, node=True, limiter=None, **opt_kw):
    provider = make_provider(pkg, [("g", 2 if opt_kw.get("enforce_node_group_min_size") else 0,
                                    hi, target, cpu, mem)])
    nodes = []
    if node:
        nodes = [pkg.tu.build_test_node("g-1", cpu_m=cpu, mem=mem)]
        provider.add_node("g", nodes[0])
    if limiter is not None:
        provider._limiter = pkg.iface.ResourceLimiter(max_limits=limiter)
    opts = pkg.opts.AutoscalingOptions(**opt_kw)
    csr = pkg.reg.ClusterStateRegistry(provider, opts)
    csr.update_nodes(nodes, now_ts=0.0)
    return provider, csr, orchestrator(pkg, provider, opts, csr), nodes


def case_end_to_end(pkg):
    provider, csr, orch, nodes = setup_two_groups(pkg)
    pods = [pkg.tu.build_test_pod(f"p{i}", cpu_m=900, mem=1800 * MB) for i in range(6)]
    return provider, csr, orch.scale_up(pods, nodes, now_ts=10.0)


def case_no_pending(pkg):
    provider, csr, orch, nodes = setup_two_groups(pkg)
    return provider, csr, orch.scale_up([], nodes, now_ts=0.0)


def case_backed_off(pkg):
    provider, csr, orch, nodes = setup_two_groups(pkg)
    csr.backoff.backoff("small", 0.0)
    csr.backoff.backoff("big", 0.0)
    return provider, csr, orch.scale_up([pkg.tu.build_test_pod("p", cpu_m=500)], nodes, now_ts=10.0)


def case_max_size(pkg):
    provider, csr, orch, nodes = one_group(pkg, 3, 1, 1000, 2 * GB)
    pods = [pkg.tu.build_test_pod(f"p{i}", cpu_m=900) for i in range(10)]
    return provider, csr, orch.scale_up(pods, nodes, now_ts=0.0)


def case_max_nodes_total(pkg):
    provider, csr, orch, nodes = setup_two_groups(pkg, max_nodes_total=3)
    pods = [pkg.tu.build_test_pod(f"p{i}", cpu_m=900, mem=1800 * MB) for i in range(6)]
    return provider, csr, orch.scale_up(pods, nodes, now_ts=0.0)


def case_resource_limit(pkg):
    provider, csr, orch, _ = one_group(pkg, 20, 0, 4000, 8 * GB, node=False,
                                       limiter={"cpu": 8000})
    pods = [pkg.tu.build_test_pod(f"p{i}", cpu_m=3500) for i in range(8)]
    return provider, csr, orch.scale_up(pods, [], now_ts=0.0)


def case_failed_increase(pkg):
    provider, csr, orch, nodes = setup_two_groups(pkg)

    def boom(group, delta):
        raise pkg.iface.NodeGroupError("cloud says no")

    provider.on_scale_up = boom
    pods = [pkg.tu.build_test_pod("p", cpu_m=900, mem=1800 * MB)]
    return provider, csr, orch.scale_up(pods, nodes, now_ts=0.0)


def case_min_size(pkg):
    provider, csr, orch, _ = one_group(pkg, 10, 0, 1000, 2 * GB, node=False,
                                       enforce_node_group_min_size=True)
    return provider, csr, orch.scale_up_to_node_group_min_size(0.0)


CASES = {
    "end_to_end": case_end_to_end, "no_pending": case_no_pending,
    "backed_off": case_backed_off, "max_size": case_max_size,
    "max_nodes_total": case_max_nodes_total, "resource_limit": case_resource_limit,
    "failed_increase": case_failed_increase, "min_size": case_min_size,
}


def result_canon(res):
    """canon of a ScaleUpResult without estimator_explain: the JAX
    estimator fills it, the port's has no decision explain yet (its
    results keep it empty, which the cases check)."""
    import dataclasses

    if isinstance(res, list):
        return canon(res)
    return canon(dataclasses.replace(res, estimator_explain={}))


def provider_state(provider, csr):
    return (
        [(g.id(), g.target_size()) for g in provider.node_groups()],
        list(provider.scale_up_calls),
        canon(csr.scale_up_requests),
        canon(csr.scale_up_failures),
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_orchestrator_matches_jax(case):
    """The whole ScaleUpResult (or min-size plan), the cloud calls, the
    target sizes and the registry's requests and failures are equal; the
    case's own assertions from tests/test_scaleup.py hold on the port."""
    jprov_, jcsr, jres = CASES[case](JAX)
    tprov_, tcsr, tres = CASES[case](TORCH)
    assert result_canon(tres) == result_canon(jres)
    if not isinstance(tres, list):
        assert tres.estimator_explain == {}
    assert provider_state(tprov_, tcsr) == provider_state(jprov_, jcsr)
    if case == "end_to_end":
        assert tres.scaled_up and tres.new_nodes > 0
        assert tprov_.scale_up_calls[0] == (tres.chosen_group, tres.new_nodes)
        assert tcsr.scale_up_requests and not tres.pods_remain_unschedulable
    elif case == "no_pending":
        assert not tres.scaled_up and tprov_.scale_up_calls == []
    elif case == "backed_off":
        assert tres.skipped_groups["small"] is treasons.SkipReason.NOT_SAFE
    elif case == "max_size":
        assert tres.new_nodes == 2 and tres.pods_remain_unschedulable
    elif case == "max_nodes_total":
        assert tres.new_nodes <= 1
    elif case == "resource_limit":
        assert tres.new_nodes == 2
    elif case == "failed_increase":
        assert tres.error is not None and len(tcsr.scale_up_failures) == 1
        assert not tcsr.is_node_group_safe_to_scale_up(tcsr.scale_up_failures[0].group_id, 1.0)
    else:
        assert tres == [("g", 2)]


def test_orchestrator_estimates_on_its_device():
    provider, csr, orch, _ = setup_two_groups(TORCH, expander=False)
    assert orch.estimator.device == torch.device("cpu")
    assert orch.expander.filters and orch.expander.filters[0].name == "least-waste"


@pytest.mark.parametrize("unported", [
    {"metrics": object()}, {"observatory": object()},
    {"priorities_fetch": lambda: {}}, {"preemption_churn_weight": 0.5},
])
def test_unported_options_raise(unported):
    provider = make_provider(TORCH, [("g", 0, 5, 0, 1000, 2 * GB)])
    weight = unported.pop("preemption_churn_weight", 0.0)
    opts = topts.AutoscalingOptions(preemption_churn_weight=weight)
    csr = treg.ClusterStateRegistry(provider, opts)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_orch.ScaleUpOrchestrator(provider, opts, csr, device="cpu", **unported)


@pytest.mark.parametrize("name", ["price", "priority", "grpc"])
def test_unported_expanders_raise(name):
    provider = make_provider(TORCH, [("g", 0, 5, 0, 1000, 2 * GB)])
    opts = topts.AutoscalingOptions(expander=name)
    with pytest.raises(NotImplementedError, match="not ported"):
        torch_orch.ScaleUpOrchestrator(provider, opts, treg.ClusterStateRegistry(provider, opts),
                                       device="cpu")


def test_orchestrator_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    provider = make_provider(TORCH, [("g", 0, 5, 0, 1000, 2 * GB)])
    opts = topts.AutoscalingOptions()
    csr = treg.ClusterStateRegistry(provider, opts)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_orch.ScaleUpOrchestrator(provider, opts, csr)


# -- the tick's scale-up half as a whole


@pytest.mark.parametrize("spread", [False, True], ids=["plain", "spread"])
@pytest.mark.parametrize("form", ["dense", "factored"])
def test_scale_up_tick_matches_jax(form, spread, monkeypatch):
    """run_once's scale-up half on both packages: fork, filter-out, revert,
    then scale_up over what is still pending (least-waste, seeded ties).
    The filtered keys, the snapshot after the revert, the whole
    ScaleUpResult and the provider afterwards are equal."""
    if form == "factored":
        monkeypatch.setattr(jpack, "DENSE_MASK_CELL_LIMIT", 16)
        monkeypatch.setattr(tpack, "DENSE_MASK_CELL_LIMIT", 16)
    for k in tbin.ROUTES:
        tbin.ROUTES[k] = 0
    out = {}
    for pkg in (JAX, TORCH):
        snap, pending, provider = tick_world(pkg.tu, pkg.obj, pkg.prov, pkg.cs, spread,
                                             **pkg.kw)
        before = [(p.key(), snap.assignment(p.key())) for p in snap.pods()]
        snap.fork()
        still, filtered = pkg.plp.FilterOutSchedulablePodListProcessor().process(snap, pending)
        snap.revert()
        after = [(p.key(), snap.assignment(p.key())) for p in snap.pods()]
        assert after == before
        opts = pkg.opts.AutoscalingOptions(expander="least-waste", expander_random_seed=0)
        csr = pkg.reg.ClusterStateRegistry(provider, opts)
        res = orchestrator(pkg, provider, opts, csr).scale_up(
            still, snap.nodes(), 5.0, pods_of_node=snap.pods_on_node)
        out[pkg.name] = (
            [p.key() for p in filtered], [p.key() for p in still], result_canon(res),
            [(g.id(), g.target_size()) for g in provider.node_groups()],
            list(provider.scale_up_calls),
        )
        if pkg is TORCH:
            assert filtered and still and res.scaled_up and res.new_nodes > 0
            assert res.estimator_explain == {}
            route = "ffd_scan_aff" if spread else "ffd_scan"
            assert tbin.ROUTES[route] == 1 and sum(tbin.ROUTES.values()) == 1
    assert out["torch"] == out["jax"]


def test_tick_probe_runs_the_chip_ticks_on_the_cpu():
    """tools/tick_probe.run_tick, which chip_smoke.py's ticks 3j and 3k run
    through, on a cut-down snapshot world and burst on the CPU: the timed
    run (its wrappers in place) and the plain one agree in every field,
    and the wrappers are undone afterwards."""
    from autoscaler_tpu_torch.ops import ffd_scan, schedule
    from autoscaler_tpu_torch.simulator import hinting
    from autoscaler_tpu_torch.tools import tick_probe
    from autoscaler_tpu_torch.utils.workload import build_snapshot_world

    templates, burst = tick_probe.burst_operands()
    nodes, pods = build_snapshot_world(N=120, P=840, port_nodes=40)
    groups = tick_probe.zoned_templates(templates)
    real = (schedule.greedy_schedule, hinting.build_spread_context_from_meta,
            ffd_scan.ffd_scan_swar)
    for extra in (burst[:400], tick_probe.spread_burst(burst[:400])):
        timed = tick_probe.run_tick(nodes, pods, extra, groups, "cpu", timed=True)
        plain = tick_probe.run_tick(nodes, pods, extra, groups, "cpu")
        assert tick_probe.tick_differences(timed["out"], plain["out"]) == []
        assert timed["out"]["reverted"] and timed["greedy_devices"] == ("cpu", "cpu")
        assert timed["out"]["filtered"] and timed["out"]["still"]
        assert timed["out"]["result"].scaled_up
        assert {"pack_s", "filter_s", "greedy_s", "estimate_s", "scale_up_s"} <= set(timed)
    assert (schedule.greedy_schedule, hinting.build_spread_context_from_meta,
            ffd_scan.ffd_scan_swar) == real
    assert [p.labels for p in tick_probe.spread_burst(burst[:40])[1::20]] == [
        {"app": "app-0"}, {"app": "app-1"}]
