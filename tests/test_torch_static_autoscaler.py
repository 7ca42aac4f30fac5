"""The port's reconcile loop (autoscaler_tpu_torch/core/static_autoscaler.py
and the copies it runs on: metrics/, explain/, slo/, journal/,
clusterstate/status.py) against the JAX package's, on the CPU.

Every case of tests/test_static_autoscaler.py::TestRunOnce runs on twin
worlds, each built with its own package's modules from the same
arguments, and the same three-tick sequence runs on the twins of
``torch_parity.tick_world``. Both tracers read one synthetic clock, set to
each tick's ``now_ts``. After every tick these are equal, bit for bit or
byte for byte: the RunOnceResult (canonicalised), the provider's groups,
target sizes and calls, the API's nodes, taints, pods, evictions, events
and ConfigMaps (the status ConfigMap among them), every line of the
decision ledger (the estimator's attribution and each pending pod's
reason included), of the flight journal and of the SLO windows, and the
metrics exposition. The exposition leaves out only the families of what
the port does not have yet, listed by name in ``UNPORTED_FAMILIES``, and
the spans those time (``UNPORTED_SPANS``); the duration families keep
their counts, not their wall-clock values.
"""
import types

import pytest

import autoscaler_tpu.cloudprovider.interface as jiface
import autoscaler_tpu.cloudprovider.test_provider as jprov
import autoscaler_tpu.config.options as jopts
import autoscaler_tpu.core.static_autoscaler as jsa
import autoscaler_tpu.kube.api as japi
import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.metrics.metrics as jmetrics
import autoscaler_tpu.snapshot.cluster_snapshot as jcs
import autoscaler_tpu.trace as jtrace
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.cloudprovider.interface as tiface
import autoscaler_tpu_torch.cloudprovider.test_provider as tprov
import autoscaler_tpu_torch.config.options as topts
import autoscaler_tpu_torch.core.static_autoscaler as tsa
import autoscaler_tpu_torch.kube.api as tapi
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.metrics.metrics as tmetrics
import autoscaler_tpu_torch.snapshot.cluster_snapshot as tcs
import autoscaler_tpu_torch.trace as ttrace
import autoscaler_tpu_torch.utils.test_utils as ttu
from autoscaler_tpu_torch.estimator import binpacking as tbin
from autoscaler_tpu_torch.tools import loop_probe
from torch_parity import tick_world

JAX = types.SimpleNamespace(
    name="jax", iface=jiface, prov=jprov, opts=jopts, sa=jsa, api=japi, obj=jobj,
    metrics=jmetrics, cs=jcs, trace=jtrace, tu=jtu, kw={},
)
TORCH = types.SimpleNamespace(
    name="torch", iface=tiface, prov=tprov, opts=topts, sa=tsa, api=tapi, obj=tobj,
    metrics=tmetrics, cs=tcs, trace=ttrace, tu=ttu, kw={"device": "cpu"},
)
GB = 1024**3

# the metric families of the estimator's routes and budget, the kernel
# ladder and the perf observatory, which the port does not have yet
UNPORTED_FAMILIES = (
    "device_dispatches_total", "estimator_kernel_route_total",
    "estimation_over_budget_total",
    "estimator_kernel_rung_attempts_total", "estimator_kernel_breaker_state",
    "estimator_breaker_transitions_total",
    "kernel_compile_seconds", "kernel_execute_seconds", "kernel_compile_cache_total",
    "kernel_model_utilization", "device_resident_bytes",
)
# the spans of the estimator, its dispatch and the perf record
UNPORTED_SPANS = ('function="estimate"', 'function="deviceDispatch"', 'function="perfRecord"')
DURATIONS = ("function_duration_seconds", "function_duration_quantile_seconds")

# the one synthetic timeline clock both packages' tracers read
CLOCK = {"now": 0.0}


def synthetic_clock() -> float:
    return CLOCK["now"]


class World(types.SimpleNamespace):
    """One package's provider, API and autoscaler of a case."""


def make_world(k, provider, api, opts) -> World:
    metrics = k.metrics.AutoscalerMetrics()
    tracer = k.trace.Tracer(
        clock=synthetic_clock, metrics=metrics,
        recorder=k.trace.FlightRecorder(capacity=opts.trace_ring_size),
        slow_tick_threshold_s=opts.trace_slow_tick_threshold_s,
    )
    sa = k.sa.StaticAutoscaler(provider, api, opts, metrics=metrics, tracer=tracer, **k.kw)
    return World(k=k, provider=provider, api=api, sa=sa)


def build_world(k, groups, nodes_per_group, pods=(), **opt_kw) -> World:
    """tests/test_static_autoscaler.py::build_world with package ``k``'s
    modules, the journal probed every tick."""
    provider = k.prov.TestCloudProvider()
    api = k.api.FakeClusterAPI()
    for name, lo, hi, cpu, mem in groups:
        n = nodes_per_group.get(name, 0)
        provider.add_node_group(
            name, lo, hi, n, k.tu.build_test_node(f"{name}-tmpl", cpu_m=cpu, mem=mem)
        )
        for i in range(n):
            node = k.tu.build_test_node(f"{name}-{i}", cpu_m=cpu, mem=mem)
            provider.add_node(name, node)
            api.add_node(node)
    for pod in pods:
        api.add_pod(pod)
    opts = k.opts.AutoscalingOptions(expander="least-waste", journal_probe_interval=1, **opt_kw)
    return make_world(k, provider, api, opts)


def tick(w: World, now: float):
    CLOCK["now"] = now
    return w.sa.run_once(now_ts=now)


def exposition(w: World) -> list:
    """The metrics exposition, less the unported families and spans, with
    the duration families' wall-clock values dropped (their counts stay)."""
    prefix = "cluster_autoscaler_"
    out = []
    for line in w.sa.metrics.registry.expose().splitlines():
        name = line.split()[2] if line.startswith("#") else line.split("{")[0].split()[0]
        family = name[len(prefix):] if name.startswith(prefix) else name
        if any(family.startswith(f) for f in UNPORTED_FAMILIES):
            continue
        if family.startswith(DURATIONS) and not line.startswith("#"):
            if any(s in line for s in UNPORTED_SPANS):
                continue
            if not family.endswith("_count"):
                line = line.rsplit(" ", 1)[0]
        out.append(line)
    return out


def state(w: World, result) -> dict:
    """Everything a tick leaves behind, in plain values: ``loop_probe``'s
    tick state with every ledger line so far, and the metrics exposition."""
    return {**loop_probe.tick_state(w.sa, w.api, w.provider, result, full=True),
            "metrics": exposition(w)}


# -- tests/test_static_autoscaler.py::TestRunOnce, as generators that yield
# (world, result) after each tick; the cases' own assertions run on both


def case_scale_up_on_pending_pods(k):
    pods = [k.tu.build_test_pod(f"p{i}", cpu_m=900, mem=1 * GB) for i in range(4)]
    w = build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 1}, pods)
    result = tick(w, 100.0)
    assert result.scale_up is not None and result.scale_up.scaled_up
    assert w.provider.scale_up_calls == [("g", result.scale_up.new_nodes)]
    assert result.scale_up.new_nodes >= 3
    yield w, result


def case_no_scale_up_when_pods_fit(k):
    pods = [k.tu.build_test_pod("p", cpu_m=100)]
    w = build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 1}, pods)
    result = tick(w, 100.0)
    assert result.filtered_schedulable == 1 and result.pending_pods == 0
    assert result.scale_up is None and w.provider.scale_up_calls == []
    yield w, result


def case_upcoming_nodes_prevent_double_scale_up(k):
    pods = [k.tu.build_test_pod(f"p{i}", cpu_m=900, mem=1 * GB) for i in range(2)]
    w = build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 0}, pods)
    r1 = tick(w, 100.0)
    assert r1.scale_up.scaled_up
    first_calls = len(w.provider.scale_up_calls)
    yield w, r1
    r2 = tick(w, 110.0)
    assert len(w.provider.scale_up_calls) == first_calls
    assert r2.filtered_schedulable == 2
    yield w, r2


def case_scale_down_empty_node_after_unneeded_time(k):
    w = build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 3},
                    [k.tu.build_test_pod("p", cpu_m=300, node_name="g-0")])
    w.sa.options.node_group_defaults.scale_down_unneeded_time_s = 50
    w.sa.options.scale_down_delay_after_add_s = 0
    r1 = tick(w, 0.0)
    assert r1.unneeded_nodes >= 2 and r1.scale_down is None
    yield w, r1
    r2 = tick(w, 100.0)
    deleted = set(r2.scale_down.deleted_empty)
    assert deleted and deleted <= {"g-1", "g-2"}
    assert not deleted & set(w.api.nodes) and w.provider.scale_down_calls
    yield w, r2


def case_scale_down_cooldown_after_scale_up(k):
    pods = [
        k.tu.build_test_pod("blk0", cpu_m=800, node_name="g-0"),
        k.tu.build_test_pod("blk1", cpu_m=800, node_name="g-1"),
        k.tu.build_test_pod("p", cpu_m=900, mem=1 * GB),
    ]
    w = build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 2}, pods)
    w.sa.options.node_group_defaults.scale_down_unneeded_time_s = 0
    r1 = tick(w, 0.0)
    assert r1.scale_up.scaled_up
    yield w, r1
    r2 = tick(w, 10.0)
    assert r2.scale_down_in_cooldown and r2.scale_down is None
    yield w, r2


def case_drain_scale_down_evicts_pods(k):
    w = build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 3},
                    [k.tu.build_test_pod("p", cpu_m=100, node_name="g-0")])
    w.sa.options.node_group_defaults.scale_down_unneeded_time_s = 50
    w.sa.options.scale_down_delay_after_add_s = 0
    w.sa.options.max_empty_bulk_delete = 2
    yield w, tick(w, 0.0)
    r2 = tick(w, 100.0)
    assert r2.scale_down is not None
    if r2.scale_down.deleted_drain:
        assert "default/p" in w.api.evicted
    yield w, r2


def case_unhealthy_cluster_halts(k):
    w = build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 3})
    for node in w.api.list_nodes():
        node.ready = False
        node.creation_ts = -10_000
    w.sa.options.ok_total_unready_count = 0
    result = tick(w, 1000.0)
    assert not result.cluster_healthy
    assert result.scale_up is None and result.scale_down is None
    yield w, result


def case_unregistered_instance_cleanup(k):
    w = build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 1})
    w.provider.add_instance("g", k.iface.Instance(id="ghost"))
    w.provider.node_groups()[0].set_target_size(2)
    r0 = tick(w, 10_000.0)
    assert r0.removed_unregistered == 0
    yield w, r0
    result = tick(w, 10_000.0 + w.sa.options.max_node_provision_time_s + 1)
    assert result.removed_unregistered == 1
    assert ("g", "ghost") in w.provider.scale_down_calls
    yield w, result


def case_errored_instances_deleted(k):
    w = build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 1})
    w.provider.add_instance("g", k.iface.Instance(
        id="bad", state=k.iface.InstanceState.CREATING,
        error_info=k.iface.InstanceErrorInfo(k.iface.InstanceErrorClass.OUT_OF_RESOURCES),
    ))
    result = tick(w, 10.0)
    assert ("g", "bad") in w.provider.scale_down_calls
    yield w, result


def case_expendable_pods_ignored(k):
    pods = [k.tu.build_test_pod("exp", cpu_m=900, mem=1 * GB, priority=-100)]
    w = build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 0}, pods)
    result = tick(w, 0.0)
    assert result.scale_up is None and w.provider.scale_up_calls == []
    yield w, result


def case_multi_loop_convergence(k):
    pods = [k.tu.build_test_pod(f"p{i}", cpu_m=800, mem=1 * GB) for i in range(4)]
    w = build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 0}, pods)
    w.sa.options.node_group_defaults.scale_down_unneeded_time_s = 60
    w.sa.options.scale_down_delay_after_add_s = 120
    r1 = tick(w, 0.0)
    assert r1.scale_up.scaled_up and r1.scale_up.new_nodes == 4
    yield w, r1
    for i in range(r1.scale_up.new_nodes):
        node = k.tu.build_test_node(f"g-{i}", cpu_m=1000, mem=2 * GB)
        w.provider.add_node("g", node)
        w.api.add_node(node)
    for i, pod in enumerate(pods):
        w.api.pods[pod.key()].node_name = f"g-{i}"
    r2 = tick(w, 30.0)
    assert r2.scale_up is None or not r2.scale_up.scaled_up
    assert len(w.provider.scale_up_calls) == 1
    yield w, r2
    del w.api.pods["default/p3"]
    yield w, tick(w, 60.0)
    r4 = tick(w, 200.0)
    assert "g-3" in (r4.scale_down.deleted_empty if r4.scale_down else [])
    yield w, r4


CASES = {
    name[len("case_"):]: fn for name, fn in sorted(globals().items())
    if name.startswith("case_")
}


def run_twins(case):
    """Run ``case`` on both packages in lockstep; after every tick, the
    two worlds' states must be equal. → the number of ticks compared."""
    ticks = 0
    jax_run, torch_run = case(JAX), case(TORCH)
    for (wj, rj), (wt, rt) in zip(jax_run, torch_run):
        ref, out = state(wj, rj), state(wt, rt)
        diff = sorted(key for key in ref if ref[key] != out[key])
        assert not diff, f"tick {ticks + 1}: {diff} differ"
        ticks += 1
    for rest in (jax_run, torch_run):
        assert next(rest, None) is None, "one package ran more ticks"
    return ticks


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_once_matches_jax(case):
    assert run_twins(CASES[case]) >= 1


def test_every_run_once_case_is_twinned():
    """Each TestRunOnce case of the JAX package's tests has its twin here."""
    import test_static_autoscaler

    names = {n[len("test_"):] for n in dir(test_static_autoscaler.TestRunOnce)
             if n.startswith("test_")}
    assert names == set(CASES)


# -- a three-tick sequence on torch_parity.tick_world ------------------------


def late_pods(k, n=8):
    """Pods listed before the third tick: tick_world's pending pods' shape,
    one in two with tick_world's zone DoNotSchedule spread."""
    pods = []
    for i in range(n):
        p = k.tu.build_test_pod(f"late{i}", cpu_m=1500.0 + 250 * i, mem=512 * 1024**2,
                                labels={"app": f"a{i % 3}"})
        if i % 2 == 0:
            p.topology_spread = (k.obj.TopologySpreadConstraint(
                max_skew=1, topology_key="zone",
                selector=k.obj.LabelSelector.from_dict({"app": f"a{i % 3}"}),
            ),)
        pods.append(p)
    return pods


def case_tick_world_sequence(k, spread=True, **opt_kw):
    snap, pending, provider = tick_world(k.tu, k.obj, k.prov, k.cs, spread, **k.kw)
    api = k.api.FakeClusterAPI()
    for node in snap.nodes():
        api.add_node(node)
    for pod in snap.pods():
        api.add_pod(pod)
    opts = k.opts.AutoscalingOptions(expander="least-waste", expander_random_seed=0,
                                     journal_probe_interval=1, **opt_kw)
    w = make_world(k, provider, api, opts)
    calls = 0
    for i, now in enumerate(loop_probe.LOOP_TICKS):
        if i:
            churned = loop_probe.churn(w.sa, api, provider, calls, seed=i,
                                       arriving=late_pods(k) if i == 2 else ())
            calls = len(provider.scale_up_calls)
            assert churned["arrived"] == (8 if i == 2 else 0)
        yield w, tick(w, now)


@pytest.mark.parametrize("arena", [False, True], ids=["cold", "arena"])
def test_tick_world_sequence_matches_jax(arena):
    """Three ticks (loop_probe.LOOP_TICKS) over one autoscaler a package,
    with loop_probe.churn between them (filtered pods bound, the requested
    nodes up with the remaining pods on them, new pods before the third):
    equal after every tick, the journal's probe finding no drift, and the
    port's estimate taking the dynamic route on the spread leftovers. With
    the arena, the packer serves resident tensors and the estimator its
    resident operands, and the arena's metrics count alike."""
    for key in tbin.ROUTES:
        tbin.ROUTES[key] = 0
    assert run_twins(lambda k: case_tick_world_sequence(k, arena_enabled=arena)) == 3
    assert tbin.ROUTES["ffd_scan_aff"] >= 1


def test_loop_probe_runs_the_chip_loop_on_the_cpu():
    """tools/loop_probe.run_loop_ticks, which chip_smoke's 3o and 4l run
    through, on a cut-down world on the CPU: the timed run (its wrappers in
    place) equals the plain one tick for tick, the ticks scale up, delete
    and take the dynamic route as 3o expects, and the probe finds no drift."""
    from autoscaler_tpu_torch.utils.workload import build_snapshot_world

    nodes, pods = build_snapshot_world(N=300, P=2000, port_nodes=100)
    nodes, pods = loop_probe.scale_in_listing(nodes, pods)
    templates, burst = loop_probe.burst_operands()
    groups = loop_probe.zoned_templates(templates)
    for key in tbin.ROUTES:
        tbin.ROUTES[key] = 0
    with loop_probe.KernelCapture() as capture:
        timed = loop_probe.run_loop_ticks(nodes, pods, burst[:600], groups, "cpu",
                                          timed=True, arrive=100, replayable=True)
    routes = dict(tbin.ROUTES)
    assert capture.counts()["ffd_scan_aff"] == routes["ffd_scan_aff"] == 1
    assert capture.counts()["ffd_scan_swar"] + capture.counts()["ffd_scan_f32"] >= 1
    held = loop_probe.hold_launches(capture.launches)
    assert len(held) == len(capture.launches) and not any(differ for *_, differ in held)
    plain = loop_probe.run_loop_ticks(nodes, pods, burst[:600], groups, "cpu", arrive=100,
                                      replayable=True)
    for a, b in zip(timed["ticks"], plain["ticks"]):
        assert loop_probe.state_differences(a["state"], b["state"]) == []
        assert a["probe"]["checked"] and not a["probe"]["drift"]
        assert set(a["split"]) == {"tick"} | {key for key, _ in loop_probe.SPLIT}
    first, second, third = (t["result"] for t in timed["ticks"])
    assert first.scale_up.scaled_up and first.scale_down_in_cooldown
    assert second.scale_down is not None and second.scale_down.deleted_empty
    assert third.scale_up is not None and routes["ffd_scan_aff"] == 1
    assert timed["autoscaler"]._packer.journal_sink == timed["autoscaler"].journal.observe_update


def test_hold_launches_finds_a_differing_output():
    """``hold_launches`` names the field where a captured output departs
    from the plain version on the captured operands."""
    import torch

    from autoscaler_tpu_torch.ops import fit_reduce

    g = torch.Generator().manual_seed(0)
    pod_req, free = torch.rand(8, 3, generator=g), torch.rand(5, 3, generator=g)
    classes = torch.zeros(8, dtype=torch.int32), torch.zeros(5, dtype=torch.int32)
    operands = (pod_req, free, *classes, torch.ones(1, 1, dtype=torch.bool),
                torch.ones(5, dtype=torch.bool))
    rows = (pod_req[:4], free, torch.rand(4, 5, generator=g) > 0.5,
            torch.tensor([0, 1, 2, -1], dtype=torch.int32))
    real = fit_reduce.fit_reduce_cuda, fit_reduce.fit_reduce_rows
    with loop_probe.KernelCapture() as capture:
        fit_reduce.fit_reduce_cuda(*operands)
        fit_reduce.fit_reduce_rows(*rows)
    assert (fit_reduce.fit_reduce_cuda, fit_reduce.fit_reduce_rows) == real
    assert capture.counts() == {"fit_reduce": 1, "fit_reduce_rows": 1}
    assert loop_probe.hold_launches(capture.launches) == [
        ("fit_reduce", [8, 3], 0.0, []), ("fit_reduce_rows", [4, 3], 0.0, [])]
    name, args, got = capture.launches[0]
    got.fit_count[0] += 1
    assert loop_probe.hold_launches([(name, args, got)])[0][3] == ["fit_count"]


def test_unported_options_raise():
    provider, api = tprov.TestCloudProvider(), tapi.FakeClusterAPI()
    for kw, item in (
        ({"preemption_enabled": True}, "preemption"),
        ({"jax_profiler_dir": "x"}, "trace/device.py"),
        ({"perf_cost_model": True}, "estimator services"),
    ):
        with pytest.raises(NotImplementedError, match=item):
            tsa.StaticAutoscaler(provider, api, topts.AutoscalingOptions(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match="observatory"):
        tsa.StaticAutoscaler(provider, api, topts.AutoscalingOptions(),
                             observatory=object(), device="cpu")


def test_autoscaler_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsa.StaticAutoscaler(tprov.TestCloudProvider(), tapi.FakeClusterAPI())


def test_autoscaler_threads_its_device():
    import torch

    sa = tsa.StaticAutoscaler(tprov.TestCloudProvider(), tapi.FakeClusterAPI(),
                              topts.AutoscalingOptions(arena_enabled=True), device="cpu")
    cpu = torch.device("cpu")
    assert sa.device == cpu and sa._packer.device == cpu and sa._arena.device == cpu
    assert sa.scale_up_orchestrator.estimator.device == cpu
    assert sa._operand_arena.device == cpu
    assert sa.kernel_ladder() is None and sa.degraded_rungs() == []
