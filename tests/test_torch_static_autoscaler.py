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
metrics exposition: the JAX package's lines under the rung, route and
reason name map (``torch_parity.NAME_MAP``), the estimator's, the kernel
ladder's and the perf observatory's families and spans among them. Only
the families of what the port does not have yet would be left out, listed
by name in ``UNPORTED_FAMILIES``, with the spans those time
(``UNPORTED_SPANS``): both are empty. The duration families keep their
counts, not their wall-clock values.
"""
import json
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
from autoscaler_tpu_torch.tools import loop_probe
from torch_parity import port_exposition_line, port_label, tick_world

JAX = types.SimpleNamespace(
    name="jax", iface=jiface, prov=jprov, opts=jopts, sa=jsa, api=japi, obj=jobj,
    metrics=jmetrics, cs=jcs, trace=jtrace, tu=jtu, kw={},
)
TORCH = types.SimpleNamespace(
    name="torch", iface=tiface, prov=tprov, opts=topts, sa=tsa, api=tapi, obj=tobj,
    metrics=tmetrics, cs=tcs, trace=ttrace, tu=ttu, kw={"device": "cpu"},
)
GB = 1024**3

# the metric families of what the port does not have yet: none since the
# estimator's routes and budget, the kernel ladder and the perf
# observatory were ported
UNPORTED_FAMILIES = ()
# the spans those would time
UNPORTED_SPANS = ()
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
    """The metrics exposition (the JAX package's under the name map), less
    the unported families and spans, with the duration families'
    wall-clock values dropped (their counts stay)."""
    prefix = "cluster_autoscaler_"
    out = []
    for line in w.sa.metrics.registry.expose().splitlines():
        if w.k is JAX:
            line = port_exposition_line(line)
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
    worlds = {}

    def case(k):
        for w, result in case_tick_world_sequence(k, arena_enabled=arena):
            worlds[k.name] = w
            yield w, result

    assert run_twins(case) == 3
    # the dynamic per-pod route: the affinity torch loop, observed with its
    # term operands
    records = worlds["torch"].sa.observatory.records()
    assert any(d["route"] == "torch_scan" and "match=" in d["sig"]
               for rec in records for d in rec["dispatches"])


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
    with loop_probe.KernelCapture() as capture:
        timed = loop_probe.run_loop_ticks(nodes, pods, burst[:600], groups, "cpu",
                                          timed=True, arrive=100, replayable=True)
    route = timed["autoscaler"].metrics.estimator_kernel_route_total
    # on the CPU the torch loops serve every estimate (not_cuda), so the
    # capture (in place, and transparent) sees no scan launch; the scan
    # kernels' capture and hold are tested on their own below
    assert route.get(route="torch_scan", reason="not_cuda") >= 2
    assert route.get(route="cuda", reason="ok") == route.get(route="cuda_affinity", reason="ok") == 0
    assert not {"ffd_scan_swar", "ffd_scan_f32", "ffd_scan_aff"} & set(capture.counts())
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
    assert third.scale_up is not None
    assert timed["autoscaler"]._packer.journal_sink == timed["autoscaler"].journal.observe_update


def test_hold_launches_holds_the_scan_kernels():
    """K1, K2 and K3 launched through their glue on CPU tensors (their
    wrappers then run the plain versions) are captured and held, every
    field equal."""
    import numpy as np

    from autoscaler_tpu_torch.ops import ffd_scan, ffd_scan_affinity
    from autoscaler_tpu_torch.utils.workload import build_affinity_workload, build_workload

    req, masks, allocs, caps = build_workload(P=300, G=6, seed=1)
    frac = req.copy()
    frac[:, 1] += 0.5                      # fractional memory: the f32 plan
    aff = build_affinity_workload(200, 4, 8, seed=2)
    with loop_probe.KernelCapture() as capture:
        for r in (req, frac):
            ops = ffd_scan.operands_from_numpy(r, masks, allocs, caps, "cpu")
            ffd_scan.ffd_binpack_groups_cuda(*ops[:3], max_nodes=64, node_caps=ops[3])
        ops = ffd_scan_affinity.affinity_operands_from_numpy(
            *aff, node_caps=np.full(4, 32, np.int32), device="cpu")
        ffd_scan_affinity.ffd_binpack_groups_affinity_cuda(**ops, max_nodes=32)
    assert capture.counts() == {"ffd_scan_swar": 1, "ffd_scan_f32": 1, "ffd_scan_aff": 1}
    held = loop_probe.hold_launches(capture.launches)
    assert [name for name, *_ in held] == ["ffd_scan_swar", "ffd_scan_f32", "ffd_scan_aff"]
    assert all(err == 0.0 and not differ for _, _, err, differ in held)


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


def test_unported_options_raise(tmp_path, monkeypatch):
    """No option is refused any more: the profiler is taken (a tick writes
    its torch.profiler session under ``tick_<id>``, keyed by the tick's
    trace id); preemption is taken and built as in the JAX package (an
    engine on the orchestrator's estimator, the churn filter leading the
    chain); the perf observatory and its cost model are taken."""
    from autoscaler_tpu_torch.perf import PerfObservatory
    from autoscaler_tpu_torch.trace import device as tdev

    monkeypatch.setattr(tdev, "_sessions_broken", False)
    provider, api = tprov.TestCloudProvider(), tapi.FakeClusterAPI()
    sa = tsa.StaticAutoscaler(provider, api,
                              topts.AutoscalingOptions(jax_profiler_dir=str(tmp_path)),
                              device="cpu")
    sa.run_once(now_ts=0.0)
    tid = sa.tracer.recorder.traces()[0].trace_id
    capture = tmp_path / f"tick_{tid:06d}" / tdev.TRACE_FILE
    assert capture.stat().st_size > 0 and f"ProfilerStep#{tid}" in capture.read_text()
    built = {}
    for k in (JAX, TORCH):
        opts = k.opts.AutoscalingOptions(preemption_enabled=True, preemption_churn_weight=1.0)
        sa = k.sa.StaticAutoscaler(k.prov.TestCloudProvider(), k.api.FakeClusterAPI(), opts,
                                   **k.kw)
        orch = sa.scale_up_orchestrator
        assert sa.preempt_engine.estimator is orch.estimator
        built[k.name] = (type(sa.preempt_engine).__name__,
                         [f.name for f in orch.expander.filters], orch.churn_filter.weight)
    assert built["torch"] == built["jax"]
    sa = tsa.StaticAutoscaler(provider, api, topts.AutoscalingOptions(perf_cost_model=True),
                              device="cpu")
    assert sa.observatory.cost_model_enabled
    obs = PerfObservatory()
    sa = tsa.StaticAutoscaler(provider, api, topts.AutoscalingOptions(), observatory=obs,
                              device="cpu")
    assert sa.observatory is obs and sa.scale_up_orchestrator.estimator.observatory is obs


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
    from autoscaler_tpu_torch.estimator.ladder import KernelLadder

    assert isinstance(sa.kernel_ladder(), KernelLadder) and sa.degraded_rungs() == []
    assert sa._arena.observatory is sa.observatory


# -- run_once with faults injected through the kernel ladder's hook


def port_named(st: dict, k) -> dict:
    """A tick state with the JAX package's rung names under the name map
    (its decision lines' degraded rungs, its status ConfigMap's degraded
    line), and each journal line without its decision line's sha256: that
    hash pins a decision line which differs between the packages exactly
    by those names. Each package's own pin is held in
    ``test_run_once_under_kernel_faults_matches_jax``."""
    import json
    import re

    from autoscaler_tpu_torch.explain.ledger import record_line as explain_line

    def rename(rec):
        if isinstance(rec, dict):
            return {key: ([port_label("rung", r) for r in value] if key == "degraded_rungs"
                          else rename(value)) for key, value in rec.items()}
        if isinstance(rec, list):
            return [rename(v) for v in rec]
        return rec

    def status_line(match):
        return match.group(1) + ",".join(port_label("rung", r) for r in match.group(2).split(","))

    out = dict(st)
    out["decision"] = [explain_line(rename(json.loads(line))) for line in st["decision"]]
    out["journal"] = [{k_: v for k_, v in json.loads(line).items() if k_ != "explain_sha256"}
                      for line in st["journal"]]
    out["configmaps"] = json.loads(re.sub(
        r"(kernel ladder rungs tripped: )([a-z_,]+)", status_line, json.dumps(st["configmaps"])))
    return out


def faulted_world(k):
    """Two pods a 2000m node holds and five it never can, so every tick
    estimates: the five stay pending, the first two scale up."""
    pods = [k.tu.build_test_pod(f"fit{i}", cpu_m=900.0 + 10 * i, mem=GB) for i in range(2)]
    pods += [k.tu.build_test_pod(f"big{i}", cpu_m=3000.0 + 10 * i, mem=GB) for i in range(5)]
    return build_world(k, [("g", 0, 10, 2000, 4 * GB)], {"g": 0}, pods,
                       kernel_breaker_failure_threshold=2, kernel_breaker_cooldown_s=30.0)


def faulted_tick_world(k):
    w = None
    for w, _ in case_tick_world_sequence(k, kernel_breaker_failure_threshold=2,
                                         kernel_breaker_cooldown_s=30.0):
        break
    return w


@pytest.mark.parametrize("faults", [("cuda", "torch"), ("torch",)], ids=["device", "torch"])
@pytest.mark.parametrize("world", ["plain", "spread"])
def test_run_once_under_kernel_faults_matches_jax(world, faults):
    """Faults armed on the device rungs (``fault_hook``) for the first
    ticks, then cleared: after every tick the whole state and the metrics
    exposition — the route, rung-attempt, breaker and perf families among
    them — equal the JAX package's under the name map; the breaker trips,
    the estimator serves from a lower rung (forced on the spread world, which
    no host rung serves), the status reads degraded, and past the cooldown a
    half-open probe closes the breakers again."""
    import hashlib

    worlds = {}
    for k in (JAX, TORCH):
        w = faulted_world(k) if world == "plain" else faulted_tick_world(k)
        armed = {"on": True}
        ladder = w.sa.kernel_ladder()
        ladder.fault_hook = lambda rung, armed=armed: (
            "kernel_fault" if armed["on"] and port_label("rung", rung) in faults else None)
        worlds[k.name] = (w, armed)
    degraded = []
    for i, now in enumerate((700.0, 710.0, 720.0, 800.0)):
        states = {}
        for name, (w, armed) in worlds.items():
            armed["on"] = i < 3
            result = tick(w, now)
            st = state(w, result)
            for line, jline in zip(st["decision"], st["journal"]):
                pin = json.loads(jline)["explain_sha256"]
                assert pin in ("", hashlib.sha256(line.encode()).hexdigest())
            states[name] = port_named(st, w.k)
        diff = sorted(key for key in states["jax"] if states["jax"][key] != states["torch"][key])
        assert not diff, f"tick {i + 1}: {diff} differ"
        degraded.append(worlds["torch"][0].sa.degraded_rungs())
    sa = worlds["torch"][0].sa
    assert any(degraded) and degraded[-1] == []
    attempts = sa.metrics.estimator_kernel_rung_attempts_total
    assert attempts.get(rung=faults[-1], outcome="fault") >= 2
    assert attempts.get(rung=faults[-1], outcome="skipped") >= 1
    transitions = sa.metrics.estimator_breaker_transitions_total
    assert transitions.get(rung=faults[-1], from_state="half_open", to_state="closed") == 1
