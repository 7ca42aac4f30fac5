"""The scenario engine's device, API and preemption faults on the CPU
against the JAX package: each fault kind the JAX suites drive through the
scenario driver (``kernel_fault`` on every device rung, ``device_lost``,
``kube_api_error``, ``template_error``, ``arena_fault``,
``provider_latency``, ``spot_reclaim`` under priorities and preemption) in
a spec built in code, through both packages' drivers: every artifact equal,
the JAX package's under the name map (``torch_loadgen_twin``). Off the card
the port's ladder descends as the JAX package's does; on the card a
cuda-rung fault raises (chip_smoke 5e)."""
import pytest

import autoscaler_tpu_torch.loadgen.faults as tfaults
import autoscaler_tpu_torch.loadgen.spec as tspec
import torch_loadgen_twin as twin
from autoscaler_tpu_torch.estimator.ladder import DEVICE_RUNGS
from autoscaler_tpu_torch.tools import drill_probe


def spec_doc(name, **kw):
    doc = dict(
        name=name, seed=4, ticks=10,
        node_groups=[dict(name="g", min_size=0, max_size=10, initial_size=1)],
        events=[dict(at_tick=1, kind="pod_burst", count=8, cpu_m=1500.0, mem_mb=1024.0,
                     prefix="burst"),
                dict(at_tick=4, kind="pod_burst", count=5, cpu_m=900.0, mem_mb=512.0,
                     prefix="more")],
        options={"kernel_breaker_failure_threshold": 1, "kernel_breaker_cooldown_s": 20.0},
    )
    doc.update(kw)
    return doc


def fault_event(at, clear_at=None, **fault):
    evs = spec_doc("x")["events"] + [dict(at_tick=at, kind="fault", fault=fault)]
    if clear_at is not None:
        evs.append(dict(at_tick=clear_at, kind="clear_faults"))
    return evs


FAULTS = {
    # the JAX package's rung names: the port's spec reads them as its own
    "kernel_fault-xla": spec_doc("kernel_fault-xla",
                                 events=fault_event(1, 6, kind="kernel_fault", rung="xla")),
    "kernel_fault-pallas": spec_doc("kernel_fault-pallas",
                                    events=fault_event(1, 6, kind="kernel_fault", rung="pallas")),
    "kernel_fault-any": spec_doc("kernel_fault-any",
                                 events=fault_event(1, 6, kind="kernel_fault")),
    "device_lost": spec_doc("device_lost", faults=[dict(kind="device_lost", start_tick=1,
                                                        end_tick=5)]),
    "kube_api_error": spec_doc("kube_api_error", faults=[dict(kind="kube_api_error",
                                                              start_tick=2, end_tick=4)]),
    "template_error": spec_doc(
        "template_error",
        node_groups=[dict(name="g", min_size=0, max_size=10, initial_size=1),
                     dict(name="h", min_size=0, max_size=10, initial_size=0, cpu_m=8000.0)],
        faults=[dict(kind="template_error", group="g", start_tick=1, end_tick=3)]),
    "provider_latency": spec_doc("provider_latency", faults=[
        dict(kind="provider_latency", latency_s=0.25, probability=0.5)]),
    "spot_reclaim": spec_doc(
        "spot_reclaim", ticks=10,
        events=[dict(at_tick=0, kind="pod_burst", count=6, cpu_m=1200.0, mem_mb=1024.0,
                     prefix="low", priority=0),
                dict(at_tick=3, kind="pod_burst", count=4, cpu_m=1200.0, mem_mb=1024.0,
                     prefix="high", priority=1000, preemption_policy="Never")],
        faults=[dict(kind="spot_reclaim", priority_cutoff=10, start_tick=5)],
        options={"preemption_enabled": True}),
    "preemption": spec_doc(
        "preemption", ticks=8,
        node_groups=[dict(name="g", min_size=2, max_size=2, initial_size=2)],
        events=[dict(at_tick=0, kind="pod_burst", count=6, cpu_m=1200.0, mem_mb=1024.0,
                     prefix="low", priority=0),
                dict(at_tick=2, kind="pod_burst", count=3, cpu_m=1500.0, mem_mb=1024.0,
                     prefix="high", priority=1000)],
        options={"preemption_enabled": True, "preemption_churn_weight": 1.0}),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_fault_run_matches_jax(name):
    jres, tres = twin.assert_twin(FAULTS[name])
    kind = name.split("-")[0]
    if kind not in ("preemption",):
        assert tres.injected_faults, f"{name}: no fault fired"


def test_arena_fault_matches_jax():
    """The arena's delta apply fails for two ticks: the faulted ticks serve
    from a cold upload and the arena reseeds, alike in both packages."""
    doc = spec_doc("arena_fault", ticks=6,
                   faults=[dict(kind="arena_fault", start_tick=2, end_tick=4)],
                   options={"arena_enabled": True})
    jres, tres = twin.assert_twin(doc)
    assert tres.injected_faults == {"arena_fault": 2}


def test_kernel_fault_descends_and_recovers_off_the_card():
    """Off the card a torch-rung fault trips its breaker, the estimates
    descend (the tick's record names the tripped rung), and after the clear
    a half-open probe closes it again: decisions flow throughout."""
    doc = spec_doc("kernel_fault-recovery", ticks=12,
                   events=fault_event(1, 6, kind="kernel_fault", rung="xla") + [
                       dict(at_tick=9, kind="pod_burst", count=4, cpu_m=1800.0,
                            mem_mb=1024.0, prefix="late")])
    _, tres = twin.assert_twin(doc)
    degraded = [r.degraded for r in tres.records]
    assert ["torch"] in degraded and degraded[-1] == []
    assert all(not r.errors for r in tres.records)
    assert sum(n for r in tres.records for _, n in r.scale_ups) > 0


def test_kube_api_error_records_the_typed_error():
    _, tres = twin.run_both(FAULTS["kube_api_error"])
    crashed = [r for r in tres.records if r.errors]
    assert [r.tick for r in crashed] == [2, 3]
    assert all("run_once crashed" in e for r in crashed for e in r.errors)
    assert all(not r.cluster_healthy for r in crashed)


def test_spot_reclaim_repends_low_priority_pods():
    _, tres = twin.run_both(FAULTS["spot_reclaim"])
    assert sum(r.reclaimed for r in tres.records) > 0


def test_injector_device_rungs_are_the_ladders():
    """Only the ladder's device rungs can fault; the host rungs are the
    degradation target."""
    assert DEVICE_RUNGS == ("cuda", "torch")
    inj = tfaults.FaultInjector([tspec.FaultSpec(kind="kernel_fault", rung="cuda")], seed=0)
    assert inj.on_kernel_dispatch("cuda") == "kernel_fault"
    assert inj.on_kernel_dispatch("torch") is None
    assert inj.on_kernel_dispatch("native") is None
    lost = tfaults.FaultInjector([tspec.FaultSpec(kind="device_lost")], seed=0)
    assert [lost.on_kernel_dispatch(r) for r in ("cuda", "torch", "native", "python")] == [
        "device_lost", "device_lost", None, None]


def test_drill_fault_matches_jax_and_recovers():
    """5e's drill off the card: the cuda-rung fault (the JAX package's
    pallas rung) is injected on its two ticks, the ladder descends, and
    after the clear the decisions flow with no rung tripped."""
    jres, tres = twin.assert_twin(drill_probe.fault_doc())
    assert tres.injected_faults.get("kernel_fault", 0) >= 2
    assert drill_probe.fault_problems(tres, card=False) == []
