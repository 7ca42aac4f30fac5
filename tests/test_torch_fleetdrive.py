"""The fleet drill (``loadgen/fleetdrive.py``) on the CPU against the JAX
package:

- the cases of tests/test_fleet.py, test_fleet_overload.py and
  test_fleet_ha.py that drive the load generator's fleet mode (left out of
  test_torch_fleet.py until the port had one), run on the port's modules
  (``torch_parity.Rebound``); the two that read the canned
  ``fleet_tenants`` or drive bench.py have their twins in
  ``test_torch_canned_fleet.py``;
- twin drills: a fleet scenario in the shape of the canned
  ``fleet_tenants`` (``tools/drill_probe.fleet_doc``), with and without a
  fault window on the batched rung, storms, sheds, outages and replica
  faults, through both packages' drivers: the fleet decision ledgers, the
  reports without their walls, the SLO and perf ledgers, the fault counts,
  the certificate and the admission tallies equal, the JAX package's under
  the name map (``torch_loadgen_twin``).
"""
import inspect

import pytest
import torch

import autoscaler_tpu_torch.fleet.coalescer as tcoalescer
import autoscaler_tpu_torch.loadgen.driver as tdriver
import autoscaler_tpu_torch.loadgen.fleetdrive as tfleetdrive
import autoscaler_tpu_torch.parallel.mesh as tmesh
import test_fleet
import test_fleet_ha
import test_fleet_overload
import torch_loadgen_twin as twin
from autoscaler_tpu_torch.tools import drill_probe
from torch_parity import Rebound


def _cpu(device=None):
    return torch.device("cpu") if device is None else torch.device(device)


@pytest.fixture()
def on_cpu(monkeypatch):
    for mod in (tdriver, tfleetdrive, tcoalescer, tmesh):
        monkeypatch.setattr(mod, "resolve_device", _cpu)


MODULES = {m.__name__: Rebound(m) for m in (test_fleet, test_fleet_overload, test_fleet_ha)}
DRIVER_CASES = [
    ("test_fleet", "test_cli_rejects_explain_ledger_for_fleet_scenarios"),
    ("test_fleet", "test_fleet_spec_roundtrip"),
    ("test_fleet", "test_fleet_spec_rejects_workloads_and_empty_tenants"),
    ("test_fleet", "test_fleet_driver_smoke"),
    ("test_fleet", "test_fleet_driver_certifies_and_replays_byte_identically"),
    ("test_fleet", "test_fleet_perf_ledger_validates"),
    ("test_fleet_overload", "test_new_fault_kinds_roundtrip_and_validate"),
    ("test_fleet_overload", "test_fleet_driver_overload_chaos_smoke"),
    ("test_fleet_overload", "test_rpc_slow_latency_reaches_slis_deterministically"),
    ("test_fleet_ha", "test_new_replica_fault_kinds_roundtrip_and_validate"),
    ("test_fleet_ha", "test_driver_routes_around_a_restarting_replica"),
    ("test_fleet_ha", "test_endpoint_choice_column_replays_byte_identically"),
    ("test_fleet_ha", "test_full_outage_sheds_typed_and_burns_budget"),
    ("test_fleet_ha", "test_ha_report_section"),
    ("test_fleet_ha", "test_replica_fault_out_of_range_is_rejected"),
]


@pytest.mark.parametrize("module,name", DRIVER_CASES, ids=[f"{m}::{n}" for m, n in DRIVER_CASES])
def test_jax_fleet_driver_case_on_the_port(module, name, request, on_cpu):
    rb = MODULES[module]
    target = getattr(rb.module, name)
    params = list(inspect.signature(target).parameters)
    rb.case(name)(**{p: request.getfixturevalue(p) for p in params})


def fleet(name, **kw):
    doc = drill_probe.fleet_doc(ticks=4)
    doc["name"] = name
    doc["options"] = dict(doc["options"], fleet_shape_buckets="32x8x8,128x16x8",
                          fleet_prewarm=False)
    doc.update(kw)
    return doc


TWINS = {
    "fleet_tenants": fleet("fleet_tenants"),
    # the canned scenario's window: a batched-rung fault for two rounds
    "batched-fault": fleet("batched-fault", events=[
        {"at_tick": 1, "kind": "fault", "fault": {"kind": "kernel_fault", "rung": "xla",
                                                  "end_tick": 2}},
        {"at_tick": 3, "kind": "clear_faults"}]),
    "device_lost": fleet("device_lost", faults=[
        {"kind": "device_lost", "start_tick": 2, "end_tick": 3}]),
    "storm-outage": fleet("storm-outage", seed=2, events=[
        {"at_tick": 2, "kind": "fault", "fault": {"kind": "sidecar_crash", "end_tick": 1}}],
        options={"fleet_shape_buckets": "32x8x8,128x16x8", "fleet_prewarm": False,
                 "fleet_tenant_qps": 0.2, "fleet_tenant_burst": 2.0}),
    "replicas": dict(fleet("replicas", events=[
        {"at_tick": 1, "kind": "fault", "fault": {"kind": "replica_restart", "replica": 0,
                                                  "end_tick": 2}},
        {"at_tick": 2, "kind": "fault", "fault": {"kind": "endpoint_flap", "replica": 1,
                                                  "probability": 0.5}}]),
        fleet=dict(drill_probe.fleet_doc()["fleet"], replicas=3)),
    "prewarm-rpc_slow": fleet("prewarm-rpc_slow", faults=[
        {"kind": "rpc_slow", "latency_s": 2.5, "end_tick": 1}],
        options={"fleet_shape_buckets": "32x8x8,128x16x8", "fleet_prewarm": True}),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_fleet_drill_matches_jax(name):
    jres, tres = twin.run_fleet_both(TWINS[name])
    diff = sorted(k for k, (a, b) in twin.fleet_views(jres, tres).items() if a != b)
    assert not diff, f"{name}: {diff} differ"
    assert tres.records and tres.unresolved == 0


def test_fleet_tenants_certifies_every_answer():
    """3x's drill off the card: every answer equals its solo dispatch."""
    doc = drill_probe.fleet_doc(ticks=3)
    result, seconds = drill_probe.run_fleet(doc, "cpu")
    assert result.all_match() and seconds > 0
    assert sum(len(r.tenants) for r in result.records) == 3 * len(doc["fleet"]["tenants"])
    assert result.device == "cpu"


def test_batched_fault_descends_off_the_card():
    """Off the card a fault on the batched rung descends to the oracle for
    the faulted rounds, with every answer still equal to solo."""
    jres, tres = twin.run_fleet_both(TWINS["batched-fault"])
    routes = [{t.route for t in r.tenants} for r in tres.records]
    assert "fleet_oracle" in set().union(*routes)
    assert tres.all_match()
    assert any(r.degraded == ["torch"] for r in tres.records)
