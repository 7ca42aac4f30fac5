"""The fleet on the CPU against the JAX package:

- every case of tests/test_fleet.py, test_fleet_overload.py and
  test_fleet_ha.py that builds a coalescer, an admission controller, quota
  tiers or an endpoint balancer, run on the port's modules
  (``torch_parity.Rebound``: the case's globals and imports pointed at the
  port, its rung labels under the name map, the port's entry points bound
  to the CPU);
- twin rounds: both packages' coalescers on the same submissions and the
  same injected clock, with and without faults injected on the batched
  rung, overload sheds, deadlines, tiers and a drain — equal answers, shed
  verdicts, fleet decision-ledger records (``tools/fleet_probe.
  serve_round``), spans and metric expositions (the JAX package's under
  ``torch_parity.NAME_MAP``);
- the estimator's fleet lane (a ``FleetEstimatorClient`` per estimator on
  one shared coalescer) against the same estimator's solo estimate, in
  both packages, with its fall-backs, and the card's strictness (a batch
  failed on the card's rung raises, never descends);
- chip_smoke's 4q and 5d helpers at a small size.
"""
import inspect

import numpy as np
import pytest
import torch

import autoscaler_tpu.estimator.binpacking as jbinpacking
import autoscaler_tpu.estimator.ladder as jladder
import autoscaler_tpu.fleet as jfleet
import autoscaler_tpu.gym.env as jgym
import autoscaler_tpu.metrics.metrics as jmetrics
import autoscaler_tpu.parallel.mesh as jmesh
import autoscaler_tpu.trace as jtrace
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.estimator.binpacking as tbinpacking
import autoscaler_tpu_torch.estimator.ladder as tladder
import autoscaler_tpu_torch.fleet as tfleet
import autoscaler_tpu_torch.fleet.coalescer as tcoalescer
import autoscaler_tpu_torch.gym.env as tgym
import autoscaler_tpu_torch.metrics.metrics as tmetrics
import autoscaler_tpu_torch.parallel.mesh as tmesh
import autoscaler_tpu_torch.rpc.service as tservice
import autoscaler_tpu_torch.trace as ttrace
import autoscaler_tpu_torch.utils.test_utils as ttu
import test_fleet
import test_fleet_ha
import test_fleet_overload
from autoscaler_tpu_torch.tools import fleet_probe
from torch_parity import Rebound, port_exposition_line, port_label


def _cpu(device=None):
    return torch.device("cpu") if device is None else torch.device(device)


@pytest.fixture()
def on_cpu(monkeypatch):
    """The port's fleet entry points default to the CPU (on a host the
    tests would otherwise refuse: they default to the first card)."""
    for mod in (tcoalescer, tmesh, tservice):
        monkeypatch.setattr(mod, "resolve_device", _cpu)


# -- the JAX package's cases on the port ------------------------------------------

MODULES = {m.__name__: Rebound(m) for m in (test_fleet, test_fleet_overload, test_fleet_ha)}
# cases that drive the load generator (in test_torch_fleetdrive.py; the
# canned fleet_tenants CLI run and the fleet ledger gate have their twins
# in test_torch_canned_fleet.py), a gRPC server or client (in
# test_torch_sidecar.py), the static checker or the XLA scan itself
NOT_HERE = ("driver", "cli_", "spec_", "perf_ledger", "fault_kinds", "ha_report",
            "ledger_validator", "full_outage", "endpoint_choice_column", "replica_fault",
            "rpc_", "serve_", "scenario_kernel", "Client", "Hedge", "send_rides",
            "call_does_not", "non_outage", "released_probe", "resource_exhausted_probe",
            "duplicate_endpoints", "health_server", "fleet_pb2", "parse_rejects_malformed")


def _cases():
    out = []
    for name, rb in MODULES.items():
        for key, value in vars(rb.module).items():
            if key.startswith("test_") and callable(value):
                out.append((name, key))
            elif key.startswith("Test") and isinstance(value, type):
                out += [(name, f"{key}.{m}") for m in vars(value) if m.startswith("test_")]
    return [(m, n) for m, n in out if not any(s in n for s in NOT_HERE)]


CASES = _cases()


@pytest.mark.parametrize("module,name", CASES, ids=[f"{m}::{n}" for m, n in CASES])
def test_jax_fleet_case_on_the_port(module, name, request, on_cpu):
    rb = MODULES[module]
    target = getattr(rb.module, name.split(".")[0])
    if "." in name:
        target = getattr(target, name.split(".")[1])
    params = [p for p in inspect.signature(target).parameters if p != "self"]
    rb.case(name)(**{p: request.getfixturevalue(p) for p in params})


@pytest.mark.parametrize("bad", ["", "64x8", "axbxc", "0x8x8", "63x8x8"])
def test_parse_rejects_malformed_on_the_port(bad):
    MODULES["test_fleet"].case("test_parse_rejects_malformed")(bad=bad)


def test_the_cases_cover_the_fleet_suites():
    assert len(CASES) >= 55
    for suite in ("TestTokenBucket", "TestAdmissionController", "TestCoalescerAdmission",
                  "TestDrain", "TestAbandonment", "TestEndpointBalancer", "TestTierPolicy",
                  "TestCoalescerTiers", "test_fault_isolation", "test_breaker_recovers"):
        assert any(suite in n for _, n in CASES), suite


# -- twin rounds ----------------------------------------------------------------

JAX = dict(fleet=jfleet, metrics=jmetrics, trace=jtrace, ladder=jladder, mesh=jmesh,
           rung="xla")
TORCH = dict(fleet=tfleet, metrics=tmetrics, trace=ttrace, ladder=tladder, mesh=tmesh,
             rung="torch")


class Twin:
    """One package's coalescer with its metrics, a tracer on a counting
    clock and an injected coalescer clock."""

    def __init__(self, k, **kw):
        self.k = k
        self.now = {"t": 0.0}
        self.ticks = {"n": 0}
        self.metrics = k["metrics"].AutoscalerMetrics()
        self.tracer = k["trace"].Tracer(clock=self._tick, recorder=k["trace"].FlightRecorder(64))
        extra = {} if k is JAX else {"device": "cpu"}
        ladder = kw.pop("ladder", None)
        self.co = k["fleet"].FleetCoalescer(
            metrics=self.metrics, clock=lambda: self.now["t"],
            ladder=k["ladder"].KernelLadder(**ladder) if ladder else None, **kw, **extra)

    def _tick(self):
        self.ticks["n"] += 1
        return float(self.ticks["n"])

    def solo(self, req):
        kw = {} if self.k is JAX else {"device": "cpu"}
        return self.k["mesh"].fleet_solo_estimate(
            req.pod_req, req.pod_masks, req.template_allocs, req.node_caps, req.max_nodes, **kw)

    def round(self, reqs, tick=0, limit=None):
        with self.tracer.tick("fleetRound", round=tick):
            if limit is None:
                answers, record = fleet_probe.serve_round(self.co, reqs, self.solo, tick,
                                                          self.now["t"])
            else:   # bounded service: flush(limit), the rest stays queued
                tickets = []
                for r in reqs:
                    try:
                        tickets.append(self.co.submit(r))
                    except Exception as e:  # noqa: BLE001
                        tickets.append(e)
                self.co.flush(limit=limit)
                answers = [t if isinstance(t, Exception) else
                           (t.result(0.0) if t.done() else TimeoutError("queued"))
                           for t in tickets]
                record = None
        return [fleet_probe.answer_view(a) for a in answers], record

    def state(self):
        lines = [port_exposition_line(line) if self.k is JAX else line
                 for line in self.metrics.registry.expose().splitlines()
                 if "_fleet_" in line or "rung_attempts" in line or "breaker_transitions" in line]
        spans = []
        for tr in self.tracer.recorder.traces():
            for sp in tr.to_dict()["spans"]:
                spans.append((sp["name"], sp["parent_id"], sp["start"], sp["end"], {
                    key: port_label(key, v) if isinstance(v, str) else v
                    for key, v in sp["attrs"].items()}))
        return {"metrics": lines, "spans": spans, "degraded": [
            port_label("rung", r) for r in self.co.degraded()],
            "admission": self.co.admission_snapshot()}


def twins(**kw):
    return Twin(JAX, **kw), Twin(TORCH, **kw)


def requests(k, seed, n, **kw):
    return fleet_probe.fleet_tenants(seed, n, request_cls=k["fleet"].FleetRequest, **kw)


def port_record(rec):
    if rec is None:
        return None
    return {**rec, "degraded": [port_label("rung", r) for r in rec["degraded"]],
            "tenants": [{**row, "route": row["route"]} for row in rec["tenants"]]}


def run_twins(script, **kw):
    """Run ``script(twin, k)`` → a list of rounds on both packages; every
    round's answers and ledger record, and the final metrics, spans,
    breakers and admission tallies, equal."""
    j, t = twins(**kw)
    out_j, out_t = script(j, JAX), script(t, TORCH)
    assert len(out_j) == len(out_t)
    for r, ((aj, rj), (at, rt)) in enumerate(zip(out_j, out_t)):
        assert at == aj, f"round {r}: answers differ"
        assert rt == port_record(rj), f"round {r}: ledger records differ"
        if rt is not None:
            assert all(row["match_solo"] for row in rt["tenants"]), r
    sj, st = j.state(), t.state()
    for key in sj:
        assert st[key] == sj[key], key
    return out_t, st


WIDE = dict(pods=(4, 40), groups=(1, 9), adhoc=(70, 12))


def test_twin_rounds_parity_buckets_and_adhoc():
    def script(tw, k):
        return [tw.round(requests(k, seed, 9, **WIDE), tick=seed) for seed in (0, 1)]

    out, st = run_twins(script, buckets="16x4x8,64x8x8", batch_scenarios=4)
    routes = {a["route"] for answers, _ in out for a in answers}
    buckets = {a["bucket"] for answers, _ in out for a in answers}
    assert routes == {"fleet_batched"} and "128x16x8" in buckets
    assert any(a["best_group"] >= 0 for answers, _ in out for a in answers)
    assert any(name == "fleetDispatch" for name, *_ in st["spans"])


def test_twin_rounds_under_batched_rung_faults():
    """Two faulted batches descend to the oracle and open the batched
    rung's breaker; a batch while it is open skips it; past the cooldown
    on the coalescer's clock a probe closes it."""
    def script(tw, k):
        rounds = []
        tw.co.ladder.fault_hook = lambda rung: "kernel_fault" if rung == k["rung"] else None
        for seed in (2, 3):
            rounds.append(tw.round(requests(k, seed, 3, **WIDE), tick=seed))
        tw.co.ladder.fault_hook = None
        rounds.append(tw.round(requests(k, 4, 3, **WIDE), tick=4))
        tw.now["t"] = 11.0
        rounds.append(tw.round(requests(k, 5, 3, **WIDE), tick=5))
        return rounds

    out, st = run_twins(script, buckets="16x4x8,64x8x8", batch_scenarios=4,
                        ladder=dict(failure_threshold=2, cooldown_s=10.0))
    routes = [sorted({a["route"] for a in answers}) for answers, _ in out]
    assert routes == [["fleet_oracle"]] * 3 + [["fleet_batched"]]
    assert st["degraded"] == []
    assert any('to_state="open"' in line for line in st["metrics"])


def test_twin_rounds_when_both_rungs_fault():
    def script(tw, k):
        tw.co.ladder.fault_hook = lambda rung: "device_lost"
        return [tw.round(requests(k, 6, 4, **WIDE), tick=0)]

    out, _ = run_twins(script, buckets="16x4x8,64x8x8", batch_scenarios=4)
    assert {a.get("error") for a in out[0][0]} == {"FleetError"}


def test_twin_rounds_overload_sheds_and_deadlines():
    """A queue-depth bound, per-tenant quotas on the injected clock, a
    dead-on-arrival deadline and one that expires in the queue."""
    def script(tw, k):
        reqs = requests(k, 7, 8, **WIDE)
        for i, r in enumerate(reqs):
            r.tenant_id = f"tenant-{i % 3}"
        reqs[1].deadline_s = 0.0            # dead on arrival
        reqs[2].deadline_s = 0.5            # expires before the flush below
        rounds = []
        tickets = []
        for r in reqs:
            try:
                tickets.append(tw.co.submit(r))
            except Exception as e:  # noqa: BLE001
                tickets.append(e)
        tw.now["t"] = 1.0
        tw.co.flush()
        views = []
        for tk in tickets:
            if isinstance(tk, Exception):
                views.append({"error": type(tk).__name__, "outcome": tk.outcome,
                              "retry_after_s": tk.retry_after_s})
            else:
                try:
                    views.append(fleet_probe.answer_view(tk.result(0.0)))
                except Exception as e:  # noqa: BLE001
                    views.append({"error": type(e).__name__})
        rounds.append((views, None))
        tw.now["t"] = 5.0                   # the quota buckets refill
        rounds.append(tw.round(requests(k, 8, 3, **WIDE), tick=1))
        return rounds

    out, st = run_twins(script, buckets="16x4x8,64x8x8", batch_scenarios=4,
                        max_queue_depth=5, tenant_qps=1.0, tenant_burst=2.0)
    errors = {v.get("error") for v in out[0][0]}
    assert {"FleetOverloadError", "FleetDeadlineError"} <= errors
    assert st["admission"].get("shed_quota", 0) + st["admission"].get("shed_queue_full", 0) > 0


def test_twin_rounds_with_tiers_and_bounded_service():
    tiers = ('{"gold": {"qps": 100, "burst": 100, "queue_share": 1.0, '
             '"default_deadline_s": 30, "shed_priority": 0, "tenants": ["tenant-00", '
             '"tenant-02"]}, "default": {"qps": 100, "burst": 100, "queue_share": 0.5, '
             '"shed_priority": 1}}')

    def script(tw, k):
        reqs = requests(k, 9, 6, **WIDE)
        rounds = [tw.round(reqs, tick=0, limit=3)]
        tw.now["t"] = 2.0
        rounds.append(tw.round(requests(k, 10, 4, **WIDE), tick=1))
        return rounds

    out, st = run_twins(script, buckets="16x4x8,64x8x8", batch_scenarios=4,
                        tenant_tiers=tiers)
    served = [a for a in out[0][0] if "route" in a]
    assert len(served) == 3
    assert any('tier="gold"' in line for line in st["metrics"])


def test_twin_drain_sheds_then_restart_serves():
    def script(tw, k):
        reqs = requests(k, 11, 3, **WIDE)
        tw.co.stop()
        drained = [tw.round(reqs, tick=0)]
        tw.co.start()
        try:
            tickets = [tw.co.submit(r) for r in reqs]
            answers = [fleet_probe.answer_view(tk.result(timeout=30.0)) for tk in tickets]
        finally:
            tw.co.stop()
        return drained + [(answers, None)]

    j, t = twins(buckets="16x4x8,64x8x8", batch_scenarios=4)
    out_j, out_t = script(j, JAX), script(t, TORCH)
    assert out_t[0] == (out_j[0][0], port_record(out_j[0][1]))
    assert {a["error"] for a in out_t[0][0]} == {"FleetDrainError"}
    # the window thread batches by arrival: compare verdicts, not batch sizes
    verdicts = [[(a["node_counts"], a["scheduled"], a["route"]) for a in answers]
                for answers, _ in (out_j[1], out_t[1])]
    assert verdicts[0] == verdicts[1]


def test_twin_prewarm_and_observatory_cache_verdicts():
    from autoscaler_tpu.perf import PerfObservatory as JObs
    from autoscaler_tpu_torch.perf import PerfObservatory as TObs

    out = {}
    for k, obs_cls in ((JAX, JObs), (TORCH, TObs)):
        tw = Twin(k, buckets="16x4x8", batch_scenarios=4)
        tw.co.observatory = obs_cls(metrics=tw.metrics)
        warmed = tw.co.prewarm()
        answers, record = tw.round(requests(k, 12, 2, pods=(4, 16), groups=(1, 4), adhoc=None))
        cache = {key: v for key, v in tw.metrics.kernel_compile_cache_total.values.items()}
        out[k["rung"]] = (warmed, answers, record, cache, tw.metrics.fleet_prewarmed_buckets.get())
    assert out["torch"][:3] == (out["xla"][0], out["xla"][1], port_record(out["xla"][2]))
    assert out["torch"][4] == out["xla"][4] == 1.0
    hits = {dict(key)["outcome"]: n for key, n in out["torch"][3].items()
            if dict(key)["route"] == "fleet_batched"}
    assert hits.get("hit", 0) >= 1


# -- the estimator's fleet lane -------------------------------------------------


def lane_world(tu, n=40, seed=3):
    rng = np.random.default_rng(seed)
    pods = [tu.build_test_pod(f"p{i}", cpu_m=float(rng.integers(100, 3000)),
                              mem=float(rng.integers(64, 4096)) * tu.MB) for i in range(n)]
    templates = {f"g{j}": tu.build_test_node(f"t{j}", cpu_m=float(rng.choice([2000, 4000, 8000])),
                                             mem=float(rng.choice([4, 8])) * tu.GB)
                 for j in range(5)}
    return pods, templates


def canon(results):
    return {g: (n, sorted(p.key() for p in pods)) for g, (n, pods) in results.items()}


def lane_estimators(k_fleet, est_mod, gym, tu, metrics_mod, n=2, **est_kw):
    m = metrics_mod.AutoscalerMetrics()
    co = k_fleet.FleetCoalescer(buckets="64x8x8", batch_scenarios=4, **est_kw.pop("co_kw", {}))
    ests = [est_mod.BinpackingNodeEstimator(
        metrics=m, fleet_client=gym.FleetEstimatorClient(co, f"e{i}", timeout_s=30.0), **est_kw)
        for i in range(n)]
    return co, ests, m


@pytest.mark.parametrize("started", [False, True])
def test_fleet_lane_equals_solo_in_both_packages(started):
    import threading

    out = {}
    for name, (fleet, est_mod, gym, tu, metrics_mod, kw) in {
        "jax": (jfleet, jbinpacking, jgym, jtu, jmetrics, {}),
        "torch": (tfleet, tbinpacking, tgym, ttu, tmetrics, {"device": "cpu"}),
    }.items():
        pods, templates = lane_world(tu)
        co_kw = {} if name == "jax" else {"device": "cpu"}
        co, ests, m = lane_estimators(fleet, est_mod, gym, tu, metrics_mod,
                                      co_kw=co_kw, **kw)
        slices = [pods[:20], pods[20:]]
        results = [None, None]
        if started:
            co.start()

            def run(i):
                results[i] = ests[i].estimate_many(slices[i], templates)

            threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            co.stop()
        else:
            # no window thread: each submit is flushed by a helper thread
            def flusher():
                while not done.is_set():
                    co.flush()
                    done.wait(0.001)

            done = threading.Event()
            th = threading.Thread(target=flusher)
            th.start()
            try:
                results = [e.estimate_many(s, templates) for e, s in zip(ests, slices)]
            finally:
                done.set()
                th.join()
        routes = {dict(key)["route"]: n for key, n in m.estimator_kernel_route_total.values.items()}
        solo = []
        for e, s in zip(ests, slices):
            e.fleet_client = None
            solo.append(canon(e.estimate_many(s, templates)))
        out[name] = ([canon(r) for r in results], solo, routes.get("fleet_coalesced"))
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][0] == out["torch"][1]
    assert out["torch"][2] == out["jax"][2] == 2


@pytest.mark.parametrize("failure", ["drain", "overload", "deadline", "timeout", "batch"])
def test_fleet_lane_falls_back_to_the_solo_ladder(failure):
    """Off the card every fleet failure falls back to the solo ladder, as
    in the JAX package, with the same decisions."""
    out = {}
    for name, (fleet, est_mod, gym, tu, kw) in {
        "jax": (jfleet, jbinpacking, jgym, jtu, {}),
        "torch": (tfleet, tbinpacking, tgym, ttu, {"device": "cpu"}),
    }.items():
        pods, templates = lane_world(tu, n=12)
        errors = {
            "drain": fleet.FleetDrainError("draining"),
            "overload": fleet.FleetOverloadError("full", retry_after_s=1.0),
            "deadline": fleet.FleetDeadlineError("late"),
            "timeout": TimeoutError("no answer"),
            "batch": fleet.FleetError("no fleet rung served bucket"),
        }

        class Failing:
            def estimate_groups(self, *a, err=errors[failure]):
                raise err

        est = est_mod.BinpackingNodeEstimator(fleet_client=Failing(), **kw)
        got = canon(est.estimate_many(pods, templates))
        est.fleet_client = None
        out[name] = (got, canon(est.estimate_many(pods, templates)))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == out["torch"][1]


def test_fleet_lane_on_a_card_raises_a_batch_failure(monkeypatch):
    """On a CUDA device a ticket failed by the card's rung (a FleetError
    that is not an admission error) raises; an admission shed still falls
    back. The estimator's device is set to a CUDA device after building on
    the CPU; the fallback it takes runs the host's route."""
    pods, templates = lane_world(ttu, n=12)

    class Failing:
        def __init__(self, err):
            self.err = err

        def estimate_groups(self, *a):
            raise self.err

    est = tbinpacking.BinpackingNodeEstimator(device="cpu",
                                              fleet_client=Failing(tfleet.FleetError("kernel")))
    est.device = torch.device("cuda")
    with pytest.raises(tfleet.FleetError, match="kernel"):
        est._fleet_estimate(pods, sorted(templates), templates,
                            np.full(len(templates), 16, np.int32))
    est.fleet_client = Failing(tfleet.FleetDrainError("draining"))
    assert est._fleet_estimate(pods, sorted(templates), templates,
                               np.full(len(templates), 16, np.int32)) is None


def test_coalescer_on_a_card_is_strict(monkeypatch):
    """The card's ladder is the one ``cuda`` rung: an injected fault, a
    raising dispatch and an open breaker fail the batch's tickets and no
    oracle serves; past the cooldown a probe closes the breaker. The
    coalescer's device is made a CUDA device and its batched dispatch
    computed on the CPU."""
    real = tmesh.fleet_batch_estimate
    monkeypatch.setattr(tmesh, "fleet_batch_estimate",
                        lambda *a, device=None: real(*a, device="cpu"))
    clock = {"t": 0.0}
    m = tmetrics.AutoscalerMetrics()
    co = tfleet.FleetCoalescer(buckets="16x4x8", batch_scenarios=4, metrics=m, device="cpu",
                               clock=lambda: clock["t"],
                               ladder=tladder.KernelLadder(failure_threshold=2, cooldown_s=10.0))
    co.device = torch.device("cuda")
    reqs = requests(TORCH, 13, 2, pods=(4, 16), groups=(1, 4), adhoc=None)
    steps = []

    def batch():
        tickets = [co.submit(r) for r in reqs]
        co.flush()
        outs = []
        for tk in tickets:
            try:
                outs.append(tk.result(0.0).route)
            except tfleet.FleetError as e:
                outs.append(str(e))
        steps.append((outs, co.degraded()))

    co.ladder.fault_hook = lambda rung: "kernel_fault" if rung == "cuda" else None
    batch()
    co.ladder.fault_hook = None
    monkeypatch.setattr(tmesh, "fleet_batch_estimate",
                        lambda *a, device=None: (_ for _ in ()).throw(RuntimeError("launch")))
    batch()
    batch()
    monkeypatch.setattr(tmesh, "fleet_batch_estimate",
                        lambda *a, device=None: real(*a, device="cpu"))
    clock["t"] = 11.0
    batch()
    assert all("injected kernel_fault on cuda rung" in o for o in steps[0][0])
    assert all("launch" in o for o in steps[1][0]) and steps[1][1] == ["cuda"]
    assert all("cuda rung breaker open" in o for o in steps[2][0])
    assert steps[3] == (["fleet_batched", "fleet_batched"], [])
    routes = {dict(key)["route"] for key in m.fleet_batches_total.values}
    assert routes == {"fleet_batched"}


# -- chip_smoke's helpers at a small size -----------------------------------------


def test_fleet_probe_serve_and_holds_on_the_cpu(on_cpu):
    reqs = fleet_probe.fleet_tenants(0, 5, pods=(8, 24), groups=(2, 6), adhoc=(40, 9))
    out = fleet_probe.serve(reqs, "cpu", tmetrics.AutoscalerMetrics(), reps=1,
                            buckets="32x8x8")
    assert fleet_probe.serve_problems(reqs, out) == []
    assert out["batched_s"] > 0 and out["sequential_s"] > 0
    assert tfleet.validate_fleet_records([out["record"]]) == []
    worlds = fleet_probe.small_worlds()
    held = fleet_probe.hold_scenarios(worlds, "cpu")
    assert [h["equal"] for h in held] == [True] * 4
    assert held[2]["shape"][0] == 4 and held[3]["shape"][0] == 4
    # the decimal world is one where a node's usage summed in f32 rounds
    # apart from alloc - free (the solo route's read-back)
    from autoscaler_tpu_torch.ops import ffd_scan

    _, req, masks, allocs, caps, M = worlds[3]
    batched = ffd_scan.ffd_binpack_scenarios_cuda(*map(torch.tensor, (req, masks, allocs)), M,
                                                  torch.tensor(caps))
    solo_used = [ffd_scan.ffd_binpack_groups_cuda(*map(torch.tensor, (req[s], masks[s], allocs[s])),
                                                  M, torch.tensor(caps[s])).node_used
                 for s in range(req.shape[0])]
    assert not torch.equal(batched.node_used, torch.stack(solo_used))


def test_fleet_probe_fault_walk_on_the_cpu_descends():
    walk = fleet_probe.fault_walk("cpu")
    assert walk["rung"] == "torch" and not walk["card"]
    assert [sorted(set(o)) for o, _ in walk["steps"]] == [
        ["fleet_oracle"]] * 3 + [["fleet_batched"]]
    assert walk["oracle_batches"] == 3 and all(walk["answers_equal"])
    # a card's walk that descended is what walk_problems refuses
    assert walk_problems_of(walk)


def walk_problems_of(walk):
    return fleet_probe.walk_problems({**walk, "rung": "cuda"})


def test_fleet_probe_views_match_the_jax_coalescer(on_cpu, monkeypatch):
    """4q's CPU side at a small size, against the JAX package's coalescer
    on the same tenants: answers, decision-ledger record and fleet metric
    lines equal."""
    monkeypatch.setattr(fleet_probe, "SMALL", {"pods": (8, 32), "groups": (2, 8)})
    monkeypatch.setattr(fleet_probe, "BATCH", 4)
    real_coalescer = fleet_probe.coalescer
    monkeypatch.setattr(fleet_probe, "coalescer",
                        lambda dev, buckets=None, **kw: real_coalescer(dev, "32x8x8", 4, **kw))
    view = fleet_probe.fleet_view("cpu", n=4)
    m = jmetrics.AutoscalerMetrics()
    co = jfleet.FleetCoalescer(buckets="32x8x8", batch_scenarios=4, metrics=m, clock=lambda: 0.0)
    co.prewarm()
    reqs = fleet_probe.fleet_tenants(1, 4, adhoc=None, request_cls=jfleet.FleetRequest,
                                     pods=(8, 32), groups=(2, 8))
    answers, record = fleet_probe.serve_round(co, reqs, lambda r: jmesh.fleet_solo_estimate(
        r.pod_req, r.pod_masks, r.template_allocs, r.node_caps, r.max_nodes))
    assert view["answers"] == [fleet_probe.answer_view(a) for a in answers]
    assert view["record"] == port_record(record)
    assert view["metrics"] == [port_exposition_line(line) for line in
                               fleet_probe.fleet_metric_lines(m)]
    assert all(row["match_solo"] for row in view["record"]["tenants"])
