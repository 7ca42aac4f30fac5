"""The port's kernel ladder (autoscaler_tpu_torch/utils/circuit.py,
estimator/ladder.py, the ladder walk of estimator/binpacking.py, the native
and Python rungs) against the JAX package's, on the CPU.

- The circuit-breaker and ladder cases of tests/test_resilience.py run step
  for step on both packages' objects over the same scripted sequences:
  every return value and state equal (the port's rung names under
  ``torch_parity.NAME_MAP``), the single-flight half-open probe under
  threads included.
- The estimator's ladder walk on both packages over worlds that reach
  every route (plain, runs, runs-affinity, dynamic with affinity and with
  spread, the single-template estimate), without faults and with faults
  armed through ``fault_hook``: after every dispatch the decisions, the
  attribution and the route, rung-attempt and breaker series equal under
  the name map. On the CPU the port's cuda rung is ``not_cuda`` and its
  torch rung serves, as the JAX package's Pallas rung is ``not_tpu`` and
  its XLA rung serves.
- The native rung (built from csrc/ffd_serial.cpp into build/native/, the
  tracked native/libffd_serial.so untouched) and the Python rung against
  the JAX package's native_bridge and reference_impl on seeded operands.
"""
import logging
import os
import threading

import numpy as np
import pytest

import autoscaler_tpu.estimator.ladder as jladder
import autoscaler_tpu.estimator.reference_impl as jref
import autoscaler_tpu.metrics.metrics as jmetrics
import autoscaler_tpu.native_bridge as jnative
import autoscaler_tpu.utils.circuit as jcircuit
import autoscaler_tpu_torch.estimator.binpacking as tes
import autoscaler_tpu_torch.estimator.ladder as tladder
import autoscaler_tpu_torch.estimator.reference_impl as tref
import autoscaler_tpu_torch.metrics.metrics as tmetrics
import autoscaler_tpu_torch.native_bridge as tnative
import autoscaler_tpu_torch.utils.circuit as tcircuit
from test_torch_estimator import (
    HOST,
    JAX,
    TORCH,
    dynamic_spec,
    estimator,
    make_dynamic_pods,
    make_pods,
    make_templates,
    pod_spec,
    template_spec,
    zoned_templates,
)
from torch_parity import port_label, port_series, series

# -- the circuit breaker: tests/test_resilience.py::TestCircuitBreaker, each
# case a generator of observations run on both packages' breakers


def case_trips_after_threshold_and_skips_while_open(circuit):
    br = circuit.CircuitBreaker(failure_threshold=3, cooldown_s=60.0)
    for _ in range(2):
        yield br.allow(0.0)
        br.record_failure(0.0)
    yield br.state.value, br.consecutive_failures
    yield br.allow(0.0)
    br.record_failure(10.0)
    yield br.state.value
    yield br.allow(10.0), br.allow(69.0)


def case_half_open_probe_success_closes(circuit):
    br = circuit.CircuitBreaker(failure_threshold=1, cooldown_s=30.0)
    br.record_failure(100.0)
    yield br.state.value
    yield br.allow(130.0), br.state.value
    br.record_success(130.0)
    yield br.state.value, br.allow(130.0)


def case_half_open_probe_failure_reopens(circuit):
    br = circuit.CircuitBreaker(failure_threshold=1, cooldown_s=30.0)
    br.record_failure(100.0)
    yield br.allow(130.0)
    br.record_failure(130.0)
    yield br.state.value, br.allow(159.0), br.allow(160.0)


def case_success_resets_consecutive_failures(circuit):
    br = circuit.CircuitBreaker(failure_threshold=3, cooldown_s=30.0)
    for step in ("f", "f", "s", "f", "f"):
        (br.record_failure if step == "f" else br.record_success)(0.0)
        yield br.state.value, br.consecutive_failures


def case_neutral_does_not_reset_closed_failure_streak(circuit):
    br = circuit.CircuitBreaker(failure_threshold=3, cooldown_s=30.0)
    for step in ("f", "n", "f", "n", "f"):
        (br.record_failure if step == "f" else br.record_neutral)(0.0)
        yield br.state.value, br.consecutive_failures


def case_neutral_resolves_half_open_probe(circuit):
    br = circuit.CircuitBreaker(failure_threshold=1, cooldown_s=30.0)
    br.record_failure(100.0)
    yield br.allow(130.0)
    br.record_neutral(130.0)
    yield br.state.value


def case_release_probe_keeps_half_open_and_returns_slot(circuit):
    br = circuit.CircuitBreaker(failure_threshold=1, cooldown_s=30.0)
    br.record_failure(100.0)
    yield br.allow(130.0)
    br.release_probe(130.0)
    yield br.state.value, br.allow(131.0)
    br.record_success(131.0)
    yield br.state.value


def case_stale_reports_while_open_are_ignored(circuit):
    br = circuit.CircuitBreaker(failure_threshold=1, cooldown_s=30.0)
    br.record_failure(100.0)
    br.record_success(101.0)
    yield br.state.value
    br.record_failure(120.0)
    yield br.allow(130.0)


def case_transitions_reach_the_callback(circuit):
    seen = []
    br = circuit.CircuitBreaker(
        failure_threshold=2, cooldown_s=5.0, name="r",
        on_transition=lambda old, new: seen.append((old.value, new.value)),
    )
    for now in (0.0, 1.0, 7.0, 7.0, 20.0):
        if br.allow(now):
            br.record_failure(now)
    br.allow(40.0)
    br.record_success(40.0)
    yield seen


BREAKER_CASES = {
    name[len("case_"):]: fn for name, fn in sorted(globals().items())
    if name.startswith("case_")
}


@pytest.mark.parametrize("case", sorted(BREAKER_CASES))
def test_circuit_breaker_matches_jax(case):
    ref = list(BREAKER_CASES[case](jcircuit))
    out = list(BREAKER_CASES[case](tcircuit))
    assert out == ref and out


def test_breaker_rejects_a_zero_threshold():
    for circuit in (jcircuit, tcircuit):
        with pytest.raises(ValueError, match="failure_threshold"):
            circuit.CircuitBreaker(failure_threshold=0)


def _admitted_under_contention(circuit, threads=32, rounds=10):
    """tests/test_resilience.py::TestHalfOpenConcurrencyStress: threads
    racing for each half-open window's probe → probes admitted a round."""
    br = circuit.CircuitBreaker(failure_threshold=1, cooldown_s=10.0)
    br.record_failure(0.0)
    admitted_per_round = []
    for round_i in range(rounds):
        now = 10.0 * (round_i + 1)
        barrier = threading.Barrier(threads)
        admitted = []
        lock = threading.Lock()

        def worker():
            barrier.wait()
            if br.allow(now):
                with lock:
                    admitted.append(1)

        workers = [threading.Thread(target=worker) for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join()
        admitted_per_round.append(len(admitted))
        if round_i < rounds - 1:
            br.record_failure(now)
    br.record_success(100.0)
    return admitted_per_round, br.state.value, all(br.allow(100.0) for _ in range(threads))


def test_exactly_one_probe_admitted_under_contention():
    ref, out = (_admitted_under_contention(c) for c in (jcircuit, tcircuit))
    assert out == ref == ([1] * 10, "closed", True)


# -- the ladder's per-dispatch protocol


def _ladder_trace(mod, rung_of, script):
    """Run ``script`` (a list of (op, port rung name, now)) on one
    package's KernelLadder with metrics bound → each step's return value,
    degraded rungs and states, and the metric series at the end (the
    rung labels in the port's names)."""
    m = (jmetrics if mod is jladder else tmetrics).AutoscalerMetrics()
    ladder = mod.KernelLadder(failure_threshold=2, cooldown_s=10.0)
    ladder.bind_metrics(m)
    armed = set()
    ladder.fault_hook = lambda rung: "kernel_fault" if port_label("rung", rung) in armed else None
    out = []
    for op, rung, now in script:
        ladder.tick(now)
        name = rung_of(rung)
        if op == "arm":
            armed.add(rung)
            continue
        if op == "disarm":
            armed.discard(rung)
            continue
        got = getattr(ladder, op)(name)
        out.append((op, rung, got, [port_label("rung", r) for r in ladder.degraded()],
                    {port_label("rung", k): v for k, v in ladder.states().items()}))
    metric_lines = {
        name: (series if mod is tladder else port_series)(getattr(m, name))
        for name in ("estimator_kernel_rung_attempts_total", "estimator_kernel_breaker_state",
                     "estimator_breaker_transitions_total")
    }
    return out, metric_lines


LADDER_SCRIPT = [
    ("begin", "cuda", 0.0), ("record_unavailable", "cuda", 0.0),
    ("begin", "torch", 0.0), ("record_failure", "torch", 0.0),
    ("begin", "torch", 1.0), ("record_failure", "torch", 1.0),     # trips
    ("begin", "torch", 2.0),                                        # skipped
    ("begin", "native", 2.0), ("record_success", "native", 2.0),
    ("arm", "cuda", 3.0), ("begin", "cuda", 3.0), ("begin", "cuda", 4.0),   # injected: trips
    ("disarm", "cuda", 5.0),
    ("begin", "torch", 12.0), ("record_skipped_dispatch", "torch", 12.0),   # probe released
    ("begin", "torch", 12.5), ("record_success", "torch", 12.5),            # probe closes
    ("begin", "cuda", 15.0), ("record_unavailable", "cuda", 15.0),          # closes: neutral
    ("begin", "python", 15.0), ("record_failure", "python", 15.0),
    ("begin", "python", 16.0), ("record_success", "python", 16.0),
]


def test_ladder_protocol_matches_jax():
    """Begin, success, failure, unavailable, released probes and injected
    faults on every rung: the same answers, degraded lists, states and
    rung-attempt, breaker-state and transition series."""
    inverse = {v: k for k, v in {"pallas": "cuda", "xla": "torch"}.items()}
    ref = _ladder_trace(jladder, lambda r: inverse.get(r, r), LADDER_SCRIPT)
    out = _ladder_trace(tladder, lambda r: r, LADDER_SCRIPT)
    assert out == ref
    assert out[0][-1][3] == [] and any(step[3] for step in out[0])


def test_ladder_constants_are_the_jax_packages_under_the_name_map():
    assert tladder.LADDER_RUNGS == tuple(port_label("rung", r) for r in jladder.LADDER_RUNGS)
    assert tladder.DEVICE_RUNGS == tuple(port_label("rung", r) for r in jladder.DEVICE_RUNGS)
    assert tladder.HOST_LEVEL_SKIP_REASONS == tuple(
        port_label("reason", r) for r in jladder.HOST_LEVEL_SKIP_REASONS)


def _single_flight(mod, rung):
    ladder = mod.KernelLadder(failure_threshold=1, cooldown_s=10.0)
    ladder.tick(0.0)
    first = ladder.begin(rung)
    ladder.record_failure(rung)
    degraded = ladder.degraded()
    ladder.tick(20.0)
    barrier = threading.Barrier(16)
    outcomes = []
    lock = threading.Lock()

    def worker():
        barrier.wait()
        got = ladder.begin(rung)
        with lock:
            outcomes.append(got)

    workers = [threading.Thread(target=worker) for _ in range(16)]
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    ladder.record_success(rung)
    return (first, [port_label("rung", r) for r in degraded], outcomes.count(None),
            outcomes.count("breaker_open"), ladder.degraded())


def test_ladder_begin_single_flight_probe():
    ref, out = _single_flight(jladder, "xla"), _single_flight(tladder, "torch")
    assert out == ref == (None, ["torch"], 1, 15, [])


# -- the estimator's ladder walk on every route


def plain_world(pkg):
    return make_pods(pkg, pod_spec(0, 40)), make_templates(pkg, template_spec(0, 3))


def runs_world(pkg):
    return (make_pods(pkg, pod_spec(4, 80, replicated=True)),
            make_templates(pkg, template_spec(4, 3)))


def affinity_world(pkg):
    return (make_dynamic_pods(pkg, dynamic_spec(10, 40, anti=0.4, aff=0.2)),
            zoned_templates(pkg, 0, 3))


def spread_world(pkg):
    return (make_dynamic_pods(pkg, dynamic_spec(11, 40, spread=0.5, anti=0.2, skew=2)),
            zoned_templates(pkg, 0, 3))


def runs_affinity_world(pkg):
    return (make_dynamic_pods(pkg, dynamic_spec(15, 100, replicated=True, apps=7)),
            zoned_templates(pkg, 0, 3))


def runs_spread_world(pkg):
    return (make_dynamic_pods(pkg, dynamic_spec(16, 100, replicated=True, apps=7, spread=1.0,
                                                spread_key=HOST)),
            zoned_templates(pkg, 0, 3))


def estimate_many(est, pods, templates):
    return est.estimate_many(pods, templates)


def estimate_one(est, pods, templates):
    return {"ng-0": est.estimate(pods, templates["ng-0"], max_size_headroom=3)}


WALK_WORLDS = {
    "plain": (plain_world, estimate_many),
    "runs": (runs_world, estimate_many),
    "affinity": (affinity_world, estimate_many),
    "spread": (spread_world, estimate_many),
    "runs-affinity": (runs_affinity_world, estimate_many),
    "runs-spread": (runs_spread_world, estimate_many),
    "single": (plain_world, estimate_one),
    "single-dynamic": (affinity_world, estimate_one),
}
# which rungs the fault hook fails in each scenario (port names)
FAULTS = {"none": (), "device": ("cuda", "torch"), "torch": ("torch",)}
LADDER_SERIES = ("estimator_kernel_route_total", "estimator_kernel_rung_attempts_total",
                 "estimator_kernel_breaker_state", "estimator_breaker_transitions_total")


def walk(pkg, world, call, faults):
    """Five dispatches four seconds apart with ``faults`` armed (threshold
    2, cooldown 10 s), then one past the cooldown with none: after each, the
    decisions, the attribution, the degraded rungs and the ladder series
    (the JAX package's under the name map)."""
    m = (jmetrics if pkg is JAX else tmetrics).AutoscalerMetrics()
    est = estimator(pkg, 16, m)
    ladder = est.ladder = (jladder if pkg is JAX else tladder).KernelLadder(
        failure_threshold=2, cooldown_s=10.0)
    ladder.bind_metrics(m)
    armed = {"on": True}
    ladder.fault_hook = lambda rung: (
        "kernel_fault" if armed["on"] and port_label("rung", rung) in faults else None)
    pods, templates = world(pkg)
    trace = []
    for i, now in enumerate((0.0, 4.0, 8.0, 12.0, 16.0, 40.0)):
        if i == 5:
            armed["on"] = False
        ladder.tick(now)
        res = call(est, pods, templates)
        trace.append((
            {g: (c, [p.name for p in sched]) for g, (c, sched) in res.items()},
            est.last_explain,
            [port_label("rung", r) for r in ladder.degraded()],
            {name: (port_series if pkg is JAX else series)(getattr(m, name))
             for name in LADDER_SERIES},
        ))
    return trace


@pytest.mark.parametrize("faults", sorted(FAULTS))
@pytest.mark.parametrize("world", sorted(WALK_WORLDS))
def test_ladder_walk_matches_jax(world, faults):
    make, call = WALK_WORLDS[world]
    ref = walk(JAX, make, call, FAULTS[faults])
    out = walk(TORCH, make, call, FAULTS[faults])
    for i, (a, b) in enumerate(zip(ref, out)):
        assert b[0] == a[0], f"dispatch {i}: decisions"
        assert b[1] == a[1], f"dispatch {i}: attribution"
        assert b[2:] == a[2:], f"dispatch {i}: degraded rungs or ladder series"
    routes = out[-1][3]["estimator_kernel_route_total"]
    assert sum(routes.values()) == len(out)
    if faults == "none":
        assert all(not step[2] for step in out)
    else:
        assert any(step[2] for step in out) and out[-1][2] == []


def test_python_rung_serves_when_native_unavailable(monkeypatch):
    """tests/test_resilience.py's case on both packages: the device rungs
    lost, no native library → the Python oracle serves (python_ref,
    native_unavailable)."""
    out = []
    for pkg, bridge, metrics_mod, ladder_mod in ((JAX, jnative, jmetrics, jladder),
                                                  (TORCH, tnative, tmetrics, tladder)):
        monkeypatch.setattr(bridge, "available", lambda: False)
        monkeypatch.setattr(bridge, "build_error", lambda: "no g++")
        m = metrics_mod.AutoscalerMetrics()
        est = estimator(pkg, 16, m)
        est.ladder = ladder_mod.KernelLadder(failure_threshold=1, cooldown_s=1e9)
        est.ladder.bind_metrics(m)
        est.ladder.fault_hook = lambda rung: (
            "device_lost" if port_label("rung", rung) in ("cuda", "torch") else None)
        pods, templates = plain_world(pkg)
        res = est.estimate_many(pods, templates)
        out.append(({g: (c, [p.name for p in s]) for g, (c, s) in res.items()},
                    (port_series if pkg is JAX else series)(m.estimator_kernel_route_total)))
    assert out[0] == out[1]
    assert out[1][1] == {(("reason", "native_unavailable"), ("route", "python_ref")): 1.0}


def test_dedup_dispatch_cannot_close_a_tripped_device_rung():
    """On a card, run-compressed dispatches route around the cuda rung
    through a pure gate; a half-open probe landing on one must be released,
    not resolved. (Off a card the same probe closes it: the cuda rung can
    never fault there.) The gate answers as on a card here."""
    pods, templates = runs_world(TORCH)
    est = estimator(TORCH, 16)
    est._dedup_skip = lambda: ("dedup", "", False)
    ladder = est.ladder
    ladder.tick(0.0)
    ladder.begin("cuda")
    ladder.record_failure("cuda")
    for _ in range(2):
        ladder.begin("cuda")
        ladder.record_failure("cuda")
    assert ladder.breakers["cuda"].state is tcircuit.BreakerState.OPEN
    ladder.tick(200.0)
    out = est.estimate_many(pods, templates)
    assert any(c > 0 for c, _ in out.values())
    assert ladder.breakers["cuda"].state is tcircuit.BreakerState.HALF_OPEN
    assert "cuda" in ladder.degraded()
    # off a card the dedup gate is host-level: the probe closes the rung
    est = estimator(TORCH, 16)
    est.ladder.tick(0.0)
    for _ in range(3):
        est.ladder.begin("cuda")
        est.ladder.record_failure("cuda")
    est.ladder.tick(200.0)
    est.estimate_many(pods, templates)
    assert est.ladder.degraded() == []


@pytest.mark.parametrize("world", ["runs", "runs-affinity", "single", "single-dynamic"])
def test_torch_rung_is_strict_on_a_card(world):
    """On a card, a dispatch that the cuda rung does not serve (dedup, a
    single template) is served on the torch rung or not at all: a fault
    there raises, the breaker opens at its threshold and then raises too,
    and no host rung serves. The estimator's device is made a CUDA device;
    the faults fire before any tensor is made."""
    from autoscaler_tpu_torch.utils.errors import AutoscalerError

    make, call = WALK_WORLDS[world]
    pods, templates = make(TORCH)
    m = tmetrics.AutoscalerMetrics()
    est = estimator(TORCH, 16, m)
    est.ladder = tladder.KernelLadder(failure_threshold=2, cooldown_s=10.0)
    est.ladder.bind_metrics(m)
    est.device = tes.torch.device("cuda")
    est.ladder.fault_hook = lambda rung: "kernel_fault" if rung == "torch" else None
    raised = []
    for now in (0.0, 1.0, 2.0):
        est.ladder.tick(now)
        with pytest.raises(AutoscalerError) as e:
            call(est, pods, templates)
        raised.append(str(e.value))
    assert raised[:2] == ["injected kernel_fault on torch rung"] * 2
    assert "torch rung's breaker is open" in raised[2]
    assert sum(m.estimator_kernel_route_total.values.values()) == 0
    attempts = m.estimator_kernel_rung_attempts_total
    assert attempts.get(rung="torch", outcome="fault") == 2
    assert attempts.get(rung="torch", outcome="skipped") == 1
    assert sum(attempts.get(rung=r, outcome=o) for r in ("native", "python")
               for o in ("ok", "fault", "unavailable")) == 0
    assert est.ladder.degraded() == ["torch"]


def test_a_raising_gate_is_a_fault(caplog):
    """A gate that raises (a kernel that fails to build, a device fault
    while probing the operands) counts as a failure of its rung, is logged
    at WARNING, and the dispatch descends."""
    m = tmetrics.AutoscalerMetrics()
    est = estimator(TORCH, 16, m)
    pods, templates = plain_world(TORCH)
    plain = estimator(TORCH, 16).estimate_many(pods, templates)

    def broken(*args):
        raise RuntimeError("nvcc failed on ffd_scan.cu")

    real = tes.plain_gate
    tes.plain_gate = broken
    try:
        with caplog.at_level("WARNING", logger="estimator"):
            out = est.estimate_many(pods, templates)
    finally:
        tes.plain_gate = real
    assert out == plain
    assert m.estimator_kernel_rung_attempts_total.get(rung="cuda", outcome="fault") == 1
    assert m.estimator_kernel_route_total.get(route="torch_scan", reason="kernel_fault") == 1
    assert any("gate raised" in r.getMessage() for r in caplog.records if r.name == "estimator")


# -- the native and Python rungs on seeded operands


def ffd_operands(seed, P=60, R=6, T=4):
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 6, (P, R)).astype(np.float32)
    req[:, 0] = rng.integers(100, 2000, P)
    req[:, 1] = rng.integers(64, 4096, P)
    mask = rng.random(P) > 0.15
    alloc = np.array([4000, 8192, 8, 8, 8, 30], np.float32)[:R]
    match = rng.random((T, P)) > 0.7
    aff_of = rng.random((T, P)) > 0.9
    anti_of = rng.random((T, P)) > 0.8
    node_level = np.array([True, False] * (T // 2))
    has_label = rng.random(T) > 0.2
    return req, mask, alloc, match, aff_of, anti_of, node_level, has_label


@pytest.mark.parametrize("seed", range(3))
def test_native_and_python_rungs_match_jax(seed):
    """The port's native library and oracle against the JAX package's, on
    the plain and the affinity FFD and the first fit: equal counts and
    verdicts; all four agree with one another."""
    req, mask, alloc, match, aff_of, anti_of, node_level, has_label = ffd_operands(seed)
    tracked = "native/libffd_serial.so"
    before = os.stat(tracked).st_mtime_ns if os.path.exists(tracked) else None
    assert tnative.available(), tnative.build_error()
    lib = tnative.lib_path()
    # the native/ subdirectory of the kernels' directory, build/kernels/ in a checkout
    assert lib.parent.name == "native" and lib.parent.parent.name == "kernels" \
        and lib.parent.parent.parent.name == "build" and lib.exists()
    plain = [bridge(req, mask, alloc, 12) for bridge in
             (jnative.ffd_binpack_native, tnative.ffd_binpack_native,
              jref.ffd_binpack_reference, tref.ffd_binpack_reference)]
    aff_args = (req, mask, alloc, 12, match, aff_of, anti_of, node_level, has_label)
    aff = [fn(*aff_args) for fn in
           (jnative.ffd_binpack_affinity_native, tnative.ffd_binpack_affinity_native,
            jref.ffd_binpack_reference_affinity, tref.ffd_binpack_reference_affinity)]
    for results in (plain, aff):
        for count, sched in results[1:]:
            assert count == results[0][0] and np.array_equal(sched, results[0][1])
    free = np.tile(alloc, (9, 1)) * np.linspace(0.1, 1.0, 9)[:, None].astype(np.float32)
    fit_mask = np.random.default_rng(seed).random((req.shape[0], 9)) > 0.3
    assert np.array_equal(tnative.first_fit_native(req, free, fit_mask),
                          jnative.first_fit_native(req, free, fit_mask))
    after = os.stat(tracked).st_mtime_ns if os.path.exists(tracked) else None
    assert after == before


@pytest.mark.parametrize("seed", range(3))
def test_attribution_oracle_matches_jax(seed):
    rng = np.random.default_rng(seed)
    P, G, R = 50, 4, 7
    req = rng.integers(0, 5, (P, R)).astype(np.float32)
    allocs = rng.integers(0, 5, (G, R)).astype(np.float32)
    masks, scheduled = rng.random((G, P)) > 0.2, rng.random((G, P)) > 0.6
    involved = rng.random(P) > 0.5
    args = (req, masks, allocs, scheduled, involved)
    assert np.array_equal(tref.attribute_unschedulable_reference(*args),
                          jref.attribute_unschedulable_reference(*args))


def test_native_rung_reports_a_missing_compiler(monkeypatch, tmp_path):
    """No g++: available() is false and build_error() says why; nothing is
    written beside the source or into native/."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    monkeypatch.setattr(tnative._build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert not tnative.available()
    assert "g++ not found" in tnative.build_error()
    with pytest.raises(RuntimeError, match="native library unavailable"):
        tnative.ffd_binpack_native(np.zeros((1, 6), np.float32), np.ones(1, bool),
                                   np.ones(6, np.float32), 1)
    assert not (tmp_path / "native").exists()


# -- tools/ladder_probe: chip_smoke's 5a-5c on the CPU at a small size


def small_loop_world():
    from autoscaler_tpu_torch.tools import loop_probe
    from autoscaler_tpu_torch.utils.workload import build_snapshot_world

    nodes, pods = loop_probe.scale_in_listing(*build_snapshot_world(N=60, P=300, port_nodes=20))
    templates, burst = loop_probe.burst_operands()
    groups = loop_probe.zoned_templates(templates)
    return nodes, pods, burst[:120], {g: groups[g] for g in sorted(groups)[:8]}


def test_ladder_probe_fault_walk_and_host_rungs():
    """The fault walk and the host rungs, as chip_smoke's 5b and 5c run
    them, on the CPU: the faults armed on the cuda rung descend to the
    torch rung here (off a card), the breaker opens and closes as on a
    card, every problem list is empty, and the faults are counted and
    logged."""
    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics
    from autoscaler_tpu_torch.tools import ladder_probe

    world = small_loop_world()
    watch = ladder_probe.LadderWatch(AutoscalerMetrics())
    try:
        walk = ladder_probe.fault_walk(*world, "cpu")
        assert not walk["card"] and ladder_probe.walk_problems(walk) == []
        assert all(s[5] is None for s in walk["steps"])
        assert walk["faults"] == ladder_probe.FAULTS
        assert sum("kernel rung failed" in w for w in watch.warnings) == ladder_probe.FAULTS
        rungs = ladder_probe.host_rungs(world[2], world[3], walk["steps"][0][0], stride=4)
    finally:
        watch.close()
    assert rungs["built"] and rungs["native"][2] and rungs["python_ref"][2]
    assert rungs["native"][1] == 8 and rungs["python_ref"][1] == 2
    assert rungs["native"][3] == {("native", "kernel_fault"): 1}
    assert rungs["python_ref"][3] == {("python_ref", "kernel_fault"): 1}
    assert "equal True" in ladder_probe.host_line(rungs)
    assert "threshold 3" in ladder_probe.walk_line(walk)


def test_walk_problems_on_a_card():
    """What 5b must see on a card: each faulted estimate and the one past
    the open breaker raise and launch nothing, the cuda rung serves the
    healthy and the probe step with equal decisions; a walk that
    descended instead is named."""
    from autoscaler_tpu_torch.tools import ladder_probe

    ok, bad = (200, "ok"), (200, "ok (degraded: cuda)")
    decided = {"g": (1, ["p"])}
    steps = [(decided, 1, 0.1, [], ok, None)]
    steps += [(None, 0, 0.1, ["cuda"] if k == 3 else [], bad if k == 3 else ok,
               "injected kernel_fault on cuda rung") for k in (1, 2, 3)]
    steps += [(None, 0, 0.1, ["cuda"], bad, "breaker open"), (decided, 1, 0.1, [], ok, None)]
    walk = {"steps": steps, "routes": {("cuda", "ok"): 2}, "card": True, "cooldown": 120.0,
            "threshold": 3, "faults": 3}
    assert ladder_probe.walk_problems(walk) == []
    descended = dict(walk, steps=[(decided, 0, *s[2:5], None) if s[5] else s for s in steps],
                     routes={("cuda", "ok"): 2, ("torch_scan", "kernel_fault"): 3,
                             ("torch_scan", "breaker_open"): 1})
    problems = ladder_probe.walk_problems(descended)
    assert any(p.startswith("raised ") for p in problems)
    assert any(p.startswith("routes ") for p in problems)


def test_ladder_tally_names_what_a_card_path_must_not_do():
    """The watch reads the card's estimators' counters since its last
    reset and flags faults, warnings, breaker transitions, forced
    dispatches and dispatches below the cuda rung but for the shape gates
    and dedup."""
    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics
    from autoscaler_tpu_torch.tools import ladder_probe

    metrics = AutoscalerMetrics()
    watch = ladder_probe.LadderWatch(metrics)
    try:
        routes = metrics.estimator_kernel_route_total
        routes.inc(route="cuda", reason="ok")
        routes.inc(route="torch_scan", reason="smem")
        routes.inc(route="torch_runs", reason="dedup")
        routes.inc(route="cuda_affinity", reason="ok")
        assert watch.problems() == []
        assert watch.counts() == {
            "route:cuda": 1, "route:cuda:ok": 1, "route:torch_scan": 1,
            "route:torch_scan:smem": 1, "route:torch_runs": 1, "route:torch_runs:dedup": 1,
            "route:cuda_affinity": 1, "route:cuda_affinity:ok": 1}
        watch.reset()
        assert watch.counts() == {} and watch.problems() == []
        # an estimator on the CPU with the same metrics: its torch rung
        # faulted, the native rung serves
        pods, templates = plain_world(TORCH)
        est = tes.BinpackingNodeEstimator(metrics=metrics, device="cpu")
        est.ladder.fault_hook = lambda rung: "kernel_fault" if rung == "torch" else None
        est.estimate_many(pods, templates)
        routes.inc(route="torch_scan", reason="forced")
        problems = watch.problems()
        assert "rung torch: 1 fault attempts" in problems
        assert "native served on the card (kernel_fault) x1" in problems
        assert "torch_scan served on the card (forced) x1" in problems
        assert any(p.startswith("WARNING: torch kernel rung failed") for p in problems)
        est.estimate_many(pods, templates)
        est.estimate_many(pods, templates)
        assert "breaker torch: closed -> open x1" in watch.problems()
    finally:
        watch.close()
    assert watch._handler not in logging.getLogger("estimator").handlers


def test_ladder_probe_perf_lines():
    """One line a perf record, with the record's own cost from the tick's
    trace."""
    from autoscaler_tpu_torch.tools import ladder_probe
    from test_torch_static_autoscaler import TORCH as K, build_world, tick

    pods = [K.tu.build_test_pod(f"p{i}", cpu_m=600 + i, mem=K.tu.GB) for i in range(4)]
    w = build_world(K, [("g", 0, 10, 1000, 2 * K.tu.GB)], {"g": 1}, pods)
    for now in (0.0, 10.0):
        tick(w, now)
    lines = ladder_probe.perf_lines(w.sa)
    assert len(lines) == 2 and "tick 0" in lines[0] and "torch_scan" in lines[0]
    assert all("perfRecord" in line and "deviceDispatch" in line for line in lines)
