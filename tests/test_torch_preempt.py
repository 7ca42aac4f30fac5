"""The port's preemption (autoscaler_tpu_torch/ops/preempt.py, the
estimator's ``estimate_preemption``, preempt/, the churn filter, run_once's
preemption branch and the journal's replay) against the JAX package's, on
the CPU.

Every world goes through four implementations and must give the same
decision triple (scheduled, placed_node, victim_of), field for field and
exactly: the JAX package's XLA scan and its serial oracle, and the port's
main loop (``ffd_binpack_preempt``) and plain version
(``ffd_binpack_preempt_plain``), with the port's copy of the oracle beside
them. The worlds: every case of tests/test_preempt.py::TestPreemptKernel
(its own assertions run on the port's results), its 30 randomized worlds,
bench.py's storm worlds, and seeded worlds with six resources in the
packer's units, memory in bytes (decimal M requests against Gi
allocatable). One crafted world, where the XLA scan's f32 sums round and
the exact sums do not, is pinned as the divergence ROADMAP queue 3 holds.
Above the kernel: the engine's plan, the churn filter, a run_once
sequence with preemption and churn weight on both packages (results,
decision and journal lines, metrics exposition under
``torch_parity.NAME_MAP``), and both packages' journal CLIs over the same
journal files.
"""
import hashlib
import json
import types

import numpy as np
import pytest
import torch

import autoscaler_tpu.estimator.binpacking as jbp
import autoscaler_tpu.expander.core as jexp
import autoscaler_tpu.journal.__main__ as jcli
import autoscaler_tpu.metrics.metrics as jmetrics
import autoscaler_tpu.preempt as jpre
import autoscaler_tpu.snapshot.cluster_snapshot as jcs
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.estimator.binpacking as tbp
import autoscaler_tpu_torch.expander.core as texp
import autoscaler_tpu_torch.journal.__main__ as tcli
import autoscaler_tpu_torch.metrics.metrics as tmetrics
import autoscaler_tpu_torch.preempt as tpre_pkg
import autoscaler_tpu_torch.snapshot.cluster_snapshot as tcs
import autoscaler_tpu_torch.snapshot.packer as tpack
import autoscaler_tpu_torch.utils.test_utils as ttu
import test_preempt as jtp
import test_torch_static_autoscaler as tsat
from autoscaler_tpu.estimator.reference_impl import ffd_binpack_preempt_reference as jax_oracle
from autoscaler_tpu.ops.preempt import ffd_binpack_preempt as jax_scan
from autoscaler_tpu_torch.estimator import reference_impl as tref
from autoscaler_tpu_torch.ops import preempt as tpre
from autoscaler_tpu_torch.tools import preempt_probe
from torch_parity import port_label, port_series

OPERANDS = preempt_probe.OPERANDS
FIELDS = preempt_probe.FIELDS
GB = 1024**3

JAX = types.SimpleNamespace(name="jax", tu=jtu, cs=jcs, bp=jbp, pre=jpre, exp=jexp,
                            metrics=jmetrics, kw={}, snap_kw={})
TORCH = types.SimpleNamespace(name="torch", tu=ttu, cs=tcs, bp=tbp, pre=tpre_pkg, exp=texp,
                              metrics=tmetrics, kw={"device": "cpu"}, snap_kw={"device": "cpu"})


def port_run(w, fn=tpre.ffd_binpack_preempt):
    t = {k: torch.tensor(np.asarray(w[k])) for k in OPERANDS}
    return tuple(x.numpy() for x in fn(**t))


def results(w) -> dict:
    """The decision triple of every implementation on world ``w``."""
    args = [np.asarray(w[k]) for k in OPERANDS]
    return {
        "xla": tuple(np.asarray(x) for x in jax_scan(**{k: w[k] for k in OPERANDS})),
        "jax_oracle": jax_oracle(*args),
        "port_oracle": tref.ffd_binpack_preempt_reference(*args),
        "main": port_run(w),
        "plain": port_run(w, tpre.ffd_binpack_preempt_plain),
    }


def assert_all_equal(w, got=None):
    res = results(w)
    want = res["jax_oracle"]
    if got is not None:
        res["given"] = got
    for name, triple in res.items():
        for field, a, b in zip(FIELDS, triple, want):
            assert a.dtype == b.dtype, (name, field)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}: {field}")


# -- the JAX package's kernel cases and worlds ---------------------------------


KERNEL_CASES = sorted(n for n in dir(jtp.TestPreemptKernel) if n.startswith("test_"))


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_kernel_case_matches_jax(case, monkeypatch):
    """Each TestPreemptKernel case with its ``_run`` pointed at the port's
    main loop: the case's own assertions hold on the port's results, and
    on each of its worlds every implementation agrees."""
    worlds = []

    def run(w):
        got = port_run(w)
        assert_all_equal(w, got)
        worlds.append(w)
        return got

    monkeypatch.setattr(jtp, "_run", run)
    getattr(jtp.TestPreemptKernel(), case)()
    assert worlds


def test_every_kernel_case_is_twinned():
    """tests/test_preempt.py's twelve kernel cases, each a case above."""
    assert len(KERNEL_CASES) == 12 and "test_crafted_worlds_match_oracle" in KERNEL_CASES


@pytest.mark.parametrize("case", range(30))
def test_randomized_world_matches_jax(case):
    """tests/test_preempt.py's randomized worlds (priorities, Never-policy
    pods, ineligible victims, predicate vetoes)."""
    assert_all_equal(jtp._random_world(np.random.default_rng((1600, case))))


@pytest.mark.parametrize("case", range(12))
def test_byte_world_matches_jax(case):
    """Six resources in the packer's units, memory in bytes: decimal M
    requests against Gi allocatable, so many f32 sums are inexact; every
    implementation still agrees on these seeds."""
    w = preempt_probe.byte_world(np.random.default_rng((1613, case)))
    assert_all_equal(w)


@pytest.mark.parametrize("trial", [0, 5, 23])
def test_storm_world_matches_jax(trial):
    """bench.py's preemption storm worlds (96 × 12), as 4p draws them."""
    assert_all_equal(preempt_probe.storm_worlds(trial + 1)[trial])


def rounding_world():
    """Two victims of 11 718 751·128 and 11 718 752·128 bytes on a node
    whose usage (their f32 sum, 3 000 000 512) equals its allocatable, and
    a pending pod asking for exactly that: in exact arithmetic the victims
    free 3 000 000 384 bytes, short of the request by 128; the f32 sum
    rounds up to 3 000 000 512 and fits."""
    w = jtp._world(3, 1, node_cpu=4000.0, node_mem=0.0)
    jtp._resident(w, 0, 0, 1000, 11_718_751 * 128, prio=5)
    jtp._resident(w, 1, 0, 1000, 11_718_752 * 128, prio=6)
    w["node_alloc"][0, 1] = w["node_used"][0, 1]
    jtp._pending(w, 2, 1000, float(w["node_used"][0, 1]), prio=100)
    return w


def test_rounding_world_is_the_queue3_divergence():
    """Summation order: the XLA scan sums a node's candidates in f32 (a
    blocked tree on XLA:CPU), the oracle and the port in exact arithmetic.
    On this world the XLA scan admits the pod by evicting both residents,
    and the oracle and the port admit nothing: the first differing field
    is ``scheduled`` (row 2). ROADMAP queue 3 records it."""
    w = rounding_world()
    res = results(w)
    for name in ("port_oracle", "main", "plain"):
        for field, a, b in zip(FIELDS, res[name], res["jax_oracle"]):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}: {field}")
    assert not res["main"][0].any() and (res["main"][2] == -1).all()
    xla = res["xla"]
    assert xla[0].tolist() == [False, False, True]
    assert xla[2].tolist() == [2, 2, -1]


def test_update_adds_request_less_freed_once():
    """The carry's update is ``used[target] += req - freed``: a pod admitted
    by eviction leaves exactly its own request behind, so the next pod sees
    the freed room less the first pod's request (here: room for one more
    500m pod, not two)."""
    w = jtp._world(4, 1, node_cpu=4000.0, node_mem=16384.0)
    jtp._resident(w, 0, 0, 3000, 1024, prio=5)
    jtp._resident(w, 1, 0, 1000, 1024, prio=50)
    jtp._pending(w, 2, 2000, 1024, prio=100)
    jtp._pending(w, 3, 1000, 1024, prio=90)
    assert_all_equal(w)
    sched, placed, victim = port_run(w)
    assert sched.tolist() == [False, False, True, True] and victim.tolist() == [2, -1, -1, -1]


def test_zero_request_candidates_count_as_victims():
    """Every candidate up to the minimal prefix is a victim, even one that
    frees nothing: a zero-request resident of lower priority is evicted
    with the one that makes room."""
    w = jtp._world(3, 1, node_cpu=4000.0, node_mem=16384.0)
    jtp._resident(w, 0, 0, 0, 0, prio=1)
    jtp._resident(w, 1, 0, 4000, 1024, prio=2)
    jtp._pending(w, 2, 4000, 1024, prio=100)
    assert_all_equal(w)
    assert port_run(w)[2].tolist() == [2, 2, -1]


def test_no_feasible_node_masks_the_choice():
    """No node can take the pod even empty: the choice falls to node 0
    (argmax of nothing) and is masked; nothing is admitted or evicted."""
    w = jtp._world(3, 2, node_cpu=4000.0, node_mem=16384.0)
    jtp._resident(w, 0, 0, 4000, 1024, prio=1)
    jtp._resident(w, 1, 1, 4000, 1024, prio=1)
    jtp._pending(w, 2, 5000, 1024, prio=100)
    assert_all_equal(w)
    sched, placed, victim = port_run(w)
    assert not sched.any() and (placed == -1).all() and (victim == -1).all()


def test_packing_order_is_the_oracles():
    """Priority desc, the FFD score against the max valid allocatable row
    desc (no FMA, stable), row asc: the port's order equals the oracle's
    ``preempt_order`` on a world with score and priority ties."""
    w = preempt_probe.byte_world(np.random.default_rng(7), P=64, N=8)
    w["pod_priority"][::3] = 7
    w["pod_req"][1::4] = w["pod_req"][0]
    w["node_valid"][-1] = False
    cap = np.where(w["node_valid"][:, None], w["node_alloc"], 0.0).max(axis=0)
    want = tref.preempt_order(w["pod_req"], w["pod_priority"], cap)
    t = {k: torch.tensor(w[k]) for k in ("pod_req", "pod_priority", "node_alloc", "node_valid")}
    got = tpre.packing_order(t["pod_req"], t["pod_priority"], t["node_alloc"], t["node_valid"])
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("chunk", [1, 3, 64])
@pytest.mark.parametrize("seed", range(3))
def test_main_loop_equals_plain_across_chunks(seed, chunk, monkeypatch):
    """The main loop against its plain version with chunk edges anywhere
    (``CHUNK``), on wide byte worlds and with the mask read as rows of a
    ``SchedRows``."""
    monkeypatch.setattr(tpre, "CHUNK", chunk)
    w = preempt_probe.byte_world(np.random.default_rng((1614, seed)), P=96, N=16, pending=20)
    want = port_run(w, tpre.ffd_binpack_preempt_plain)
    got = port_run(w)
    rows = types.SimpleNamespace(
        num_pods=96, num_nodes=16,
        sched_rows=lambda idx: torch.tensor(w["sched_mask"]).index_select(0, idx.long()))
    t = {k: torch.tensor(w[k]) for k in OPERANDS}
    t["sched_mask"] = tpre.SchedRows(rows)
    via_rows = tuple(x.numpy() for x in tpre.ffd_binpack_preempt(**t))
    for a, b, c in zip(want, got, via_rows):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_hold_plain_holds_every_small_world():
    """tools/preempt_probe.hold_plain, 4p's check, on the CPU."""
    held = preempt_probe.hold_plain(preempt_probe.storm_worlds(4)
                                    + preempt_probe.wide_worlds(1, P=120, N=20), "cpu")
    assert [h["equal"] for h in held] == [True] * 5
    assert sum(h["evictions"] for h in held) > 0 and max(h["max_abs_err"] for h in held) == 0


# -- the estimator, the engine and the churn filter ----------------------------


def snap_world(k, seed, N=6):
    """A snapshot of ``N`` nodes holding residents of priority 0-49 (one in
    six a DaemonSet pod, never a victim) and 10 pending pods of priority
    0-119, one in four at Never, built with package ``k``'s modules."""
    rng = np.random.default_rng((1615, seed))
    snap = k.cs.ClusterSnapshot(**k.snap_kw)
    nodes = [k.tu.build_test_node(f"n{j}", cpu_m=float(rng.choice([4000, 8000])), mem=16 * GB)
             for j in range(N)]
    for n in nodes:
        snap.add_node(n)
    i = 0
    for n in nodes:
        used = 0.0
        while True:
            cpu = float(rng.integers(2, 20)) * 100
            if used + cpu > n.allocatable.cpu_m * rng.uniform(0.6, 1.0):
                break
            pod = k.tu.build_test_pod(f"r{i}", cpu_m=cpu, mem=float(rng.integers(1, 8)) * 2**28,
                                      node_name=n.name, priority=int(rng.integers(0, 50)))
            pod.daemonset = i % 6 == 5
            snap.add_pod(pod, n.name)
            used += cpu
            i += 1
    for j in range(10):
        pod = k.tu.build_test_pod(f"p{j}", cpu_m=float(rng.integers(5, 60)) * 100,
                                  mem=float(rng.integers(1, 16)) * 2**28,
                                  priority=int(rng.integers(0, 120)))
        if j % 4 == 3:
            pod.preemption_policy = "Never"
        snap.add_pod(pod)
    return snap


def engine_plan(k, seed, eligible=None, metrics=None, fault=None):
    est = k.bp.BinpackingNodeEstimator(metrics=metrics, **k.kw)
    if fault is not None:
        est.ladder.fault_hook = lambda rung: "kernel_fault" if port_label("rung", rung) == fault else None
    return k.pre.PreemptionEngine(est, metrics=metrics).plan(snap_world(k, seed), eligible)


@pytest.mark.parametrize("factored", [False, True], ids=["dense", "factored"])
@pytest.mark.parametrize("seed", range(4))
def test_engine_plan_matches_jax(seed, factored, monkeypatch):
    """PreemptionEngine.plan on twin snapshots: the admitted keys, the
    placements, the victim → evictor map and its pods equal the JAX
    package's, with every pending pod and with every other one eligible;
    the port's snapshot packed dense or factored (its loop then reads the
    mask as rows)."""
    if factored:
        monkeypatch.setattr(tpack, "DENSE_MASK_CELL_LIMIT", 64)
    for half in (False, True):
        plans = {}
        for k in (JAX, TORCH):
            eligible = {f"default/p{j}" for j in range(0, 10, 2)} if half else None
            plans[k.name] = engine_plan(k, seed, eligible)
        j, t = plans["jax"], plans["torch"]
        assert (t.admitted, t.placements, t.victims) == (j.admitted, j.placements, j.victims)
        assert sorted(t.victim_pods) == sorted(j.victim_pods)
        assert t.route == port_label("route", j.route) == "torch_preempt"
    assert any(engine_plan(TORCH, seed).victims for seed in range(4))


@pytest.mark.parametrize("fault", [None, "torch"], ids=["healthy", "torch_faulted"])
def test_estimate_preemption_series_match_jax(fault):
    """estimate_preemption's route and rung-attempt series and the planned
    evictions gauge equal the JAX package's under the name map: the cuda
    rung has no twin (the ``unsupported`` skip) and the torch loop serves,
    or, with a fault armed on it off the card, the Python oracle does."""
    series = {}
    for k in (JAX, TORCH):
        m = k.metrics.AutoscalerMetrics()
        plan = engine_plan(k, 1, metrics=m, fault=fault)
        as_port = port_series if k is JAX else series_of
        series[k.name] = (
            as_port(m.estimator_kernel_route_total),
            as_port(m.estimator_kernel_rung_attempts_total),
            port_label("route", plan.route), m.preemption_planned_evictions.get(),
        )
    assert series["torch"] == series["jax"]
    route = "torch_preempt" if fault is None else "python_preempt_ref"
    assert series["torch"][2] == route
    reason = "unsupported" if fault is None else "kernel_fault"
    assert series["torch"][0] == {(("reason", reason), ("route", route)): 1}


def series_of(counter) -> dict:
    return {tuple(labels): value for labels, value in counter.values.items()}


def test_preempt_plan_span_counts_alike():
    """Both packages time the pass under the ``preemptPlan`` span, with a
    ``deviceDispatch`` span a rung engaged."""
    lines = {}
    for k in (JAX, TORCH):
        m = k.metrics.AutoscalerMetrics()
        engine_plan(k, 2, metrics=m)
        lines[k.name] = sorted(
            line.rsplit(" ", 1)[0] + " " + line.rsplit(" ", 1)[1]
            for line in m.registry.expose().splitlines()
            if "_count{" in line and ('"preemptPlan"' in line or '"deviceDispatch"' in line))
    assert lines["torch"] == lines["jax"] and lines["torch"]


def test_churn_filter_matches_jax():
    """PreemptionChurnFilter on twin options: the same scores, survivors
    and disengagement without a plan."""
    out = {}
    for k in (JAX, TORCH):
        plan = k.pre.PreemptionPlan(victims={"v1": "default/a", "v2": "default/a",
                                             "v3": "default/b"})
        pods = {n: k.tu.build_test_pod(n) for n in "abc"}
        groups = [types.SimpleNamespace(id=lambda g=g: g) for g in ("g1", "g2", "g3")]
        options = [k.exp.Option(groups[0], 1, [pods["a"]]),
                   k.exp.Option(groups[1], 1, [pods["a"], pods["b"]]),
                   k.exp.Option(groups[2], 1, [pods["c"]])]
        f = k.exp.PreemptionChurnFilter(2.0)
        unbound = (f.scores(options), [o.node_group.id() for o in f.best_options(options)])
        f.churn_of = plan.churn
        out[k.name] = (unbound, f.scores(options),
                       [o.node_group.id() for o in f.best_options(options)], f.name)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == [2.0, 0.0, 6.0] and out["torch"][2] == ["g2"]


# -- run_once with preemption, and the journal's CLIs ---------------------------


def storm_loop(k, fail_victim=True):
    """Twin reconcile loops over a full group of 3 nodes (max 4): residents
    of priority 0 and 5 fill them, pending pods of priority 100 (one at
    Never) need evictions, and scale-up can bring one node. With
    ``fail_victim`` one victim's eviction is rejected by the API. Ticks at
    0 and 30 s."""
    pods = []
    for n in range(3):
        for r in range(3):
            pods.append(k.tu.build_test_pod(f"low{n}{r}", cpu_m=1200.0, mem=GB,
                                            node_name=f"g-{n}", priority=5 * (r % 2)))
    for j in range(5):
        pod = k.tu.build_test_pod(f"hi{j}", cpu_m=2000.0 + 100 * j, mem=GB, priority=100)
        if j == 4:
            pod.preemption_policy = "Never"
        pods.append(pod)
    w = tsat.build_world(tsat.JAX if k is JAX else tsat.TORCH, [("g", 0, 4, 4000, 8 * GB)],
                         {"g": 3}, pods, preemption_enabled=True, preemption_churn_weight=1.0)
    if fail_victim:
        w.api.fail_evictions_for = {"default/low00"}
    for now in (0.0, 30.0):
        yield w, tsat.tick(w, now)


def renamed(st: dict, k) -> dict:
    """A tick state with the JAX package's route names under the name map
    (the decision lines' preemption section and degraded rungs) and the
    journal lines without their decision line's sha256 (which pins a line
    that differs exactly by those names); each package's own pins are
    checked here first."""
    from autoscaler_tpu_torch.explain.ledger import record_line as explain_line

    for line, jline in zip(st["decision"], st["journal"]):
        pin = json.loads(jline)["explain_sha256"]
        assert pin in ("", hashlib.sha256(line.encode()).hexdigest())
    out = tsat.port_named(st, k)
    decisions = []
    for line in out["decision"]:
        rec = json.loads(line)
        if rec.get("preemption"):
            rec["preemption"]["route"] = port_label("route", rec["preemption"]["route"])
        decisions.append(explain_line(rec))
    out["decision"] = decisions
    return out


def run_storm_twins():
    worlds = {}
    ticks = 0
    for (wj, rj), (wt, rt) in zip(storm_loop(JAX), storm_loop(TORCH)):
        ref = renamed(tsat.state(wj, rj), tsat.JAX)
        out = renamed(tsat.state(wt, rt), tsat.TORCH)
        diff = sorted(key for key in ref if ref[key] != out[key])
        assert not diff, f"tick {ticks + 1}: {diff} differ"
        worlds = {"jax": (wj, rj), "torch": (wt, rt)}
        ticks += 1
    return worlds, ticks


def test_run_once_with_preemption_matches_jax():
    """Two ticks of a loop with --preemption-enabled and a churn weight on
    both packages: the RunOnceResult (preempt_admitted, preempted_pods),
    the API's evictions, every decision line (its preemption section:
    route, admitted, evictions, evicted), journal line (its preemption
    notes) and the metrics exposition equal; the pass admitted and
    evicted, a rejected eviction was recorded, and the churn filter scored
    the scale-up options."""
    worlds, ticks = run_storm_twins()
    assert ticks == 2
    w, _ = worlds["torch"]
    first = w.sa.explainer.records()[0]
    sec = first["preemption"]
    assert sec["route"] == "torch_preempt" and sec["admitted"] and sec["evictions"]
    assert sec["evicted"] and "default/low00" not in sec["evicted"]
    assert w.sa.journal.records()[0]["ctx"]["preempt_evict_failed"] == ["default/low00"]
    assert all("preempt-churn" in row["scores"] for row in first["expander"]["options"])
    assert w.sa.metrics.preempted_pods_total.get() == len(sec["evicted"])


def cli_outputs(cli, journal, ledger, capsys, device_args=()):
    out = []
    for argv in (["reconstruct", journal], ["reconstruct", journal, "--tick", "0"],
                 ["diff", journal, "0", "1"],
                 ["replay", journal, "--explain-ledger", ledger, *device_args]):
        rc = cli.main(argv)
        captured = capsys.readouterr()
        out.append((rc, captured.out))
    return out


def test_journal_cli_matches_jax_over_the_same_files(tmp_path, capsys):
    """``reconstruct``, ``diff`` and ``replay`` of both packages' CLIs over
    each package's journal and decision ledger of the storm loop print the
    same output; replay re-derives every preemption section (zero
    divergences), and a tampered ledger diverges in both."""
    from autoscaler_tpu_torch.explain.ledger import record_line as explain_line

    worlds, _ = run_storm_twins()
    for name, (w, _) in worlds.items():
        d = tmp_path / name
        d.mkdir()
        journal, ledger = preempt_probe.write_ledgers(w.sa, str(d))
        jax_out = cli_outputs(jcli, journal, ledger, capsys)
        port_out = cli_outputs(tcli, journal, ledger, capsys, ("--device", "cpu"))
        assert port_out == jax_out
        verdict = json.loads(port_out[-1][1].splitlines()[-1])
        assert port_out[-1][0] == 0 and verdict["diverged"] == 0 and verdict["replayed"] == 2
        records = [json.loads(line) for line in open(ledger)]
        records[0]["preemption"]["evictions"] = []
        bad = d / "tampered.jsonl"
        bad.write_text("".join(explain_line(r) for r in records))
        rcs = [cli.main(["replay", journal, "--explain-ledger", str(bad), *extra])
               for cli, extra in ((jcli, ()), (tcli, ("--device", "cpu")))]
        err = capsys.readouterr().err
        assert rcs == [1, 1] and err.count("DIVERGED") >= 4


def test_replay_runs_on_the_device_asked_for():
    """journal.replay re-runs the pass through the port's estimator on the
    caller's device, and the torch loop serves it."""
    from autoscaler_tpu_torch.journal import JournalReader
    from autoscaler_tpu_torch.journal.replay import _replan

    worlds, _ = run_storm_twins()
    w, _ = worlds["torch"]
    reader = JournalReader(w.sa.journal.records())
    state = reader.reconstruct(reader.ticks()[0])
    derived = _replan(state, state.ctx["preempt_eligible"], "cpu")
    assert derived["route"] == "torch_preempt" and derived["evictions"]


def test_main_runs_with_preemption_as_jax(capsys):
    """``python -m autoscaler_tpu_torch.main --preemption-enabled
    --preemption-churn-weight=...`` runs its loop as the JAX package's main
    does, instead of refusing."""
    import autoscaler_tpu.main as jmain
    import autoscaler_tpu_torch.main as tmain

    argv = ["--provider=test", "--max-iterations=2", "--scan-interval=0",
            "--address=127.0.0.1:0", "--preemption-enabled=true",
            "--preemption-churn-weight=1.5"]
    assert jmain.main(argv) == 0
    capsys.readouterr()
    assert tmain.main(argv + ["--device=cpu"]) == 0
    assert "device cpu" in capsys.readouterr().out
