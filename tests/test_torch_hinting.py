"""The port's hinting simulator and filter-out-schedulable processor
(autoscaler_tpu_torch/simulator/hinting.py, core/podlistprocessor.py)
against the JAX package's: both packages build their ClusterSnapshots from
one numpy-seeded generator (dense mask, or factored with
``packer.DENSE_MASK_CELL_LIMIT`` lowered at call time), and the
assignments, scheduled lists, hint maps and snapshots after commit or
revert must be equal."""
import random

import pytest

import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.snapshot.cluster_snapshot as jcs
import autoscaler_tpu.snapshot.packer as jpack
import autoscaler_tpu.utils.test_utils as jtu
from autoscaler_tpu.core.podlistprocessor import (
    FilterOutSchedulablePodListProcessor as JFilter,
)
from autoscaler_tpu.simulator.hinting import HintingSimulator as JSim
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.snapshot.cluster_snapshot as tcs
import autoscaler_tpu_torch.snapshot.packer as tpack
import autoscaler_tpu_torch.utils.test_utils as ttu
from autoscaler_tpu_torch.core.podlistprocessor import (
    FilterOutSchedulablePodListProcessor as TFilter,
)
from autoscaler_tpu_torch.simulator.hinting import HintingSimulator as TSim
from torch_parity import mask_world

JAX = (jtu, jobj, jcs, JSim, JFilter)
TORCH = (ttu, tobj, tcs, TSim, TFilter)
ZONE = "topology.kubernetes.io/zone"
FORMS = ["dense", "factored"]


def new_snapshot(pkg):
    cs = pkg[2]
    return cs.ClusterSnapshot() if pkg is JAX else cs.ClusterSnapshot(device="cpu")


@pytest.fixture(params=FORMS)
def form(request, monkeypatch):
    if request.param == "factored":
        monkeypatch.setattr(jpack, "DENSE_MASK_CELL_LIMIT", 16)
        monkeypatch.setattr(tpack, "DENSE_MASK_CELL_LIMIT", 16)
    return request.param


def snapshot_world(pkg, seed, spread=False):
    """mask_world in a ClusterSnapshot (placed pods on their nodes, the rest
    pending), pending pods with priorities 0-2 and 2000-4100 m of cpu, more
    than the free capacity holds; with ``spread`` one pending pod in three
    carries a zone DoNotSchedule spread on its app."""
    tu, obj = pkg[0], pkg[1]
    nodes, pods, _ = mask_world(tu, obj, seed)
    snap = new_snapshot(pkg)
    for n in nodes:
        snap.add_node(n)
    for i, p in enumerate(pods):
        p.priority = i % 3
        if not p.node_name:
            p.requests = obj.Resources(cpu_m=2000.0 + 700 * (i % 4), memory=p.requests.memory)
        if spread and not p.node_name and i % 3 == 0:
            p.topology_spread = (obj.TopologySpreadConstraint(
                max_skew=1, topology_key="zone",
                selector=obj.LabelSelector.from_dict({"app": p.labels["app"]}),
            ),)
        snap.add_pod(p)
    return snap, [p for p in pods if not p.node_name]


def state(snap):
    return (
        [n.name for n in snap.nodes()],
        [(p.key(), snap.assignment(p.key())) for p in snap.pods()],
        [[p.key() for p in snap.pods_on_node(n.name)] for n in snap.nodes()],
        [p.key() for p in snap.pending_pods()],
        snap.fork_depth,
    )


def keys(pods):
    return [p.key() for p in pods]


@pytest.mark.parametrize("spread", [False, True], ids=["plain", "spread"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hinting_simulator_over_three_generations(seed, spread, form):
    """Three calls on one simulator: half the pending pods without commit,
    the other half with it, then the first half again, whose hints from
    call 1 the generation GC (max_generations 2) has dropped; a hint to a
    node the snapshot lacks is ignored. Assignments, scheduled lists, the
    hint store and the snapshot after every call are equal."""
    out = {}
    for pkg in (JAX, TORCH):
        snap, pending = snapshot_world(pkg, seed, spread)
        sim = pkg[3]()
        sim.hints.set(pending[0].key(), "ghost-node")
        half = len(pending) // 2
        calls = []
        for pods, commit in ((pending[:half], False), (pending[half:], True),
                             (pending[:half], True)):
            scheduled, assignments = sim.try_schedule_pods(snap, pods, commit=commit)
            calls.append((keys(scheduled), assignments, dict(sim.hints._store),
                          sim.hints._generation, state(snap)))
        out[pkg is TORCH] = calls
    assert out[True] == out[False]
    calls = out[True]
    assert all(c[0] for c in calls)            # every call places pods
    assert calls[1][4][3] != calls[0][4][3]    # call 2 committed, call 1 did not
    # call 3's pods lost their generation-0 hints in call 2's GC
    assert all(v[1] >= 1 for v in calls[1][2].values())


def test_hints_generations_drop_old_entries():
    for pkg in (JAX, TORCH):
        hints = pkg[3]().hints
        hints.set("a", "n0")
        hints.next_generation()
        hints.set("b", "n1")
        assert hints.get("a") == "n0"
        hints.next_generation()
        assert hints.get("a") is None and hints.get("b") == "n1"
        hints.next_generation()
        assert hints.get("b") is None


@pytest.mark.parametrize("spread", [False, True], ids=["plain", "spread"])
@pytest.mark.parametrize("seed", [0, 3])
def test_filter_out_schedulable_on_a_fork(seed, spread, form):
    """run_once's sequence: fork, filter-out (priority then key order, one
    commit a placed pod), revert. The filtered and still-pending keys, the
    fork's state before the revert and the snapshot after it are equal,
    and the revert restores the snapshot."""
    out = {}
    for pkg in (JAX, TORCH):
        snap, pending = snapshot_world(pkg, seed, spread)
        before = state(snap)
        random.Random(seed).shuffle(pending)
        snap.fork()
        still, filtered = pkg[4]().process(snap, pending)
        forked = state(snap)
        snap.revert()
        assert state(snap) == before
        out[pkg is TORCH] = (keys(still), keys(filtered), forked, state(snap))
    assert out[True] == out[False]
    still, filtered = out[True][0], out[True][1]
    assert still and filtered


# tests/test_static_autoscaler.py's TestHintingSimulator and
# TestPodListProcessor, run on both packages


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])
def test_schedule_and_hints(pkg):
    tu = pkg[0]
    s = new_snapshot(pkg)
    s.add_node(tu.build_test_node("n0", cpu_m=1000))
    s.add_node(tu.build_test_node("n1", cpu_m=1000))
    pods = [tu.build_test_pod(f"p{i}", cpu_m=400) for i in range(3)]
    for p in pods:
        s.add_pod(p)
    sim = pkg[3]()
    scheduled, assignments = sim.try_schedule_pods(s, pods, commit=True)
    assert len(scheduled) == 3
    per_node = {}
    for node in assignments.values():
        per_node[node] = per_node.get(node, 0) + 1
    assert all(v <= 2 for v in per_node.values())
    assert assignments == {"default/p0": "n0", "default/p1": "n0", "default/p2": "n1"}
    assert sim.hints.get("default/p0") == "n0"


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])
def test_hint_preferred(pkg):
    tu = pkg[0]
    s = new_snapshot(pkg)
    s.add_node(tu.build_test_node("n0", cpu_m=2000))
    s.add_node(tu.build_test_node("n1", cpu_m=2000))
    pod = tu.build_test_pod("p", cpu_m=100)
    s.add_pod(pod)
    sim = pkg[3]()
    sim.hints.set("default/p", "n1")
    _, assignments = sim.try_schedule_pods(s, [pod], commit=False)
    assert assignments["default/p"] == "n1"
    assert s.assignment("default/p") == ""


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])
def test_no_capacity(pkg):
    tu = pkg[0]
    s = new_snapshot(pkg)
    s.add_node(tu.build_test_node("n0", cpu_m=100))
    pod = tu.build_test_pod("p", cpu_m=500)
    s.add_pod(pod)
    scheduled, _ = pkg[3]().try_schedule_pods(s, [pod])
    assert scheduled == []
    assert pkg[3]().try_schedule_pods(s, []) == ([], {})


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])
def test_filters_schedulable(pkg):
    tu = pkg[0]
    s = new_snapshot(pkg)
    s.add_node(tu.build_test_node("n0", cpu_m=1000))
    fits = tu.build_test_pod("fits", cpu_m=300)
    too_big = tu.build_test_pod("big", cpu_m=5000)
    s.add_pod(fits)
    s.add_pod(too_big)
    still, filtered = pkg[4]().process(s, [fits, too_big])
    assert [p.name for p in filtered] == ["fits"]
    assert [p.name for p in still] == ["big"]
    assert pkg[4]().process(s, []) == ([], [])


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])
def test_priority_order(pkg):
    tu = pkg[0]
    s = new_snapshot(pkg)
    s.add_node(tu.build_test_node("n0", cpu_m=500))
    low = tu.build_test_pod("low", cpu_m=400, priority=0)
    high = tu.build_test_pod("high", cpu_m=400, priority=10)
    s.add_pod(low)
    s.add_pod(high)
    still, filtered = pkg[4]().process(s, [low, high])
    assert [p.name for p in filtered] == ["high"]
    assert [p.name for p in still] == ["low"]


def test_equal_priority_tiebreak_is_order_independent():
    """Equal priorities break ties on the pod key, so the outcome is a
    function of the pod set, in both packages alike."""
    outcomes = set()
    for pkg in (JAX, TORCH):
        tu = pkg[0]
        pods = [tu.build_test_pod(f"p{i}", cpu_m=400, priority=7) for i in range(6)]
        for seed in range(4):
            s = new_snapshot(pkg)
            s.add_node(tu.build_test_node("n0", cpu_m=900))
            shuffled = list(pods)
            random.Random(seed).shuffle(shuffled)
            for p in shuffled:
                s.add_pod(p)
            still, filtered = pkg[4]().process(s, shuffled)
            outcomes.add((tuple(sorted(p.name for p in filtered)),
                          tuple(sorted(p.name for p in still))))
    assert outcomes == {(("p0", "p1"), ("p2", "p3", "p4", "p5"))}


@pytest.mark.parametrize("preload", [0, 2])
def test_within_wave_spread_matches_jax(preload):
    """TestSpreadWithinWaveExact's worlds through both simulators: eight
    zone-spread pods over two empty zones land 4/4; with zone a holding two
    matching pods, three land in zone b and the fourth waits for the next
    loop, where it lands in zone a."""
    out = {}
    for pkg in (JAX, TORCH):
        tu, obj = pkg[0], pkg[1]
        snap = new_snapshot(pkg)
        for z in "ab":
            n = tu.build_test_node(f"n-{z}", cpu_m=10_000)
            n.labels[ZONE] = f"zone-{z}"
            snap.add_node(n)
        for k in range(preload):
            snap.add_pod(tu.build_test_pod(f"pre{k}", cpu_m=100, labels={"app": "web"}),
                         "n-a")
        pending = []
        for i in range(8 if preload == 0 else 4):
            p = tu.build_test_pod(f"p{i}", cpu_m=100, labels={"app": "web"})
            p.topology_spread = (obj.TopologySpreadConstraint(
                max_skew=1, topology_key=ZONE,
                selector=obj.LabelSelector.from_dict({"app": "web"}),
            ),)
            snap.add_pod(p)
            pending.append(p)
        calls = []
        for _ in range(2):
            left = [p for p in pending if not snap.assignment(p.key())]
            scheduled, assignments = pkg[3]().try_schedule_pods(snap, left, commit=True)
            calls.append((keys(scheduled), assignments))
        out[pkg is TORCH] = (calls, state(snap))
    assert out[True] == out[False]
    calls = out[True][0]
    if preload == 0:
        zones = [n[-1] for n in calls[0][1].values()]
        assert zones.count("a") == zones.count("b") == 4
    else:
        assert sorted(calls[0][1].values()) == ["n-b"] * 3
        assert list(calls[1][1].values()) == ["n-a"]
