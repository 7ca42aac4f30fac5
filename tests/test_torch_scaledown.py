"""The port's scale-down half of a reconcile tick against the JAX package's,
on the CPU, bit for bit (tolerance 0: every operation on both sides is an
IEEE f32 divide, subtract, add or compare in a fixed order, or integer
arithmetic):

- the device code: ``ops/utilization.node_utilization``,
  ``ops/scaledown.empty_nodes`` and the four removal passes, on seeded
  numpy worlds handed to both packages (dense and factored masks, padding,
  repeated placements onto one node of one lane, blocked and empty lanes,
  a ``-1`` slot, a rolled-back candidate, lane chunks crossing an edge);
- the object level: the drain rules, ``RemovalSimulator``, eligibility, the
  trackers, the planner and the actuator, each case of
  tests/test_scaledown.py run on both packages (each with its own objects,
  built the same way) with the same outcome;
- the two loops of a scale-down on the scale-in world of
  ``tools/scaledown_probe`` at a small size, the port's probe against the
  JAX package's planner and actuator driven the same way.
"""
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autoscaler_tpu.cloudprovider.test_provider as jprov
import autoscaler_tpu.config.options as jopts
import autoscaler_tpu.core.scaledown.actuator as jact
import autoscaler_tpu.core.scaledown.eligibility as jelig
import autoscaler_tpu.core.scaledown.limits as jlimits
import autoscaler_tpu.core.scaledown.planner as jplanner
import autoscaler_tpu.core.scaledown.tracking as jtrack
import autoscaler_tpu.core.scaleup.resource_manager as jrm
import autoscaler_tpu.kube.api as japi
import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.ops.scaledown as jsd
import autoscaler_tpu.ops.utilization as jutil
import autoscaler_tpu.processors.pipeline as jpipe
import autoscaler_tpu.simulator.drain as jdrain
import autoscaler_tpu.simulator.removal as jrem
import autoscaler_tpu.simulator.tracker as jtracker
import autoscaler_tpu.snapshot.cluster_snapshot as jcs
import autoscaler_tpu.snapshot.tensors as jtensors
import autoscaler_tpu.trace as jtrace
import autoscaler_tpu.utils.sharded_worlds as jworlds
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.cloudprovider.test_provider as tprov
import autoscaler_tpu_torch.config.options as topts
import autoscaler_tpu_torch.core.scaledown.actuator as tact
import autoscaler_tpu_torch.core.scaledown.eligibility as telig
import autoscaler_tpu_torch.core.scaledown.limits as tlimits
import autoscaler_tpu_torch.core.scaledown.planner as tplanner
import autoscaler_tpu_torch.core.scaledown.tracking as ttrack
import autoscaler_tpu_torch.core.scaleup.resource_manager as trm
import autoscaler_tpu_torch.kube.api as tapi
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.ops.scaledown as tsd
import autoscaler_tpu_torch.ops.utilization as tutil
import autoscaler_tpu_torch.simulator.drain as tdrain
import autoscaler_tpu_torch.simulator.removal as trem
import autoscaler_tpu_torch.simulator.tracker as ttracker
import autoscaler_tpu_torch.snapshot.cluster_snapshot as tcs
import autoscaler_tpu_torch.snapshot.packer as tpack
import autoscaler_tpu_torch.trace as ttrace
import autoscaler_tpu_torch.utils.test_utils as ttu
from autoscaler_tpu_torch.snapshot.affinity import spread_context_from_numpy
from autoscaler_tpu_torch.snapshot.tensors import tensors_from_numpy
from autoscaler_tpu_torch.tools import scaledown_probe
from autoscaler_tpu_torch.utils.workload import build_snapshot_world
from torch_parity import (
    assert_bits_equal,
    canon,
    lanes_of,
    removal_arrays,
    removal_spread_context,
    twin,
)

JAX = types.SimpleNamespace(
    name="jax", prov=jprov, opts=jopts, act=jact, elig=jelig, limits=jlimits,
    planner=jplanner, track=jtrack, rm=jrm, api=japi, obj=jobj, drain=jdrain,
    rem=jrem, tracker=jtracker, cs=jcs, tu=jtu, trace=jtrace, kw={},
)
TORCH = types.SimpleNamespace(
    name="torch", prov=tprov, opts=topts, act=tact, elig=telig, limits=tlimits,
    planner=tplanner, track=ttrack, rm=trm, api=tapi, obj=tobj, drain=tdrain,
    rem=trem, tracker=ttracker, cs=tcs, tu=ttu, trace=ttrace, kw={"device": "cpu"},
)
GB = 1024**3
MB = 1024**2
CPU, MEMORY, GPU, PODS = 0, 1, 3, 5


# -- the device code on seeded numpy worlds ----------------------------------

def both_tensors(arrays):
    """The same numpy fields as the JAX package's SnapshotTensors and the
    port's (on the CPU)."""
    jt = jtensors.SnapshotTensors(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jt, tensors_from_numpy(arrays, device="cpu")


def util_arrays(seed, N=24, pad=8):
    """Nodes of mixed shapes, a third of them GPU nodes, some with zero
    memory allocatable, ``pad`` padding rows; usage up to 1.2 × alloc."""
    rng = np.random.default_rng(seed)
    M = N + pad
    alloc = np.zeros((M, 6), np.float32)
    alloc[:N, CPU] = rng.choice([1000, 3000, 7000], N)
    alloc[:N, MEMORY] = rng.integers(0, 4, N) * np.float32(3000.7)
    alloc[:N, GPU] = np.where(np.arange(N) % 3 == 0, rng.integers(1, 8, N), 0)
    alloc[:N, PODS] = 110
    used = (alloc * rng.random((M, 6)).astype(np.float32) * np.float32(1.2)).astype(np.float32)
    used[N:] = rng.random((pad, 6)).astype(np.float32)   # garbage under padding
    valid = np.arange(M) < N
    P = 8
    return {
        "node_alloc": alloc, "node_used": used, "node_valid": valid,
        "node_group": np.zeros(M, np.int32), "pod_req": np.zeros((P, 6), np.float32),
        "pod_valid": np.zeros(P, bool), "pod_node": np.full(P, -1, np.int32),
        "sched_mask": np.ones((P, M), bool),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("exclude", [False, True])
def test_node_utilization(seed, exclude):
    arrays = util_arrays(seed)
    jt, tt = both_tensors(arrays)
    ex = None
    if exclude:
        rng = np.random.default_rng(seed + 10)
        ex = (arrays["node_used"] * rng.random(arrays["node_used"].shape)).astype(np.float32)
    ref = jutil.node_utilization(jt, None if ex is None else jnp.asarray(ex))
    out = tutil.node_utilization(tt, None if ex is None else torch.tensor(ex))
    assert_bits_equal(ref, out)
    assert out.dtype == torch.float32
    n = int(arrays["node_valid"].sum())
    assert (out[n:] == 0).all()                     # padding rows
    gpu = arrays["node_alloc"][:n, GPU] > 0
    assert gpu.any() and (~gpu).any()               # both rules in play


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_empty_nodes(seed):
    arrays = removal_arrays(seed)
    rng = np.random.default_rng(seed)
    movable = rng.random(arrays["pod_valid"].shape[0]) < 0.3
    jt, tt = both_tensors(arrays)
    ref = jsd.empty_nodes(jt, jnp.asarray(movable))
    out = tsd.empty_nodes(tt, torch.tensor(movable))
    assert_bits_equal(ref, out)
    assert out.any() and not out.all()


def run_removal(arrays, cand, slots, blocked):
    jt, tt = both_tensors(arrays)
    ref = jsd.removal_feasibility(jt, jnp.asarray(cand), jnp.asarray(slots),
                                  jnp.asarray(blocked))
    out = tsd.removal_feasibility(tt, torch.tensor(cand), torch.tensor(slots),
                                  torch.tensor(blocked))
    return ref, out


def assert_feasibility_equal(ref, out):
    for name, a, b in zip(ref._fields, ref, out):
        try:
            assert_bits_equal(a, b)
        except AssertionError as e:
            raise AssertionError(f"field {name}: {e}") from None
    assert out.feasible.dtype == torch.bool
    assert out.destinations.dtype == out.moved_counts.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("factored", [False, True], ids=["dense", "factored"])
def test_removal_feasibility(seed, factored):
    arrays = removal_arrays(seed, factored=factored)
    cand, slots, blocked, _ = lanes_of(arrays, seed=seed)
    ref, out = run_removal(arrays, cand, slots, blocked)
    assert_feasibility_equal(ref, out)
    d = np.asarray(ref.destinations)
    # the cases the world is built to hold
    assert not bool(out.feasible[2])                        # blocked
    assert (slots[3] < 0).all() and bool(out.feasible[3])   # no movable pods
    assert any((row[row >= 0] == 0).sum() >= 2 for row in d), "no repeated placement"
    assert (slots[:, 0] < 0).any() and (slots >= 0).any(axis=1).sum() > 1


def test_removal_feasibility_lane_chunks(monkeypatch):
    """Lanes cut into chunks of 3 (C = 10: a ragged last chunk) give what
    one chunk gives, and what the JAX package gives."""
    arrays = removal_arrays(5, factored=True)
    cand, slots, blocked, _ = lanes_of(arrays, seed=5)
    whole = run_removal(arrays, cand, slots, blocked)[1]
    _, tt = both_tensors(arrays)
    monkeypatch.setattr(tsd, "LANE_BYTES", 3 * tsd.lane_bytes(tt))
    assert tsd.lane_chunk(tt) == 3
    ref, out = run_removal(arrays, cand, slots, blocked)
    assert_feasibility_equal(ref, out)
    assert_feasibility_equal(whole, out)


def test_filled_slots_stops_at_the_last_pod_column():
    slots = torch.full((3, 8), -1, dtype=torch.int32)
    assert tsd.filled_slots(slots) == 0
    slots[1, :2] = 4
    slots[2, 4] = 7
    assert tsd.filled_slots(slots) == 5
    assert tsd.filled_slots(slots[:0]) == 0


def test_repeated_placements_subtract_in_slot_order():
    """Three pods placed on one node of one lane: the carry must hold
    (free - r1) - r2 before the third pod's fit test, which here differs
    from free - (r1 + r2) in f32 and decides whether the third pod fits."""
    r = np.float32(0.1)
    free = np.float32(0.3)
    assert (free - r) - r != free - (r + r)
    third = np.float32((free - r) - r)
    arrays = {
        "node_alloc": np.array([[4000, 0, 0, 0, 0, 110], [4000, third, 0, 0, 0, 110],
                                [4000, free, 0, 0, 0, 110]], np.float32),
        "node_used": np.zeros((3, 6), np.float32),
        "node_valid": np.ones(3, bool), "node_group": np.zeros(3, np.int32),
        "pod_req": np.array([[10, r, 0, 0, 0, 1]] * 2 + [[10, third, 0, 0, 0, 1]], np.float32),
        "pod_valid": np.ones(3, bool), "pod_node": np.array([1, 1, 1], np.int32),
        "sched_mask": np.array([[False, False, True]] * 3),
    }
    cand = np.array([1], np.int32)
    slots = np.array([[0, 1, 2]], np.int32)
    ref, out = run_removal(arrays, cand, slots, np.zeros(1, bool))
    assert_feasibility_equal(ref, out)
    assert out.destinations.tolist() == [[2, 2, 2]] and bool(out.feasible[0])


def run_joint(arrays, cand, slots, excluded):
    jt, tt = both_tensors(arrays)
    ref = jsd.joint_removal_feasibility(jt, jnp.asarray(cand), jnp.asarray(slots),
                                        jnp.asarray(excluded))
    out = tsd.joint_removal_feasibility(tt, torch.tensor(cand), torch.tensor(slots),
                                        torch.tensor(excluded))
    return ref, out


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("factored", [False, True], ids=["dense", "factored"])
def test_joint_removal_feasibility(seed, factored):
    """Tight capacity (the spare node shrunk) so some candidates fail and
    roll back while later ones still commit."""
    arrays = removal_arrays(seed, factored=factored)
    arrays["node_alloc"][0, CPU] = 2500
    cand, slots, _, excluded = lanes_of(arrays, seed=seed)
    # the node with no pod last: it drains whatever came before it
    order = [k for k in range(len(cand)) if k != 3] + [3]
    cand, slots = cand[order], slots[order]
    ref, out = run_joint(arrays, cand, slots, excluded)
    assert_feasibility_equal(ref, out)
    f = out.feasible.tolist()
    assert any(not a and b for a, b in zip(f, f[1:])), f"no rollback then commit: {f}"
    assert (out.destinations[~out.feasible] == -1).all()
    assert (out.moved_counts[~out.feasible] == 0).all()


def torch_spread_world(n_zones=2, per_zone=8, cands_per_zone=4):
    """The twin of sharded_worlds.scaledown_spread_world built with the
    port's objects and helpers: the argument set of
    removal_feasibility_spread."""
    ZONE = "topology.kubernetes.io/zone"
    constraint = tobj.TopologySpreadConstraint(
        max_skew=1, topology_key=ZONE, selector=tobj.LabelSelector.from_dict({"app": "web"}),
        when_unsatisfiable="DoNotSchedule",
    )
    nodes, pods, pods_on = [], [], {}
    for z in range(n_zones):
        for i in range(per_zone):
            name = f"n-{z}-{i}"
            n = ttu.build_test_node(name, cpu_m=4000)
            n.labels[ZONE] = f"zone-{z}"
            p = ttu.build_test_pod(f"w-{z}-{i}", cpu_m=300, labels={"app": "web"},
                                   node_name=name)
            p.topology_spread = (constraint,)
            nodes.append(n)
            pods.append(p)
            pods_on[name] = [p]
    tensors, meta = tpack.pack(nodes, pods, device="cpu")
    cand_names = [f"n-{z}-{i}" for z in range(n_zones) for i in range(cands_per_zone)]
    movers = [pods_on[c] for c in cand_names]
    spread8, static_counts, sp_match_np = trem._spread_refit_context(
        meta, tensors, [m for ms in movers for m in ms])
    C = len(cand_names)
    cand = np.asarray([meta.node_index[c] for c in cand_names], np.int32)
    pod_slots = np.full((C, 2), -1, np.int32)
    for ci, ms in enumerate(movers):
        for si, p in enumerate(ms):
            pod_slots[ci, si] = meta.pod_index[p.key()]
    blocked = np.zeros(C, bool)
    excluded = np.zeros(int(tensors.node_valid.shape[0]), bool)
    excluded[cand] = True
    cand_sub = trem._cand_sub_matrix(sp_match_np, meta, movers)
    return (tensors, cand, pod_slots, blocked, excluded, spread8, static_counts, cand_sub)


@pytest.mark.parametrize("shape", [(2, 8, 4), (3, 5, 3)], ids=["2x8", "3x5"])
def test_spread_removal_passes(shape):
    """Both spread variants on the twin worlds: the packed operands agree,
    then the per-candidate and the joint pass (shared counts, rollbacks)."""
    jw = jworlds.scaledown_spread_world(*shape)
    tw = torch_spread_world(*shape)
    for k in range(1, 5):
        assert_bits_equal(jw[k], tw[k])
    for a, b in zip(jw[5] + (jw[6], jw[7]), tw[5] + (tw[6], tw[7])):
        assert_bits_equal(a, b)
    jt, cand, slots, blocked, excluded, sp8, counts, sub = jw
    ref = jsd.removal_feasibility_spread(jt, jnp.asarray(cand), jnp.asarray(slots),
                                         jnp.asarray(blocked), sp8, counts, jnp.asarray(sub))
    tt = tw[0]
    out = tsd.removal_feasibility_spread(tt, torch.tensor(cand), torch.tensor(slots),
                                         torch.tensor(blocked), tw[5], tw[6], torch.tensor(sub))
    assert_feasibility_equal(ref, out)
    ref = jsd.joint_removal_feasibility_spread(jt, jnp.asarray(cand), jnp.asarray(slots),
                                               jnp.asarray(excluded), sp8, counts,
                                               jnp.asarray(sub))
    out = tsd.joint_removal_feasibility_spread(tt, torch.tensor(cand), torch.tensor(slots),
                                               torch.tensor(excluded), tw[5], tw[6],
                                               torch.tensor(sub))
    assert_feasibility_equal(ref, out)
    assert bool(out.feasible.any())


@pytest.mark.parametrize("seed", [0, 1])
def test_spread_removal_random_context(seed, monkeypatch):
    """The spread passes on a random dense world with a random spread
    context of 3 terms over 4 domains (counts per lane, commits, the gate's
    minimum and minDomains), the per-candidate pass in chunks of 4 lanes."""
    arrays = removal_arrays(seed, N=20, P=60)
    cand, slots, blocked, excluded = lanes_of(arrays, seed=seed)
    ctx, sub = removal_spread_context(arrays, len(cand), seed)
    S = ctx[0].shape[1]
    jt, tt = both_tensors(arrays)
    j9 = tuple(jnp.asarray(a) for a in ctx)
    t9 = spread_context_from_numpy(ctx, device="cpu")
    j8, t8 = j9[:5] + j9[6:], t9[:5] + t9[6:]
    ref = jsd.removal_feasibility_spread(jt, jnp.asarray(cand), jnp.asarray(slots),
                                         jnp.asarray(blocked), j8, j9[5], jnp.asarray(sub))
    monkeypatch.setattr(tsd, "LANE_BYTES", 4 * tsd.lane_bytes(tt, S))
    assert tsd.lane_chunk(tt, S) == 4
    out = tsd.removal_feasibility_spread(tt, torch.tensor(cand), torch.tensor(slots),
                                         torch.tensor(blocked), t8, t9[5], torch.tensor(sub))
    assert_feasibility_equal(ref, out)
    ref = jsd.joint_removal_feasibility_spread(jt, jnp.asarray(cand), jnp.asarray(slots),
                                               jnp.asarray(excluded), j8, j9[5],
                                               jnp.asarray(sub))
    out = tsd.joint_removal_feasibility_spread(tt, torch.tensor(cand), torch.tensor(slots),
                                               torch.tensor(excluded), t8, t9[5],
                                               torch.tensor(sub))
    assert_feasibility_equal(ref, out)


# -- the object level: each case on both packages ------------------------------

def both(case):
    """Run ``case(pkg)`` on both packages; their results (canonicalised)
    must be equal. → the port's result."""
    ref, out = case(JAX), case(TORCH)
    assert canon(ref) == canon(out), (canon(ref), canon(out))
    return out


def snapshot_with(pkg, nodes, pods_with_nodes):
    s = pkg.cs.ClusterSnapshot(**pkg.kw)
    for n in nodes:
        s.add_node(n)
    for pod, node_name in pods_with_nodes:
        s.add_pod(pod, node_name)
    return s


def removal_summary(r):
    return (r.node.name, [p.key() for p in r.pods_to_reschedule],
            sorted(r.destinations.items()), [p.key() for p in r.daemonset_pods])


def unremovable_summary(u):
    block = None if u.blocking_pod is None else (u.blocking_pod.pod.key(),
                                                 u.blocking_pod.reason.value)
    return (u.node.name, u.reason.value, block)


def plan_summary(plan):
    return ([removal_summary(r) for r in plan.empty], [removal_summary(r) for r in plan.drain],
            [unremovable_summary(u) for u in plan.unremovable])


# drain-rule cases of tests/test_scaledown.py::TestDrainRules and the
# MinReplicas knob: (pods builder, rules, PDBs builder) → (moved, reason)
def _drain_case(name, pkg):
    tu, obj, drain = pkg.tu, pkg.obj, pkg.drain
    rules, pdbs, owners = drain.DrainabilityRules(), [], None
    if name == "replicated_moves":
        pods = [tu.build_test_pod("p")]
    elif name == "unreplicated_blocks":
        pods = [tu.build_test_pod("naked", owner_kind="")]
    elif name == "safe_to_evict_overrides":
        pods = [tu.build_test_pod("naked", owner_kind="")]
        pods[0].annotations[obj.SAFE_TO_EVICT_ANNOTATION] = "true"
    elif name == "not_safe_to_evict_blocks":
        pods = [tu.build_test_pod("p")]
        pods[0].annotations[obj.SAFE_TO_EVICT_ANNOTATION] = "false"
    elif name == "local_storage_blocks":
        pods = [tu.build_test_pod("p")]
        pods[0].local_storage = True
    elif name == "not_restartable_blocks":
        pods = [tu.build_test_pod("p")]
        pods[0].restartable = False
    elif name == "kube_system_without_pdb_blocks":
        pods = [tu.build_test_pod("sys", namespace="kube-system")]
    elif name == "kube_system_with_pdb_moves":
        pods = [tu.build_test_pod("sys", namespace="kube-system", labels={"k": "v"})]
        pdbs = [obj.PodDisruptionBudget("pdb", "kube-system",
                                        obj.LabelSelector.from_dict({"k": "v"}), 1)]
    elif name == "pdb_exhausted_blocks":
        pods = [tu.build_test_pod(f"p{i}", labels={"app": "x"}) for i in range(3)]
        pdbs = [obj.PodDisruptionBudget("pdb", "default",
                                        obj.LabelSelector.from_dict({"app": "x"}), 2)]
    elif name == "mirror_and_daemonset_ignored":
        mirror = tu.build_test_pod("m", owner_kind="")
        mirror.mirror = True
        ds = tu.build_test_pod("d")
        ds.daemonset = True
        pods = [mirror, ds]
    elif name.startswith("min_replicas"):
        pods = []
        for i in range(2):
            p = tu.build_test_pod(f"small-{i}", cpu_m=100, mem=256 * MB, node_name="n0")
            p.owner_ref = obj.OwnerRef(kind="ReplicaSet", name="small-rs")
            pods.append(p)
        owners = drain.count_owner_replicas(pods)
        rules = drain.DrainabilityRules(min_replica_count=3 if name.endswith("3") else 2)
        pods = pods[:1]
    moved, block = drain.get_pods_to_move(pods, rules, pdbs, owners)
    return [p.key() for p in moved], None if block is None else block.reason.value


DRAIN_CASES = {
    "replicated_moves": (1, None),
    "unreplicated_blocks": (0, "NotReplicated"),
    "safe_to_evict_overrides": (1, None),
    "not_safe_to_evict_blocks": (0, "NotSafeToEvictAnnotation"),
    "local_storage_blocks": (0, "LocalStorageRequested"),
    "not_restartable_blocks": (0, "ControllerNotFound"),
    "kube_system_without_pdb_blocks": (0, "UnmovableKubeSystemPod"),
    "kube_system_with_pdb_moves": (1, None),
    "pdb_exhausted_blocks": (0, "NotEnoughPdb"),
    "mirror_and_daemonset_ignored": (0, None),
    "min_replicas_3": (0, "MinReplicasReached"),
    "min_replicas_2": (1, None),
}


@pytest.mark.parametrize("name", sorted(DRAIN_CASES))
def test_drain_rules(name):
    moved, reason = both(lambda pkg: _drain_case(name, pkg))
    assert (len(moved), reason) == DRAIN_CASES[name]


def _spread_pod(pkg, name, skew=1, terminating=False):
    p = pkg.tu.build_test_pod(name, cpu_m=100, labels={"app": "web"})
    p.topology_spread = (pkg.obj.TopologySpreadConstraint(
        max_skew=skew, topology_key="topology.kubernetes.io/zone",
        selector=pkg.obj.LabelSelector.from_dict({"app": "web"})),)
    if terminating:
        p.deletion_ts = 42.0
    return p


def _zoned(pkg, name, cpu_m, zone):
    n = pkg.tu.build_test_node(name, cpu_m=cpu_m)
    n.labels["topology.kubernetes.io/zone"] = zone
    return n


def _removal_case(name, pkg):
    """The cases of tests/test_scaledown.py::TestRemovalSimulator and
    ::TestJointSetValidation → what the simulator answered."""
    tu = pkg.tu
    node, pod = tu.build_test_node, tu.build_test_pod
    sim = pkg.rem.RemovalSimulator()
    out = {}
    if name == "find_empty_nodes":
        ds = pod("ds")
        ds.daemonset = True
        s = snapshot_with(pkg, [node("empty"), node("ds-only"), node("busy")],
                          [(ds, "ds-only"), (pod("p"), "busy")])
        return {"empty": sim.find_empty_nodes(s, ["empty", "ds-only", "busy", "gone"])}
    if name == "feasible":
        s = snapshot_with(pkg, [node("n0", cpu_m=1000), node("n1", cpu_m=2000)],
                          [(pod("p", cpu_m=500), "n0")])
        cands = ["n0"]
    elif name.startswith("spread_skew"):
        skew = int(name[-1])
        s = snapshot_with(pkg, [_zoned(pkg, "n-a", 1000, "zone-a"),
                                _zoned(pkg, "n-a2", 2000, "zone-a"),
                                _zoned(pkg, "n-b", 2000, "zone-b")],
                          [(_spread_pod(pkg, "m0", skew), "n-a"),
                           (_spread_pod(pkg, "m1", skew), "n-a")])
        cands = ["n-a"]
    elif name == "terminating_movers":
        m_term, m_live = _spread_pod(pkg, "m-term", terminating=True), _spread_pod(pkg, "m-live")
        s = snapshot_with(pkg, [_zoned(pkg, "n-a", 1000, "zone-a"),
                                _zoned(pkg, "n-b", 2000, "zone-b")],
                          [(m_term, "n-a"), (m_live, "n-a")])
        tensors, meta = s.tensors()
        spread8, counts, sp_match = pkg.rem._spread_refit_context(meta, tensors, [m_term, m_live])
        counts = np.asarray(counts.cpu() if isinstance(counts, torch.Tensor) else counts)
        sub = pkg.rem._cand_sub_matrix(sp_match, meta, [[m_term, m_live]])
        return {"counts": counts.tolist(), "sub": sub.tolist(), "sp_match": sp_match.tolist()}
    elif name == "infeasible":
        s = snapshot_with(pkg, [node("n0", cpu_m=1000), node("n1", cpu_m=600)],
                          [(pod("p", cpu_m=800), "n0"), (pod("q", cpu_m=500), "n1")])
        cands = ["n0"]
    elif name == "blocking_pod":
        s = snapshot_with(pkg, [node("n0"), node("n1")], [(pod("naked", owner_kind=""), "n0")])
        cands = ["n0"]
    elif name == "capacity_across_moves":
        s = snapshot_with(pkg, [node("n0", cpu_m=2000), node("n1", cpu_m=1000)],
                          [(pod("a", cpu_m=600), "n0"), (pod("b", cpu_m=600), "n0")])
        cands = ["n0"]
    elif name == "too_many_pods":
        s = snapshot_with(pkg, [node("n0", cpu_m=4000), node("n1", cpu_m=4000)],
                          [(pod(f"p{i}", cpu_m=100), "n0") for i in range(3)])
        to_remove, unremovable = sim.find_nodes_to_remove(s, ["n0"], max_pods_per_node=2)
        return {"remove": [removal_summary(r) for r in to_remove],
                "unremovable": [unremovable_summary(u) for u in unremovable]}
    elif name.startswith("joint"):
        if name in ("joint_double_booked", "joint_stale"):
            s = snapshot_with(pkg, [node("d0", cpu_m=1000), node("d1", cpu_m=1000),
                                    node("spare", cpu_m=1000)],
                              [(pod("p0", cpu_m=600), "d0"), (pod("p1", cpu_m=600), "d1"),
                               (pod("filler", cpu_m=200), "spare")])
            cands, also = ["d0", "d1"], []
        elif name == "joint_destination_leaving":
            s = snapshot_with(pkg, [node("d0", cpu_m=1000), node("empty", cpu_m=1000),
                                    node("full", cpu_m=1000)],
                              [(pod("p0", cpu_m=600), "d0"), (pod("big", cpu_m=900), "full")])
            cands, also = ["d0"], ["empty"]
        else:  # joint_destinations_updated
            s = snapshot_with(pkg, [node(n, cpu_m=1000) for n in ("d0", "d1", "s0", "s1")],
                              [(pod("p0", cpu_m=700), "d0"), (pod("p1", cpu_m=700), "d1")])
            cands, also = ["d0", "d1"], []
        to_remove, _ = sim.find_nodes_to_remove(s, cands)
        out["independent"] = [removal_summary(r) for r in to_remove]
        if name == "joint_stale":
            s.remove_pod("default/p1")
        valid, rejected = sim.validate_removal_set(s, to_remove, also_removed=also)
        out["valid"] = [removal_summary(r) for r in valid]
        out["rejected"] = [unremovable_summary(u) for u in rejected]
        return out
    to_remove, unremovable = sim.find_nodes_to_remove(s, cands)
    return {"remove": [removal_summary(r) for r in to_remove],
            "unremovable": [unremovable_summary(u) for u in unremovable]}


def _check_removal(name, out):
    """The assertions of the reference tests, on the port's answer."""
    remove = out.get("remove")
    if name == "find_empty_nodes":
        assert out["empty"] == ["empty", "ds-only"]
    elif name == "feasible":
        assert remove == [("n0", ["default/p"], [("default/p", "n1")], [])]
    elif name == "spread_skew1":
        assert remove == [] and out["unremovable"][0][:2] == ("n-a", "NoPlaceToMovePods")
    elif name == "spread_skew2":
        assert len(remove) == 1 and {d for _, d in remove[0][2]} <= {"n-a2", "n-b"}
    elif name == "terminating_movers":
        assert np.asarray(out["counts"]).sum() == 1 and np.asarray(out["sub"]).sum() == 1
    elif name in ("infeasible", "capacity_across_moves"):
        assert remove == [] and out["unremovable"][0][1] == "NoPlaceToMovePods"
    elif name in ("blocking_pod", "too_many_pods"):
        assert remove == [] and out["unremovable"][0][1] == "BlockedByPod"
    elif name == "joint_double_booked":
        assert [r[0] for r in out["independent"]] == ["d0", "d1"]
        assert [r[0] for r in out["valid"]] == ["d0"]
        assert out["rejected"] == [("d1", "NoPlaceToMovePods", None)]
    elif name == "joint_destination_leaving":
        assert out["valid"] == [] and [u[0] for u in out["rejected"]] == ["d0"]
    elif name == "joint_destinations_updated":
        assert out["rejected"] == []
        assert {out["valid"][0][2][0][1], out["valid"][1][2][0][1]} == {"s0", "s1"}
    elif name == "joint_stale":
        assert [r[0] for r in out["valid"]] == ["d0"] and out["rejected"][0][0] == "d1"


REMOVAL_CASES = [
    "find_empty_nodes", "feasible", "spread_skew1", "spread_skew2", "terminating_movers",
    "infeasible", "blocking_pod", "capacity_across_moves", "too_many_pods",
    "joint_double_booked", "joint_destination_leaving", "joint_destinations_updated",
    "joint_stale",
]


@pytest.mark.parametrize("name", REMOVAL_CASES)
def test_removal_simulator(name):
    _check_removal(name, both(lambda pkg: _removal_case(name, pkg)))


def _eligibility_case(name, pkg):
    """tests/test_scaledown.py::TestEligibility and the rules it leaves out:
    ignored DaemonSet usage, the GPU threshold, unready nodes."""
    tu = pkg.tu
    nodes = [tu.build_test_node("low", cpu_m=1000), tu.build_test_node("high", cpu_m=1000)]
    pods = [(tu.build_test_pod("l", cpu_m=200), "low"), (tu.build_test_pod("h", cpu_m=900), "high")]
    opts = pkg.opts.AutoscalingOptions()
    cache, now = None, 0.0
    if name == "disabled_annotation":
        nodes[0].annotations[pkg.obj.SCALE_DOWN_DISABLED_ANNOTATION] = "true"
    elif name == "unremovable_cache":
        cache = pkg.track.UnremovableNodesCache(ttl_s=100)
        cache.add("low", now_ts=0.0)
        now = 10.0
    elif name == "ignore_daemonsets":
        ds = tu.build_test_pod("ds", cpu_m=500)
        ds.daemonset = True
        pods.append((ds, "low"))
        opts.ignore_daemonsets_utilization = True
    elif name == "gpu_threshold":
        g = tu.build_test_node("gpu", cpu_m=1000, gpu=4)
        nodes.append(g)
        gp = tu.build_test_pod("gp", cpu_m=900)
        gp.requests = gp.requests.__class__(cpu_m=900, gpu=1)
        pods.append((gp, "gpu"))
        opts.node_group_defaults.scale_down_gpu_utilization_threshold = 0.2
    elif name.startswith("unready"):
        nodes[1].ready = False
        opts.scale_down_unready_enabled = name.endswith("enabled")
    s = snapshot_with(pkg, nodes, pods)
    checker = pkg.elig.EligibilityChecker(opts)
    eligible, util, unremovable = checker.filter_out_unremovable(s, nodes, now, cache)
    return eligible, {k: v.hex() for k, v in util.items()}, [unremovable_summary(u)
                                                            for u in unremovable]


ELIGIBILITY_CASES = {
    "utilization_threshold": ["low"],
    "disabled_annotation": [],
    "unremovable_cache": [],
    "ignore_daemonsets": ["low"],
    "gpu_threshold": ["low"],
    "unready_enabled": ["low", "high"],
    "unready_disabled": ["low"],
}


@pytest.mark.parametrize("name", sorted(ELIGIBILITY_CASES))
def test_eligibility(name):
    eligible, util, unremovable = both(lambda pkg: _eligibility_case(name, pkg))
    assert eligible == ELIGIBILITY_CASES[name]
    reasons = {u[1] for u in unremovable}
    if name == "utilization_threshold":
        assert float.fromhex(util["high"]) == pytest.approx(0.9)
        assert reasons == {"NotUnderutilized"}
    elif name == "disabled_annotation":
        assert "ScaleDownDisabledAnnotation" in reasons
    elif name == "unremovable_cache":
        assert "RecentlyUnremovable" in reasons
    elif name == "ignore_daemonsets":
        assert float.fromhex(util["low"]) == pytest.approx(0.2)
    elif name == "gpu_threshold":
        assert float.fromhex(util["gpu"]) == pytest.approx(0.25)
        assert ("gpu", "NotUnderutilized", None) in unremovable
    elif name == "unready_disabled":
        assert ("high", "UnreadyNotAllowed", None) in unremovable


def _tracker_case(name, pkg):
    """tests/test_scaledown.py::TestUnneededTracking, ::TestPdbTracker, the
    usage tracker's expiry and ScaleDownLimits' all-or-nothing decrement."""
    tu = pkg.tu
    if name in ("unneeded_time_gate", "min_size_gate"):
        p = pkg.prov.TestCloudProvider()
        p.add_node_group("g", 0 if name == "unneeded_time_gate" else 2, 10, 2,
                         tu.build_test_node("t"))
        node = tu.build_test_node("n0")
        p.add_node("g", node)
        opts = pkg.opts.AutoscalingOptions()
        opts.node_group_defaults.scale_down_unneeded_time_s = (
            600 if name == "unneeded_time_gate" else 0)
        tracker = pkg.track.UnneededNodes()
        tracker.update([node], now_ts=0.0)
        return [tracker.removable_at(node, t, opts, p) for t in (10.0, 100.0, 700.0)]
    if name == "interrupted_unneeded_resets":
        node = tu.build_test_node("n0")
        opts = pkg.opts.AutoscalingOptions()
        opts.node_group_defaults.scale_down_unneeded_time_s = 100
        tracker = pkg.track.UnneededNodes()
        tracker.update([node], now_ts=0.0)
        tracker.update([], now_ts=50.0)
        tracker.update([node], now_ts=60.0)
        return [tracker.removable_at(node, t, opts) for t in (120.0, 170.0)]
    if name == "pdb_budget":
        pdb = pkg.obj.PodDisruptionBudget(
            "pdb", "default", pkg.obj.LabelSelector.from_dict({"a": "b"}), 1)
        t = pkg.track.RemainingPdbTracker([pdb])
        p1 = tu.build_test_pod("p1", labels={"a": "b"})
        p2 = tu.build_test_pod("p2", labels={"a": "b"})
        first = t.can_remove_pods([p1])
        t.remove_pods([p1])
        return [first, t.can_remove_pods([p2])]
    if name == "usage_tracker_cleanup":
        t = pkg.tracker.UsageTracker()
        t.register_usage("a", "b", now_ts=0.0)
        t.register_usage("a", "c", now_ts=100.0)
        t.cleanup(cutoff_ts=50.0)
        return [list(t.get("a").using), dict(t.get("b").used_by), dict(t.get("c").used_by)]
    # limits_try_decrement
    limits = pkg.limits.ScaleDownLimits({"cpu": 1500.0, "memory": 4096.0})
    failed = limits.try_decrement(pkg.rm.ResourceDelta({"cpu": 1000.0, "memory": 8192.0}))
    left = dict(limits.left)
    ok = limits.try_decrement(pkg.rm.ResourceDelta({"cpu": 1000.0, "memory": 2048.0}))
    return [failed, left, ok, dict(limits.left)]


TRACKER_CASES = {
    "unneeded_time_gate": [False, False, True],
    "min_size_gate": [False, False, False],
    "interrupted_unneeded_resets": [False, True],
    "pdb_budget": [True, False],
    "usage_tracker_cleanup": [["c"], {}, {"a": 100.0}],
    "limits_try_decrement": [["memory"], {"cpu": 1500.0, "memory": 4096.0}, [],
                             {"cpu": 500.0, "memory": 2048.0}],
}


@pytest.mark.parametrize("name", sorted(TRACKER_CASES))
def test_trackers(name):
    assert both(lambda pkg: _tracker_case(name, pkg)) == TRACKER_CASES[name]


def three_node_world(pkg):
    """tests/test_scaledown.py::TestPlannerAndActuator._world: n0 empty, n1
    lightly used (its pod fits n2), n2 moderately used."""
    tu = pkg.tu
    provider = pkg.prov.TestCloudProvider()
    provider.add_node_group("g", 0, 10, 3, tu.build_test_node("tmpl", cpu_m=1000, mem=2 * GB))
    api = pkg.api.FakeClusterAPI()
    nodes = []
    for i in range(3):
        n = tu.build_test_node(f"n{i}", cpu_m=1000, mem=2 * GB)
        provider.add_node("g", n)
        api.add_node(n)
        nodes.append(n)
    p1 = tu.build_test_pod("p1", cpu_m=200, mem=100 * MB, node_name="n1")
    p2 = tu.build_test_pod("p2", cpu_m=400, mem=100 * MB, node_name="n2")
    api.add_pod(p1)
    api.add_pod(p2)
    snapshot = snapshot_with(pkg, nodes, [(p1, "n1"), (p2, "n2")])
    opts = pkg.opts.AutoscalingOptions()
    opts.node_group_defaults.scale_down_unneeded_time_s = 100
    return provider, api, snapshot, nodes, opts


def actuation_summary(result, provider, api):
    return {
        "deleted_empty": sorted(result.deleted_empty),
        "deleted_drain": sorted(result.deleted_drain),
        "failed": dict(sorted(result.failed.items())),
        "evicted_pods": sorted(result.evicted_pods),
        "sizes": [(g.id(), g.target_size()) for g in provider.node_groups()],
        "delete_calls": sorted(provider.scale_down_calls),
        "api_nodes": sorted(api.nodes),
        "evicted": sorted(api.evicted),
        "taints": {n: sorted(t.key for t in node.taints) for n, node in sorted(api.nodes.items())},
        "unschedulable": sorted(n for n, node in api.nodes.items() if node.unschedulable),
    }


def _planner_case(name, pkg):
    """tests/test_scaledown.py::TestPlannerAndActuator and
    ::TestNodeDeleteDelayAfterTaint on the three-node world."""
    provider, api, snapshot, nodes, opts = three_node_world(pkg)
    planner = pkg.planner.ScaleDownPlanner(provider, opts)
    out = {}
    if name == "failed_eviction_rolls_back":
        api.fail_evictions_for = {"default/p1"}
        opts.max_pod_eviction_time_s = 0.0
    planner.update_cluster_state(snapshot, nodes, [], now_ts=0.0)
    out["unneeded_0"] = planner.unneeded_names()
    if name == "usage_tracker_resets_destinations":
        rec = planner.usage_tracker.get("n1")
        dest = next(iter(rec.using))
        out["dest"] = dest
        planner.update_cluster_state(snapshot, nodes, [], now_ts=150.0)
        out["since_before"] = planner.unneeded.since(dest)
        out["reset"] = planner.node_deleted("n1", now_ts=150.0)
        out["since_after"] = planner.unneeded.since(dest)
        out["n1_using"] = list(planner.usage_tracker.get("n1").using)
        return out
    if name in ("soft_taints", "soft_taints_time_budget"):
        actuator = pkg.act.ScaleDownActuator(provider, opts, api, planner.deletion_tracker)
        if name == "soft_taints":
            out["changed"] = actuator.update_soft_deletion_taints(nodes, planner.unneeded_names())
            out["tainted"] = sorted(t.key for t in api.nodes["n0"].taints)
            out["changed_back"] = actuator.update_soft_deletion_taints(api.list_nodes(), [])
            out["taints_after"] = sorted(t.key for t in api.nodes["n0"].taints)
            return out
        opts.max_bulk_soft_taint_count = 10
        opts.max_bulk_soft_taint_time_s = 2.0
        ticks = iter(range(100))
        real = pkg.trace.timeline_now
        pkg.trace.timeline_now = lambda: float(next(ticks)) * 1.5
        try:
            out["changed"] = actuator.update_soft_deletion_taints(
                nodes, planner.unneeded_names())
        finally:
            pkg.trace.timeline_now = real
        return out
    if name == "cleanup_leftover_taints":
        api.add_taint("n0", pkg.api.to_be_deleted_taint())
        actuator = pkg.act.ScaleDownActuator(provider, opts, api)
        out["removed"] = actuator.clean_up_to_be_deleted_taints(api.list_nodes())
        out["taints"] = [t.key for t in api.nodes["n0"].taints]
        return out
    plan0 = planner.nodes_to_delete(snapshot, now_ts=0.0)
    out["plan_0"] = plan_summary(plan0)
    planner.update_cluster_state(snapshot, nodes, [], now_ts=150.0)
    plan = planner.nodes_to_delete(snapshot, now_ts=150.0)
    out["plan_150"] = plan_summary(plan)
    out["unneeded_150"] = planner.unneeded_names()
    if name == "categorize_and_plan":
        return out
    actuator = pkg.act.ScaleDownActuator(provider, opts, api, planner.deletion_tracker,
                                         sleep=lambda s: None)
    result = actuator.start_deletion(plan, now_ts=150.0)
    out["actuation"] = actuation_summary(result, provider, api)
    return out


PLANNER_CASES = [
    "categorize_and_plan", "actuator_end_to_end", "failed_eviction_rolls_back",
    "usage_tracker_resets_destinations", "soft_taints", "soft_taints_time_budget",
    "cleanup_leftover_taints",
]


@pytest.mark.parametrize("name", PLANNER_CASES)
def test_planner_and_actuator(name):
    out = both(lambda pkg: _planner_case(name, pkg))
    if "unneeded_0" in out:
        assert set(out["unneeded_0"]) == {"n0", "n1", "n2"}
    if "plan_0" in out:
        assert out["plan_0"][:2] == ([], [])            # not unneeded long enough
        assert "n0" in [r[0] for r in out["plan_150"][0]]
        assert len(out["plan_150"][1]) <= 1             # max_drain_parallelism
    act = out.get("actuation")
    if name == "actuator_end_to_end":
        assert "n0" in act["deleted_empty"] and "n0" not in act["api_nodes"]
        assert ("g", "n0") in act["delete_calls"]
        assert not act["deleted_drain"] or act["evicted"]
    elif name == "failed_eviction_rolls_back":
        if "n1" in [r[0] for r in out["plan_150"][1]]:
            assert "n1" in act["failed"]
            assert "ToBeDeletedByClusterAutoscaler" not in act["taints"]["n1"]
    elif name == "usage_tracker_resets_destinations":
        assert out["since_before"] == 0.0 and out["dest"] in out["reset"]
        assert out["since_after"] == 150.0 and out["n1_using"] == []
    elif name == "soft_taints":
        assert out["changed"] == 3 and out["tainted"] == ["DeletionCandidateOfClusterAutoscaler"]
        assert out["changed_back"] == 3 and out["taints_after"] == []
    elif name == "soft_taints_time_budget":
        assert out["changed"] == 1
    elif name == "cleanup_leftover_taints":
        assert out["removed"] == 1 and out["taints"] == []


def _delay_case(name, pkg):
    """tests/test_scaledown.py::TestNodeDeleteDelayAfterTaint: pacing,
    cordons and the rollbacks of a failed deletion."""
    provider, api, _snap, nodes, opts = three_node_world(pkg)
    sleeps, cordoned = [], []
    clock_now = [0.0]

    def clock():
        clock_now[0] += 100.0          # each read passes the retry deadline
        return clock_now[0]

    plan_cls, rm_cls = pkg.planner.ScaleDownPlan, pkg.rem.NodeToRemove
    empty_plan = plan_cls(empty=[rm_cls(node=nodes[0], pods_to_reschedule=[],
                                        daemonset_pods=[])])
    drain_plan = plan_cls(drain=[rm_cls(node=nodes[1], pods_to_reschedule=[api.pods["default/p1"]],
                                        daemonset_pods=[])])
    plan = empty_plan
    if name in ("delay_pauses", "zero_delay_never_sleeps"):
        opts.node_delete_delay_after_taint_s = 5.0 if name == "delay_pauses" else 0.0
    else:
        opts.cordon_node_before_terminating = True
    if name in ("failed_deletion_uncordons", "uncordon_despite_taint_failure"):
        api.fail_evictions_for.add("default/p1")
        plan = drain_plan
    if name == "uncordon_despite_taint_failure":
        def flaky_remove(node_name, key):
            raise RuntimeError("api blip")
        api.remove_taint = flaky_remove
    if name == "cordon_before_terminating":
        orig = api.cordon_node
        api.cordon_node = lambda n: (cordoned.append(n), orig(n))
    if name == "taint_rolled_back_when_cordon_fails":
        def broken_cordon(node_name):
            raise RuntimeError("cordon blip")
        api.cordon_node = broken_cordon
    actuator = pkg.act.ScaleDownActuator(provider, opts, api, clock=clock, sleep=sleeps.append)
    result = actuator.start_deletion(plan, now_ts=0.0)
    return {"sleeps": sleeps, "cordoned": cordoned,
            "actuation": actuation_summary(result, provider, api)}


DELAY_CASES = [
    "delay_pauses", "zero_delay_never_sleeps", "failed_deletion_uncordons",
    "cordon_before_terminating", "uncordon_despite_taint_failure",
    "taint_rolled_back_when_cordon_fails",
]


@pytest.mark.parametrize("name", DELAY_CASES)
def test_actuator_pacing_and_rollbacks(name):
    out = both(lambda pkg: _delay_case(name, pkg))
    act = out["actuation"]
    if name == "delay_pauses":
        assert 5.0 in out["sleeps"]
    elif name == "zero_delay_never_sleeps":
        assert out["sleeps"] == []
    elif name in ("failed_deletion_uncordons", "uncordon_despite_taint_failure"):
        assert "n1" in act["failed"] and "n1" not in act["unschedulable"]
        if name == "failed_deletion_uncordons":
            assert "ToBeDeletedByClusterAutoscaler" not in act["taints"]["n1"]
    elif name == "cordon_before_terminating":
        assert out["cordoned"] == ["n0"]
    elif name == "taint_rolled_back_when_cordon_fails":
        assert "n0" in act["failed"] and act["taints"]["n0"] == []


def _two_drains_world(pkg, **opt_kw):
    """tests/test_scaledown.py::TestJointSetValidation (the planner case) and
    ::TestDaemonSetEviction worlds."""
    tu = pkg.tu
    provider = pkg.prov.TestCloudProvider()
    provider.add_node_group("g", 0, 10, 3, tu.build_test_node("t", cpu_m=1000))
    opts = pkg.opts.AutoscalingOptions(**opt_kw)
    opts.node_group_defaults.scale_down_unneeded_time_s = 0.0
    opts.node_group_defaults.scale_down_utilization_threshold = 0.9
    return provider, opts


def _planner_world_case(name, pkg):
    tu = pkg.tu
    node, pod = tu.build_test_node, tu.build_test_pod
    if name == "planner_joint_validation":
        provider, opts = _two_drains_world(pkg, max_drain_parallelism=5,
                                           max_scale_down_parallelism=10)
        snap = snapshot_with(pkg, [node(n, cpu_m=1000) for n in ("d0", "d1", "spare")],
                             [(pod("p0", cpu_m=600), "d0"), (pod("p1", cpu_m=600), "d1"),
                              (pod("filler", cpu_m=200), "spare")])
        snap.get_node("spare").annotations[pkg.obj.SCALE_DOWN_DISABLED_ANNOTATION] = "true"
        for n in ("d0", "d1", "spare"):
            provider.add_node("g", snap.get_node(n))
        planner = pkg.planner.ScaleDownPlanner(provider, opts)
        planner.update_cluster_state(snap, list(snap.nodes()), [], now_ts=100.0)
        return {"plan": plan_summary(planner.nodes_to_delete(snap, now_ts=200.0))}
    # the DaemonSet eviction cases
    opt_kw = {"daemonset_eviction_for_empty_nodes": True} if name == "ds_empty_opt_in" else {}
    provider, opts = _two_drains_world(pkg, **opt_kw)
    d0, e0, spare = node("d0", cpu_m=1000), node("e0", cpu_m=1000), node("spare", cpu_m=1000)
    for n in (d0, e0, spare):
        provider.add_node("g", n)
    p0 = pod("p0", cpu_m=100, node_name="d0")
    ds_d = pod("ds-d", cpu_m=50, node_name="d0")
    ds_d.daemonset = True
    ds_e = pod("ds-e", cpu_m=50, node_name="e0")
    ds_e.daemonset = True
    snap = snapshot_with(pkg, [d0, e0, spare], [(p0, "d0"), (ds_d, "d0"), (ds_e, "e0")])
    api = pkg.api.FakeClusterAPI()
    for n in (d0, e0, spare):
        api.add_node(n)
    for p in (p0, ds_d, ds_e):
        api.add_pod(p)
    if name == "ds_failure_does_not_block":
        api.fail_evictions_for = {"default/ds-d"}
    planner = pkg.planner.ScaleDownPlanner(provider, opts)
    planner.update_cluster_state(snap, [snap.get_node("d0"), snap.get_node("e0")], [],
                                 now_ts=100.0)
    plan = planner.nodes_to_delete(snap, now_ts=200.0)
    result = pkg.act.ScaleDownActuator(provider, opts, api).start_deletion(plan, now_ts=300.0)
    return {"plan": plan_summary(plan), "actuation": actuation_summary(result, provider, api)}


PLANNER_WORLD_CASES = ["planner_joint_validation", "ds_drained_by_default",
                       "ds_empty_not_by_default", "ds_empty_opt_in", "ds_failure_does_not_block"]


@pytest.mark.parametrize("name", PLANNER_WORLD_CASES)
def test_planner_worlds(name):
    out = both(lambda pkg: _planner_world_case(name, pkg))
    empty, drain, unremovable = out["plan"]
    act = out.get("actuation")
    if name == "planner_joint_validation":
        assert [r[0] for r in drain] == ["d0"]
        assert ("d1", "NoPlaceToMovePods", None) in unremovable
        return
    assert [r[0] for r in drain] == ["d0"] and [r[0] for r in empty] == ["e0"]
    assert drain[0][3] == ["default/ds-d"]
    assert act["deleted_drain"] == ["d0"] and act["deleted_empty"] == ["e0"]
    assert ("default/ds-d" in act["evicted_pods"]) == (name != "ds_failure_does_not_block")
    assert ("default/ds-e" in act["evicted_pods"]) == (name == "ds_empty_opt_in")


def _limits_case(name, pkg):
    """tests/test_scaledown.py::TestScaleDownResourceLimits: 5 nodes, 3 of
    them empty, the tail loaded past the threshold."""
    tu = pkg.tu
    opt_kw = {"min_cores": {"min_cores_total": 3000.0},
              "min_memory": {"min_memory_total": 8192.0}, "no_floor": {}}[name]
    provider = pkg.prov.TestCloudProvider()
    provider.add_node_group("g", 0, 10, 5, tu.build_test_node("tmpl", cpu_m=1000, mem=2 * GB))
    nodes, pods = [], []
    for i in range(5):
        n = tu.build_test_node(f"n{i}", cpu_m=1000, mem=2 * GB)
        provider.add_node("g", n)
        nodes.append(n)
        if i >= 3:
            pods.append((tu.build_test_pod(f"w{i}", cpu_m=800, mem=1 * GB, node_name=n.name),
                         n.name))
    snapshot = snapshot_with(pkg, nodes, pods)
    opts = pkg.opts.AutoscalingOptions(**opt_kw)
    opts.node_group_defaults.scale_down_unneeded_time_s = 100
    planner = pkg.planner.ScaleDownPlanner(provider, opts)
    planner.update_cluster_state(snapshot, nodes, [], now_ts=0.0)
    planner.update_cluster_state(snapshot, nodes, [], now_ts=150.0)
    return plan_summary(planner.nodes_to_delete(snapshot, now_ts=150.0))


@pytest.mark.parametrize("name,n_empty,n_limited",
                         [("min_cores", 2, 1), ("min_memory", 1, 2), ("no_floor", 3, 0)])
def test_scale_down_resource_limits(name, n_empty, n_limited):
    empty, _drain, unremovable = both(lambda pkg: _limits_case(name, pkg))
    assert len(empty) == n_empty
    assert sum(u[1] == "MinimalResourceLimitExceeded" for u in unremovable) == n_limited


def _wave_case(name, pkg):
    """tests/test_scaledown.py::TestConcurrentActuation: a threaded drain
    wave, paced evictions and the timer-driven batcher."""
    import threading

    tu = pkg.tu
    if name == "drain_wave_bounded_concurrency":
        provider = pkg.prov.TestCloudProvider()
        provider.add_node_group("g", 0, 200, 50, tu.build_test_node("tmpl", cpu_m=4000, mem=8 * GB))
        api = pkg.api.FakeClusterAPI()
        drains = []
        for i in range(50):
            n = tu.build_test_node(f"d{i}", cpu_m=4000, mem=8 * GB)
            provider.add_node("g", n)
            api.add_node(n)
            p = tu.build_test_pod(f"p{i}-0", cpu_m=100, mem=100 * MB, node_name=n.name)
            api.add_pod(p)
            drains.append(pkg.rem.NodeToRemove(n, pods_to_reschedule=[p]))
        opts = pkg.opts.AutoscalingOptions(max_drain_parallelism=50, max_scale_down_parallelism=8)
        lock, live = threading.Lock(), {"now": 0, "max": 0}
        orig = api.evict_pod

        def slow_evict(p):
            with lock:
                live["now"] += 1
                live["max"] = max(live["max"], live["now"])
            time.sleep(0.01)
            try:
                orig(p)
            finally:
                with lock:
                    live["now"] -= 1

        api.evict_pod = slow_evict
        actuator = pkg.act.ScaleDownActuator(provider, opts, api)
        result = actuator.start_deletion(pkg.planner.ScaleDownPlan(drain=drains), now_ts=100.0)
        results = {r.node_name: r.ok for r in actuator.tracker.drain_results()}
        return {"actuation": actuation_summary(result, provider, api),
                "bounded": 2 <= live["max"] <= 8, "results": sorted(results.items())}
    if name in ("eviction_retry_pacing", "eviction_gives_up"):
        api = pkg.api.FakeClusterAPI()
        node = tu.build_test_node("n", cpu_m=1000)
        api.add_node(node)
        p = tu.build_test_pod("flaky", cpu_m=100, node_name="n")
        api.add_pod(p)
        api.eviction_failures = {p.key(): 2 if name == "eviction_retry_pacing" else 1000}
        opts = pkg.opts.AutoscalingOptions()
        opts.eviction_retry_time_s = 10.0
        opts.max_pod_eviction_time_s = 120.0 if name == "eviction_retry_pacing" else 25.0
        t, sleeps, attempts = {"now": 0.0}, [], []
        orig = api.evict_pod

        def counting_evict(q):
            attempts.append(t["now"])
            orig(q)

        def sleep(s):
            sleeps.append(s)
            t["now"] += s

        api.evict_pod = counting_evict
        ev = pkg.act.Evictor(api, opts, clock=lambda: t["now"], sleep=sleep)
        ok, evicted = ev.drain_node(node, [p], pkg.track.NodeDeletionTracker(), now_ts=0.0)
        return {"ok": ok, "evicted": evicted, "sleeps": sleeps, "attempts": attempts}
    provider = pkg.prov.TestCloudProvider()
    provider.add_node_group("g", 0, 10, 3, tu.build_test_node("tmpl", cpu_m=1000))
    nodes = []
    for i in range(3 if name == "timer_driven_batcher" else 1):
        n = tu.build_test_node(f"b{i}", cpu_m=1000)
        provider.add_node("g", n)
        nodes.append(n)
    group = {g.id(): g for g in provider.node_groups()}["g"]
    flushed = []
    batcher = pkg.act.NodeDeletionBatcher(
        provider, interval_s=0.15 if name == "timer_driven_batcher" else 30.0,
        on_result=lambda node, gid, err: flushed.append((node.name, err)))
    for n in nodes:
        batcher.add_node(group, n)
    before = list(provider.scale_down_calls)
    if name == "timer_driven_batcher":
        deadline = time.monotonic() + 3.0
        while len(flushed) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
    else:
        batcher.flush()
    return {"before": before, "flushed": sorted(flushed),
            "calls": sorted(provider.scale_down_calls)}


WAVE_CASES = ["drain_wave_bounded_concurrency", "eviction_retry_pacing", "eviction_gives_up",
              "timer_driven_batcher", "flush_cancels_pending_timer"]


@pytest.mark.parametrize("name", WAVE_CASES)
def test_actuator_concurrency(name):
    out = both(lambda pkg: _wave_case(name, pkg))
    if name == "drain_wave_bounded_concurrency":
        act = out["actuation"]
        assert act["deleted_drain"] == sorted(f"d{i}" for i in range(50)) and not act["failed"]
        assert out["bounded"] and len(out["results"]) == 50
        assert all(ok for _, ok in out["results"]) and len(act["evicted"]) == 50
    elif name == "eviction_retry_pacing":
        assert out["ok"] and out["evicted"] == ["default/flaky"] and out["sleeps"] == [10.0, 10.0]
    elif name == "eviction_gives_up":
        assert not out["ok"] and out["attempts"] == [0.0, 10.0, 20.0, 30.0]
    elif name == "timer_driven_batcher":
        assert out["before"] == [] and out["flushed"] == [(f"b{i}", None) for i in range(3)]
        assert [n for _, n in out["calls"]] == ["b0", "b1", "b2"]
    else:
        assert out["flushed"] == [("b0", None)]


def test_min_replica_count_flows_from_options():
    def case(pkg):
        planner = pkg.planner.ScaleDownPlanner(
            pkg.prov.TestCloudProvider(), pkg.opts.AutoscalingOptions(min_replica_count=5))
        rules = planner.simulator.rules
        return rules.min_replica_count, rules.skip_nodes_with_local_storage

    assert both(case) == (5, True)


def test_simulation_timeout_halves_candidates(monkeypatch):
    """The AIMD clamp on the timeline clock: a dispatch over the budget
    halves the next loop's candidates."""
    def case(pkg):
        tu = pkg.tu
        provider = pkg.prov.TestCloudProvider()
        provider.add_node_group("g", 0, 20, 8, tu.build_test_node("t", cpu_m=4000, mem=8 * GB))
        snap = pkg.cs.ClusterSnapshot(**pkg.kw)
        for i in range(8):
            n = tu.build_test_node(f"n{i}", cpu_m=4000, mem=8 * GB)
            provider.add_node("g", n)
            snap.add_node(n)
            p = tu.build_test_pod(f"p{i}", cpu_m=100, mem=256 * MB)
            p.owner_ref = pkg.obj.OwnerRef(kind="ReplicaSet", name="rs")
            snap.add_pod(p, n.name)
        opts = pkg.opts.AutoscalingOptions(scale_down_simulation_timeout_s=0.001)
        opts.node_group_defaults.scale_down_utilization_threshold = 0.9
        planner = pkg.planner.ScaleDownPlanner(provider, opts)
        seen, real = [], planner.simulator.find_nodes_to_remove

        def slow_sim(snapshot, candidates, *a, **k):
            seen.append(len(candidates))
            time.sleep(0.01)
            return real(snapshot, candidates, *a, **k)

        monkeypatch.setattr(planner.simulator, "find_nodes_to_remove", slow_sim)
        limits = []
        for now in (0.0, 30.0, 60.0):
            planner.update_cluster_state(snap, snap.nodes(), [], now_ts=now)
            limits.append(planner._adaptive_candidate_limit)
        return seen, limits

    seen, limits = both(case)
    assert seen == [8, 4, 2] and limits == [4, 2, 1]


# -- the two loops of a scale-down on the scale-in world ----------------------

SMALL_WORLD = dict(N=160, P=1200, port_nodes=50, apps=30)
SMALL_REMOVED, SMALL_SPREAD = 10, 8


def small_listing(spread_apps):
    nodes, pods = build_snapshot_world(**SMALL_WORLD)
    return scaledown_probe.scale_in_listing(nodes, pods, removed_apps=SMALL_REMOVED,
                                            spread_apps=spread_apps)


def jax_scale_down(nodes, pods, options_kw):
    """``scaledown_probe.run_scale_down``'s two loops with the JAX
    package's planner and actuator, on twins of the same objects: → the
    same ``out`` record."""
    jn, jp = twin(nodes, jobj), twin(pods, jobj)
    provider = jprov.TestCloudProvider()
    shapes = {}
    for node in jn:
        shapes.setdefault((node.allocatable.cpu_m, node.allocatable.memory), []).append(node)
    for (cpu_m, mem), members in sorted(shapes.items()):
        gid = f"shape-{int(cpu_m) // 1000}c-{int(mem / MB) // 1024}g"
        provider.add_node_group(gid, 0, len(members), len(members),
                                jtu.build_test_node(f"{gid}-template", cpu_m=cpu_m, mem=mem))
        for node in members:
            provider.add_node(gid, node)
    api = japi.FakeClusterAPI()
    for node in jn:
        api.add_node(node)
    for pod in jp:
        api.add_pod(pod)
    snapshot = jcs.ClusterSnapshot()
    for node in jn:
        snapshot.add_node(node)
    for pod in jp:
        snapshot.add_pod(pod)
    options = jopts.AutoscalingOptions(**options_kw)
    planner = jplanner.ScaleDownPlanner(provider, options)
    actuator = jact.ScaleDownActuator(provider, options, api, planner.deletion_tracker)
    sorting = jpipe.ScaleDownCandidatesSortingProcessor()
    seen = {}
    real_elig = planner.eligibility.filter_out_unremovable
    real_empty = planner.simulator.find_empty_nodes
    real_removal = planner.simulator.find_nodes_to_remove

    def elig(*a, **k):
        seen["elig"] = real_elig(*a, **k)
        return seen["elig"]

    def empty_nodes(*a, **k):
        seen["empty"] = real_empty(*a, **k)
        return seen["empty"]

    def removal(snap, cands, *a, **k):
        seen["simulated"] = list(cands)
        return real_removal(snap, cands, *a, **k)

    planner.eligibility.filter_out_unremovable = elig
    planner.simulator.find_empty_nodes = empty_nodes
    planner.simulator.find_nodes_to_remove = removal
    loops = []
    for k, now in enumerate(scaledown_probe.DOWN_TICKS):
        cands = sorting.sort(jpipe.ScaleDownNodeProcessor().get_scale_down_candidates(
            snapshot.nodes(), snapshot.nodes()))
        planner.update_cluster_state(snapshot, cands, api.list_pdbs(), now)
        sorting.update(planner.unneeded_names())
        plan = planner.nodes_to_delete(snapshot, now)
        eligible, utilization, _ = seen["elig"]
        empty = sorted(seen["empty"])
        loops.append({
            "eligible": list(eligible),
            "utilization": {n: float(u).hex() for n, u in utilization.items()},
            "empty": empty,
            "pool": len(planner._bound_candidates([n for n in eligible if n not in empty])),
            "simulated": seen["simulated"],
            "unneeded": planner.unneeded_names(),
            "plan": dict(zip(("empty", "drain", "unremovable"), plan_summary(plan))),
        })
        if k == len(scaledown_probe.DOWN_TICKS) - 1:
            result = actuator.start_deletion(plan, now)
    act = actuation_summary(result, provider, api)
    keep = ("deleted_empty", "deleted_drain", "failed", "evicted_pods", "sizes", "delete_calls")
    return {"loops": loops, "actuation": {k: act[k] for k in keep}}


@pytest.mark.parametrize("label", ["3m", "3n"])
def test_scale_down_loops_against_jax(label):
    """chip_smoke's 3m (the reference's defaults) and 3n (every eligible
    non-empty node simulated, spread, ten drains validated jointly) at a
    small size: the port's probe on the CPU against the JAX package's
    planner and actuator, field for field over both loops."""
    spread, kw = (0, {}) if label == "3m" else (SMALL_SPREAD, scaledown_probe.WIDE_REFIT)
    nodes, pods = small_listing(spread)
    rec = scaledown_probe.run_scale_down(nodes, pods, "cpu", kw)
    ref = jax_scale_down(nodes, pods, kw)
    assert scaledown_probe.scaledown_differences(ref, rec["out"]) == []
    loop1, loop2 = rec["out"]["loops"]
    assert loop1["plan"]["empty"] == loop1["plan"]["drain"] == []    # not unneeded long enough
    act = rec["out"]["actuation"]
    assert len(loop2["plan"]["empty"]) == 10 and act["deleted_empty"]
    if label == "3m":
        assert len(loop1["simulated"]) == 30 and loop2["plan"]["drain"] == []
    else:
        assert len(loop1["simulated"]) == loop1["pool"] > 30
        assert act["deleted_drain"] and act["evicted_pods"]
        assert rec["loops"][1]["dispatch_ops"][0] is tsd.removal_feasibility_spread
        assert rec["loops"][1]["joint_ops"][0] is tsd.joint_removal_feasibility_spread


def test_scale_in_listing_keeps_unchanged_objects():
    nodes, pods = build_snapshot_world(**SMALL_WORLD)
    n2, p2 = scaledown_probe.scale_in_listing(nodes, pods, removed_apps=SMALL_REMOVED,
                                              spread_apps=SMALL_SPREAD)
    ids = {id(p) for p in pods}
    gone = [p for p in pods if p.node_name and 0 <= scaledown_probe.app_index(p) < SMALL_REMOVED]
    spread = [p for p in p2 if p.topology_spread]
    assert gone and len(p2) == len(pods) - len(gone) and all(n is m for n, m in zip(nodes, n2))
    assert spread and all(id(p) not in ids for p in spread)
    assert all(id(p) in ids for p in p2 if not p.topology_spread)
    assert all(SMALL_REMOVED <= scaledown_probe.app_index(p) < SMALL_REMOVED + SMALL_SPREAD
               and p.node_name for p in spread)


def test_shape_provider_owns_every_node():
    nodes, _ = build_snapshot_world(**SMALL_WORLD)
    provider = scaledown_probe.shape_provider(nodes)
    groups = provider.node_groups()
    assert len(groups) == 12
    assert sum(g.target_size() for g in groups) == len(nodes)
    assert all(provider.node_group_for_node(n) is not None for n in nodes)
    assert all(g.min_size() == 0 for g in groups)


def test_probe_reports_and_cpu_checks():
    """The probe's report lines and its CPU checks (chip_smoke 4k) on a run
    on the CPU: the lane subset and the joint pass find no difference
    against themselves, and a changed operand shows as one."""
    nodes, pods = small_listing(SMALL_SPREAD)
    rec = scaledown_probe.run_scale_down(nodes, pods, "cpu", scaledown_probe.WIDE_REFIT)
    ops, joint = rec["loops"][-1]["dispatch_ops"], rec["loops"][-1]["joint_ops"]
    shape = scaledown_probe.dispatch_shape(ops)
    assert shape["lanes"] == len(rec["out"]["loops"][-1]["simulated"]) and shape["terms"] > 0
    assert 0 < shape["steps"] <= shape["slots"] == 128 and shape["chunks"] == 1
    lanes, fields, first = scaledown_probe.cpu_lanes_check(ops, lanes=16)
    assert (lanes, fields, first) == (16, 3, None)
    assert scaledown_probe.cpu_joint_check(joint)[2] is None
    fn, args = ops
    tampered = (fn, (args[0], args[1], args[2], ~args[3]) + args[4:])
    bad = scaledown_probe._first_difference(fn(*args), fn(*tampered[1]), None)
    assert bad is not None and bad[0] == "feasible"
    assert "scale-down 3n: loop 1:" in scaledown_probe.summary_line("3n", rec)
    line = scaledown_probe.split_line("3n", rec)
    assert "lane chunk" in line and "not measured" not in line
