"""The port's IncrementalPacker against the JAX package's, and the packer
hook of the port's ClusterSnapshot.

A twin world builds the same objects with both packages' modules and feeds
each package's packer the same listing after every mutation, through each
package's ClusterSnapshot(packer=...). After every update the two outputs
must be equal row for row and bit for bit (every SnapshotTensors field, its
dtype and shape, the meta and the packers' counters), and the port's
output must equal, by pod key and node name, a full ``pack`` of the same
objects. Tolerance 0: the packers only copy rows and count. No Pallas
kernel is involved, so nothing compiles in interpret mode.
"""
import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.snapshot.cluster_snapshot as jcs
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.cloudprovider.test_provider as tprov
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.snapshot.cluster_snapshot as tcs
import autoscaler_tpu_torch.utils.test_utils as ttu
from autoscaler_tpu.snapshot.arena import DeviceArena as JaxArena
from autoscaler_tpu.snapshot.incremental import IncrementalPacker as JaxPacker
from autoscaler_tpu_torch.snapshot import packer as tpacker
from autoscaler_tpu_torch.snapshot.arena import DeviceArena
from autoscaler_tpu_torch.snapshot.incremental import IncrementalPacker
from autoscaler_tpu_torch.tools import tick_probe
from torch_parity import assert_bits_equal, tick_world, to_np

GB, MB = ttu.GB, ttu.MB
JAX = SimpleNamespace(name="jax", tu=jtu, obj=jobj, cs=jcs)
TORCH = SimpleNamespace(name="torch", tu=ttu, obj=tobj, cs=tcs)
SIDES = (JAX, TORCH)


def assert_outputs_equal(jax_out, torch_out):
    """Every SnapshotTensors field equal bit for bit with the same dtype and
    shape, and the meta equal: row for row."""
    jt, jm = jax_out
    tt, tm = torch_out
    for f in dataclasses.fields(jt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        a = np.asarray(a)
        assert to_np(b).dtype == a.dtype, (f.name, b.dtype, a.dtype)
        try:
            assert_bits_equal(a, b)
        except AssertionError as e:
            raise AssertionError(f"field {f.name}: {e}") from None
    assert tm.pod_index == jm.pod_index
    assert tm.node_index == jm.node_index
    assert tm.group_names == jm.group_names and tm.group_index == jm.group_index
    assert tm.extended_resources == jm.extended_resources
    assert [n.name for n in tm.nodes] == [n.name for n in jm.nodes]
    assert [(p.key(), p.node_name) for p in tm.pods] == [(p.key(), p.node_name) for p in jm.pods]


class TwinWorld:
    """The world of tests/test_incremental_pack.py::World, twice: every
    mutation builds its objects with each package's modules, every check
    hands each package's packer the same listing through that package's
    ClusterSnapshot and compares the two outputs, and the port's output
    with a full pack of the same objects."""

    def __init__(self, dense=None, arena=False):
        self.dense = dense
        self.packers = {
            "jax": JaxPacker(dense_mask=dense, arena=JaxArena() if arena else None),
            "torch": IncrementalPacker(
                dense_mask=dense, device="cpu",
                arena=DeviceArena(device="cpu") if arena else None,
            ),
        }
        self.nodes = {s.name: {} for s in SIDES}
        self.pods = {s.name: {} for s in SIDES}   # key -> (pod, assign)
        self.groups = {}
        self.checks = 0
        self.on_check = None     # called with each check's port output

    def node(self, name, **kw):
        for s in SIDES:
            self.nodes[s.name][name] = s.tu.build_test_node(name, **kw)

    def node_with(self, name, build):
        for s in SIDES:
            self.nodes[s.name][name] = build(s)

    def pod(self, name, assign="", build=None, **kw):
        for s in SIDES:
            p = build(s) if build is not None else s.tu.build_test_pod(name, **kw)
            self.pods[s.name][p.key()] = (p, assign)

    def assign(self, key, node):
        for s in SIDES:
            self.pods[s.name][key] = (self.pods[s.name][key][0], node)

    def drop_pod(self, key):
        for s in SIDES:
            del self.pods[s.name][key]

    def drop_node(self, name):
        for s in SIDES:
            del self.nodes[s.name][name]

    def keys(self):
        return list(self.pods["torch"])

    def snapshot(self, side):
        snap = side.cs.ClusterSnapshot(packer=self.packers[side.name])
        for node in self.nodes[side.name].values():
            snap.add_node(node)
        for pod, assign in self.pods[side.name].values():
            if assign and assign in self.nodes[side.name]:
                snap.add_pod(pod, assign)
            else:
                snap.add_pod(pod)
        return snap

    def effective_pods(self):
        eff = []
        for pod, assign in self.pods["torch"].values():
            effective = assign if assign in self.nodes["torch"] else ""
            if pod.node_name != effective:
                pod = copy.copy(pod)
                pod.node_name = effective
            eff.append(pod)
        return eff

    def check(self):
        outs = {s.name: self.snapshot(s).tensors(self.groups or None) for s in SIDES}
        assert_outputs_equal(outs["jax"], outs["torch"])
        jp, tp = self.packers["jax"], self.packers["torch"]
        assert (tp.full_packs, tp.incremental_updates, tp.last_repack_reason) == (
            jp.full_packs, jp.incremental_updates, jp.last_repack_reason)
        full = tpacker.pack(list(self.nodes["torch"].values()), self.effective_pods(),
                            self.groups or None, dense_mask=self.dense, device="cpu")
        assert tick_probe.tensors_differences(*outs["torch"], *full) == []
        self.checks += 1
        if self.on_check is not None:
            self.on_check(outs["torch"])
        return outs["torch"]


def anti(s, app, key="zone"):
    return s.obj.Affinity(pod_anti_affinity=(s.obj.PodAffinityTerm(
        selector=s.obj.LabelSelector(match_labels=(("app", app),)), topology_key=key),))


def zone_node(name, zone, taint=False):
    def build(s):
        n = s.tu.build_test_node(name, cpu_m=4000, mem=8 * GB, labels={"zone": zone})
        if taint:
            n.taints = [s.obj.Taint(key="dedicated", value="x", effect="NoSchedule")]
        return n
    return build


def scripted(w: TwinWorld):
    """Fourteen updates, each kind of delta the packer handles at least once."""
    for i, zone in enumerate(("z1", "z1", "z2", "z2", "z3", "z3")):
        w.node_with(f"n{i}", zone_node(f"n{i}", zone, taint=i == 5))
    for i in range(20):
        w.pod(f"p{i}", f"n{i % 6}" if i % 3 else "", cpu_m=100 + 10 * i, mem=128 * MB,
              labels={"app": "ab"[i % 2]})
    w.check()                                                   # 1: cold build
    w.node("n9", cpu_m=16000, mem=32 * GB)                      # 2: add a node and pods
    w.pod("fresh", "n9", cpu_m=500, mem=GB)
    w.check()
    w.drop_node("n1")                                           # 3: column swap-fill
    w.check()
    for key in w.keys()[2:6]:                                   # 4: row swap-fill
        w.drop_pod(key)
    w.check()
    for key in w.keys()[:3]:                                    # 5: relist (change)
        name = key.split("/")[1]
        assign = w.pods["torch"][key][1]
        w.pod(name, assign, cpu_m=999, mem=333 * MB)
    w.check()
    w.assign(w.keys()[0], "n2")                                 # 6: reassign
    w.check()
    for s in SIDES:                                             # 7: in-place mutation
        w.nodes[s.name]["n2"].taints.append(s.obj.Taint(key="k", value="v", effect="NoSchedule"))
    w.nodes["torch"]["n3"].unschedulable = True
    w.nodes["jax"]["n3"].unschedulable = True
    w.check()
    w.drop_pod("default/p7")                                    # 8: swap-fill + re-add
    w.drop_pod("default/p10")
    w.pod("p7", "n4", cpu_m=777, mem=256 * MB)
    w.pod("p99", "", cpu_m=250, mem=64 * MB)
    w.check()

    def port_pod(name, port):
        def build(s):
            p = s.tu.build_test_pod(name, cpu_m=100, mem=128 * MB)
            p.host_ports = (port,)
            return p
        return build

    def csi_pod(name, handle):
        def build(s):
            p = s.tu.build_test_pod(name, cpu_m=50, mem=64 * MB)
            p.csi_volumes = (("ebs", handle),)
            return p
        return build

    def limited(s):
        n = s.tu.build_test_node("lim", cpu_m=4000, mem=8 * GB)
        n.csi_attach_limits = {"ebs": 1}
        return n

    w.pod("portly", "n0", build=port_pod("portly", 8080))      # 9: host ports and CSI
    w.pod("incoming", "", build=port_pod("incoming", 8080))
    w.node_with("lim", limited)
    w.pod("vol1", "lim", build=csi_pod("vol1", "h1"))
    w.pod("vol2", "", build=csi_pod("vol2", "h2"))
    w.check()
    w.assign("default/portly", "n4")                            # 10: occupancy moves
    w.drop_pod("default/vol1")
    w.check()
    w.pod("anchor", "n0", cpu_m=100, mem=128 * MB, labels={"app": "db"})   # 11: exceptions
    w.pod("anti", "", build=lambda s: s.tu.build_test_pod(
        "anti", cpu_m=100, mem=128 * MB, affinity=anti(s, "db")))

    def spready(s):
        p = s.tu.build_test_pod("spready", cpu_m=100, mem=128 * MB, labels={"app": "web"})
        p.topology_spread = [s.obj.TopologySpreadConstraint(
            max_skew=1, topology_key="zone", when_unsatisfiable="DoNotSchedule",
            selector=s.obj.LabelSelector(match_labels=(("app", "web"),)))]
        return p

    w.pod("spready", "", build=spready)
    w.pod("web0", "n0", cpu_m=100, mem=128 * MB, labels={"app": "web"})
    w.pod("holder", "n4", build=lambda s: s.tu.build_test_pod(
        "holder", cpu_m=100, mem=128 * MB, affinity=anti(s, "victim")))
    w.pod("victim", "", cpu_m=100, mem=128 * MB, labels={"app": "victim"})
    w.check()
    w.drop_pod("default/holder")                                # 12: symmetric target clears
    w.assign("default/anchor", "n4")
    w.groups = {name: f"g{j % 2}" for j, name in enumerate(w.nodes["torch"])}
    w.check()

    def gpu_pod(s):
        p = s.tu.build_test_pod("acc", cpu_m=100, mem=128 * MB)
        p.requests = dataclasses.replace(p.requests, extended=(("example.com/fpga", 1.0),))
        return p

    w.pod("acc", "", build=gpu_pod)                             # 13: schema change
    w.check()
    for i in range(40):                                         # 14: bucket growth
        w.pod(f"grow{i}", "", cpu_m=100, mem=128 * MB)
    w.check()


@pytest.mark.parametrize("dense", [True, False])
def test_scripted_updates_match_jax(dense):
    w = TwinWorld(dense=dense)
    scripted(w)
    assert w.checks == 14
    tp = w.packers["torch"]
    assert tp.full_packs == 3 and tp.incremental_updates == 11
    assert tp.last_repack_reason == "capacity_growth"


@pytest.mark.parametrize("dense", [True, False])
def test_randomized_churn_matches_jax(dense):
    """tests/test_incremental_pack.py::test_randomized_churn_parity's op
    soup, drawn once from a seed and applied to both packages."""
    rng = np.random.default_rng(7)
    w = TwinWorld(dense=dense)
    serial = [0]

    def new_node():
        name = f"n{serial[0]}"
        serial[0] += 1
        cpu, zone, taint = int(rng.integers(2000, 16000)), str(rng.choice(("z1", "z2", "z3"))), rng.random() < 0.2

        def build(s):
            n = s.tu.build_test_node(name, cpu_m=cpu, mem=8 * GB, labels={"zone": zone})
            if taint:
                n.taints = [s.obj.Taint(key="dedicated", value="x", effect="NoSchedule")]
            return n
        w.node_with(name, build)

    def new_pod():
        name = f"p{serial[0]}"
        serial[0] += 1
        cpu, app = int(rng.integers(50, 900)), str(rng.choice(("a", "b")))
        tol, port = rng.random() < 0.2, rng.random() < 0.15
        port_v = int(rng.choice((80, 443))) if port else 0
        has_anti = rng.random() < 0.15
        anti_app = str(rng.choice(("a", "b"))) if has_anti else ""
        assign = ""
        if w.nodes["torch"] and rng.random() < 0.6:
            assign = str(rng.choice(list(w.nodes["torch"])))

        def build(s):
            p = s.tu.build_test_pod(name, cpu_m=cpu, mem=256 * MB, labels={"app": app})
            if tol:
                p.tolerations = [s.obj.Toleration(key="dedicated", value="x", effect="NoSchedule")]
            if port:
                p.host_ports = (port_v,)
            if has_anti:
                p.affinity = anti(s, anti_app)
            return p
        w.pod(name, assign, build=build)

    for _ in range(4):
        new_node()
    for _ in range(10):
        new_pod()
    w.check()
    for _step in range(12):
        op = rng.random()
        if op < 0.25:
            new_pod()
        elif op < 0.4 and len(w.pods["torch"]) > 3:
            w.drop_pod(str(rng.choice(w.keys())))
        elif op < 0.5:
            new_node()
        elif op < 0.6 and len(w.nodes["torch"]) > 2:
            w.drop_node(str(rng.choice(list(w.nodes["torch"]))))
        elif op < 0.75 and w.pods["torch"]:
            key = str(rng.choice(w.keys()))
            node = str(rng.choice(list(w.nodes["torch"]))) if rng.random() < 0.7 else ""
            w.assign(key, node)
        elif op < 0.9 and w.pods["torch"]:
            key = str(rng.choice(w.keys()))
            cpu = int(rng.integers(50, 900))
            for s in SIDES:
                pod, assign = w.pods[s.name][key]
                newp = s.tu.build_test_pod(pod.name, cpu_m=cpu, mem=256 * MB,
                                           namespace=pod.namespace, labels=dict(pod.labels))
                newp.tolerations = list(pod.tolerations)
                newp.host_ports = tuple(pod.host_ports)
                newp.affinity = pod.affinity
                w.pods[s.name][key] = (newp, assign)
        else:
            w.groups = {name: f"g{int(rng.integers(0, 3))}" for name in w.nodes["torch"]}
        w.check()
    assert w.checks == 13


def test_full_bucket_churn_matches_jax():
    """Replacing members at exactly the bucket capacity: removals run before
    additions, so 8 live + 1 new never overflows 8 rows."""
    w = TwinWorld()
    for i in range(8):
        w.node(f"n{i}", cpu_m=4000, mem=8 * GB)
    for i in range(16):
        w.pod(f"p{i}", f"n{i % 8}", cpu_m=100, mem=128 * MB)
    w.check()
    for step in range(3):
        victim = f"n{step}" if step == 0 else f"extra{step - 1}"
        for key in w.keys():
            if w.pods["torch"][key][1] == victim:
                w.assign(key, "")
        w.drop_node(victim)
        w.node(f"extra{step}", cpu_m=4000, mem=8 * GB)
        w.check()
    assert w.packers["torch"].full_packs == 1


def test_idle_update_reuses_the_uploaded_tensors():
    w = TwinWorld()
    for i in range(3):
        w.node(f"n{i}", cpu_m=4000, mem=8 * GB)
    for i in range(10):
        w.pod(f"p{i}", f"n{i % 3}", cpu_m=100, mem=128 * MB)
    t1, _ = w.check()
    t2, _ = w.check()
    assert w.packers["torch"].incremental_updates == 1
    assert t2.pod_req is t1.pod_req and t2.node_alloc is t1.node_alloc
    assert w.packers["torch"].last_dirty == {"pod_rows": 0, "pod_node": 0, "node_rows": 0}


@pytest.mark.parametrize("arena", [False, True])
def test_served_tensors_are_copies(arena):
    """Copy, don't alias: tensors served by one update keep their values
    when the next update rewrites the same rows of the packer's host arrays
    in place."""
    w = TwinWorld(dense=False, arena=arena)
    for i in range(3):
        w.node(f"n{i}", cpu_m=4000, mem=8 * GB)
    for i in range(6):
        w.pod(f"p{i}", f"n{i % 3}", cpu_m=100, mem=128 * MB)
    t1, m1 = w.check()
    held = {f: getattr(t1, f).clone() for f in ("pod_req", "node_used", "pod_node")}
    row = m1.pod_index["default/p1"]
    w.pod("p1", "n0", cpu_m=1500, mem=GB)          # the same row, new values
    w.assign("default/p2", "")
    t2, m2 = w.check()
    assert m2.pod_index["default/p1"] == row
    assert float(t2.pod_req[row, 0]) == 1500.0
    for f, before in held.items():
        assert torch.equal(getattr(t1, f), before), f


def test_fields_stay_int32_and_bool():
    w = TwinWorld(dense=False)
    w.node("n0", cpu_m=4000, mem=8 * GB)
    w.pod("p0", "n0", cpu_m=100, mem=128 * MB)
    t, _ = w.check()
    for f in ("pod_class", "node_class", "pod_node", "node_group", "pod_priority",
              "pod_exc", "cell_pod", "cell_node"):
        assert getattr(t, f).dtype == torch.int32, f
    for f in ("pod_valid", "node_valid", "pod_preempt", "class_mask", "exc_rows", "cell_val"):
        assert getattr(t, f).dtype == torch.bool, f


@pytest.mark.parametrize("dense", [True, False])
def test_snapshot_hook_fork_schedule_revert(dense):
    """ClusterSnapshot(packer=...) through a fork: tensors() before the
    fork, schedule_pod and tensors() inside it, revert, tensors() again,
    then the next loop's snapshot of a changed listing; each against a
    full pack by key, and both packages row for row."""
    w = TwinWorld(dense=dense)
    for i in range(4):
        w.node(f"n{i}", cpu_m=4000, mem=8 * GB)
    for i in range(12):
        w.pod(f"p{i}", f"n{i % 4}" if i % 3 else "", cpu_m=200, mem=256 * MB)
    snaps = {s.name: w.snapshot(s) for s in SIDES}

    def both(fn):
        return {name: fn(snap) for name, snap in snaps.items()}

    def full(snap):
        pods = []
        for p in snap.pods():
            pod = copy.copy(p)
            pod.node_name = snap.assignment(p.key())
            pods.append(pod)
        return tpacker.pack(snap.nodes(), pods, dense_mask=dense, device="cpu")

    def check_both():
        outs = both(lambda s: s.tensors())
        assert_outputs_equal(outs["jax"], outs["torch"])
        assert tick_probe.tensors_differences(*outs["torch"], *full(snaps["torch"])) == []
        return outs["torch"]

    before, _ = check_both()
    both(lambda s: s.fork())
    assert both(lambda s: s.tensors()[0])["torch"] is before     # cached per version
    both(lambda s: s.schedule_pod("default/p0", "n1"))
    both(lambda s: s.schedule_pod("default/p3", "n2"))
    check_both()
    both(lambda s: s.revert())
    check_both()
    assert w.packers["torch"].incremental_updates == 2
    w.pod("late", "n3", cpu_m=300, mem=GB)                      # the next loop
    w.drop_pod("default/p5")
    snaps = {s.name: w.snapshot(s) for s in SIDES}
    check_both()
    assert w.packers["torch"].full_packs == 1


def test_snapshot_refuses_a_packer_of_another_device():
    pk = IncrementalPacker(device="meta")
    with pytest.raises(ValueError, match="packer"):
        tcs.ClusterSnapshot(device="cpu", packer=pk)
    assert tcs.ClusterSnapshot(packer=IncrementalPacker(device="cpu")).device.type == "cpu"
    with pytest.raises(ValueError, match="arena"):
        IncrementalPacker(device="cpu", arena=DeviceArena(device="meta"))


def test_packer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        IncrementalPacker()
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceArena()
    assert IncrementalPacker(device="cpu").device.type == "cpu"


SMALL_CHURNS = (
    {"seed": 1, "remove_share": 0.2, "arrive": 6, "grow": True},
    {"seed": 2, "remove": 2, "arrive": 3, "grow": False},
)


def _small_sequence(packer):
    """tick_world's cluster with five small spare nodes (17 nodes: the
    nodes churn 1 brings up stay inside the 32-node bucket)."""
    snap, _pending, provider = tick_world(ttu, tobj, tprov, tcs, False, device="cpu")
    templates = {g.id(): g.template_node_info() for g in provider.node_groups()}
    nodes = snap.nodes() + [ttu.build_test_node(f"spare-{k}", cpu_m=500, mem=GB)
                            for k in range(5)]
    return tick_probe.run_sequence(nodes, snap.pods(), templates, "cpu", packer,
                                   churns=SMALL_CHURNS), templates


def test_tick_sequence_through_the_packer_equals_full_packs():
    """tests/torch_parity.tick_world's cluster over three ticks with the
    listing churned between them: each tick's ``out`` through one carried
    packer equals the same tick with a full pack, ticks 2 and 3 are
    incremental, and the dirty rows are the churn's."""
    pk = IncrementalPacker(device="cpu")
    seq, templates = _small_sequence(pk)
    assert [rec["packer"]["full_packs"] for *_, rec in seq] == [1, 1, 1]
    assert [rec["packer"]["incremental_updates"] for *_, rec in seq] == [0, 1, 2]
    for nodes, pods, counts, rec in seq:
        full = tick_probe.run_tick(nodes, pods, (), templates, "cpu")
        assert tick_probe.tick_differences(rec["out"], full["out"]) == []
        assert tick_probe.tensors_differences(rec["tensors"], rec["meta"],
                                              full["tensors"], full["meta"]) == []
        if counts is not None:
            changed = counts["bound"] + counts["removed"] + counts["arrived"]
            assert rec["packer"]["pod_rows"] <= 2 * changed
    _n, _p, counts, _rec = seq[1]
    assert counts["new_nodes"] == sum(d for _g, d in seq[0][3]["out"]["calls"]) > 0


def test_churn_keeps_unchanged_objects():
    """A watch cache keeps an object until it changes: churn hands back the
    same objects for every pod and node it did not touch."""
    pk = IncrementalPacker(device="cpu")
    seq, _templates = _small_sequence(pk)
    (nodes1, pods1, _c, rec1), (nodes2, pods2, counts, _r) = seq[0], seq[1]
    bound = dict(rec1["out"]["assigned"])
    before = {p.key(): p for p in pods1}
    kept = [p for p in pods2 if p.key() in before and p.key() not in bound]
    assert kept and all(p is before[p.key()] for p in kept)
    moved = [p for p in pods2 if p.key() in bound]
    assert all(p is not before[p.key()] and p.node_name == bound[p.key()] for p in moved)
    assert all(a is b for a, b in zip(nodes1, nodes2))
    assert len(pods2) == len(pods1) - counts["removed"] + counts["arrived"]


@pytest.mark.parametrize("dense", [True, False])
def test_rule_loops_across_namespaces_match_jax(dense):
    """The rule loops test a term once per pod profile (namespace and
    labels): terms with and without ``namespaces``, pods of one app in two
    namespaces, placed and pending holders of affinity and anti-affinity,
    so that a profile matches in one namespace and not in the other; each
    update equal to the JAX package's and to a full pack."""
    w = TwinWorld(dense=dense)
    for i, zone in enumerate(("z1", "z1", "z2", "z3")):
        w.node_with(f"n{i}", zone_node(f"n{i}", zone))

    def term(s, app, namespaces=(), key="zone"):
        return s.obj.PodAffinityTerm(selector=s.obj.LabelSelector(match_labels=(("app", app),)),
                                     topology_key=key, namespaces=namespaces)

    for i in range(24):
        ns = ("default", "other")[i % 2]
        w.pod(f"w{i}", f"n{i % 4}" if i % 3 else "", build=lambda s, i=i, ns=ns: s.tu.build_test_pod(
            f"w{i}", cpu_m=100, mem=64 * MB, namespace=ns, labels={"app": "ab"[i % 2 == 0]}))
    w.pod("holder", "n0", build=lambda s: s.tu.build_test_pod(
        "holder", cpu_m=100, mem=64 * MB, namespace="other",
        affinity=s.obj.Affinity(pod_anti_affinity=(term(s, "a"), term(s, "b", ("default",))))))
    # app "a" lives in "other" and app "b" in "default"; the seeker (app a,
    # "default") needs a zone with a "b" pod and keeps off hosts with an
    # "a" pod of its own namespace: the buddy's, never its own once placed
    w.pod("buddy", "n3", cpu_m=100, mem=64 * MB, labels={"app": "a"})
    w.pod("seeker", "", build=lambda s: s.tu.build_test_pod(
        "seeker", cpu_m=100, mem=64 * MB, labels={"app": "a"},
        affinity=s.obj.Affinity(pod_affinity=(term(s, "b", ("default",)),),
                                pod_anti_affinity=(term(s, "a", (), "kubernetes.io/hostname"),))))
    t, m = w.check()
    row = t.dense_sched()[m.pod_index["default/seeker"]]
    assert not row[m.node_index["n3"]] and row[m.node_index["n2"]]
    w.assign("default/seeker", "n2")
    w.drop_pod("other/w1")
    t, m = w.check()
    row = t.dense_sched()[m.pod_index["default/seeker"]]
    assert row[m.node_index["n2"]] and not row[m.node_index["n3"]]
    w.drop_pod("other/holder")
    w.check()
