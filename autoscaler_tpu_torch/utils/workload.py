"""The repo's workloads, generated from a seed: the port's own copies of
the generators in ``bench.py``, ``benchmarks/affinity_bench.py``,
``benchmarks/spread_bench.py`` and ``benchmarks/fit_bench.py`` (which
import the JAX package), and the object-level snapshot world. Each copy
draws the same numbers from the same seed as its original.

- ``build_workload``: the headline, 100k pending heterogeneous pods
  (cpu/mem, 10% with GPUs) × 500 node groups, 6 resource axes, a cap of
  1000 nodes a group; the masks stand for the non-resource predicate
  outcomes (taints/selectors), and GPU pods fit only GPU groups.
- ``build_affinity_workload``: the dynamic-affinity scan's tensors, 15% of
  the pods in one term each (60% hostname anti-affinity, 20% zone
  affinity, 20% zone anti-affinity).
- ``build_spread_world``: pods and templates for the object-level
  estimator, 10% with hostname anti-affinity on their app and 5% with a
  DoNotSchedule spread constraint (maxSkew 2) on their app, over zoned
  templates.
- ``build_fit_workload``: the tiled fit's operands, 100k pods × 15k nodes
  × 6 resources, 40 × 24 classes (fit_bench's operands).
- ``build_snapshot_world``: nodes and pods of a 15k-node cluster with
  100k pods, one in seven pending, zones, taints, selectors, tolerations,
  hostname anti-affinity and a host-port DaemonSet.
"""
from __future__ import annotations

import numpy as np

from autoscaler_tpu_torch.kube.objects import (
    CPU,
    GPU,
    MEMORY,
    NUM_RESOURCES,
    PODS,
    LabelSelector,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)
from autoscaler_tpu_torch.utils.test_utils import (
    GB,
    MB,
    anti_affinity,
    build_test_node,
    build_test_pod,
)

HEADLINE_PODS = 100_000
HEADLINE_GROUPS = 500
HEADLINE_MAX_NODES = 1000


def build_workload(P=HEADLINE_PODS, G=HEADLINE_GROUPS, seed=0):
    """→ (pod_req [P, 6] f32, masks [G, P] bool, allocs [G, 6] f32,
    caps [G] i32), memory in MiB, identical to bench.build_workload."""
    rng = np.random.default_rng(seed)
    pod_req = np.zeros((P, NUM_RESOURCES), np.float32)
    pod_req[:, CPU] = rng.integers(50, 2000, P)
    pod_req[:, MEMORY] = rng.integers(64, 8192, P)
    gpu_pods = rng.random(P) < 0.1
    pod_req[gpu_pods, GPU] = rng.integers(1, 4, int(gpu_pods.sum()))
    pod_req[:, PODS] = 1

    allocs = np.zeros((G, NUM_RESOURCES), np.float32)
    allocs[:, CPU] = rng.choice([4000, 8000, 16000, 32000], G)
    allocs[:, MEMORY] = rng.choice([8192, 16384, 32768, 65536], G)
    gpu_groups = rng.random(G) < 0.2
    allocs[gpu_groups, GPU] = 8
    allocs[:, PODS] = 110

    masks = rng.random((G, P)) > 0.05
    masks[np.ix_(~gpu_groups, gpu_pods)] = False
    caps = np.full(G, HEADLINE_MAX_NODES, np.int32)
    return pod_req, masks, allocs, caps


AFFINITY_PODS = 20_000
AFFINITY_GROUPS = 100
AFFINITY_TERMS = 50
AFFINITY_MAX_NODES = 1000


def build_affinity_workload(P, G, T, seed=0, involved_frac=0.15):
    """→ (pod_req [P, 6] f32, masks [G, P] bool, allocs [G, 6] f32,
    match, aff_of, anti_of [T, P] bool, node_level [T] bool, has_label
    [G, T] bool), identical to affinity_bench.build_workload. Each involved
    pod belongs to one app with one term; every template carries both
    topology labels."""
    rng = np.random.default_rng(seed)
    pod_req = np.zeros((P, NUM_RESOURCES), np.float32)
    pod_req[:, CPU] = rng.integers(50, 2000, P)
    pod_req[:, MEMORY] = rng.integers(64, 8192, P)
    pod_req[:, PODS] = 1

    allocs = np.zeros((G, NUM_RESOURCES), np.float32)
    allocs[:, CPU] = rng.choice([4000, 8000, 16000, 32000], G)
    allocs[:, MEMORY] = rng.choice([8192, 16384, 32768, 65536], G)
    allocs[:, PODS] = 110

    masks = rng.random((G, P)) > 0.05

    involved = rng.random(P) < involved_frac
    app_of = rng.integers(0, T, P)
    match = np.zeros((T, P), bool)
    aff_of = np.zeros((T, P), bool)
    anti_of = np.zeros((T, P), bool)
    node_level = np.zeros(T, bool)
    kind = rng.random(T)
    node_level[kind < 0.6] = True          # hostname-scoped terms
    is_aff = (kind >= 0.6) & (kind < 0.8)  # zone affinity terms
    for t in range(T):
        members = involved & (app_of == t)
        match[t, members] = True
        if is_aff[t]:
            aff_of[t, members] = True
        else:
            anti_of[t, members] = True
    has_label = np.ones((G, T), bool)
    return pod_req, masks, allocs, match, aff_of, anti_of, node_level, has_label


ZONE = "topology.kubernetes.io/zone"
SPREAD_PODS = 20_000
SPREAD_GROUPS = 16
SPREAD_APPS = 24
SPREAD_MAX_NODES = 1000


def build_spread_world(P, G, apps, seed=0, topology_key=ZONE):
    """→ (pods, templates {name: node}), identical to
    spread_bench.build_world: P unique pods of ``apps`` apps, 10% with
    hostname anti-affinity on their app, 5% with a DoNotSchedule spread
    constraint (maxSkew 2) on their app over ``topology_key``; G templates
    in zones a, b, c."""
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(P):
        app = int(rng.integers(0, apps))
        p = build_test_pod(
            f"p{i}",
            cpu_m=int(rng.integers(50, 2000)),
            mem=int(rng.integers(64, 8192)) * 1024 * 1024,
            labels={"app": f"a{app}"},
        )
        r = rng.random()
        if r < 0.10:
            p.affinity = anti_affinity({"app": f"a{app}"})
        elif r < 0.15:
            p.topology_spread = (
                TopologySpreadConstraint(
                    max_skew=2,
                    topology_key=topology_key,
                    selector=LabelSelector.from_dict({"app": f"a{app}"}),
                ),
            )
        pods.append(p)
    templates = {}
    for g in range(G):
        t = build_test_node(
            f"tmpl-{g}",
            cpu_m=int(rng.choice([4000, 8000, 16000, 32000])),
            mem=int(rng.choice([8, 16, 32, 64])) * GB,
        )
        t.labels[ZONE] = f"zone-{'abc'[g % 3]}"
        templates[f"g{g}"] = t
    return pods, templates


FIT_PODS = 100_000
FIT_NODES = 15_000
FIT_POD_CLASSES = 40
FIT_NODE_CLASSES = 24


def build_fit_workload(seed=0):
    """→ (pod_req [P, 6] f32, free [N, 6] f32, pod_class [P] i32,
    node_class [N] i32, class_mask [40, 24] bool, node_valid [N] bool) at
    P = 100 000, N = 15 000: fit_bench's operands, the same numpy calls in
    the same order."""
    P, N, R = FIT_PODS, FIT_NODES, 6
    rng = np.random.default_rng(seed)
    req = np.zeros((P, R), np.float32)
    req[:, 0] = rng.integers(50, 2000, P)
    req[:, 1] = rng.integers(64, 8192, P)
    req[:, 3] = 1
    free = np.zeros((N, R), np.float32)
    free[:, 0] = rng.integers(0, 16000, N)
    free[:, 1] = rng.integers(0, 32768, N)
    free[:, 3] = 110
    CP, CN = FIT_POD_CLASSES, FIT_NODE_CLASSES
    pod_class = rng.integers(0, CP, P).astype(np.int32)
    node_class = rng.integers(0, CN, N).astype(np.int32)
    class_mask = rng.random((CP, CN)) > 0.1
    node_valid = np.ones(N, bool)
    return req, free, pod_class, node_class, class_mask, node_valid


SNAPSHOT_NODES = 15_000      # a point of the reference's snapshot benchmark grid
SNAPSHOT_PODS = 100_000
SNAPSHOT_PORT_NODES = 5_000
SNAPSHOT_APPS = 300
HOSTNAME = "kubernetes.io/hostname"


def build_snapshot_world(
    N=SNAPSHOT_NODES, P=SNAPSHOT_PODS, port_nodes=SNAPSHOT_PORT_NODES,
    apps=SNAPSHOT_APPS, seed=0,
):
    """→ (nodes, pods): a cluster of N nodes (4/8/16/32 cores, 16/32/64 GiB,
    zones a/b/c in turn, one node in ten tainted dedicated=batch:NoSchedule)
    and P pods of ``apps`` apps (50-1500 m CPU, 64-2048 MiB), one in seven
    pending. One pod in ten selects a zone and one in twenty tolerates the
    batch taint; a placed pod sits on a node it selects and tolerates,
    drawn with weight proportional to the node's cores. One pending pod in
    a hundred has hostname anti-affinity on its own app. On each of the
    first ``port_nodes`` nodes runs one more pod, of a host-port DaemonSet
    (port 9100, tolerating the taint): N + P pods in all when
    port_nodes = N."""
    rng = np.random.default_rng(seed)
    zones = [f"zone-{z}" for z in "abc"]
    cores = rng.choice([4, 8, 16, 32], N)
    mem_gib = rng.choice([16, 32, 64], N)
    zone_of = np.arange(N) % 3
    tainted = np.arange(N) % 10 == 9
    batch = Taint(key="dedicated", value="batch")
    nodes = [
        build_test_node(
            f"node-{j:05d}", cpu_m=float(cores[j] * 1000), mem=float(mem_gib[j]) * GB,
            labels={ZONE: zones[zone_of[j]]}, taints=[batch] if tainted[j] else None,
        )
        for j in range(N)
    ]
    cpu = rng.integers(50, 1501, P)
    mem = rng.integers(64, 2049, P)
    idx = np.arange(P)
    pending = idx % 7 == 0
    selector = np.where(idx % 10 == 3, idx % 3, -1)          # zone index or -1
    tolerates = idx % 20 == 5
    anti = pending & ((idx // 7) % 100 == 0)
    # each placed pod on a node it selects and tolerates, weighted by cores
    node_of = np.full(P, -1, np.int64)
    for z in (-1, 0, 1, 2):
        for tol in (False, True):
            who = ~pending & (selector == z) & (tolerates == tol)
            ok = (zone_of == z if z >= 0 else np.ones(N, bool)) & (tol | ~tainted)
            cand = np.flatnonzero(ok)
            w = cores[cand] / cores[cand].sum()
            node_of[who] = rng.choice(cand, size=int(who.sum()), p=w)
    tolerations = [Toleration(key="dedicated", value="batch", effect="NoSchedule")]
    pods = []
    for i in range(P):
        app = f"app-{i % apps}"
        pods.append(build_test_pod(
            f"pod-{i:06d}", cpu_m=float(cpu[i]), mem=float(mem[i]) * MB,
            labels={"app": app},
            node_selector={ZONE: zones[selector[i]]} if selector[i] >= 0 else None,
            tolerations=tolerations if tolerates[i] else None,
            affinity=anti_affinity({"app": app}, HOSTNAME) if anti[i] else None,
            node_name=nodes[node_of[i]].name if node_of[i] >= 0 else "",
        ))
    for j in range(port_nodes):
        ds = build_test_pod(
            f"node-exporter-{j:05d}", cpu_m=50.0, mem=64.0 * MB,
            labels={"app": "node-exporter"}, tolerations=tolerations,
            owner_kind="DaemonSet", node_name=nodes[j].name,
        )
        ds.host_ports = (9100,)
        ds.daemonset = True
        pods.append(ds)
    return nodes, pods
