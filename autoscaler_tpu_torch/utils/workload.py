"""The repo's scale-up workloads, generated from a seed: the port's own
copies of the generators in ``bench.py``, ``benchmarks/affinity_bench.py``
and ``benchmarks/spread_bench.py`` (which import the JAX package). Each
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
    TopologySpreadConstraint,
)
from autoscaler_tpu_torch.utils.test_utils import (
    GB,
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
