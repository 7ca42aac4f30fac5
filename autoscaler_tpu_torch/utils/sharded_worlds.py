"""Shared randomized worlds for the sharded-kernel-fleet certification.

One definition of each scenario, so that every consumer certifies the
same workloads. The port of ``autoscaler_tpu/utils/sharded_worlds.py``:
the worlds are the same numpy draws; where a world is tensors, they are
torch tensors on an explicit ``device`` (None = the first CUDA card;
``"cpu"`` for the host).
"""
from __future__ import annotations

import numpy as np

from autoscaler_tpu_torch.kube.objects import CPU, MEMORY, PODS


def affinity_world(G: int, P: int, T: int, M: int, seed: int = 9):
    """Randomized dynamic-affinity estimation inputs: heterogeneous pods,
    per-group masks/templates, and a term structure mixing affinity and
    anti-affinity at hostname and group scope. Returns a dict matching
    ffd_binpack_groups_affinity's keyword surface (numpy arrays)."""
    rng = np.random.default_rng(seed)
    pod_req = np.zeros((P, 6), np.float32)
    pod_req[:, CPU] = rng.integers(100, 1500, P)
    pod_req[:, MEMORY] = rng.integers(128, 2048, P)
    pod_req[:, PODS] = 1
    masks = rng.random((G, P)) > 0.1
    allocs = np.zeros((G, 6), np.float32)
    allocs[:, CPU] = rng.integers(3000, 8000, G)
    allocs[:, MEMORY] = rng.integers(8192, 16384, G)
    allocs[:, PODS] = 110
    match = rng.random((T, P)) < 0.2
    aff_of = (rng.random((T, P)) < 0.08) & match
    anti_of = (rng.random((T, P)) < 0.08) & match & ~aff_of
    return dict(
        pod_req=pod_req,
        pod_masks=masks,
        template_allocs=allocs,
        match=match,
        aff_of=aff_of,
        anti_of=anti_of,
        node_level=rng.random(T) < 0.5,
        has_label=rng.random((G, T)) < 0.9,
        node_caps=np.full(G, M, np.int32),
    )


def spread_world(G: int, P: int, M: int):
    """A hard-topology-spread world where the skew gate actually bites:
    every other pod carries a DoNotSchedule zone constraint and the cluster
    context holds an EMPTY zone-other domain, so each group's wave budget is
    maxSkew + min_other(0) = 1 (a template-only single-domain world never
    blocks — see tests/test_spread_binpack.py). Returns (kernel_kwargs,
    spread_tuple) with zero-width affinity terms."""
    from autoscaler_tpu_torch.estimator.binpacking import _spread_tuple
    from autoscaler_tpu_torch.kube.objects import (
        LabelSelector,
        TopologySpreadConstraint,
    )
    from autoscaler_tpu_torch.snapshot.affinity import build_spread_terms
    from autoscaler_tpu_torch.utils.test_utils import build_test_node, build_test_pod

    ZONE = "topology.kubernetes.io/zone"
    constraint = TopologySpreadConstraint(
        max_skew=1, topology_key=ZONE,
        selector=LabelSelector.from_dict({"app": "web"}),
        when_unsatisfiable="DoNotSchedule",
    )
    pods = []
    for i in range(P):
        p = build_test_pod(f"p{i}", cpu_m=100, labels={"app": "web"})
        if i % 2 == 0:
            p.topology_spread = (constraint,)
        pods.append(p)
    templates = []
    for g in range(G):
        t = build_test_node(f"tmpl-{g}", cpu_m=4000)
        t.labels[ZONE] = f"zone-{g % 3}"
        templates.append(t)
    other = build_test_node("existing-other", cpu_m=4000)
    other.labels[ZONE] = "zone-other"
    spread = _spread_tuple(
        build_spread_terms(pods, templates, cluster=([other], [], []))
    )

    pod_req = np.zeros((P, 6), np.float32)
    pod_req[:, CPU] = 100
    pod_req[:, PODS] = 1
    allocs = np.zeros((G, 6), np.float32)
    allocs[:, CPU] = 4000
    allocs[:, PODS] = 110
    z = np.zeros((1, P), bool)
    kwargs = dict(
        pod_req=pod_req,
        pod_masks=np.ones((G, P), bool),
        template_allocs=allocs,
        match=z,
        aff_of=z,
        anti_of=z,
        node_level=np.zeros(1, bool),
        has_label=np.ones((G, 1), bool),
        node_caps=np.full(G, M, np.int32),
    )
    return kwargs, spread


def scaledown_spread_world(n_zones: int = 2, per_zone: int = 8,
                           cands_per_zone: int = 4, device=None):
    """An object-level drain world where hard topology-spread gates the
    refit: every node hosts one movable "web" pod carrying a DoNotSchedule
    zone constraint (maxSkew=1), so draining a node must re-place its pod
    without re-skewing the zones. Returns (tensors, cand, pod_slots,
    blocked, excluded, spread8, static_counts, cand_sub) — the exact
    argument set of removal_feasibility_spread, built by the same private
    helpers the RemovalSimulator uses; the tensors on ``device``."""
    from autoscaler_tpu_torch.kube.objects import (
        LabelSelector,
        TopologySpreadConstraint,
    )
    from autoscaler_tpu_torch.simulator.removal import (
        _cand_sub_matrix,
        _spread_refit_context,
    )
    from autoscaler_tpu_torch.snapshot.packer import pack
    from autoscaler_tpu_torch.utils.test_utils import build_test_node, build_test_pod

    ZONE = "topology.kubernetes.io/zone"
    constraint = TopologySpreadConstraint(
        max_skew=1, topology_key=ZONE,
        selector=LabelSelector.from_dict({"app": "web"}),
        when_unsatisfiable="DoNotSchedule",
    )
    nodes, pods = [], []
    pods_on: dict = {}
    for z in range(n_zones):
        for i in range(per_zone):
            name = f"n-{z}-{i}"
            n = build_test_node(name, cpu_m=4000)
            n.labels[ZONE] = f"zone-{z}"
            p = build_test_pod(
                f"w-{z}-{i}", cpu_m=300, labels={"app": "web"},
                node_name=name,
            )
            p.topology_spread = (constraint,)
            nodes.append(n)
            pods.append(p)
            pods_on[name] = [p]
    tensors, meta = pack(nodes, pods, device=device)
    cand_names = [
        f"n-{z}-{i}" for z in range(n_zones) for i in range(cands_per_zone)
    ]
    movers = [pods_on[c] for c in cand_names]
    spread8, static_counts, sp_match_np = _spread_refit_context(
        meta, tensors, [m for ms in movers for m in ms]
    )
    C = len(cand_names)
    cand = np.asarray([meta.node_index[c] for c in cand_names], np.int32)
    pod_slots = np.full((C, 2), -1, np.int32)
    for ci, ms in enumerate(movers):
        for si, p in enumerate(ms):
            pod_slots[ci, si] = meta.pod_index[p.key()]
    blocked = np.zeros(C, bool)
    excluded = np.zeros(int(tensors.node_valid.shape[0]), bool)
    excluded[cand] = True
    cand_sub = _cand_sub_matrix(sp_match_np, meta, movers)
    return (tensors, cand, pod_slots, blocked, excluded,
            spread8, static_counts, cand_sub)


def scaledown_world(N: int, P: int, C: int, slots: int, seed: int = 7,
                    device=None):
    """A packed cluster with C drain candidates: random pod→node placement,
    a mostly-permissive dense sched_mask, per-candidate movable-pod slots,
    and the joint-plan exclusion set. Returns (snap, cand, pod_slots,
    blocked, excluded) ready for removal_feasibility /
    joint_removal_feasibility; the snapshot's tensors on ``device``."""
    import torch

    from autoscaler_tpu_torch.device import resolve_device
    from autoscaler_tpu_torch.snapshot.tensors import SnapshotTensors

    dev = resolve_device(device)

    def on(a):
        return torch.as_tensor(a, device=dev)

    rng = np.random.default_rng(seed)
    node_alloc = np.zeros((N, 6), np.float32)
    node_alloc[:, CPU] = 4000
    node_alloc[:, PODS] = 110
    pod_req = np.zeros((P, 6), np.float32)
    pod_req[:, CPU] = rng.integers(200, 900, P)
    pod_req[:, PODS] = 1
    pod_node = rng.integers(0, N, P).astype(np.int32)
    node_used = np.zeros((N, 6), np.float32)
    for i in range(P):
        node_used[pod_node[i]] += pod_req[i]
    snap = SnapshotTensors(
        node_alloc=on(node_alloc),
        node_used=on(node_used),
        node_valid=on(np.ones(N, bool)),
        node_group=on(np.zeros(N, np.int32)),
        pod_req=on(pod_req),
        pod_valid=on(np.ones(P, bool)),
        pod_node=on(pod_node),
        sched_mask=on(rng.random((P, N)) > 0.05),
    )
    cand = rng.choice(N, C, replace=False).astype(np.int32)
    pod_slots = np.full((C, slots), -1, np.int32)
    for ci, j in enumerate(cand):
        on = np.where(pod_node == j)[0][:slots]
        pod_slots[ci, : len(on)] = on
    blocked = np.zeros(C, bool)
    excluded = np.zeros(N, bool)
    excluded[cand] = True
    return snap, cand, pod_slots, blocked, excluded
