"""Serial host-side FFD — the parity oracle and bench baseline.

This mirrors the *algorithmic structure* of the reference's Go
BinpackingNodeEstimator (cluster-autoscaler/estimator/binpacking_estimator.go:
65-141: score-sort, first-fit over open template nodes, open-on-miss) in
plain numpy, serving two jobs:

1. Parity tests: the TPU scan in ops/binpack.py must agree with this oracle
   exactly (same counts, same scheduled sets) on identical inputs.
2. bench.py baseline: a faithful stand-in for the reference's serial
   per-pod × per-node × per-group hot loop when measuring TPU speedup
   (the reference itself is Go and not runnable in this environment).

The port's copy of ``autoscaler_tpu/estimator/reference_impl.py`` (numpy
only): the FFD order spec, the serial oracle and its affinity form (the
estimator's Python rung), the attribution's oracle twin (its fallback)
and the preemption oracle (the preemption estimate's Python rung). The
scenario and row-delta oracles come with the modules that use them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from autoscaler_tpu_torch.kube.objects import CPU, MEMORY


def ffd_order(pod_req: np.ndarray, template_alloc: np.ndarray) -> np.ndarray:
    """Stable score-descending pod order — the ONE FFD order spec every
    kernel, oracle, and the C++ baseline share: f32
    `cpu·mem_cap + mem·cpu_cap` (the division-free order-equivalent of the
    reference's cpu/cpu_cap + mem/mem_cap, binpacking_estimator.go:164-193;
    see ops/binpack.ffd_scores for why division is banned — TPU f32 divide
    is not correctly rounded and flips ulp-near orders vs the host)."""
    cpu_cap = np.float32(template_alloc[CPU])
    mem_cap = np.float32(template_alloc[MEMORY])
    P = pod_req.shape[0]
    score = np.zeros(P, np.float32)
    if cpu_cap > 0:
        score = score + pod_req[:, CPU].astype(np.float32) * (
            mem_cap if mem_cap > 0 else np.float32(1.0)
        )
    if mem_cap > 0:
        score = score + pod_req[:, MEMORY].astype(np.float32) * (
            cpu_cap if cpu_cap > 0 else np.float32(1.0)
        )
    return np.argsort(-score, kind="stable")


def ffd_binpack_reference(
    pod_req: np.ndarray,         # [P, R]
    pod_mask: np.ndarray,        # [P] bool
    template_alloc: np.ndarray,  # [R]
    max_nodes: int,
) -> Tuple[int, np.ndarray]:
    """Returns (node_count, scheduled[P] bool)."""
    P = pod_req.shape[0]
    order = ffd_order(pod_req, template_alloc)

    used: list = []  # per-open-node usage vectors, in open order
    scheduled = np.zeros(P, bool)
    for i in order:
        if not pod_mask[i]:
            continue
        req = pod_req[i]
        placed = False
        for u in used:  # first-fit in open order
            if np.all(req <= template_alloc - u):
                u += req
                placed = True
                break
        if not placed and len(used) < max_nodes and np.all(req <= template_alloc):
            used.append(req.astype(np.float64).copy())
            placed = True
        scheduled[i] = placed
    return len(used), scheduled


def ffd_binpack_reference_affinity(
    pod_req: np.ndarray,         # [P, R]
    pod_mask: np.ndarray,        # [P] bool
    template_alloc: np.ndarray,  # [R]
    max_nodes: int,
    match: np.ndarray,           # [T, P] bool
    aff_of: np.ndarray,          # [T, P] bool
    anti_of: np.ndarray,         # [T, P] bool
    node_level: np.ndarray,      # [T] bool
    has_label: np.ndarray,       # [T] bool (this group's template)
) -> Tuple[int, np.ndarray]:
    """Serial FFD with dynamic inter-pod (anti-)affinity — the oracle for
    ops/binpack.ffd_binpack_groups_affinity. Mirrors the reference's
    re-run-the-filter-after-every-placement behavior
    (binpacking_estimator.go:119-141) over the term factorization."""
    P = pod_req.shape[0]
    T = match.shape[0]
    order = ffd_order(pod_req, template_alloc)

    used: list = []
    pm = []        # per-open-node matching count per term [T]
    ha = []        # per-open-node anti-holder count per term [T]
    pm_tot = np.zeros(T, np.int64)
    ha_tot = np.zeros(T, np.int64)
    scheduled = np.zeros(P, bool)

    def node_allowed(i: int, m: int) -> bool:
        for t in range(T):
            dom_pm = pm[m][t] if node_level[t] else pm_tot[t]
            dom_ha = ha[m][t] if node_level[t] else ha_tot[t]
            if aff_of[t, i]:
                seed = match[t, i] and pm_tot[t] == 0
                if not (has_label[t] and (dom_pm > 0 or seed)):
                    return False
            # no topology label → no domain → an anti term cannot be violated
            if has_label[t] and anti_of[t, i] and dom_pm > 0:
                return False
            if has_label[t] and match[t, i] and dom_ha > 0:
                return False
        return True

    def new_node_allowed(i: int) -> bool:
        for t in range(T):
            if aff_of[t, i]:
                seed = match[t, i] and pm_tot[t] == 0
                if node_level[t]:
                    if not seed:
                        return False
                elif not (has_label[t] and (pm_tot[t] > 0 or seed)):
                    return False
            if not node_level[t] and has_label[t]:
                if anti_of[t, i] and pm_tot[t] > 0:
                    return False
                if match[t, i] and ha_tot[t] > 0:
                    return False
        return True

    def commit(i: int, m: int) -> None:
        nonlocal pm_tot, ha_tot
        used[m] += pod_req[i]
        pm[m] += match[:, i]
        ha[m] += anti_of[:, i]
        pm_tot += match[:, i]
        ha_tot += anti_of[:, i]

    for i in order:
        if not pod_mask[i]:
            continue
        req = pod_req[i]
        placed = False
        for m, u in enumerate(used):
            if np.all(req <= template_alloc - u) and node_allowed(i, m):
                commit(i, m)
                placed = True
                break
        if (
            not placed
            and len(used) < max_nodes
            and np.all(req <= template_alloc)
            and new_node_allowed(i)
        ):
            used.append(np.zeros_like(req, np.float64))
            pm.append(np.zeros(T, np.int64))
            ha.append(np.zeros(T, np.int64))
            commit(i, len(used) - 1)
            placed = True
        scheduled[i] = placed
    return len(used), scheduled


def attribute_unschedulable_reference(
    pod_req: np.ndarray,          # [P, R]
    pod_masks: np.ndarray,        # [G, P]
    template_allocs: np.ndarray,  # [G, R]
    scheduled: np.ndarray,        # [G, P] bool — the binpack verdict
    involved: np.ndarray,         # [P] bool — pod touches any dynamic term
) -> np.ndarray:
    """[G, P] i32 — the serial oracle twin of
    ops/binpack.attribute_unschedulable: plain Python loops over the same
    priority chain (mask → cpu → memory → pod-slot → other resource →
    affinity/spread → node cap), against which the kernel's reason codes
    are parity-locked on randomized shapes (tests/test_explain.py)."""
    from autoscaler_tpu_torch.explain.reasons import (
        REASON_AFFINITY_SPREAD,
        REASON_CPU,
        REASON_MEMORY,
        REASON_NODE_CAP,
        REASON_NONE,
        REASON_POD_SLOT,
        REASON_RESOURCE,
        REASON_TOPOLOGY,
    )
    from autoscaler_tpu_torch.kube.objects import CPU as CPU_AX
    from autoscaler_tpu_torch.kube.objects import MEMORY as MEM_AX
    from autoscaler_tpu_torch.kube.objects import PODS as PODS_AX

    G, P = pod_masks.shape
    R = pod_req.shape[1]
    out = np.zeros((G, P), np.int32)
    for g in range(G):
        alloc = template_allocs[g]
        for p in range(P):
            if scheduled[g, p]:
                out[g, p] = REASON_NONE
                continue
            if not pod_masks[g, p]:
                out[g, p] = REASON_TOPOLOGY
                continue
            req = pod_req[p]
            if req[CPU_AX] > alloc[CPU_AX]:
                out[g, p] = REASON_CPU
            elif req[MEM_AX] > alloc[MEM_AX]:
                out[g, p] = REASON_MEMORY
            elif R > PODS_AX and req[PODS_AX] > alloc[PODS_AX]:
                out[g, p] = REASON_POD_SLOT
            elif any(
                req[r] > alloc[r]
                for r in range(R)
                if r not in (CPU_AX, MEM_AX, PODS_AX)
            ):
                out[g, p] = REASON_RESOURCE
            elif involved[p]:
                out[g, p] = REASON_AFFINITY_SPREAD
            else:
                out[g, p] = REASON_NODE_CAP
    return out


def preempt_order(
    pod_req: np.ndarray, pod_prio: np.ndarray, cap_row: np.ndarray
) -> np.ndarray:
    """Stable (priority desc, ffd score desc, index asc) pod order — the ONE
    preemption packing order spec shared by ops/preempt.ffd_binpack_preempt
    and this oracle. Reuses ffd_order (the shared FFD score spec) for the
    secondary key; cap_row is the elementwise max allocatable over valid
    nodes (heterogeneous nodes have no single template row, and any fixed
    positive weights give a deterministic order — both twins compute the
    same max, which is exact in f32)."""
    sorder = ffd_order(pod_req, cap_row)
    return sorder[np.argsort(-pod_prio.astype(np.int64)[sorder], kind="stable")]


def ffd_binpack_preempt_reference(
    pod_req: np.ndarray,       # [P, R] — ALL pods (pending + resident)
    pod_valid: np.ndarray,     # [P] bool
    pod_node: np.ndarray,      # [P] i32 — node row a resident sits on, -1 pending
    pod_prio: np.ndarray,      # [P] i32
    pod_can_preempt: np.ndarray,  # [P] bool — pending: may evict (policy != Never)
    pod_evictable: np.ndarray,    # [P] bool — resident: may be chosen as victim
    node_alloc: np.ndarray,    # [N, R]
    node_used: np.ndarray,     # [N, R] — includes the residents' requests
    node_valid: np.ndarray,    # [N] bool
    sched_mask: np.ndarray,    # [P, N] bool — non-resource predicate verdicts
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Serial oracle twin of ops/preempt.ffd_binpack_preempt.

    Packs pending pods (pod_node < 0) over the EXISTING nodes in priority-
    then-FFD order; a pod that fits nowhere directly may evict strictly-
    lower-priority residents. Victim selection is the closed spec both twins
    implement: per node, candidates are taken greedily in global (priority
    asc, index asc) order until the pod fits — the minimal such prefix —
    and the node is chosen by lexicographic (victim count, aggregate victim
    priority, node index). Pods admitted this pass occupy capacity but are
    never victims. Returns (scheduled [P] bool, placed_node [P] i32,
    victim_of [P] i32 — the evictor's pod row, -1 if not evicted)."""
    P, _R = pod_req.shape
    N = node_alloc.shape[0]
    used = node_used.astype(np.float64).copy()
    alive = pod_valid & (pod_node >= 0)
    pending = pod_valid & (pod_node < 0)
    scheduled = np.zeros(P, bool)
    placed_node = np.full(P, -1, np.int32)
    victim_of = np.full(P, -1, np.int32)

    cap_row = (
        np.where(node_valid[:, None], node_alloc, 0.0).max(axis=0)
        if N and node_valid.any()
        else np.zeros(pod_req.shape[1], np.float32)
    )
    order = preempt_order(pod_req, pod_prio, cap_row)
    # global victim order: priority asc, index asc (stable)
    vorder = np.argsort(pod_prio.astype(np.int64), kind="stable")

    for i in order:
        if not pending[i]:
            continue
        req = pod_req[i]
        placed = False
        for n in range(N):  # direct first-fit on the lowest node row
            if node_valid[n] and sched_mask[i, n] and np.all(
                req <= node_alloc[n] - used[n]
            ):
                used[n] += req
                scheduled[i] = True
                placed_node[i] = n
                placed = True
                break
        if placed or not pod_can_preempt[i]:
            continue
        best = None  # ((victims, agg_prio, node), victim rows)
        for n in range(N):
            if not (node_valid[n] and sched_mask[i, n]):
                continue
            if not np.all(req <= node_alloc[n]):
                continue  # cannot fit even an empty node
            free = node_alloc[n] - used[n]
            victims: list = []
            agg = 0
            fits = False
            for q in vorder:
                if not (
                    alive[q]
                    and pod_node[q] == n
                    and pod_evictable[q]
                    and pod_prio[q] < pod_prio[i]
                ):
                    continue
                victims.append(int(q))
                agg += int(pod_prio[q])
                free = free + pod_req[q]
                if np.all(req <= free):
                    fits = True
                    break
            if fits:
                cand = (len(victims), agg, n)
                if best is None or cand < best[0]:
                    best = (cand, victims)
        if best is not None:
            (_k, _agg, n), victims = best
            for q in victims:
                alive[q] = False
                victim_of[q] = i
                used[n] -= pod_req[q]
            used[n] += req
            scheduled[i] = True
            placed_node[i] = n
    return scheduled, placed_node, victim_of


def scenario_binpack_reference(
    scen_req: np.ndarray,     # [S, P, R] per-scenario pod matrices
    scen_masks: np.ndarray,   # [S, G, P]
    scen_allocs: np.ndarray,  # [S, G, R]
    max_nodes: int,
    scen_caps: np.ndarray | None = None,  # [S, G] i32
):
    """Serial per-scenario oracle twin of ops/binpack.ffd_binpack_scenarios
    (the fleet batched entry): plain Python loops over scenarios and groups,
    each through the ONE shared FFD order spec. This is also the fleet
    coalescer's degraded rung — a faulted batched dispatch falls back here
    off the card, and because every rung shares the order spec the
    per-tenant verdicts are identical. → (counts [S, G] i32, scheduled
    [S, G, P])."""
    S, P, R = scen_req.shape
    G = scen_masks.shape[1]
    counts = np.zeros((S, G), np.int32)
    scheds = np.zeros((S, G, P), bool)
    for s in range(S):
        for g in range(G):
            cap = max_nodes if scen_caps is None else int(
                min(scen_caps[s, g], max_nodes)
            )
            c, sched = ffd_binpack_reference(
                scen_req[s], scen_masks[s, g], scen_allocs[s, g], cap
            )
            counts[s, g] = c
            scheds[s, g] = sched
    return counts, scheds
