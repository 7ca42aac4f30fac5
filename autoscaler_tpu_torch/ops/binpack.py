"""First-fit-decreasing binpacking in plain PyTorch — the port of the XLA
scans in ``autoscaler_tpu/ops/binpack.py`` (``ffd_scores``,
``ffd_binpack``, ``ffd_binpack_groups``, ``ffd_binpack_groups_runs``, and
the dynamic inter-pod affinity and hard topology-spread scans
``ffd_binpack_groups_affinity`` and ``ffd_binpack_groups_runs_affinity``).

Reference: cluster-autoscaler/estimator/binpacking_estimator.go:65. Pods
are sorted by score descending (ties keep pod order), then each pod takes
the first open node it fits, opening a new node on a miss, up to the
group's cap.

The JAX versions are ``lax.scan``s; here each is a Python loop over the
pod (or run) axis whose body is vectorized over node groups and nodes. The
arithmetic is the same IEEE f32 mul, add, sub and compare sequence as the
XLA scans, so results are bit-identical on the same operands. The hot
plain route of the estimator does not come here: it runs the hand-written
scan kernels of ``ops/ffd_scan.py``, and its per-pod dynamic route runs
the kernel of ``ops/ffd_scan_affinity.py`` unless the term state is too
wide for it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from autoscaler_tpu_torch.kube.objects import CPU, MEMORY

BIG_I32 = 2**30  # "no domain yet" sentinel in the spread minimums


class BinpackResult(NamedTuple):
    node_count: torch.Tensor   # i32 scalar (or [G]) — template nodes opened
    scheduled: torch.Tensor    # [P] bool (or [G, P]) — pod was placed
    node_used: torch.Tensor    # [max_nodes, R] (or [G, max_nodes, R]) f32


class RunBinpackResult(NamedTuple):
    node_count: torch.Tensor     # [G] i32 — template nodes opened
    placed_counts: torch.Tensor  # [G, U] i32 — pods of run u placed in group g
    node_used: torch.Tensor      # [G, max_nodes, R] f32


def ffd_scores(pod_req: torch.Tensor, template_alloc: torch.Tensor) -> torch.Tensor:
    """Pod score against template capacity: the division-free
    order-equivalent ``cpu·mem_cap + mem·cpu_cap`` of the reference's
    cpu/cpu_cap + mem/mem_cap (binpacking_estimator.go:164-193); a zero cap
    drops its term.

    ``template_alloc`` is [R] (→ [P] scores) or [G, R] (→ [G, P]). Each
    product and the sum are separate eager kernels, so no fused
    multiply-add re-rounds the sum: the result is bit-identical to the JAX
    package, numpy and the serial C++ oracle. Never compile this."""
    cpu_cap = template_alloc[..., CPU, None]
    mem_cap = template_alloc[..., MEMORY, None]
    c_scale = torch.where(cpu_cap > 0, cpu_cap, 1.0)
    m_scale = torch.where(mem_cap > 0, mem_cap, 1.0)
    s_cpu = torch.where(cpu_cap > 0, pod_req[:, CPU] * m_scale, 0.0)
    s_mem = torch.where(mem_cap > 0, pod_req[:, MEMORY] * c_scale, 0.0)
    return s_cpu + s_mem


def score_order(pod_req: torch.Tensor, template_allocs: torch.Tensor) -> torch.Tensor:
    """[G, P] int64 — each group's pods by descending score; ties keep pod
    order (stable sort; zero scores all negate to -0.0 alike)."""
    scores = ffd_scores(pod_req, template_allocs)
    return torch.sort(-scores, dim=1, stable=True).indices


def _caps(node_caps: Optional[torch.Tensor], G: int, max_nodes: int, device):
    if node_caps is None:
        return torch.full((G,), max_nodes, dtype=torch.int32, device=device)
    return torch.clamp(node_caps.to(torch.int32), max=max_nodes)


def ffd_binpack(
    pod_req: torch.Tensor,         # [P, R] f32
    pod_mask: torch.Tensor,        # [P] bool
    template_alloc: torch.Tensor,  # [R] f32
    max_nodes: int,
    node_cap=None,                 # int or i32 scalar tensor, <= max_nodes
) -> BinpackResult:
    """Single-group FFD: score-sort descending, first-fit over open nodes
    in open order, open a new node when none fit, skip pods that fit no
    empty template node. ``max_nodes`` is the carry size; ``node_cap`` the
    dynamic cap."""
    dev = pod_req.device
    P, R = pod_req.shape
    cap = torch.as_tensor(
        max_nodes if node_cap is None else node_cap, dtype=torch.int32, device=dev
    )
    cap = torch.clamp(cap, max=max_nodes)
    order = torch.sort(-ffd_scores(pod_req, template_alloc), stable=True).indices
    sorted_req = pod_req[order]
    sorted_mask = pod_mask[order]
    node_ids = torch.arange(max_nodes, dtype=torch.int32, device=dev)
    used = torch.zeros((max_nodes, R), dtype=torch.float32, device=dev)
    opened = torch.zeros((), dtype=torch.int32, device=dev)
    fits_empty_all = (sorted_req <= template_alloc[None, :]).all(dim=1)
    placed = []
    for s in range(P):
        req = sorted_req[s]
        free = template_alloc[None, :] - used
        fits = (req[None, :] <= free).all(dim=1) & (node_ids < opened)
        has_fit = fits.any()
        first = torch.argmax(fits.to(torch.int32)).to(torch.int32)
        can_open = (opened < cap) & fits_empty_all[s]
        place = sorted_mask[s] & (has_fit | can_open)
        target = torch.where(has_fit, first, opened)
        hit = (node_ids == target) & place
        used = used + torch.where(hit[:, None], req[None, :], 0.0)
        opened = opened + (place & ~has_fit).to(torch.int32)
        placed.append(place)
    placed_sorted = (
        torch.stack(placed) if placed else torch.zeros((0,), dtype=torch.bool, device=dev)
    )
    scheduled = torch.zeros((P,), dtype=torch.bool, device=dev)
    scheduled[order] = placed_sorted
    return BinpackResult(node_count=opened, scheduled=scheduled, node_used=used)


def ffd_binpack_groups(
    pod_req: torch.Tensor,          # [P, R] f32 shared pending-pod matrix
    pod_masks: torch.Tensor,        # [G, P] bool per-group schedulability
    template_allocs: torch.Tensor,  # [G, R] f32
    max_nodes: int,
    node_caps: Optional[torch.Tensor] = None,  # [G] i32
) -> BinpackResult:
    """All node groups at once: the per-pod loop of ffd_binpack vectorized
    over the group axis, with a usage carry [G, R, M]. Returns [G]-leading
    results."""
    dev = pod_req.device
    P, R = pod_req.shape
    G = pod_masks.shape[0]
    caps = _caps(node_caps, G, max_nodes, dev)
    order = score_order(pod_req, template_allocs)                  # [G, P]
    sorted_mask = torch.gather(pod_masks, 1, order)                 # [G, P]
    alloc_t = template_allocs[:, :, None]                           # [G, R, 1]
    node_ids = torch.arange(max_nodes, dtype=torch.int32, device=dev)
    used_t = torch.zeros((G, R, max_nodes), dtype=torch.float32, device=dev)
    opened = torch.zeros((G,), dtype=torch.int32, device=dev)
    placed = torch.zeros((G, P), dtype=torch.bool, device=dev)
    for s in range(P):
        req = pod_req[order[:, s]]                                  # [G, R]
        free_t = alloc_t - used_t
        fits_n = (req[:, :, None] <= free_t).all(dim=1)             # [G, M]
        fits_n &= node_ids[None, :] < opened[:, None]
        has_fit = fits_n.any(dim=1)
        first = torch.argmax(fits_n.to(torch.int32), dim=1).to(torch.int32)
        fits_empty = (req <= template_allocs).all(dim=1)
        can_open = (opened < caps) & fits_empty
        place = sorted_mask[:, s] & (has_fit | can_open)
        target = torch.where(has_fit, first, opened)
        onehot = ((node_ids[None, :] == target[:, None]) & place[:, None]).to(
            torch.float32
        )
        used_t = used_t + req[:, :, None] * onehot[:, None, :]
        opened = opened + (place & ~has_fit).to(torch.int32)
        placed[:, s] = place
    scheduled = torch.zeros((G, P), dtype=torch.bool, device=dev)
    scheduled.scatter_(1, order, placed)
    return BinpackResult(
        node_count=opened,
        scheduled=scheduled,
        node_used=used_t.transpose(1, 2).contiguous(),              # [G, M, R]
    )


def _max_fit(q: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """[G, M] f32 — max k with k*q <= free elementwise over resources, exact
    under f32 multiply via floor-division + a ±1-ulp correction pass (the
    quotient may round up across an integer; the correction restores
    ``k*q <= free`` exactly as the per-pod scan would judge it)."""
    pos = q > 0                                                     # [G, R]
    safe_q = torch.where(pos, q, 1.0)
    per = torch.where(
        pos[:, :, None], torch.floor(free / safe_q[:, :, None]), float(2**30)
    )
    cnt = torch.clamp(per.amin(dim=1), min=0.0)                     # [G, M]

    def fits_k(k):
        return (k[:, None, :] * q[:, :, None] <= free).all(dim=1)

    cnt = torch.where(fits_k(cnt), cnt, torch.clamp(cnt - 1, min=0.0))
    return torch.where(fits_k(cnt + 1), cnt + 1, cnt)


def ffd_binpack_groups_runs(
    run_req: torch.Tensor,          # [U, R] f32 unique pod-requirement rows
    run_counts: torch.Tensor,       # [U] i32 — identical pods per run
    run_masks: torch.Tensor,        # [G, U] bool
    template_allocs: torch.Tensor,  # [G, R] f32
    max_nodes: int,
    node_caps: Optional[torch.Tensor] = None,  # [G] i32
) -> RunBinpackResult:
    """FFD over equivalence runs: one loop step per unique pod type. For
    identical pods the first-fit index is monotone within the run, so a run
    places as a greedy fill of nodes in open order: per-node capacity
    counts, one cumulative sum in node order, a clip against the run's
    remaining count. New nodes continue the cumsum with the empty-template
    capacity, bounded by the group cap."""
    dev = run_req.device
    U, R = run_req.shape
    G = run_masks.shape[0]
    caps = _caps(node_caps, G, max_nodes, dev)
    order = score_order(run_req, template_allocs)                   # [G, U]
    sorted_mask = torch.gather(run_masks, 1, order)
    alloc_t = template_allocs[:, :, None]                           # [G, R, 1]
    node_ids = torch.arange(max_nodes, dtype=torch.int32, device=dev)
    counts_f = run_counts.to(torch.float32)
    used_t = torch.zeros((G, R, max_nodes), dtype=torch.float32, device=dev)
    opened = torch.zeros((G,), dtype=torch.int32, device=dev)
    placed = torch.zeros((G, U), dtype=torch.float32, device=dev)
    for s in range(U):
        idx = order[:, s]
        q = run_req[idx]                                            # [G, R]
        c = torch.where(sorted_mask[:, s], counts_f[idx], 0.0)      # [G]
        free_t = alloc_t - used_t
        cnt_open = _max_fit(q, free_t)                              # [G, M]
        per_new = _max_fit(q, alloc_t)[:, 0]                        # [G]
        fits_empty = (q <= template_allocs).all(dim=1)
        open_mask = node_ids[None, :] < opened[:, None]
        new_mask = ~open_mask & (node_ids[None, :] < caps[:, None])
        capvec = torch.where(open_mask, cnt_open, 0.0) + torch.where(
            new_mask & fits_empty[:, None], per_new[:, None], 0.0
        )                                                           # [G, M]
        prefix = torch.cumsum(capvec, dim=1)
        take = torch.minimum(
            torch.clamp(c[:, None] - (prefix - capvec), min=0.0), capvec
        )
        used_t = _fma_update(used_t, q, take)
        newly = (take > 0) & new_mask
        high = torch.where(newly, node_ids[None, :] + 1, 0).amax(dim=1).to(torch.int32)
        opened = torch.maximum(opened, high)
        placed[:, s] = take.sum(dim=1)
    placed_counts = torch.zeros((G, U), dtype=torch.int32, device=dev)
    placed_counts.scatter_(1, order, placed.to(torch.int32))
    return RunBinpackResult(
        node_count=opened,
        placed_counts=placed_counts,
        node_used=used_t.transpose(1, 2).contiguous(),
    )


def _fma_update(used_t: torch.Tensor, q: torch.Tensor, take: torch.Tensor) -> torch.Tensor:
    """used_t + q ⊗ take with ONE rounding, as XLA's fused multiply-add
    gives the JAX run scans: the product of an f32 by a count is exact in
    f64, and so is its sum with an f32 whose exponent lies within 28 binary
    orders of it."""
    return (
        used_t.double() + q.double()[:, :, None] * take.double()[:, None, :]
    ).float()


def _spread_state_init(G: int, S: int, max_nodes: int, device):
    return (
        torch.zeros((G, S, max_nodes), dtype=torch.int32, device=device),  # spc: per-node scan counts
        torch.zeros((G, S), dtype=torch.int32, device=device),             # spc_tot: group scan counts
    )


def _spread_gates(sp, spc, spc_tot, idx, opened, node_ids):
    """Within-wave topology-spread gating → (group_ok [G], node_ok [G, M],
    upd [G, S]).

    Group-level terms: every new node of a group shares the template's
    domain, so its count is static_count + scan placements; the global min
    is min(min over OTHER static domains, that count), with minDomains
    folded into a precomputed force_zero. One violated term blocks the
    whole group this step (both open-node placement and opening).

    Hostname-level terms: each opened node is a domain with its own scan
    count; the global min is min(static domain min, min over opened nodes),
    and minDomains compares against static domains + opened. A fresh node
    is a 0-count domain, so opening is never blocked by a hostname term."""
    (sp_of_T, sp_match_T, nl, skew, mind, has_label, st_count,
     min_others, st_min, st_domnum, force_zero) = sp
    sp_o = sp_of_T[idx]                                             # [G, S]
    sp_m = sp_match_T[idx]                                          # [G, S]
    self_i = sp_m.to(torch.int32)
    # group-level; the XLA form of the minDomains fold
    cnt = st_count + spc_tot                                        # [G, S]
    min_eff_z = torch.where(force_zero, 0, torch.minimum(min_others, cnt))
    bad_z = (
        sp_o & ~nl[None, :] & has_label
        & (cnt + self_i - min_eff_z > skew[None, :])
    )
    group_ok = ~bad_z.any(dim=1)                                    # [G]
    # hostname-level
    open_m = node_ids[None, None, :] < opened[:, None, None]        # [G, 1, M]
    dyn_min = torch.where(open_m, spc, BIG_I32).amin(dim=2)         # [G, S]
    domnum = st_domnum + opened[:, None]                            # [G, S]
    min_eff_h = torch.where(
        mind[None, :] > domnum, 0, torch.minimum(st_min, dyn_min)
    )
    bad_h = (
        sp_o[:, :, None] & nl[None, :, None]
        & (spc + self_i[:, :, None] - min_eff_h[:, :, None] > skew[None, :, None])
    )
    node_ok = ~bad_h.any(dim=1)                                     # [G, M]
    upd = sp_m & has_label   # placements on keyless templates never count
    return group_ok, node_ok, upd


def _affinity_node_gates(m_p, a_p, x_p, pm, pm_tot, ha, ha_tot, nl, has_label):
    """Dynamic-affinity gating → (gate_open [G, M], new_ok [G]): which open
    nodes admit the candidate pod term-wise, and whether it may seed a
    fresh node. A hostname-level term's domain is the node, any other the
    whole group. A node without the term's topology label has no domain
    there, so an anti term over it can never be violated: hence the
    has_label gate on both anti directions. ``self_seed`` is the Kubernetes
    self-match rule: a pod matching its own required affinity term may open
    a fresh domain while no scan-placed pod matches the term."""
    dom_pm = torch.where(nl[None, :, None], pm, pm_tot[:, :, None])   # [G, T, M]
    dom_ha = torch.where(nl[None, :, None], ha, ha_tot[:, :, None])
    self_seed = m_p & (pm_tot == 0)                                 # [G, T]
    hl = has_label[:, :, None]
    ok_t = ~a_p[:, :, None] | (hl & ((dom_pm > 0) | self_seed[:, :, None]))
    aff_ok = ok_t.all(dim=1)                                        # [G, M]
    anti_blocked = (x_p[:, :, None] & (dom_pm > 0) & hl).any(dim=1)
    sym_blocked = (m_p[:, :, None] & (dom_ha > 0) & hl).any(dim=1)
    gate_open = aff_ok & ~anti_blocked & ~sym_blocked
    ok_new_t = ~a_p | torch.where(
        nl[None, :], self_seed, has_label & ((pm_tot > 0) | self_seed)
    )
    new_ok = ok_new_t.all(dim=1)
    new_ok &= ~(x_p & ~nl[None, :] & (pm_tot > 0) & has_label).any(dim=1)
    new_ok &= ~(m_p & ~nl[None, :] & (ha_tot > 0) & has_label).any(dim=1)
    return gate_open, new_ok


def _term_state_init(G: int, T: int, max_nodes: int, device):
    """(pm [G, T, M], pm_tot [G, T], ha [G, T, M], ha_tot [G, T]) i32:
    scan-placed pods matching term t, and pods holding anti term t, per new
    node and per group."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)  # noqa: E731
    return z(G, T, max_nodes), z(G, T), z(G, T, max_nodes), z(G, T)


def ffd_binpack_groups_runs_affinity(
    run_req: torch.Tensor,          # [U, R] f32 unique pod-requirement rows
    run_counts: torch.Tensor,       # [U] i32 — identical pods per run
    run_masks: torch.Tensor,        # [G, U] bool
    template_allocs: torch.Tensor,  # [G, R] f32
    max_nodes: int,
    involved: torch.Tensor,         # [U] bool — run touches any term
    match: torch.Tensor,            # [T, U] bool — term selector matches run
    aff_of: torch.Tensor,           # [T, U] bool — run requires affinity term
    anti_of: torch.Tensor,          # [T, U] bool — run requires anti term
    node_level: torch.Tensor,       # [T] bool — hostname-level topology
    has_label: torch.Tensor,        # [G, T] bool — template has the topology label
    node_caps: Optional[torch.Tensor] = None,  # [G] i32
    spread: Optional[tuple] = None,  # the 11-tensor spread tuple
) -> RunBinpackResult:
    """Equivalence-run FFD that coexists with dynamic inter-pod affinity. A
    run with no term involvement collapses into one greedy-fill step as in
    ffd_binpack_groups_runs; an involved run, pre-expanded by the caller
    into singleton runs, steps through the full affinity-gated placement of
    ffd_binpack_groups_affinity. Both paths are computed each step and
    selected per group by ``involved[idx]``."""
    dev = run_req.device
    U, R = run_req.shape
    G = run_masks.shape[0]
    T = match.shape[0]
    caps = _caps(node_caps, G, max_nodes, dev)
    order = score_order(run_req, template_allocs)                   # [G, U]
    sorted_mask = torch.gather(run_masks, 1, order)
    alloc_t = template_allocs[:, :, None]                           # [G, R, 1]
    node_ids = torch.arange(max_nodes, dtype=torch.int32, device=dev)
    counts_f = run_counts.to(torch.float32)
    match_t, aff_t, anti_t = match.T, aff_of.T, anti_of.T           # [U, T]
    S = spread[2].shape[0] if spread is not None else 0
    used_t = torch.zeros((G, R, max_nodes), dtype=torch.float32, device=dev)
    opened = torch.zeros((G,), dtype=torch.int32, device=dev)
    pm, pm_tot, ha, ha_tot = _term_state_init(G, T, max_nodes, dev)
    spc, spc_tot = _spread_state_init(G, S, max_nodes, dev)
    placed = torch.zeros((G, U), dtype=torch.float32, device=dev)
    for s in range(U):
        idx = order[:, s]
        active = sorted_mask[:, s]
        q = run_req[idx]                                            # [G, R]
        inv = involved[idx]                                         # [G]
        c = torch.where(active, counts_f[idx], 0.0)                 # [G]
        m_p, a_p, x_p = match_t[idx], aff_t[idx], anti_t[idx]       # [G, T]
        free_t = alloc_t - used_t
        fits_empty = (q <= template_allocs).all(dim=1)              # [G]
        open_mask = node_ids[None, :] < opened[:, None]             # [G, M]

        # path A: plain greedy run fill (involved groups contribute zero)
        cnt_open = _max_fit(q, free_t)                              # [G, M]
        per_new = _max_fit(q, alloc_t)[:, 0]                        # [G]
        new_mask = ~open_mask & (node_ids[None, :] < caps[:, None])
        capvec = torch.where(open_mask, cnt_open, 0.0) + torch.where(
            new_mask & fits_empty[:, None], per_new[:, None], 0.0
        )
        prefix = torch.cumsum(capvec, dim=1)
        c_a = torch.where(inv, 0.0, c)
        take_a = torch.minimum(
            torch.clamp(c_a[:, None] - (prefix - capvec), min=0.0), capvec
        )
        high_a = torch.where(
            (take_a > 0) & new_mask, node_ids[None, :] + 1, 0
        ).amax(dim=1).to(torch.int32)

        # path B: affinity-gated single placement (plain groups contribute 0)
        fits_n = (q[:, :, None] <= free_t).all(dim=1) & open_mask
        gate_open, new_ok = _affinity_node_gates(
            m_p, a_p, x_p, pm, pm_tot, ha, ha_tot, node_level, has_label
        )
        fits_b = fits_n & gate_open
        if spread is not None:
            sp_group_ok, sp_node_ok, sp_upd = _spread_gates(
                spread, spc, spc_tot, idx, opened, node_ids
            )
            fits_b &= sp_node_ok & sp_group_ok[:, None]
            new_ok &= sp_group_ok
        has_fit = fits_b.any(dim=1)
        first = torch.argmax(fits_b.to(torch.int32), dim=1).to(torch.int32)
        can_open = (opened < caps) & fits_empty & new_ok
        place_b = active & inv & (c > 0) & (has_fit | can_open)
        target = torch.where(has_fit, first, opened)
        onehot_b = (node_ids[None, :] == target[:, None]) & place_b[:, None]

        # combine: A and B are disjoint per group through the inv gate
        take = take_a + onehot_b.to(torch.float32)
        used_t = _fma_update(used_t, q, take)
        opened_b = opened + (place_b & ~has_fit).to(torch.int32)
        opened = torch.maximum(opened_b, high_a)
        inc = onehot_b[:, None, :]
        pm = pm + (m_p[:, :, None] & inc).to(torch.int32)
        ha = ha + (x_p[:, :, None] & inc).to(torch.int32)
        pm_tot = pm_tot + (m_p & place_b[:, None]).to(torch.int32)
        ha_tot = ha_tot + (x_p & place_b[:, None]).to(torch.int32)
        if spread is not None:
            spc = spc + (sp_upd[:, :, None] & inc).to(torch.int32)
            spc_tot = spc_tot + (sp_upd & place_b[:, None]).to(torch.int32)
        placed[:, s] = take.sum(dim=1)
    placed_counts = torch.zeros((G, U), dtype=torch.int32, device=dev)
    placed_counts.scatter_(1, order, placed.to(torch.int32))
    return RunBinpackResult(
        node_count=opened,
        placed_counts=placed_counts,
        node_used=used_t.transpose(1, 2).contiguous(),
    )


def ffd_binpack_groups_affinity(
    pod_req: torch.Tensor,          # [P, R] f32 shared pending-pod matrix
    pod_masks: torch.Tensor,        # [G, P] bool static mask
    template_allocs: torch.Tensor,  # [G, R] f32
    max_nodes: int,
    match: torch.Tensor,            # [T, P] bool — term selector matches pod
    aff_of: torch.Tensor,           # [T, P] bool — pod requires affinity term
    anti_of: torch.Tensor,          # [T, P] bool — pod requires anti term
    node_level: torch.Tensor,       # [T] bool — hostname-level topology
    has_label: torch.Tensor,        # [G, T] bool — template has the topology label
    node_caps: Optional[torch.Tensor] = None,  # [G] i32
    spread: Optional[tuple] = None,  # the 11-tensor spread tuple
) -> BinpackResult:
    """FFD scan with *dynamic* inter-pod (anti-)affinity and hard topology
    spread: pods placed during the scan constrain later pods, as the
    reference's per-placement filter re-run does. The carry adds per-term
    placement counts (``pm``: pods matching term t on new node m; ``ha``:
    pods holding anti term t on m, for the symmetric rule; group totals)
    and, with ``spread``, per-term spread counts. The static mask handles
    terms vs pods already in the cluster."""
    dev = pod_req.device
    P, R = pod_req.shape
    G = pod_masks.shape[0]
    T = match.shape[0]
    caps = _caps(node_caps, G, max_nodes, dev)
    order = score_order(pod_req, template_allocs)                   # [G, P]
    sorted_mask = torch.gather(pod_masks, 1, order)                 # [G, P]
    alloc_t = template_allocs[:, :, None]                           # [G, R, 1]
    node_ids = torch.arange(max_nodes, dtype=torch.int32, device=dev)
    match_t, aff_t, anti_t = match.T, aff_of.T, anti_of.T           # [P, T]
    S = spread[2].shape[0] if spread is not None else 0
    used_t = torch.zeros((G, R, max_nodes), dtype=torch.float32, device=dev)
    opened = torch.zeros((G,), dtype=torch.int32, device=dev)
    pm, pm_tot, ha, ha_tot = _term_state_init(G, T, max_nodes, dev)
    spc, spc_tot = _spread_state_init(G, S, max_nodes, dev)
    placed = torch.zeros((G, P), dtype=torch.bool, device=dev)
    for s in range(P):
        idx = order[:, s]
        active = sorted_mask[:, s]
        req = pod_req[idx]                                          # [G, R]
        m_p, a_p, x_p = match_t[idx], aff_t[idx], anti_t[idx]       # [G, T]
        free_t = alloc_t - used_t
        fits_n = (req[:, :, None] <= free_t).all(dim=1)             # [G, M]
        fits_n &= node_ids[None, :] < opened[:, None]
        gate_open, new_ok = _affinity_node_gates(
            m_p, a_p, x_p, pm, pm_tot, ha, ha_tot, node_level, has_label
        )
        fits_n &= gate_open
        if spread is not None:
            sp_group_ok, sp_node_ok, sp_upd = _spread_gates(
                spread, spc, spc_tot, idx, opened, node_ids
            )
            fits_n &= sp_node_ok & sp_group_ok[:, None]
            new_ok &= sp_group_ok
        has_fit = fits_n.any(dim=1)
        first = torch.argmax(fits_n.to(torch.int32), dim=1).to(torch.int32)
        fits_empty = (req <= template_allocs).all(dim=1)
        can_open = (opened < caps) & fits_empty & new_ok
        place = active & (has_fit | can_open)
        target = torch.where(has_fit, first, opened)                # [G]
        onehot_b = (node_ids[None, :] == target[:, None]) & place[:, None]
        used_t = used_t + req[:, :, None] * onehot_b.to(torch.float32)[:, None, :]
        opened = opened + (place & ~has_fit).to(torch.int32)
        inc = onehot_b[:, None, :]                                  # [G, 1, M]
        pm = pm + (m_p[:, :, None] & inc).to(torch.int32)
        ha = ha + (x_p[:, :, None] & inc).to(torch.int32)
        pm_tot = pm_tot + (m_p & place[:, None]).to(torch.int32)
        ha_tot = ha_tot + (x_p & place[:, None]).to(torch.int32)
        if spread is not None:
            spc = spc + (sp_upd[:, :, None] & inc).to(torch.int32)
            spc_tot = spc_tot + (sp_upd & place[:, None]).to(torch.int32)
        placed[:, s] = place
    scheduled = torch.zeros((G, P), dtype=torch.bool, device=dev)
    scheduled.scatter_(1, order, placed)
    return BinpackResult(
        node_count=opened,
        scheduled=scheduled,
        node_used=used_t.transpose(1, 2).contiguous(),
    )
