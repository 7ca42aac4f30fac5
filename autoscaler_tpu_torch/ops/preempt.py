"""Priority-aware eviction packing — the ``ffd_binpack_preempt`` family, the
port of ``autoscaler_tpu/ops/preempt.py``.

Reference semantics: the CA itself never evicts for priority — preemption
lives in the scheduler (pkg/scheduler/framework/preemption) — but its
PriorityClass/preemptionPolicy model is the contract this pass mirrors:
a pending pod whose preemptionPolicy is not Never may displace strictly-
lower-priority running pods when no node fits it outright, and victims are
chosen to minimize preemption cost. The pass packs the pending pods against
the EXISTING node set (scale-up still owns capacity growth): it answers
"what could be admitted onto the cluster as-is, and at what eviction cost".

Victim selection is the closed greedy spec of the serial oracle
(``estimator/reference_impl.ffd_binpack_preempt_reference``): per candidate
node, victims are taken in global (priority asc, pod row asc) order until
the pod fits — the minimal such prefix — and the node is chosen by
lexicographic (victim count, aggregate victim priority, node row).

The JAX package runs one ``lax.scan`` over all P pods whose step builds
[P, N, R] tensors (O(P²·N·R) in all). Here:

- ``ffd_binpack_preempt`` (the main path, on the CPU and the card) steps
  only over the pending rows, in the packing order (priority desc, FFD
  score desc, row asc); the scan's other steps are no-ops. A resident sits
  on one node and a node's cumulative freed capacity only grows at its own
  candidates, so the minimal prefix comes from a per-node prefix over the
  node's evictable residents in victim order: they are laid out once as
  [N, K] slots (K the most evictable residents on one node), and a step is
  the direct first fit over [N], the candidate filter and a cumulative sum
  over [N, K, R], each node's minimal fitting prefix with its victim count
  and aggregate priority, and the lexicographic choice — linear in N·K, no
  [P, N] mask (a chunk of ``sched_rows`` at a time) and no host round trip
  (on a card a chunk of ``CHUNK`` steps is captured once as a CUDA graph
  and replayed);
- ``ffd_binpack_preempt_plain`` is the scan's step written out in torch,
  [P, N, R] and all, for small worlds only (the tests and chip_smoke hold
  the main path against it).

Capacity arithmetic is float64 in both: requests, allocatable and usage
are f32 values that are integers (millicores, bytes, counts), so in f64
every difference, per-node prefix and update is exact in any summation
order, on the CPU and the card alike, and the fit tests are those of the
oracle, which keeps its usage in f64. The XLA scan keeps them in f32: its
cumulative sum is a blocked tree (XLA:CPU rewrites it into 16-element
blocks, and the freed sum into 32-element blocks, with a nesting that
depends on P), so where an f32 sum rounds a fit test can differ from the
exact one; ROADMAP queue 3 holds what the parity tests found.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from autoscaler_tpu_torch.ops.binpack import ffd_scores
from autoscaler_tpu_torch.ops.telemetry import observed

# "worse than any real cost" sentinel in the node-selection tie-break chain
_COST_INF = 2**30
CHUNK = 64  # steps whose read-only operands are gathered at once (one CUDA graph)

# Machine-readable kernel contracts (graftlint GL007). The P axis carries
# ALL pods — pending (pod_node < 0), resident, padding — so victim rows and
# evictor rows index one shared space. ``sched_mask`` is a [P, N] bool
# tensor or a ``SchedRows`` (the rows of a snapshot's mask in either form).
KERNEL_CONTRACTS = {
    "ffd_binpack_preempt": {
        "args": {
            "pod_req": {"dims": ["P", "R"], "dtype": "f32"},
            "pod_valid": {"dims": ["P"], "dtype": "bool"},
            "pod_node": {"dims": ["P"], "dtype": "i32"},
            "pod_priority": {"dims": ["P"], "dtype": "i32"},
            "pod_can_preempt": {"dims": ["P"], "dtype": "bool"},
            "pod_evictable": {"dims": ["P"], "dtype": "bool"},
            "node_alloc": {"dims": ["N", "R"], "dtype": "f32"},
            "node_used": {"dims": ["N", "R"], "dtype": "f32"},
            "node_valid": {"dims": ["N"], "dtype": "bool"},
            "sched_mask": {"dims": ["P", "N"], "dtype": "bool"},
        },
        "notes": "a torch loop over the pending rows, O(N·K·R) a step; "
                 "no hand kernel",
    },
}


class PreemptResult(NamedTuple):
    scheduled: torch.Tensor    # [P] bool — pending pod admitted (direct or evicting)
    placed_node: torch.Tensor  # [P] i32 — node row it landed on, -1 otherwise
    victim_of: torch.Tensor    # [P] i32 — evictor's pod row, -1 = not evicted


class SchedRows:
    """The [P, N] predicate mask of a ``SnapshotTensors`` as rows on demand
    (``rows(idx)`` → [S, N] bool through ``sched_rows``, in either mask
    form), so the pass never expands the dense mask. ``shape``, ``dtype``
    and ``nbytes`` are the dense mask's: what the perf observatory's
    signature and operand bytes count for this operand in either
    package."""

    def __init__(self, tensors):
        self.tensors = tensors
        self.shape = (tensors.num_pods, tensors.num_nodes)
        self.dtype = torch.bool
        self.nbytes = self.shape[0] * self.shape[1]

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        return self.tensors.sched_rows(idx)


def _rows_of(sched_mask):
    if isinstance(sched_mask, SchedRows):
        return sched_mask.rows
    return lambda idx: sched_mask.index_select(0, idx)


def packing_order(pod_req, pod_priority, node_alloc, node_valid) -> torch.Tensor:
    """[P] int64: priority desc, then the FFD score against the elementwise
    max valid allocatable row desc, then row asc (stable sorts), as the XLA
    scan orders its steps."""
    cap_row = torch.where(node_valid[:, None], node_alloc, 0.0).amax(dim=0)
    score = ffd_scores(pod_req, cap_row)
    sorder = torch.sort(-score, stable=True).indices
    return sorder[torch.sort(-pod_priority[sorder], stable=True).indices]


def _empty_result(P: int, dev) -> PreemptResult:
    return PreemptResult(
        scheduled=torch.zeros(P, dtype=torch.bool, device=dev),
        placed_node=torch.full((P,), -1, dtype=torch.int32, device=dev),
        victim_of=torch.full((P,), -1, dtype=torch.int32, device=dev),
    )


class _Loop:
    """The pass's carry (usage, the residents' liveness, victim_of) and the
    fixed buffers of one chunk's read-only operands; ``step(j)`` is step j
    of the loaded chunk."""

    def __init__(self, pod_req, pod_valid, pod_node, pod_priority, pod_evictable,
                 node_alloc, node_used, node_valid, rows_of, C: int):
        dev = pod_req.device
        P, R = pod_req.shape
        N = node_alloc.shape[0]
        self.P, self.rows_of = P, rows_of
        self.alloc = node_alloc.double()
        self.used = node_used.double()
        self.node_valid = node_valid
        # the evictable residents in (node, priority asc, row asc) order —
        # the per-node victim order — laid out as [N, K] slots
        vpos = torch.empty(P, dtype=torch.int64, device=dev)
        vpos[torch.sort(pod_priority, stable=True).indices] = torch.arange(P, device=dev)
        res = pod_valid & (pod_node >= 0) & pod_evictable
        e_rows = torch.nonzero(res).flatten()
        e_node = pod_node[e_rows].long()
        e_rows = e_rows[torch.sort(e_node * P + vpos[e_rows]).indices]
        e_node = pod_node[e_rows].long()
        count = torch.bincount(e_node, minlength=N)
        K = max(int(count.max()) if e_rows.numel() else 0, 1)
        start = torch.cumsum(count, 0) - count
        slot = torch.arange(e_rows.numel(), device=dev) - start[e_node]
        self.slots = torch.arange(K, device=dev)[None, :]                # [1, K]
        self.req_nk = torch.zeros((N, K, R), dtype=torch.float64, device=dev)
        self.req_nk[e_node, slot] = pod_req[e_rows].double()
        self.prio_nk = torch.full((N, K), 2**62, dtype=torch.int64, device=dev)
        self.prio_nk[e_node, slot] = pod_priority[e_rows].long()
        self.row_nk = torch.full((N, K), P, dtype=torch.int64, device=dev)
        self.row_nk[e_node, slot] = e_rows
        self.alive = torch.zeros((N, K), dtype=torch.bool, device=dev)
        self.alive[e_node, slot] = True
        self.victim_of = torch.full((P + 1,), -1, dtype=torch.int32, device=dev)  # [P] drops
        self.K = K
        # one chunk's read-only operands and its outputs
        self.row = torch.zeros(C, dtype=torch.int32, device=dev)
        self.req = torch.zeros((C, R), dtype=torch.float64, device=dev)
        self.prio = torch.zeros(C, dtype=torch.int64, device=dev)
        self.canp = torch.zeros(C, dtype=torch.bool, device=dev)
        self.ok = torch.zeros((C, N), dtype=torch.bool, device=dev)
        self.place = torch.zeros(C, dtype=torch.bool, device=dev)
        self.target = torch.zeros(C, dtype=torch.int64, device=dev)

    def load(self, steps, pod_req, pod_priority, pod_can_preempt) -> None:
        n = steps.shape[0]
        self.row[:n] = steps.to(torch.int32)
        self.req[:n] = pod_req.index_select(0, steps).double()
        self.prio[:n] = pod_priority.index_select(0, steps).long()
        self.canp[:n] = pod_can_preempt.index_select(0, steps)
        self.ok[:n] = self.rows_of(steps) & self.node_valid

    def step(self, j: int) -> None:
        req, ok = self.req[j], self.ok[j]
        free = self.alloc - self.used                                   # [N, R]
        fits = ok & (req <= free).all(dim=1)
        any_direct, direct_n = fits.view(torch.uint8).max(dim=0)        # lowest row
        # candidates: alive evictable residents of strictly lower priority;
        # each node's cumulative freed capacity in victim order
        cand = self.alive & (self.prio_nk < self.prio[j])               # [N, K]
        cum = torch.where(cand[:, :, None], self.req_nk, 0.0).cumsum(dim=1)
        fit_k = cand & (req <= free[:, None, :] + cum).all(dim=2)       # [N, K]
        cap_ok = ok & (req <= self.alloc).all(dim=1)
        any_k, k_min = fit_k.view(torch.uint8).max(dim=1)               # minimal prefix
        feasible = cap_ok & (any_k > 0)
        vict = cand & (self.slots <= k_min[:, None])                    # [N, K]
        nvict = vict.sum(dim=1)
        aggprio = torch.where(vict, self.prio_nk, 0).sum(dim=1)
        # lexicographic (victim count, aggregate priority, node row) argmin
        key1 = torch.where(feasible, nvict, _COST_INF)
        t2 = feasible & (nvict == key1.min())
        key2 = torch.where(t2, aggprio, _COST_INF)
        t3 = t2 & (aggprio == key2.min())
        best = t3.view(torch.uint8).max(dim=0).indices.reshape(1)
        do_direct = any_direct > 0
        do_preempt = ~do_direct & self.canp[j] & feasible.any()
        place = do_direct | do_preempt
        target = torch.where(do_direct, direct_n, best[0])
        vm = vict.index_select(0, best)[0] & do_preempt                 # [K]
        freed = torch.where(vm[:, None], self.req_nk.index_select(0, best)[0], 0.0).sum(dim=0)
        delta = torch.where(place, req, 0.0) - torch.where(do_preempt, freed, 0.0)
        self.used.index_add_(0, target.reshape(1), delta[None, :])
        self.alive.index_copy_(0, best, self.alive.index_select(0, best) & ~vm[None, :])
        drop = torch.where(vm, self.row_nk.index_select(0, best)[0], self.P)
        self.victim_of.scatter_(0, drop, self.row[j:j + 1].expand(self.K))
        self.place[j] = place
        self.target[j] = target

    def capture(self) -> "torch.cuda.CUDAGraph":
        """One CUDA graph of a whole chunk's steps on the buffers (recorded,
        not run), on a side stream as capture requires. The capture holds
        only this thread to the capture rules (``thread_local``): other
        threads on the card (the gym's concurrent rollouts) keep running."""
        dev = self.used.device
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            for j in range(self.place.shape[0]):
                self.step(j)
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        return graph


@observed
def ffd_binpack_preempt(
    pod_req: torch.Tensor,          # [P, R] f32 — ALL pods (pending + resident)
    pod_valid: torch.Tensor,        # [P] bool
    pod_node: torch.Tensor,         # [P] i32 — resident's node row, -1 pending
    pod_priority: torch.Tensor,     # [P] i32
    pod_can_preempt: torch.Tensor,  # [P] bool — pending: policy != Never
    pod_evictable: torch.Tensor,    # [P] bool — resident: may be a victim
    node_alloc: torch.Tensor,       # [N, R] f32
    node_used: torch.Tensor,        # [N, R] f32 — includes residents' requests
    node_valid: torch.Tensor,       # [N] bool
    sched_mask,                     # [P, N] bool, or SchedRows
) -> PreemptResult:
    """Pack pending pods onto the existing nodes in (priority desc, FFD
    score desc, pod row asc) order; a pod that fits nowhere directly may
    evict strictly-lower-priority residents per the victim spec above.
    Pods admitted this pass occupy capacity but are never victims. Runs on
    the operands' device; the host reads the pending rows' count once."""
    dev = pod_req.device
    P, N = pod_req.shape[0], node_alloc.shape[0]
    if P == 0 or N == 0:
        return _empty_result(P, dev)
    order = packing_order(pod_req, pod_priority, node_alloc, node_valid)
    pending = pod_valid & (pod_node < 0)
    steps = order[pending[order]]
    S = steps.shape[0]
    if S == 0:
        return _empty_result(P, dev)
    C = min(CHUNK, S)
    loop = _Loop(pod_req, pod_valid, pod_node, pod_priority, pod_evictable,
                 node_alloc, node_used, node_valid, _rows_of(sched_mask), C)
    place = torch.zeros(S, dtype=torch.bool, device=dev)
    target = torch.zeros(S, dtype=torch.int64, device=dev)
    graph = None
    for c0 in range(0, S, C):
        n = min(C, S - c0)
        loop.load(steps[c0:c0 + n], pod_req, pod_priority, pod_can_preempt)
        # on a card every full chunk after the first (which runs eagerly and
        # so loads every kernel before the capture) replays one graph
        if dev.type == "cuda" and n == C and c0 > 0:
            if graph is None:
                graph = loop.capture()
            graph.replay()
        else:
            for j in range(n):
                loop.step(j)
        place[c0:c0 + n] = loop.place[:n]
        target[c0:c0 + n] = loop.target[:n]
    res = _empty_result(P, dev)
    res.scheduled[steps] = place
    res.placed_node[steps] = torch.where(place, target, -1).to(torch.int32)
    return res._replace(victim_of=loop.victim_of[:P].clone())


def ffd_binpack_preempt_plain(
    pod_req, pod_valid, pod_node, pod_priority, pod_can_preempt, pod_evictable,
    node_alloc, node_used, node_valid, sched_mask,
) -> PreemptResult:
    """The XLA scan's step over all P pods in the packing order, written out
    in torch with its [P, N, R] cumulative freed capacity (capacity in f64,
    as the main path): the plain version, for small worlds only."""
    dev = pod_req.device
    P, N = pod_req.shape[0], node_alloc.shape[0]
    if P == 0 or N == 0:
        return _empty_result(P, dev)
    order = packing_order(pod_req, pod_priority, node_alloc, node_valid)
    vorder = torch.sort(pod_priority, stable=True).indices
    prio_sorted = pod_priority[vorder].long()
    req_sorted = pod_req[vorder].double()
    vnode_sorted = pod_node[vorder].long()
    evict_sorted = pod_evictable[vorder]
    node_ids = torch.arange(N, device=dev)
    positions = torch.arange(P, device=dev)
    alloc = node_alloc.double()
    req_all = pod_req.double()
    used = node_used.double().clone()
    alive = pod_valid & (pod_node >= 0)
    scheduled = torch.zeros(P, dtype=torch.bool, device=dev)
    placed = torch.full((P,), -1, dtype=torch.int32, device=dev)
    victim_of = torch.full((P,), -1, dtype=torch.int32, device=dev)
    for i in order.tolist():
        req = req_all[i]
        ok = sched_mask[i] & node_valid
        free = alloc - used
        fits = ok & (req[None, :] <= free).all(dim=1)
        has_direct = fits.any()
        direct_n = fits.view(torch.uint8).argmax()
        cand = alive[vorder] & evict_sorted & (prio_sorted < int(pod_priority[i]))
        onnode = (vnode_sorted[:, None] == node_ids[None, :]) & cand[:, None]
        contrib = torch.where(onnode[:, :, None], req_sorted[:, None, :], 0.0)
        cumfree = torch.cumsum(contrib, dim=0)                          # [P, N, R]
        cap_ok = ok & (req[None, :] <= alloc).all(dim=1)
        fit_k = cap_ok[None, :] & (req[None, None, :] <= free[None] + cumfree).all(dim=2)
        feasible = fit_k.any(dim=0)
        k_min = fit_k.view(torch.uint8).argmax(dim=0)
        vict = onnode & (positions[:, None] <= k_min[None, :])
        nvict = vict.sum(dim=0)
        aggprio = torch.where(vict, prio_sorted[:, None], 0).sum(dim=0)
        key1 = torch.where(feasible, nvict, _COST_INF)
        t2 = feasible & (nvict == key1.min())
        key2 = torch.where(t2, aggprio, _COST_INF)
        t3 = t2 & (aggprio == key2.min())
        best_n = t3.view(torch.uint8).argmax()
        is_pend = pod_valid[i] & (pod_node[i] < 0)
        do_direct = is_pend & has_direct
        do_preempt = is_pend & ~has_direct & pod_can_preempt[i] & feasible.any()
        place = do_direct | do_preempt
        target = torch.where(do_direct, direct_n, best_n)
        vict_orig = torch.zeros(P, dtype=torch.bool, device=dev)
        vict_orig[vorder] = vict[:, best_n]
        vict_orig &= do_preempt
        freed = torch.where(vict_orig[:, None], req_all, 0.0).sum(dim=0)
        delta = torch.where(place, req, 0.0) - torch.where(do_preempt, freed, 0.0)
        used[target] += delta
        alive &= ~vict_orig
        victim_of = torch.where(vict_orig, i, victim_of).to(torch.int32)
        scheduled[i] = place
        placed[i] = torch.where(place, target, -1).to(torch.int32)
    return PreemptResult(scheduled=scheduled, placed_node=placed, victim_of=victim_of)
