"""Greedy pod scheduling onto existing capacity, the hinting simulator's
loop on the device: the counterpart of ``autoscaler_tpu/ops/schedule.py``.

Reference: cluster-autoscaler/simulator/scheduling/hinting_simulator.go:58
(TrySchedulePods: per pod, try the hinted node first, then a full
FitsAnyNodeMatching scan), the engine behind the filter-out-schedulable
pod-list processor (core/podlistprocessor/filter_out_schedulable.go:46,95).

The JAX package runs one ``lax.scan`` over the pod list with the free
capacity (and the spread counts) in the carry. Here the scan is a torch
loop of K steps on the snapshot's device, a few small kernels a step:

- what a step reads but does not change (its request, its static
  predicate row with ``node_valid`` folded in, its hint, its spread
  rows) is gathered ``CHUNK`` steps at a time into fixed buffers;
- the spread gate works on the [S, D] domain counts and reaches the
  nodes through one gather (a node's verdict for a term depends only on
  its domain), and the first fit and "any fits" come from one ``max``;
- no step makes the host wait: every value stays a device tensor (no
  ``.item()``, no ``nonzero``, no Python branch on one), so on a card a
  whole chunk is captured once as a CUDA graph and replayed for every
  later full chunk, and the host reads the outputs once, after the loop.

Exactness against the XLA scan: the fit is the same compare and the free
update the same add (``free[target] += where(place, -req, 0)`` at
``target = max(dest, 0)`` even when nothing is placed, as XLA does, so
signed zeros match); the first fitting node is the first maximum of the
verdict read as uint8 (``argmax`` on bool in JAX); the spread arithmetic
is the same integer arithmetic regrouped; indices are int64 for
``index_select``/``gather`` and every output and count stays int32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from autoscaler_tpu_torch.snapshot.tensors import SnapshotTensors


class ScheduleResult(NamedTuple):
    placed: torch.Tensor   # [K] bool
    dest: torch.Tensor     # [K] i32 node index, -1 when not placed


BIG_I32 = 2**30   # "no valid domain" sentinel in the minimum over domains
CHUNK = 128       # steps whose read-only operands are gathered at once (one CUDA graph)


class _SpreadStatic(NamedTuple):
    """What the gate and the commit read of the 8-array context and never
    change: S terms, D domains, N node columns."""

    dom_valid: torch.Tensor    # [S, D] bool
    md_gt: torch.Tensor        # [S] bool: minDomains above the registered domains (min 0)
    skew: torch.Tensor         # [S, 1] i32
    node_slot: torch.Tensor    # [S, N] i64: s·(D+1) + the node's domain, or + D without one
    commit_slot: torch.Tensor  # [S, N] i64: s·D + domain on eligible nodes, else S·D (dropped)


def _spread_static(sp8) -> _SpreadStatic:
    (_sp_of_T, _sp_match_T, node_dom, sp_elig, dom_valid,
     skew, min_dom, domnum) = sp8
    S, D = dom_valid.shape
    rows = torch.arange(S, device=node_dom.device)[:, None]
    has_dom = node_dom >= 0
    dom = node_dom.long()
    return _SpreadStatic(
        dom_valid=dom_valid,
        md_gt=min_dom > domnum,
        skew=skew[:, None],
        node_slot=rows * (D + 1) + torch.where(has_dom, dom, D),
        commit_slot=torch.where(sp_elig & has_dom, rows * D + dom, S * D),
    )


def _gate_violations(st: _SpreadStatic, counts, o, m) -> torch.Tensor:
    """[N] bool: nodes where a term the pod declares (``o`` [S] bool) would
    exceed its skew. For a node in domain d of term s the reference checks
    ``cnt + m - min_eff <= skew`` with ``cnt`` the count of d when d is
    registered, else 0; a node without a domain fails every term it
    declares. So the verdict is computed once a (term, domain) and
    gathered to the nodes. ``m`` [S] i32: the pod matches the term."""
    minv = torch.where(st.dom_valid, counts, BIG_I32).amin(dim=1)
    min_eff = torch.where(st.md_gt, 0, minv)                       # [S]
    cnt = torch.where(st.dom_valid, counts, 0)                     # [S, D]
    bad = (cnt + (m - min_eff)[:, None]) > st.skew                 # [S, D]
    bad = torch.cat([bad & o[:, None], o[:, None]], dim=1)         # [S, D + 1]
    # the OR over terms as a max of bytes (a bool tensor read as uint8)
    return torch.take(bad.view(torch.uint8), st.node_slot).amax(dim=0).view(torch.bool)


def _commit(st: _SpreadStatic, counts_flat, m, place, target) -> None:
    """A placed pod raises, for every term it matches, the count of the
    target's domain when the target is eligible for the term
    (countPodsMatchSelector runs over eligible nodes); ``counts_flat`` is
    the [S·D + 1] count buffer, the last slot taking what is dropped."""
    slot = st.commit_slot.index_select(1, target)[:, 0]           # [S]
    counts_flat.index_add_(0, slot, torch.where(place, m, 0))


def spread_gate(sp8, counts: torch.Tensor, safe_idx: torch.Tensor):
    """The within-wave topology-spread gate over existing nodes →
    (node_ok [N] bool, m [S] bool). ``sp8`` is the 8-array context
    (``snapshot/affinity.build_spread_schedule_context`` without the static
    counts, which travel in ``counts``); ``safe_idx`` is the pod's row as
    a [1] int64 device tensor."""
    o = sp8[0].index_select(0, safe_idx)[0]                        # [S]
    m = sp8[1].index_select(0, safe_idx)[0]                        # [S]
    viol = _gate_violations(_spread_static(sp8), counts, o, m.to(torch.int32))
    return ~viol, m


def spread_commit(sp8, counts, m, place, target):
    """The count update after a placement, as a new [S, D] count tensor.
    ``m`` [S] bool, ``place`` a [1] bool and ``target`` a [1] int64 node
    index, all on the device."""
    S, D = counts.shape
    flat = torch.cat([counts.reshape(-1), counts.new_zeros(1)])
    _commit(_spread_static(sp8), flat, m.to(torch.int32), place, target)
    return flat[: S * D].view(S, D)


def spread_gate_lanes(st: _SpreadStatic, counts, o, m) -> torch.Tensor:
    """The gate of ``_gate_violations`` for L independent lanes at once,
    one pod a lane: ``counts`` [L, S, D] i32 (a lane's own carry), ``o``
    [L, S] bool and ``m`` [L, S] i32 its pod's declared and matched terms
    → [L, N] bool, True where a term the lane's pod declares would exceed
    its skew. The same integer arithmetic, term by domain, gathered to the
    nodes through ``st.node_slot``."""
    L, S, D = counts.shape
    minv = torch.where(st.dom_valid, counts, BIG_I32).amin(dim=2)      # [L, S]
    min_eff = torch.where(st.md_gt, 0, minv)
    cnt = torch.where(st.dom_valid, counts, 0)                         # [L, S, D]
    bad = (cnt + (m - min_eff)[:, :, None]) > st.skew[None]
    bad = torch.cat([bad & o[:, :, None], o[:, :, None]], dim=2)       # [L, S, D + 1]
    flat = bad.view(torch.uint8).reshape(L, S * (D + 1))
    N = st.node_slot.shape[1]
    hit = torch.gather(flat, 1, st.node_slot.reshape(1, S * N).expand(L, S * N))
    return hit.view(L, S, N).amax(dim=1).view(torch.bool)


def spread_commit_lanes(st: _SpreadStatic, counts_flat, m, place, target) -> None:
    """``_commit`` for L lanes: lane l's placed pod raises, for every term
    it matches, its target's domain count when the target is eligible.
    ``counts_flat`` [L, S·D + 1] (the last column takes what is dropped),
    ``m`` [L, S] i32, ``place`` [L] bool, ``target`` [L] int64."""
    slot = st.commit_slot.index_select(1, target).T                   # [L, S]
    counts_flat.scatter_add_(1, slot, torch.where(place[:, None], m, 0))


class _Loop:
    """The scan's carry and the fixed buffers of one chunk's read-only
    operands; ``step(j)`` is step j of the loaded chunk."""

    def __init__(self, snap: SnapshotTensors, spread, C: int):
        dev, N, R = snap.device, snap.num_nodes, snap.pod_req.shape[1]
        self.snap = snap
        # the free capacity as [R, N]: a step's fit test reduces over the
        # leading axis, one vector compare a resource across the nodes
        self.free = snap.free().T.contiguous()
        self.ok_buf = torch.zeros(N + 1, dtype=torch.bool, device=dev)  # [N] stays False
        self.ok = self.ok_buf[:N]
        self.req = torch.zeros((R, C), dtype=snap.pod_req.dtype, device=dev)
        self.neg_req = torch.zeros_like(self.req)
        self.rows = torch.zeros((C, N), dtype=torch.bool, device=dev)
        self.hint = torch.full((C,), -1, dtype=torch.int64, device=dev)
        self.hint_slot = torch.full((C,), N, dtype=torch.int64, device=dev)
        self.valid = torch.zeros(C, dtype=torch.bool, device=dev)
        self.place = torch.zeros(C, dtype=torch.bool, device=dev)
        self.dest = torch.zeros(C, dtype=torch.int64, device=dev)
        self.spread = spread
        if spread is not None:
            # the 9-tuple splits: the static counts seed the carry, the rest
            # is the 8-array gate context
            (sp_of_T, sp_match_T, node_dom, sp_elig, dom_valid,
             static_counts, skew, min_dom, domnum) = spread
            self.sp_of_T, self.sp_match_T = sp_of_T, sp_match_T
            self.st = _spread_static((sp_of_T, sp_match_T, node_dom, sp_elig,
                                      dom_valid, skew, min_dom, domnum))
            S, D = static_counts.shape
            self.counts_flat = torch.cat([static_counts.reshape(-1),
                                          static_counts.new_zeros(1)])
            self.counts = self.counts_flat[: S * D].view(S, D)
            self.o = torch.zeros((C, S), dtype=torch.bool, device=dev)
            self.m = torch.zeros((C, S), dtype=torch.int32, device=dev)

    def load(self, slots: torch.Tensor, hints: torch.Tensor) -> None:
        """The read-only operands of the next n <= C steps."""
        n = slots.shape[0]
        safe = slots.clamp(min=0)
        snap = self.snap
        req = snap.pod_req.index_select(0, safe).T
        self.req[:, :n] = req
        self.neg_req[:, :n] = -req
        self.rows[:n] = snap.sched_rows(safe) & snap.node_valid
        self.hint[:n] = hints
        self.hint_slot[:n] = torch.where(hints >= 0, hints, snap.num_nodes)
        self.valid[:n] = slots >= 0
        if self.spread is not None:
            self.o[:n] = self.sp_of_T.index_select(0, safe)
            self.m[:n] = self.sp_match_T.index_select(0, safe)

    def step(self, j: int) -> None:
        ok = self.ok
        torch.all(self.free >= self.req[:, j:j + 1], dim=0, out=ok)
        ok.logical_and_(self.rows[j])
        if self.spread is not None:
            ok.masked_fill_(_gate_violations(self.st, self.counts, self.o[j], self.m[j]), False)
        hinted = self.ok_buf.index_select(0, self.hint_slot[j:j + 1])   # False without a hint
        any_fit, first = torch.max(ok.view(torch.uint8), dim=0)        # the first fitting node
        dest = torch.where(hinted, self.hint[j:j + 1], torch.where(any_fit > 0, first, -1))
        place = (dest >= 0) & self.valid[j:j + 1]
        target = dest.clamp(min=0)
        self.free.index_add_(1, target, torch.where(place, self.neg_req[:, j:j + 1], 0.0))
        if self.spread is not None:
            _commit(self.st, self.counts_flat, self.m[j], place, target)
        self.place[j:j + 1] = place
        self.dest[j:j + 1] = dest

    def capture(self) -> "torch.cuda.CUDAGraph":
        """One CUDA graph of a whole chunk's steps on the buffers (recorded,
        not run), on a side stream as capture requires."""
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(device=self.free.device)
        side.wait_stream(torch.cuda.current_stream(self.free.device))
        with torch.cuda.stream(side):
            graph.capture_begin()
            for j in range(self.place.shape[0]):
                self.step(j)
            graph.capture_end()
        torch.cuda.current_stream(self.free.device).wait_stream(side)
        return graph


def greedy_schedule(
    snap: SnapshotTensors,
    pod_slots: torch.Tensor,   # [K] i32 pod rows to place, in priority order (-1 pad)
    hints: torch.Tensor,       # [K] i32 hinted node per pod, -1 = no hint
    spread: Optional[tuple] = None,  # affinity.build_spread_schedule_context
) -> ScheduleResult:
    """Place pods onto existing nodes greedily, honouring hints. Capacity
    is carried across placements; the static predicate mask comes from the
    snapshot, and hard topology spread re-counts after every placement
    when the spread context is given, so pods placed earlier in the wave
    raise their domain's count for later pods (hinting_simulator.go:58 →
    PodTopologySpread filtering.go:339). Runs on the snapshot's device;
    ``pod_slots`` and ``hints`` move there once."""
    dev = snap.device
    slots = pod_slots.to(device=dev, dtype=torch.int64)
    hint_rows = hints.to(device=dev, dtype=torch.int64)
    K = slots.shape[0]
    C = max(min(CHUNK, K), 1)
    loop = _Loop(snap, spread, C)
    placed = torch.zeros(K, dtype=torch.bool, device=dev)
    dest = torch.zeros(K, dtype=torch.int64, device=dev)
    graph = None
    for c0 in range(0, K, C):
        n = min(C, K - c0)
        loop.load(slots[c0:c0 + n], hint_rows[c0:c0 + n])
        # on a card every full chunk after the first (which runs eagerly and
        # so loads every kernel before the capture) replays one graph
        if dev.type == "cuda" and n == C and c0 > 0:
            if graph is None:
                graph = loop.capture()
            graph.replay()
        else:
            for j in range(n):
                loop.step(j)
        placed[c0:c0 + n] = loop.place[:n]
        dest[c0:c0 + n] = loop.dest[:n]
    return ScheduleResult(placed=placed, dest=torch.where(placed, dest, -1).to(torch.int32))
