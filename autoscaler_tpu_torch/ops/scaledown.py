"""Scale-down device code: empty-node detection and the batched node-removal
(drain) refit: the counterpart of ``autoscaler_tpu/ops/scaledown.py``.

Reference: cluster-autoscaler/simulator/cluster.go: FindNodesToRemove :116,
SimulateNodeRemoval :145 (GetPodsToMove → fork → findPlaceFor :220) and
FindEmptyNodesToRemove :187. The reference simulates one candidate at a time
on a forked snapshot. The JAX package vmaps one lane a candidate over a
``lax.scan`` of the candidate's pod slots: lane j masks node j out and
re-places j's movable pods greedily, first fit, onto the capacity left.

Here the vmap becomes the leading axis of every tensor and the scan one
torch loop over the slot axis, all lanes of a chunk batched in each step:
the free capacity ``[L, R, N]``, the verdicts ``[L, N]``, the destinations
``[L]`` and, with hard topology spread, the counts ``[L, S, D]``. Lanes are
independent, so cutting them into chunks (``LANE_BYTES`` of card memory a
chunk) is exact. A ``-1`` slot changes nothing, and slots are filled from
the left, so the loop stops at the last column any lane uses; the outputs
keep the full ``[C, S]`` shape.

Exactness against the XLA code: the fit is the same compare and the carry
the same sequence of f32 adds, ``free + (-r1) + (-r2)`` row by row in slot
order; the first fitting node is the least index among the fitting ones;
the spread gate and commit are the same integer arithmetic
(``ops/schedule.spread_gate_lanes`` / ``spread_commit_lanes``). No step
reads a value back: the host waits once, for the outputs.

The joint re-validation walks the picked candidates in order, each through
the same step as a one-lane chunk, over one shared carry that a candidate
commits only when all its pods found a place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from autoscaler_tpu_torch.ops.schedule import (
    _spread_static,
    spread_commit_lanes,
    spread_gate_lanes,
)
from autoscaler_tpu_torch.snapshot.tensors import SnapshotTensors

LANE_BYTES = 2 << 30     # card memory a chunk of lanes may take (carry and step temporaries)


def empty_nodes(snap: SnapshotTensors, movable: torch.Tensor) -> torch.Tensor:
    """[N] bool: nodes whose only pods are unmovable but ignorable
    (DaemonSet, mirror), removable without rescheduling anything
    (FindEmptyNodesToRemove, cluster.go:187). ``movable`` [P] bool is the
    host's drain-rule verdict: True = the pod must be re-placed. One
    scatter-add of i32 ones over the pod → node assignment."""
    w = (movable & snap.pod_valid & (snap.pod_node >= 0)).to(torch.int32)
    seg = snap.pod_node.clamp(0, snap.num_nodes - 1).long()
    count = torch.zeros(snap.num_nodes, dtype=torch.int32, device=snap.device)
    count.index_add_(0, seg, w)
    return snap.node_valid & (count == 0)


class RemovalFeasibility(NamedTuple):
    feasible: torch.Tensor      # [C] bool: all movable pods of the candidate re-place
    destinations: torch.Tensor  # [C, S] i32: target node a pod slot, -1 if none
    moved_counts: torch.Tensor  # [C] i32: pods that found a new home


def lane_bytes(snap: SnapshotTensors, num_terms: int = 0) -> int:
    """Card memory one lane takes: its carry ([R, N] f32, [S·D] i32) and
    its step temporaries (the [R, N] compare, verdict rows, the first-fit
    indices, the spread gate's [S, N] gather, the factored mask's cell
    matches)."""
    N, R = snap.num_nodes, snap.pod_req.shape[1]
    cells = 0 if snap.cell_pod is None else int(snap.cell_pod.shape[0])
    return N * (5 * R + 24 + num_terms) + 16 * cells


def lane_chunk(snap: SnapshotTensors, num_terms: int = 0) -> int:
    """Lanes a chunk: as many as ``LANE_BYTES`` holds."""
    return max(1, LANE_BYTES // lane_bytes(snap, num_terms))


def filled_slots(pod_slots: torch.Tensor) -> int:
    """1 + the last column of ``pod_slots`` that holds a pod in any lane (0
    when none does): the steps the slot loop must take. Reads one value
    back."""
    if pod_slots.numel() == 0:
        return 0
    cols = torch.arange(1, pod_slots.shape[1] + 1, device=pod_slots.device)
    return int(torch.where((pod_slots >= 0).any(dim=0), cols, 0).max())


class _Lanes:
    """The carry of L lanes (free capacity [L, R, N], spread counts
    [L, S·D + 1]) and one slot step over all of them. Every write to the
    carry is an ``index_add_`` / ``index_fill_`` at flat positions, which
    needs no host value (an indexed assignment of a host scalar would)."""

    def __init__(self, snap: SnapshotTensors, free: torch.Tensor,
                 exclude_node: Optional[torch.Tensor] = None,
                 excluded: Optional[torch.Tensor] = None,
                 spread=None, counts_flat: Optional[torch.Tensor] = None):
        # ``spread``: (the 8-tensor context, its ``_spread_static``) or None
        L, R, N = free.shape
        dev = snap.device
        self.snap, self.free = snap, free
        self.node_pos = torch.arange(N, dtype=torch.int32, device=dev)
        # flat position of (lane l, resource r, node 0) in the carry
        lane = torch.arange(L, device=dev)
        self.col0 = lane[:, None] * (R * N) + torch.arange(R, device=dev)[None, :] * N
        # what no lane may use: padding rows, and the nodes leaving the plan
        self.usable = snap.node_valid if excluded is None else snap.node_valid & ~excluded
        self.excl_flat = None
        if exclude_node is not None:
            # each lane's drained node: its capacity zeroed, never a destination
            free.view(-1).index_fill_(0, (self.col0 + exclude_node[:, None]).view(-1), 0.0)
            self.excl_flat = lane * N + exclude_node
        self.spread = spread
        if spread is not None:
            self.sp_of, self.sp_match = spread[0][0], spread[0][1]
            self.st = spread[1]
            S, D = self.st.dom_valid.shape
            self.counts_flat = counts_flat
            self.counts = counts_flat[:, : S * D].view(L, S, D)

    def step(self, pods: torch.Tensor):
        """Place each lane's pod ``pods`` [L] (int64, -1 = an empty slot) on
        its first fitting node → (dest [L] i32, place [L] bool, valid [L]
        bool)."""
        snap = self.snap
        valid = pods >= 0
        safe = pods.clamp(min=0)
        req = snap.pod_req.index_select(0, safe)                        # [L, R]
        ok = (self.free >= req[:, :, None]).all(dim=1)                  # [L, N]
        ok &= snap.sched_rows(safe)
        ok &= self.usable
        if self.excl_flat is not None:
            ok.view(-1).index_fill_(0, self.excl_flat, False)
        if self.spread is not None:
            o = self.sp_of.index_select(0, safe)
            m = self.sp_match.index_select(0, safe).to(torch.int32)
            ok &= ~spread_gate_lanes(self.st, self.counts, o, m)
        N = ok.shape[1]
        first = torch.where(ok, self.node_pos, N).amin(dim=1)           # the first fitting node
        dest = torch.where(first < N, first, -1)
        place = valid & (dest >= 0)
        target = dest.clamp(min=0).long()
        cols = (self.col0 + target[:, None]).view(-1)
        self.free.view(-1).index_add_(0, cols, torch.where(place[:, None], -req, 0.0).view(-1))
        if self.spread is not None:
            spread_commit_lanes(self.st, self.counts_flat, m, place, target)
        return dest, place, valid

    def run(self, slots: torch.Tensor):
        """The slot loop over ``slots`` [L, T] (int64) → (all placed [L]
        bool, destinations [L, T] i32, moved [L] i32)."""
        L, T = slots.shape
        dev = slots.device
        placed_ok = torch.ones(L, dtype=torch.bool, device=dev)
        dests = torch.full((L, T), -1, dtype=torch.int32, device=dev)
        moved = torch.zeros(L, dtype=torch.int32, device=dev)
        for s in range(T):
            dest, place, valid = self.step(slots[:, s])
            dests[:, s] = torch.where(valid, dest, -1)
            placed_ok &= place | ~valid
            moved += place.to(torch.int32)
        return placed_ok, dests, moved


def _start_counts(spread, static_counts, nodes, sub):
    """[L, S·D + 1] i32: the live counts, less each lane's own movable
    matching pods ``sub`` [L, S] at its node's domain in each term where
    the node is eligible (the reference removes them from the forked
    snapshot before findPlaceFor); the last column is the commit's drop."""
    node_dom, sp_elig = spread[2], spread[3]
    S, D = static_counts.shape
    L = nodes.shape[0]
    flat = torch.zeros((L, S * D + 1), dtype=torch.int32, device=static_counts.device)
    flat[:, : S * D] = static_counts.reshape(1, S * D)
    dom = node_dom.index_select(1, nodes).T                             # [L, S]
    gate = (dom >= 0) & sp_elig.index_select(1, nodes).T
    col = torch.arange(S, device=dom.device)[None, :] * D + dom.clamp(min=0).long()
    flat.scatter_add_(1, col, -torch.where(gate, sub.to(torch.int32), 0))
    return flat


def removal_feasibility(
    snap: SnapshotTensors,
    candidate_nodes: torch.Tensor,  # [C] i32 node rows to evaluate
    pod_slots: torch.Tensor,        # [C, S] i32 movable pod rows of each candidate (-1 pad)
    blocked: torch.Tensor,          # [C] bool: drain rules forbid removal outright
) -> RemovalFeasibility:
    """Batched single-node removal refit. Each lane answers: if node j were
    drained, could each of its movable pods be placed on another node,
    greedily in slot order with capacity updated between placements (the
    findPlaceFor semantics, cluster.go:220)?"""
    return _removal_impl(snap, candidate_nodes, pod_slots, blocked, None, None, None)


def removal_feasibility_spread(
    snap: SnapshotTensors,
    candidate_nodes: torch.Tensor,
    pod_slots: torch.Tensor,
    blocked: torch.Tensor,
    spread: tuple,                  # the 8-tensor context (no static counts)
    static_counts: torch.Tensor,    # [S, D] live counts over all placed pods
    cand_sub: torch.Tensor,         # [C, S] each candidate's movable matching pods
) -> RemovalFeasibility:
    """``removal_feasibility`` with topology spread re-counted within each
    refit: a lane starts from the live counts less its candidate's own
    movable matching pods, and its placements raise its own counts."""
    return _removal_impl(snap, candidate_nodes, pod_slots, blocked, spread,
                         static_counts, cand_sub)


def _removal_impl(snap, candidate_nodes, pod_slots, blocked, spread, static_counts,
                  cand_sub) -> RemovalFeasibility:
    dev = snap.device
    cand = candidate_nodes.to(device=dev, dtype=torch.int64)
    slots = pod_slots.to(device=dev, dtype=torch.int64)
    blocked = blocked.to(dev)
    C, S = slots.shape
    T = filled_slots(slots)
    feasible = torch.zeros(C, dtype=torch.bool, device=dev)
    dests = torch.full((C, S), -1, dtype=torch.int32, device=dev)
    moved = torch.zeros(C, dtype=torch.int32, device=dev)
    free0 = snap.free().T.contiguous()                                  # [R, N]
    terms = 0 if spread is None else int(static_counts.shape[0])
    chunk = lane_chunk(snap, terms)
    lane_spread = None if spread is None else (spread, _spread_static(spread))
    for c0 in range(0, C, chunk):
        c1 = min(C, c0 + chunk)
        nodes = cand[c0:c1]
        free = free0.expand(c1 - c0, *free0.shape).clone(memory_format=torch.contiguous_format)
        counts = None
        if spread is not None:
            counts = _start_counts(spread, static_counts, nodes, cand_sub[c0:c1].to(dev))
        lanes = _Lanes(snap, free, exclude_node=nodes, spread=lane_spread, counts_flat=counts)
        placed_ok, d, mv = lanes.run(slots[c0:c1, :T])
        feasible[c0:c1] = placed_ok & ~blocked[c0:c1]
        dests[c0:c1, :T] = d
        moved[c0:c1] = mv
        del lanes, free        # before the next chunk's carry is allocated
    return RemovalFeasibility(feasible=feasible, destinations=dests, moved_counts=moved)


def joint_removal_feasibility(
    snap: SnapshotTensors,
    candidate_nodes: torch.Tensor,  # [C] i32 node rows, in the planner's pick order
    pod_slots: torch.Tensor,        # [C, S] i32 movable pod rows (-1 pad)
    excluded: torch.Tensor,         # [N] bool: every node leaving in this plan
) -> RemovalFeasibility:
    """Sequential re-validation of a set of removals before actuation.

    ``removal_feasibility`` answers each candidate alone against one base
    state (categorizeNodes, planner.go:252). The picked set acts jointly:
    two drained nodes cannot both re-place pods into the same free
    capacity, and nothing may land on a node that is itself leaving (the
    reference re-simulates the set on a fresh snapshot during actuation,
    actuator.go:371). Candidates run in pick order over one shared carry; a
    candidate that no longer fits is reported infeasible and its trial
    placements are rolled back."""
    return _joint_impl(snap, candidate_nodes, pod_slots, excluded, None, None, None)


def joint_removal_feasibility_spread(
    snap: SnapshotTensors,
    candidate_nodes: torch.Tensor,
    pod_slots: torch.Tensor,
    excluded: torch.Tensor,
    spread: tuple,
    static_counts: torch.Tensor,    # [S, D]
    cand_sub: torch.Tensor,         # [C, S]
) -> RemovalFeasibility:
    """``joint_removal_feasibility`` with spread re-counted within the plan:
    the counts are shared across candidates in pick order, each candidate
    first dropping its own movable matching pods from its domain; an
    infeasible candidate rolls back capacity and counts together."""
    return _joint_impl(snap, candidate_nodes, pod_slots, excluded, spread,
                       static_counts, cand_sub)


def _joint_impl(snap, candidate_nodes, pod_slots, excluded, spread, static_counts,
                cand_sub) -> RemovalFeasibility:
    dev = snap.device
    cand = candidate_nodes.to(device=dev, dtype=torch.int64)
    slots = pod_slots.to(device=dev, dtype=torch.int64)
    excluded = excluded.to(dev)
    C, S = slots.shape
    T = filled_slots(slots)
    feasible = torch.zeros(C, dtype=torch.bool, device=dev)
    dests = torch.full((C, S), -1, dtype=torch.int32, device=dev)
    moved = torch.zeros(C, dtype=torch.int32, device=dev)
    # zero the free columns of every node leaving so nothing lands there;
    # each candidate's own node is in ``excluded`` already
    free = torch.where(excluded[None, :], 0.0, snap.free().T)[None].contiguous()  # [1, R, N]
    counts, lane_spread = static_counts, None
    if spread is not None:
        lane_spread = (spread, _spread_static(spread))
    for i in range(C):
        trial_counts = None
        if spread is not None:
            trial_counts = _start_counts(spread, counts, cand[i:i + 1], cand_sub[i:i + 1].to(dev))
        lane = _Lanes(snap, free.clone(), excluded=excluded, spread=lane_spread,
                      counts_flat=trial_counts)
        placed_ok, d, mv = lane.run(slots[i:i + 1, :T])
        # commit the candidate's placements only if the whole node drains
        free = torch.where(placed_ok, lane.free, free)
        if spread is not None:
            counts = torch.where(placed_ok, lane.counts[0], counts)
        feasible[i:i + 1] = placed_ok
        dests[i:i + 1, :T] = torch.where(placed_ok[:, None], d, -1)
        moved[i:i + 1] = torch.where(placed_ok, mv, 0)
    return RemovalFeasibility(feasible=feasible, destinations=dests, moved_counts=moved)
