"""The plain FFD scan over every node group, on hand-written CUDA kernels —
the counterpart of ``autoscaler_tpu/ops/pallas_binpack.py``
(``ffd_binpack_groups_pallas`` and its kernels ``_scan_kernel`` and
``_scan_kernel_swar``).

``ffd_binpack_groups_cuda`` has the semantics of the JAX package's
``ffd_binpack_groups_pallas``: score-descending order, first fit in
node-open order, open on miss, per-group caps. Around the kernels it keeps
the same glue:

- the scores use the raw allocs; then ``clamp_inf_allocs`` turns +inf
  (unlimited CSI attach planes) into a finite always-fits power of two, so
  ``node_used = alloc - free`` never meets inf - inf;
- ONE host probe reads which resource axes any pod requests (unused axes
  are dropped: they can never gate a fit nor change the carry) and whether
  every request and alloc is a non-negative integer, which selects the
  SWAR route: integer axes packed several to an int32 plane
  (``_swar_plan``), masked pods carrying a per-plane sentinel instead of
  +inf;
- a stable sort of each group's pods by ``-score`` and a gather build the
  per-group request stream [G, P_pad, NP]; after the scan a scatter on
  the same order puts the placement bits back in pod order.

``ffd_binpack_scenarios_cuda`` serves a batch of S independent
scenarios (the fleet's coalescer's tenants, each with its own pod matrix)
the same way, flattened to S·G groups in ONE launch (``prepare_scenarios``).
Its twin is the XLA scan, which sums each node's placed requests in f32 in
pod order; so this route asks the kernel for the node each pod took
(``node_of``) and sums the requests the same way (``summed_node_used``),
where the solo route reads the usage back as alloc − free, as its Pallas
twin does.

The scan itself is ``ffd_scan_f32`` (K1) or ``ffd_scan_swar`` (K2). For a
tensor on a CUDA card each launches its kernel from ``csrc/ffd_scan.cu``
and counts the launch in ``LAUNCHES``; for a tensor on the CPU each runs
its plain PyTorch version (``_scan_plain_f32``, ``_scan_plain_swar``),
which computes the kernel's step loop on the kernel's exact operands.
There is no fallback from one to the other.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.ops import _build
from autoscaler_tpu_torch.ops.binpack import (
    BinpackResult,
    scenario_caps,
    scenario_order,
    score_order,
)
from autoscaler_tpu_torch.ops.telemetry import observed
from autoscaler_tpu_torch.trace.device import device_annotation

BIG_I32 = 2**31 - 1
STEP_BLOCK = 32  # the kernels stage 32 steps at a time: P pads to a multiple
NODE_BLOCK = 32  # nodes a warp tests at once, and a block summary covers
GROUP_WARPS = 8  # warps of each group's block (kWarps in csrc/ffd_scan.cu)
SMEM_PER_BLOCK = 232_448  # the most dynamic shared memory a Hopper block may use

# Launch counts of the kernels: each wrapper adds one where it launches
# its kernel, and nowhere else.
LAUNCHES = {"ffd_scan_f32": 0, "ffd_scan_swar": 0}

# The kernel entries' shape contracts, read by AST and never imported (GL007,
# autoscaler_tpu_torch/analysis/contracts.py): operand dims tie across
# operands, statics and padding as the entries' own checks enforce them, and
# the function that models each launch's dynamic shared memory. The launch
# grid is computed in csrc, so no contract declares one.
KERNEL_CONTRACTS = {
    "ffd_binpack_groups_cuda": {
        "args": {
            "pod_req": {"dims": ["P", "R"], "dtype": "f32"},
            "pod_masks": {"dims": ["G", "P"], "dtype": "bool"},
            "template_allocs": {"dims": ["G", "R"], "dtype": "f32"},
            "node_caps": {"dims": ["G"], "dtype": "i32"},
        },
        "static": {"max_nodes": {"min": 1}},
        "pad": {"P_pad": ["P", "STEP_BLOCK"]},
        "pad_value": "+inf rows (K1) or the guard-bit sentinel (K2): inactive pods fit nowhere",
        "smem": "smem_bytes",
    },
    "ffd_binpack_scenarios_cuda": {
        "args": {
            "scen_req": {"dims": ["S", "P", "R"], "dtype": "f32"},
            "scen_masks": {"dims": ["S", "G", "P"], "dtype": "bool"},
            "scen_allocs": {"dims": ["S", "G", "R"], "dtype": "f32"},
            "scen_caps": {"dims": ["S", "G"], "dtype": "i32"},
        },
        "static": {"max_nodes": {"min": 1}},
        "pad": {"P_pad": ["P", "STEP_BLOCK"]},
        "pad_value": "+inf rows (K1) or the guard-bit sentinel (K2): inactive pods fit nowhere",
        "smem": "smem_bytes",
    },
    "ffd_scan_f32": {
        "args": {
            "stream": {"dims": ["G", "P_pad", "NP"]},
            "allocs": {"dims": ["G", "NP"]},
            "caps": {"dims": ["G"], "dtype": "i32"},
        },
        "static": {"max_nodes": {"min": 1}},
        "pad": {"P_pad": ["P", "STEP_BLOCK"]},
        "smem": "smem_bytes",
        "notes": "K1: f32 stream and allocs, contiguous",
    },
    "ffd_scan_swar": {
        "args": {
            "stream": {"dims": ["G", "P_pad", "NP"]},
            "allocs": {"dims": ["G", "NP"]},
            "caps": {"dims": ["G"], "dtype": "i32"},
            "guards": {"dims": ["NP"], "dtype": "i32"},
        },
        "static": {"max_nodes": {"min": 1}},
        "pad": {"P_pad": ["P", "STEP_BLOCK"]},
        "smem": "smem_bytes",
        "notes": "K2: i32 SWAR-packed stream and allocs, contiguous",
    },
}


def operands_from_numpy(
    pod_req, pod_masks, template_allocs, node_caps=None, device=None, upload=None
):
    """The estimator's numpy operands → torch tensors of the contract's
    dtypes on ``device`` (None = the first CUDA card). Always a COPY:
    ``torch.from_numpy`` would alias host memory that callers mutate.
    ``upload`` (array → tensor on ``device``: an operand arena's resident
    copy) replaces the plain copy."""
    dev = resolve_device(device)
    if upload is None:
        def upload(a):
            return torch.tensor(a, device=dev)
    req = upload(np.asarray(pod_req, np.float32))
    masks = upload(np.asarray(pod_masks, bool))
    allocs = upload(np.asarray(template_allocs, np.float32))
    caps = None if node_caps is None else upload(np.asarray(node_caps, np.int32))
    return req, masks, allocs, caps


def clamp_inf_allocs(pod_req: torch.Tensor, template_allocs: torch.Tensor) -> torch.Tensor:
    """Replace +inf template capacities (unlimited CSI-attach virtual
    planes) with a finite always-fits stand-in: the power of two at or above
    max(2 × the axis's total request, 2^23). used <= total <= big/2, so
    free >= big/2 >= any request. Runs AFTER scoring (the score reads the
    raw caps). The power of two is built exactly from frexp's exponent as
    f32 bits (torch.ldexp rounds through pow on the host)."""
    x = torch.clamp(pod_req.sum(dim=0) * 2.0, min=2.0**23)
    mant, exp = torch.frexp(x)                 # x = mant * 2**exp, mant in [0.5, 1)
    k = torch.where(mant == 0.5, exp - 1, exp).to(torch.int32)
    big = ((k + 127) << 23).view(torch.float32)   # 2**k
    return torch.where(torch.isfinite(template_allocs), template_allocs, big[None, :])


def _swar_plan(max_vals):
    """Greedy field-packing plan for the SWAR route: each resource axis
    becomes a (plane, shift, width) field, packed first-fit-decreasing into
    as few int32 planes as possible (<= 31 bits a plane, the sign bit stays
    clear). width = bit_length(max_val) + 1: the top bit of each field is
    the GUARD bit of the fit test, and the masked-pod sentinel sets each
    field to exactly 2^(width-1), one above any real value, so a
    subtraction never borrows across fields. None when packing wins
    nothing."""
    R = len(max_vals)
    widths = [max(int(v).bit_length(), 1) + 1 for v in max_vals]
    order = sorted(range(R), key=lambda r: -widths[r])
    planes = []   # list of [used_bits, [(r, shift, width), ...]]
    for r in order:
        w = widths[r]
        if w > 31:
            return None
        for plane in planes:
            if plane[0] + w <= 31:
                plane[1].append((r, plane[0], w))
                plane[0] += w
                break
        else:
            planes.append([w, [(r, 0, w)]])
    if len(planes) >= R:
        return None
    return [fields for _, fields in planes]


def _swar_masks(plan) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(guards, sentinels) per plane: guard = OR of each field's top bit;
    the sentinel sets each field to 2^(width-1), which is the same bits."""
    guards = tuple(
        sum(1 << (shift + width - 1) for _, shift, width in fields)
        for fields in plan
    )
    return guards, guards


def _swar_pack_cols(values: torch.Tensor, plan) -> List[torch.Tensor]:
    """[N, R] f32 integer-valued → list of [N] int32 packed planes."""
    vi = values.to(torch.int32)
    return [
        functools.reduce(
            lambda a, b: a + b, [vi[:, r] << shift for r, shift, _ in fields]
        )
        for fields in plan
    ]


def _swar_unpack_free(free_planes: torch.Tensor, plan, num_resources: int) -> torch.Tensor:
    """[NP, ...] int32 packed free → [R, ...] f32 per-resource free."""
    outs = [None] * num_resources
    for p, fields in enumerate(plan):
        for r, shift, width in fields:
            outs[r] = (
                (free_planes[p] >> shift) & ((1 << (width - 1)) - 1)
            ).to(torch.float32)
    return torch.stack(outs)


class ScanOperands(NamedTuple):
    """What the glue hands a scan kernel, and what it needs back."""

    stream: torch.Tensor     # [G, P_pad, NP] f32, or int32 packed (SWAR)
    allocs: torch.Tensor     # [G, NP] f32, or int32 packed (SWAR)
    caps: torch.Tensor       # [G] i32, already <= max_nodes
    guards: Optional[torch.Tensor]  # [NP] i32 on the SWAR route, else None
    max_nodes: int
    order: torch.Tensor      # [G, P] int64 — the score sort
    plan: Optional[list]     # SWAR field plan, or None (f32 route)
    keep: List[int]          # resource axes kept by the compression
    allocs_kept: torch.Tensor  # [G, R_k] f32, clamped — for node_used
    num_resources: int       # R before compression
    rows: torch.Tensor       # [N, R] f32, the request rows as given
    rows_of: torch.Tensor    # [G, P] int64: group g's s-th pod is rows[rows_of[g, s]]


def _check_operands(pod_req, pod_masks, template_allocs, node_caps):
    for name, t, dtype, ndim in (
        ("pod_req", pod_req, torch.float32, 2),
        ("pod_masks", pod_masks, torch.bool, 2),
        ("template_allocs", template_allocs, torch.float32, 2),
        ("node_caps", node_caps, torch.int32, 1),
    ):
        if t is None and name == "node_caps":
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor")
        if t.device != pod_req.device:
            raise ValueError(f"{name} is on {t.device}, pod_req on {pod_req.device}")
    P, R = pod_req.shape
    G = pod_masks.shape[0]
    if pod_masks.shape[1] != P or template_allocs.shape != (G, R):
        raise ValueError(
            f"shape mismatch: pod_req {tuple(pod_req.shape)}, pod_masks "
            f"{tuple(pod_masks.shape)}, template_allocs {tuple(template_allocs.shape)}"
        )
    if node_caps is not None and node_caps.shape != (G,):
        raise ValueError(f"node_caps must be [{G}], got {tuple(node_caps.shape)}")


class ScanPlan(NamedTuple):
    """What the one host probe fixes before the stream is built."""

    keep: List[int]          # resource axes kept by the compression
    plan: Optional[list]     # SWAR field plan, or None (f32 route)
    planes: int              # NP, the kernel planes of the carry


def plan_scan(pod_req: torch.Tensor, template_allocs: torch.Tensor) -> ScanPlan:
    """The glue's ONE host fetch: per-axis usage (exact compression),
    per-axis maxima and integrality (the SWAR decision), and from them the
    kernel planes. Non-finite requests never occur by construction; the
    isfinite guard keeps an inf out of _swar_plan."""
    R_full = pod_req.shape[1]
    allocs = clamp_inf_allocs(pod_req, template_allocs)
    ints_ok = (
        (pod_req >= 0).all()
        & torch.isfinite(pod_req).all()
        & (pod_req == torch.floor(pod_req)).all()
        & (allocs == torch.floor(allocs)).all()
    )
    probe = torch.cat([
        (pod_req > 0).any(dim=0).to(torch.float32),
        torch.clamp(pod_req.amax(dim=0), min=0.0),
        torch.clamp(allocs.amax(dim=0), min=0.0),
        ints_ok.to(torch.float32)[None],
    ]).cpu().tolist()
    axis_used = probe[:R_full]
    req_max = probe[R_full:2 * R_full]
    alloc_max = probe[2 * R_full:3 * R_full]
    keep = [r for r in range(R_full) if axis_used[r] > 0] or [0]
    plan = None
    if probe[-1] > 0:
        plan = _swar_plan([max(req_max[r], alloc_max[r]) for r in keep])
    return ScanPlan(keep, plan, len(keep) if plan is None else len(plan))


def prepare_scan(
    pod_req: torch.Tensor,          # [P, R] f32
    pod_masks: torch.Tensor,        # [G, P] bool
    template_allocs: torch.Tensor,  # [G, R] f32
    max_nodes: int,
    node_caps: Optional[torch.Tensor] = None,  # [G] i32
    scan_plan: Optional[ScanPlan] = None,
) -> ScanOperands:
    """Everything before the kernel: caps, scores and their stable sort, the
    inf clamp, the one host probe (``plan_scan``, unless ``scan_plan`` is
    given), and the sorted request stream with inactive pods set to +inf or
    the sentinel."""
    _check_operands(pod_req, pod_masks, template_allocs, node_caps)
    if max_nodes < 1:
        raise ValueError(f"max_nodes must be >= 1, got {max_nodes}")
    G = pod_masks.shape[0]
    if node_caps is None:
        node_caps = torch.full((G,), max_nodes, dtype=torch.int32, device=pod_req.device)
    order = score_order(pod_req, template_allocs)                   # [G, P]
    return _build_operands(
        pod_req, order, order, pod_masks, template_allocs,
        torch.clamp(node_caps, max=max_nodes), max_nodes, scan_plan,
    )


def prepare_scenarios(
    scen_req: torch.Tensor,     # [S, P, R] f32
    scen_masks: torch.Tensor,   # [S, G, P] bool
    scen_allocs: torch.Tensor,  # [S, G, R] f32
    max_nodes: int,
    scen_caps: Optional[torch.Tensor] = None,  # [S, G] i32
    scan_plan: Optional[ScanPlan] = None,
) -> ScanOperands:
    """``prepare_scan`` for a batch of S scenarios, flattened to S·G
    groups: group (s, g) streams scenario s's pods in its own score order
    against its own alloc, with cap ``scen_caps[s, g]`` (min'd with
    ``max_nodes``). One ``plan_scan`` covers the batch (``scan_plan`` is
    that of ``scen_req.reshape(S·P, R)`` against ``scen_allocs.reshape(
    S·G, R)``), so a single fractional scenario routes the whole batch to
    K1. Padded slots (all masks False) stream only inactive rows, and
    padded groups (alloc 0, cap 0) open nothing."""
    for name, t, dtype in (("scen_req", scen_req, torch.float32),
                           ("scen_masks", scen_masks, torch.bool),
                           ("scen_allocs", scen_allocs, torch.float32)):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.dim() != 3:
            raise ValueError(f"{name} must be a 3-d {dtype} tensor")
    S, P, R = scen_req.shape
    G = scen_masks.shape[1]
    if scen_masks.shape != (S, G, P) or scen_allocs.shape != (S, G, R):
        raise ValueError(
            f"shape mismatch: scen_req {tuple(scen_req.shape)}, scen_masks "
            f"{tuple(scen_masks.shape)}, scen_allocs {tuple(scen_allocs.shape)}"
        )
    if max_nodes < 1:
        raise ValueError(f"max_nodes must be >= 1, got {max_nodes}")
    dev = scen_req.device
    caps = scenario_caps(scen_caps, S, G, max_nodes, dev).reshape(S * G)
    order = scenario_order(scen_req, scen_allocs)                   # [S, G, P]
    base = (torch.arange(S, device=dev) * P)[:, None, None]
    return _build_operands(
        scen_req.reshape(S * P, R), (order + base).reshape(S * G, P),
        order.reshape(S * G, P), scen_masks.reshape(S * G, P),
        scen_allocs.reshape(S * G, R), caps, max_nodes, scan_plan,
    )


def _build_operands(rows, rows_of, order, pod_masks, template_allocs, caps,
                    max_nodes, scan_plan) -> ScanOperands:
    """The stream of G groups: group g's s-th pod in its score order is
    column ``order[g, s]`` of ``pod_masks`` with request row
    ``rows[rows_of[g, s]]`` (for one snapshot ``rows_of`` is ``order``)."""
    dev = rows.device
    R_full = rows.shape[1]
    G, P = pod_masks.shape
    full_rows = rows
    allocs = clamp_inf_allocs(rows, template_allocs)
    if scan_plan is None:
        scan_plan = plan_scan(rows, template_allocs)
    keep, plan = scan_plan.keep, scan_plan.plan
    if len(keep) < R_full:
        keep_t = torch.tensor(keep, device=dev)
        rows = rows[:, keep_t]
        allocs = allocs[:, keep_t]

    if plan is not None:
        guard_vals, sentinels = _swar_masks(plan)
        plane_cols = torch.stack(_swar_pack_cols(rows, plan), dim=1)    # [N, NP]
        inactive = torch.tensor(sentinels, dtype=torch.int32, device=dev)
        allocs_in = torch.stack(_swar_pack_cols(allocs, plan), dim=1)   # [G, NP]
        guards = torch.tensor(guard_vals, dtype=torch.int32, device=dev)
    else:
        plane_cols = rows
        inactive = torch.full(
            (len(keep),), float("inf"), dtype=torch.float32, device=dev
        )
        allocs_in = allocs
        guards = None
    NP = plane_cols.shape[1]
    P_pad = P + (-P) % STEP_BLOCK
    stream = inactive.expand(G, P_pad, NP).contiguous()
    sorted_masks = torch.gather(pod_masks, 1, order)                 # [G, P]
    stream[:, :P] = torch.where(sorted_masks[:, :, None], plane_cols[rows_of], inactive)
    return ScanOperands(
        stream=stream,
        allocs=allocs_in.contiguous(),
        caps=caps.contiguous(),
        guards=guards,
        max_nodes=max_nodes,
        order=order,
        plan=plan,
        keep=keep,
        allocs_kept=allocs,
        num_resources=R_full,
        rows=full_rows,
        rows_of=rows_of,
    )


# -- the two kernels: wrappers and their plain versions ----------------------


SEARCH_CHUNK = 64  # steps whose work the plain version counts at once


def _scan_plain(stream, allocs, caps, max_nodes, fit, inactive, stats, block_max,
                node_of=False):
    """The kernels' step loop in PyTorch, vectorized over groups and nodes.
    Every node is tested each step; closed nodes all hold free == alloc, so
    the min lands on node `opened` exactly when the kernel's bounded test
    does. ``inactive`` is the [NP] row that masked pods carry. ``stats``,
    when given, gets the work counts of the data:

    - ``node_tests``: the node fit tests the data needs (nodes 0..first for
      a pod that fits somewhere, every open node plus one closed node
      otherwise; none for inactive rows);
    - and, as the kernels search (``_search_counts``): ``summary_tests``,
      the blocks tested against their summaries; ``candidate_blocks``, the
      blocks that passed and were searched; ``rounds``, the search rounds
      of GROUP_WARPS blocks each (one barrier each); ``placements``; and
      ``max_group_*`` of the last three, the largest count of any group
      (the kernels end with their slowest group).

    ``block_max`` gives the block summaries of a carry: the kernels keep
    each summary exact at every step (refreshed on every placement in its
    block), so the plain version keeps the carry before each step and
    counts SEARCH_CHUNK steps at a time: their summaries, their search and
    their node tests, each in a few whole-chunk operations. With
    ``node_of`` it also returns the node each step's pod took (-1 where it
    was not placed), as the kernels write it when asked."""
    G, P_pad, NP = stream.shape
    dev = stream.device
    M = max_nodes
    free = allocs[:, :, None].expand(G, NP, M).clone()               # [G, NP, M]
    opened = torch.zeros((G,), dtype=torch.int32, device=dev)
    node_ids = torch.arange(M, dtype=torch.int32, device=dev)
    rows = torch.arange(G, device=dev)
    placed = torch.zeros((G, P_pad), dtype=torch.bool, device=dev)
    nodes = torch.full((G, P_pad), -1, dtype=torch.int32, device=dev) if node_of else None
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    if stats is not None:
        NB = -(-M // NODE_BLOCK)
        span = torch.clamp(caps, min=0, max=M)
        live = torch.zeros((G, 1, NB * NODE_BLOCK), dtype=torch.bool, device=dev)
        live[:, 0, :M] = node_ids[None, :] < span[:, None]           # below the cap
        C = min(SEARCH_CHUNK, P_pad)
        frees = torch.empty((C, G, NP, M), dtype=stream.dtype, device=dev)
        firsts = torch.empty((C, G), dtype=torch.int32, device=dev)
        openeds = torch.empty((C, G), dtype=torch.int32, device=dev)
        work = torch.zeros((3, G), dtype=torch.int64, device=dev)
    for s in range(P_pad):
        req = stream[:, s, :]                                        # [G, NP]
        fits = fit(free, req).all(dim=1)                             # [G, M]
        first = torch.where(fits, node_ids, BIG_I32).amin(dim=1)     # [G]
        place = first < caps
        if stats is not None:
            i = s % C
            frees[i] = free
            firsts[i] = first
            openeds[i] = opened
            if i == C - 1 or s == P_pad - 1:
                n, chunk = i + 1, stream[:, s - i:s + 1, :]           # chunk [G, n, NP]
                work += _search_counts(
                    block_max(frees[:n], live).flatten(0, 1),
                    chunk.transpose(0, 1).flatten(0, 1),
                    firsts[:n].flatten(), openeds[:n].flatten(),
                    span.repeat(n), fit,
                ).unflatten(1, (n, G)).sum(dim=1)
                tests += _node_tests(firsts[:n], openeds[:n], caps, chunk, inactive, M)
        # only the hit node changes; select, never a multiply by a 0/1
        # flag (inf * 0 is NaN)
        tgt = torch.clamp(first, max=M - 1).long()
        cur = free[rows, :, tgt]                                     # [G, NP]
        free[rows, :, tgt] = torch.where(place[:, None], cur - req, cur)
        opened = torch.maximum(opened, torch.where(place, first + 1, 0))
        placed[:, s] = place
        if nodes is not None:
            nodes[:, s] = torch.where(place, first, -1)
    if stats is not None:
        work = torch.cat([work, placed.sum(dim=1)[None]])            # [4, G]
        keys = ("summary_tests", "candidate_blocks", "rounds", "placements")
        counts = dict(zip(keys, work.sum(dim=1).tolist()))
        counts["node_tests"] = int(tests)
        for key, n in counts.items():
            stats[key] = stats.get(key, 0) + n
        # the kernels end with their slowest group: its share of the work
        for key, n in zip(keys[1:], work[1:].amax(dim=1).tolist()):
            stats[f"max_group_{key}"] = max(stats.get(f"max_group_{key}", 0), n)
    if nodes is not None:
        return free, opened, placed, nodes
    return free, opened, placed


def _node_tests(first, opened, caps, chunk, inactive, M):
    """The node fit tests of a plain scan on n steps → a 0-d int64: nodes
    0..first for a pod that fits somewhere, every node open after its step
    plus one closed node otherwise, none for an inactive row. first and
    opened (before each step) [n, G] i32, chunk [G, n, NP] the steps'
    requests, inactive [NP] the row masked pods carry."""
    after = torch.maximum(opened, torch.where(first < caps, first + 1, 0))
    need = torch.where(first < BIG_I32, first, torch.clamp(after, max=M - 1)) + 1
    active = (chunk != inactive).any(dim=2).transpose(0, 1)          # [n, G]
    return torch.where(active, need, 0).sum()


def _search_counts(summ, req, first, opened, span, fit, round_blocks=GROUP_WARPS):
    """The kernels' search on N group steps, counted: the blocks 0..lim/32
    (lim = min(opened, span - 1)) tested against their summaries, in passes
    of 32; within a pass, the blocks that pass searched ``round_blocks`` at
    a time in node order until the round that holds `first` → [3, N] int64
    (summary tests, candidate blocks searched, rounds). summ [N, NP, NB],
    req [N, NP], first, opened and span [N]."""
    N, NP, NB = summ.shape
    lim = torch.minimum(opened, span - 1)
    nblk = torch.where(lim >= 0, lim // NODE_BLOCK + 1, 0)           # [N]
    blk = torch.arange(NB, device=summ.device)
    cand = fit(summ, req).all(dim=1) & (blk[None, :] < nblk[:, None])  # [N, NB]
    # the kernels search below the cap only
    hit = torch.where(first < span, first // NODE_BLOCK, BIG_I32)    # [N]
    searched = torch.zeros((N,), dtype=torch.int64, device=summ.device)
    rounds = torch.zeros_like(searched)
    for q0 in range(0, NB, NODE_BLOCK):
        in_pass = cand[:, q0:q0 + NODE_BLOCK]
        n = in_pass.sum(dim=1)
        rank = (in_pass & (blk[None, q0:q0 + NODE_BLOCK] < hit[:, None])).sum(dim=1)
        at_hit = (hit >= q0) & (hit < q0 + NODE_BLOCK)
        before = hit >= q0 + NODE_BLOCK          # a pass ahead of the hit, or no hit
        r = torch.where(at_hit, rank // round_blocks + 1,
                        torch.where(before, -(-n // round_blocks), 0))
        rounds += r
        searched += torch.minimum(n, r * round_blocks)
    return torch.stack([nblk.to(torch.int64), searched, rounds])


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """[..., NB * 32] → [..., NB, 32]."""
    return x.unflatten(-1, (x.shape[-1] // NODE_BLOCK, NODE_BLOCK))


def _f32_block_max(free, live):
    """Block summaries of an f32 carry [G, NP, M], or of a run of carries
    [n, G, NP, M] → [..., NP, NB]: the max over each block's nodes below
    the cap (``live`` [G, 1, NB * 32]),
    NaN nodes left out (they fit nothing), NaN for a block with none, as
    the kernel's key max gives them."""
    free = torch.nn.functional.pad(free, (0, live.shape[-1] - free.shape[-1]))
    ok = _blocks(live & ~torch.isnan(free))
    m = torch.where(ok, _blocks(free), float("-inf")).amax(dim=-1)
    return torch.where(ok.any(dim=-1), m, float("nan"))


def _swar_fields(guard: int) -> List[int]:
    """The field masks of a packed plane, read off its guard bits: the
    fields tile the plane from bit 0, each ending at its guard bit."""
    fields, low = [], 1
    for bit in range(31):
        top = 1 << bit
        if guard & top:
            fields.append(top | (top - low))
            low = top << 1
    return fields


def _swar_block_max(guards):
    """Block summaries of a packed carry (or a run of carries, as
    ``_f32_block_max``), as the kernel's field-wise max (0 for a block with
    no node below the cap)."""
    fields = [_swar_fields(int(g)) for g in guards.tolist()]
    width = max(len(f) for f in fields)
    masks = torch.tensor(
        [f + [0] * (width - len(f)) for f in fields], dtype=torch.int32, device=guards.device
    )[None, :, :, None, None]                                        # [1, NP, F, 1, 1]

    def block_max(free, live):
        free = torch.nn.functional.pad(free, (0, live.shape[-1] - free.shape[-1]))
        x = _blocks(torch.where(live, free, 0)).unsqueeze(-3)        # [..., NP, 1, NB, 32]
        # the fields are disjoint: the sum of their maxima is their OR
        return (x & masks).amax(dim=-1).sum(dim=-2, dtype=torch.int32)

    return block_max


def _fit_f32(free, req):
    return req[:, :, None] <= free


def _scan_plain_f32(stream, allocs, caps, max_nodes, stats=None, node_of=False):
    """Plain version of K1 on K1's exact operands → (free [G, NP, M] f32,
    opened [G] i32, placed [G, P_pad] bool), and node_of [G, P_pad] i32
    when asked."""
    inactive = torch.full(
        (stream.shape[2],), float("inf"), dtype=torch.float32, device=stream.device
    )
    return _scan_plain(
        stream, allocs, caps, max_nodes, _fit_f32, inactive, stats, _f32_block_max,
        node_of,
    )


def _scan_plain_swar(stream, allocs, caps, guards, max_nodes, stats=None, node_of=False):
    """Plain version of K2 on K2's exact operands, in int32 bit arithmetic:
    z = (free | guard) - req borrows out of exactly the fields where
    free < req, clearing their guard bits."""
    g = guards[None, :, None]

    def fit(free, req):
        return (((free | g) - req[:, :, None]) & g) == g

    # the sentinel sets every field to its guard bit: the guards ARE the row
    block_max = _swar_block_max(guards) if stats is not None else None
    return _scan_plain(stream, allocs, caps, max_nodes, fit, guards, stats, block_max,
                       node_of)


def _check_kernel_operands(stream, allocs, caps, guards, max_nodes, dtype):
    """The kernels' operand checks, on either device (the plain versions
    take exactly what the kernels take)."""
    if not isinstance(stream, torch.Tensor) or stream.dim() != 3:
        raise ValueError("stream must be a 3-d tensor")
    G, P_pad, NP = stream.shape
    named = [("stream", stream, dtype, (G, P_pad, NP)),
             ("allocs", allocs, dtype, (G, NP)),
             ("caps", caps, torch.int32, (G,))]
    if guards is not None:
        named.append(("guards", guards, torch.int32, (NP,)))
    for name, t, want_dtype, shape in named:
        if t.device != stream.device or t.dtype != want_dtype:
            raise ValueError(f"{name} must be {want_dtype} on {stream.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor")
    if P_pad % STEP_BLOCK or max_nodes < 1:
        raise ValueError(
            f"P_pad ({P_pad}) must be a multiple of {STEP_BLOCK}, "
            f"max_nodes ({max_nodes}) >= 1"
        )


def _require_cuda(stream):
    if stream.device.type != "cuda":
        raise ValueError(f"the scan kernels run on CUDA or CPU tensors, got {stream.device}")


def _launch(name, stream, allocs, caps, guards, max_nodes, node_of=False):
    G, P_pad, NP = stream.shape
    dev = stream.device
    free = torch.empty((G, NP, max_nodes), dtype=stream.dtype, device=dev)
    opened = torch.empty((G,), dtype=torch.int32, device=dev)
    placed = torch.empty((G, P_pad), dtype=torch.uint8, device=dev)
    nodes = torch.empty((G, P_pad), dtype=torch.int32, device=dev) if node_of else None
    lib = _build.load("ffd_scan")
    # the range names the kernel on a captured profile (trace/device.py)
    with torch.cuda.device(dev), device_annotation(name):
        cuda_stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [stream.data_ptr(), allocs.data_ptr(), caps.data_ptr()]
        if guards is not None:
            ptrs.append(guards.data_ptr())
        ptrs += [free.data_ptr(), opened.data_ptr(), placed.data_ptr(),
                 nodes.data_ptr() if nodes is not None else None]
        err = getattr(lib, name)(*ptrs, G, P_pad, NP, max_nodes, cuda_stream)
    _build.check(err, name)
    LAUNCHES[name] += 1
    if nodes is not None:
        return free, opened, placed.view(torch.bool), nodes
    return free, opened, placed.view(torch.bool)


def smem_bytes(planes: int, max_nodes: int) -> int:
    """The dynamic shared memory a kernel launch requests for each group's
    block, as ``csrc/ffd_scan.cu`` computes it for the launch."""
    return int(_build.load("ffd_scan").ffd_scan_smem_bytes(planes, max_nodes))


def ffd_scan_f32(stream, allocs, caps, max_nodes, node_of=False):
    """K1: the f32 scan. CUDA tensors launch the kernel; CPU tensors run
    the plain version. ``node_of`` adds the node each pod took."""
    _check_kernel_operands(stream, allocs, caps, None, max_nodes, torch.float32)
    if stream.device.type == "cpu":
        return _scan_plain_f32(stream, allocs, caps, max_nodes, node_of=node_of)
    _require_cuda(stream)
    return _launch("ffd_scan_f32", stream, allocs, caps, None, max_nodes, node_of)


def ffd_scan_swar(stream, allocs, caps, guards, max_nodes, node_of=False):
    """K2: the SWAR scan. CUDA tensors launch the kernel; CPU tensors run
    the plain version. ``node_of`` adds the node each pod took."""
    _check_kernel_operands(stream, allocs, caps, guards, max_nodes, torch.int32)
    if stream.device.type == "cpu":
        return _scan_plain_swar(stream, allocs, caps, guards, max_nodes, node_of=node_of)
    _require_cuda(stream)
    return _launch("ffd_scan_swar", stream, allocs, caps, guards, max_nodes, node_of)


def run_scan(ops: ScanOperands, node_of=False):
    """The scan on prepared operands → (free [G, NP, M], opened [G],
    placed [G, P_pad] bool), and node_of [G, P_pad] i32 when asked,
    through K2 on the SWAR route, else K1."""
    kw = {"node_of": True} if node_of else {}
    if ops.plan is not None:
        return ffd_scan_swar(ops.stream, ops.allocs, ops.caps, ops.guards, ops.max_nodes, **kw)
    return ffd_scan_f32(ops.stream, ops.allocs, ops.caps, ops.max_nodes, **kw)


def summed_node_used(ops: ScanOperands, node_of: torch.Tensor) -> torch.Tensor:
    """node_used [G, M, R] f32 as the XLA scan computes it: each node's
    placed requests added in f32, in the group's score order. The k-th pod
    placed on a node is added in pass k, so a pass adds at most one pod to
    a node: as many passes as the most pods on one node, no atomics."""
    G, P = ops.rows_of.shape
    M, R = ops.max_nodes, ops.num_resources
    dev = node_of.device
    nodes = node_of[:, :P].long()                                   # [G, P]
    placed = nodes >= 0
    # rank of each pod among the earlier pods on its node: sort by node
    # (stably, so score order holds within a node), minus the run's start
    key = torch.where(placed, nodes, M)
    sorted_key, perm = torch.sort(key, dim=1, stable=True)
    start = torch.searchsorted(sorted_key, sorted_key, side="left")
    rank = torch.empty_like(perm)
    rank.scatter_(1, perm, torch.arange(P, device=dev).expand(G, P) - start)
    flat = torch.nonzero(placed.flatten()).squeeze(1)               # placed pods
    by_rank = flat[torch.sort(rank.flatten()[flat], stable=True).indices]
    counts = torch.bincount(rank.flatten()[flat]).tolist() if flat.numel() else []
    target = (by_rank // P) * M + nodes.flatten()[by_rank]           # g·M + node
    req = ops.rows[ops.rows_of.flatten()[by_rank]]                   # [n, R]
    used = torch.zeros((G * M, R), dtype=torch.float32, device=dev)
    at = 0
    for n in counts:
        idx = target[at:at + n]
        used[idx] = used[idx] + req[at:at + n]
        at += n
    return used.reshape(G, M, R)


def finish_scan(ops: ScanOperands, free, opened, placed, node_of=None) -> BinpackResult:
    """Everything after the kernel: un-sort the placement bits to pod
    order, unpack SWAR free capacity, node_used = alloc − free (or, given
    ``node_of``, the placed requests summed as the XLA scan sums them), and
    put the dropped resource axes back as zero columns."""
    G, P = ops.order.shape
    scheduled = torch.zeros((G, P), dtype=torch.bool, device=free.device)
    scheduled.scatter_(1, ops.order, placed[:, :P])
    if node_of is not None:
        return BinpackResult(
            node_count=opened, scheduled=scheduled,
            node_used=summed_node_used(ops, node_of),
        )
    if ops.plan is not None:
        free = _swar_unpack_free(free.transpose(0, 1), ops.plan, len(ops.keep))
        free = free.transpose(0, 1)                                   # [G, R_k, M]
    node_used = (ops.allocs_kept[:, :, None] - free).transpose(1, 2)  # [G, M, R_k]
    if len(ops.keep) < ops.num_resources:
        full = torch.zeros(
            (G, ops.max_nodes, ops.num_resources), dtype=torch.float32,
            device=free.device,
        )
        full[:, :, ops.keep] = node_used
        node_used = full
    return BinpackResult(
        node_count=opened, scheduled=scheduled, node_used=node_used.contiguous()
    )


@observed
def ffd_binpack_groups_cuda(
    pod_req: torch.Tensor,          # [P, R] f32
    pod_masks: torch.Tensor,        # [G, P] bool
    template_allocs: torch.Tensor,  # [G, R] f32
    max_nodes: int,
    node_caps: Optional[torch.Tensor] = None,  # [G] i32
    scan_plan: Optional[ScanPlan] = None,
) -> BinpackResult:
    """The plain FFD over every node group in one scan — the port of
    ``ffd_binpack_groups_pallas``. Returns BinpackResult(node_count [G] i32,
    scheduled [G, P] bool, node_used [G, max_nodes, R] f32) on the inputs'
    device. ``scan_plan``, when given, is ``plan_scan``'s on the same operands."""
    P, R = pod_req.shape
    G = pod_masks.shape[0]
    if P == 0 or G == 0:
        _check_operands(pod_req, pod_masks, template_allocs, node_caps)
        dev = pod_req.device
        return BinpackResult(
            node_count=torch.zeros((G,), dtype=torch.int32, device=dev),
            scheduled=torch.zeros((G, P), dtype=torch.bool, device=dev),
            node_used=torch.zeros((G, max_nodes, R), dtype=torch.float32, device=dev),
        )
    ops = prepare_scan(pod_req, pod_masks, template_allocs, max_nodes, node_caps, scan_plan)
    return finish_scan(ops, *run_scan(ops))


@observed
def ffd_binpack_scenarios_cuda(
    scen_req: torch.Tensor,     # [S, P, R] f32
    scen_masks: torch.Tensor,   # [S, G, P] bool
    scen_allocs: torch.Tensor,  # [S, G, R] f32
    max_nodes: int,
    scen_caps: Optional[torch.Tensor] = None,  # [S, G] i32
    scan_plan: Optional[ScanPlan] = None,
) -> BinpackResult:
    """A batch of S independent scenarios in ONE K1/K2 launch over S·G
    groups (``prepare_scenarios``) — the port of ``ffd_binpack_scenarios``
    on the kernels. Returns BinpackResult(node_count [S, G] i32, scheduled
    [S, G, P] bool, node_used [S, G, max_nodes, R] f32) on the inputs'
    device, equal to ``ops/binpack.ffd_binpack_scenarios`` on the same
    operands. ``scan_plan``, when given, is ``plan_scan``'s on the
    flattened batch."""
    S, P, R = scen_req.shape
    G = scen_masks.shape[1]
    if S * P == 0 or S * G == 0:
        dev = scen_req.device
        return BinpackResult(
            node_count=torch.zeros((S, G), dtype=torch.int32, device=dev),
            scheduled=torch.zeros((S, G, P), dtype=torch.bool, device=dev),
            node_used=torch.zeros((S, G, max_nodes, R), dtype=torch.float32, device=dev),
        )
    ops = prepare_scenarios(scen_req, scen_masks, scen_allocs, max_nodes, scen_caps, scan_plan)
    res = finish_scan(ops, *run_scan(ops, node_of=True))
    return BinpackResult(
        node_count=res.node_count.reshape(S, G),
        scheduled=res.scheduled.reshape(S, G, P),
        node_used=res.node_used.reshape(S, G, max_nodes, R),
    )
