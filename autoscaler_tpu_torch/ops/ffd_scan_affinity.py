"""The FFD scan gated by dynamic inter-pod (anti-)affinity and hard
topology spread, over every node group, on a hand-written CUDA kernel:
the counterpart of ``autoscaler_tpu/ops/pallas_binpack_affinity.py``
(``ffd_binpack_groups_affinity_pallas`` and its kernel
``_scan_kernel_aff``).

``ffd_binpack_groups_affinity_cuda`` has the semantics of the JAX
package's ``ffd_binpack_groups_affinity_pallas``, and the same glue
around its kernel:

- the scores use the raw allocs; then ``clamp_inf_allocs`` turns +inf
  (unlimited CSI attach planes) into a finite always-fits power of two;
- the term rows ``match``, ``aff_of`` and ``anti_of`` [T, P] become int32
  bitsets [TP, P], TP = ceil(T / 32) (term t is bit t % 32 of plane
  t // 32; term 31 is the sign bit, so packing goes through int64 and
  reinterprets the low 32 bits), and so do ``node_level`` and
  ``has_label``;
- with ``spread`` (S <= 32 terms; more raise), each pod's spread rows
  become two int32 bitsets and the per-(term, group) statics a [G, 8, S]
  table, in the order nl_s, hl_s, skew, mind, st_count, min_others_eff,
  st_min, st_domnum. ``force_zero`` folds into min_others_eff = 0: the
  kernel takes min(min_others_eff, cnt), and min(0, cnt) == 0 because
  counts are never negative;
- a stable sort of each group's pods by ``-score`` and a gather build the
  request stream [G, P_pad, R] (masked pods +inf) and the bit stream
  [G, P_pad, 3 TP (+2)]; the bit payloads of masked pods are NOT masked,
  they never place and so never reach the state. After the scan a scatter
  on the same order puts the placement bits back in pod order, and
  node_used = alloc − free.

The scan is ``ffd_scan_aff`` (K3): for a tensor on a CUDA card it launches
the kernel of ``csrc/ffd_scan_affinity.cu`` and counts the launch in
``LAUNCHES``; for a tensor on the CPU it runs its plain PyTorch version
``_scan_plain_aff``, which computes the kernel's step on the kernel's
exact operands. There is no fallback from one to the other. Constraint
attribution (``attribution=True`` in the JAX package) comes with the
explain slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.ops import _build
from autoscaler_tpu_torch.ops.binpack import BinpackResult, score_order
from autoscaler_tpu_torch.ops.ffd_scan import (
    BIG_I32,
    NODE_BLOCK,
    SEARCH_CHUNK,
    STEP_BLOCK,
    _f32_block_max,
    _fit_f32,
    _search_counts,
    clamp_inf_allocs,
)

MAX_SPREAD = 32          # the spread bitset payload is one int32 plane
GROUP_WARPS = 8          # warps of each group's block (kWarps in csrc/ffd_scan_affinity.cu)
WARP_BLOCKS = 4          # candidate blocks a warp tests a round (kWarpBlocks there)

# Launch count of the kernel: the wrapper adds one where it launches it,
# and nowhere else.
LAUNCHES = {"ffd_scan_aff": 0}

# The numpy dtype of each element of the 11-array spread tuple
# (sp_of_T, sp_match_T, node_level, max_skew, min_domains, has_label,
# static_count, min_others, static_min, static_domnum, force_zero).
SPREAD_DTYPES = (
    bool, bool, bool, np.int32, np.int32, bool,
    np.int32, np.int32, np.int32, np.int32, bool,
)


def affinity_operands_from_numpy(
    pod_req, pod_masks, template_allocs, match, aff_of, anti_of, node_level,
    has_label, node_caps=None, spread=None, device=None, upload=None,
) -> dict:
    """The estimator's numpy operands → a dict of torch tensors of the
    contract's dtypes on ``device`` (None = the first CUDA card), keyed by
    the names of ``ffd_binpack_groups_affinity_cuda``'s arguments. Always a
    COPY: ``torch.from_numpy`` would alias host memory that callers
    mutate. ``upload`` (array → tensor on ``device``: an operand arena's
    resident copy) replaces the plain copy."""
    dev = resolve_device(device)

    def t(a, dtype):
        a = np.asarray(a, dtype)
        return torch.tensor(a, device=dev) if upload is None else upload(a)

    return {
        "pod_req": t(pod_req, np.float32),
        "pod_masks": t(pod_masks, bool),
        "template_allocs": t(template_allocs, np.float32),
        "match": t(match, bool),
        "aff_of": t(aff_of, bool),
        "anti_of": t(anti_of, bool),
        "node_level": t(node_level, bool),
        "has_label": t(has_label, bool),
        "node_caps": None if node_caps is None else t(node_caps, np.int32),
        "spread": (
            None if spread is None
            else tuple(t(a, dt) for a, dt in zip(spread, SPREAD_DTYPES))
        ),
    }


def _pack_term_bits(rows: torch.Tensor, TP: int) -> torch.Tensor:
    """[T, N] bool → [TP, N] int32 bitsets (term t → bit t % 32 of plane
    t // 32). The sum runs in int64 and its low 32 bits are reinterpreted
    as int32, so term 31 lands in the sign bit."""
    T, N = rows.shape
    r = torch.zeros((TP * 32, N), dtype=torch.int64, device=rows.device)
    r[:T] = rows.to(torch.int64)
    weights = torch.ones((32,), dtype=torch.int64, device=rows.device) << torch.arange(
        32, dtype=torch.int64, device=rows.device
    )
    planes = (r.reshape(TP, 32, N) * weights[None, :, None]).sum(dim=1)
    return torch.where(planes >= 2**31, planes - 2**32, planes).to(torch.int32)


def affinity_smem_bytes(R: int, TP: int, S: int, max_nodes: int) -> int:
    """The dynamic shared memory a K3 launch requests for each group's
    block, as ``csrc/ffd_scan_affinity.cu`` computes it for the launch."""
    return int(_build.load("ffd_scan_affinity").ffd_scan_aff_smem_bytes(R, TP, S, max_nodes))


class AffScanOperands(NamedTuple):
    """What the glue hands K3, and what it needs back."""

    stream: torch.Tensor    # [G, P_pad, R] f32, +inf rows for masked pods
    bits: torch.Tensor      # [G, P_pad, 3 TP (+2)] i32: m, a, x (, spof, spmt)
    allocs: torch.Tensor    # [G, R] f32, clamped
    caps: torch.Tensor      # [G] i32, already <= max_nodes
    nl: torch.Tensor        # [TP] i32
    hl: torch.Tensor        # [G, TP] i32
    spstat: Optional[torch.Tensor]  # [G, 8, S] i32, or None without spread
    num_planes: int         # TP
    num_spread: int         # S (0 without spread)
    max_nodes: int
    order: torch.Tensor     # [G, P] int64: the score sort


def _check_operands(pod_req, pod_masks, template_allocs, match, aff_of, anti_of,
                    node_level, has_label, node_caps):
    P, R = pod_req.shape
    G = pod_masks.shape[0]
    T = match.shape[0]
    for name, t, dtype, shape in (
        ("pod_req", pod_req, torch.float32, (P, R)),
        ("pod_masks", pod_masks, torch.bool, (G, P)),
        ("template_allocs", template_allocs, torch.float32, (G, R)),
        ("match", match, torch.bool, (T, P)),
        ("aff_of", aff_of, torch.bool, (T, P)),
        ("anti_of", anti_of, torch.bool, (T, P)),
        ("node_level", node_level, torch.bool, (T,)),
        ("has_label", has_label, torch.bool, (G, T)),
        ("node_caps", node_caps, torch.int32, (G,)),
    ):
        if t is None and name == "node_caps":
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise ValueError(f"{name} must be a {dtype} tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != pod_req.device:
            raise ValueError(f"{name} is on {t.device}, pod_req on {pod_req.device}")


def _spread_statics(spread, G: int) -> torch.Tensor:
    """The 11-tensor spread tuple's per-(term, group) statics → [G, 8, S]
    i32, with the Pallas form of the minDomains fold: force_zero sets
    min_others_eff to 0."""
    (_sp_of, _sp_match, sp_nl, sp_skew, sp_mind, sp_hl, sp_stc,
     sp_mino, sp_stmin, sp_stdom, sp_fz) = spread
    S = sp_nl.shape[0]

    def bcast(a):
        return a.to(torch.int32)[None, :].expand(G, S)

    mino_eff = torch.where(sp_fz, 0, sp_mino.to(torch.int32))
    return torch.stack([
        bcast(sp_nl), sp_hl.to(torch.int32), bcast(sp_skew), bcast(sp_mind),
        sp_stc.to(torch.int32), mino_eff, sp_stmin.to(torch.int32),
        sp_stdom.to(torch.int32),
    ], dim=1).contiguous()


def prepare_scan_aff(
    pod_req, pod_masks, template_allocs, max_nodes, match, aff_of, anti_of,
    node_level, has_label, node_caps=None, spread=None,
) -> AffScanOperands:
    """Everything before the kernel: caps, scores and their stable sort,
    the inf clamp, the term bitsets, the spread statics, and the sorted
    request and bit streams."""
    _check_operands(pod_req, pod_masks, template_allocs, match, aff_of, anti_of,
                    node_level, has_label, node_caps)
    if max_nodes < 1:
        raise ValueError(f"max_nodes must be >= 1, got {max_nodes}")
    dev = pod_req.device
    P, R = pod_req.shape
    G = pod_masks.shape[0]
    T = match.shape[0]
    TP = max((T + 31) // 32, 1)
    if node_caps is None:
        node_caps = torch.full((G,), max_nodes, dtype=torch.int32, device=dev)
    caps = torch.clamp(node_caps, max=max_nodes).contiguous()
    order = score_order(pod_req, template_allocs)                   # [G, P]
    allocs = clamp_inf_allocs(pod_req, template_allocs).contiguous()

    bit_cols = [
        _pack_term_bits(match, TP), _pack_term_bits(aff_of, TP),
        _pack_term_bits(anti_of, TP),
    ]                                                               # 3 × [TP, P]
    nl = _pack_term_bits(node_level[:, None], TP)[:, 0].contiguous()  # [TP]
    hl = _pack_term_bits(has_label.T, TP).T.contiguous()            # [G, TP]
    S = 0
    spstat = None
    if spread is not None:
        S = spread[2].shape[0]
        if S > MAX_SPREAD:
            raise ValueError(
                f"the spread bitset payload holds at most {MAX_SPREAD} terms; got {S} "
                "(the estimator routes larger term sets to the torch loop)"
            )
        bit_cols += [
            _pack_term_bits(spread[0].T, 1), _pack_term_bits(spread[1].T, 1),
        ]                                                           # 2 × [1, P]
        spstat = _spread_statics(spread, G)
    bit_rows = torch.cat(bit_cols, dim=0).T                         # [P, NB]
    NB = bit_rows.shape[1]

    P_pad = P + (-P) % STEP_BLOCK
    sorted_masks = torch.gather(pod_masks, 1, order)                # [G, P]
    stream = torch.full((G, P_pad, R), float("inf"), dtype=torch.float32, device=dev)
    stream[:, :P] = torch.where(sorted_masks[:, :, None], pod_req[order], float("inf"))
    bits = torch.zeros((G, P_pad, NB), dtype=torch.int32, device=dev)
    bits[:, :P] = bit_rows[order]
    return AffScanOperands(
        stream=stream, bits=bits, allocs=allocs, caps=caps, nl=nl, hl=hl,
        spstat=spstat, num_planes=TP, num_spread=S, max_nodes=max_nodes,
        order=order,
    )


# -- K3: wrapper and plain version -------------------------------------------


def _scan_plain_aff(stream, bits, allocs, caps, nl, hl, spstat, num_planes,
                    num_spread, max_nodes, stats=None):
    """Plain version of K3 on K3's exact operands → (free [G, R, M] f32,
    opened [G] i32, placed [G, P_pad] bool): the Pallas kernel's step,
    vectorized over groups, term planes, spread terms and nodes. Every
    node is tested each step; closed nodes all hold free == alloc, so the
    minimum lands on node `opened` exactly when the kernel's bounded test
    does. Steps that are inactive (+inf) in every group are skipped: they
    fit nowhere. ``stats``, when given, gets the work the data needs:

    - ``node_tests``, the node fit tests of a plain scan (nodes 0..first
      for a pod that fits somewhere, every open node plus one closed node
      otherwise; none for inactive rows or for a step a group-level spread
      term blocks); ``gate_plane_tests``, the term-gate evaluations (each
      tested open node that passes the fit, times the pod's term planes
      with a bit set); ``host_gate_tests``, the hostname spread-gate
      evaluations (each such node, times the hostname-level terms the pod
      declares); and ``open_min_nodes``, the open nodes read by the
      hostname minima;
    - and, as the kernel searches (``ffd_scan._search_counts`` with the
      gated `first`, rounds of GROUP_WARPS × WARP_BLOCKS candidate blocks):
      ``summary_tests``, ``candidate_blocks``, ``rounds``, ``placements``
      and the busiest group's ``max_group_*`` of the last three. Inactive
      rows and steps that a group-level spread term blocks search nothing.
      The block summaries are taken afresh from the carry before each step
      (the kernel keeps them exact), and the search is counted SEARCH_CHUNK
      active steps at a time."""
    G, P_pad, R = stream.shape
    TP, S, M = num_planes, num_spread, max_nodes
    dev = stream.device
    free = allocs[:, :, None].expand(G, R, M).clone()               # [G, R, M]
    opened = torch.zeros((G,), dtype=torch.int32, device=dev)
    pm = torch.zeros((G, TP, M), dtype=torch.int32, device=dev)
    ha = torch.zeros_like(pm)
    pmt = torch.zeros((G, TP), dtype=torch.int32, device=dev)
    hat = torch.zeros_like(pmt)
    node_ids = torch.arange(M, dtype=torch.int32, device=dev)
    rows = torch.arange(G, device=dev)
    placed = torch.zeros((G, P_pad), dtype=torch.bool, device=dev)
    nl_ = nl[None, :]                                               # [1, TP]
    if S:
        spc = torch.zeros((G, S, M), dtype=torch.int32, device=dev)
        spct = torch.zeros((G, S), dtype=torch.int32, device=dev)
        shifts = torch.arange(S, dtype=torch.int32, device=dev)
        nl_s, hl_s, skew, mind, st_count, mino_eff, st_min, st_domnum = (
            spstat.unbind(dim=1)
        )                                                           # each [G, S]
        nl_s, hl_s = nl_s != 0, hl_s != 0
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    active_rows = ~torch.isinf(stream[:, :, 0])                     # [G, P_pad]
    steps = torch.nonzero(active_rows.any(dim=0)).flatten().tolist()
    work = {
        k: torch.zeros((), dtype=torch.int64, device=dev)
        for k in ("node_tests", "gate_plane_tests", "host_gate_tests", "open_min_nodes")
    }
    if stats is not None:
        NB = -(-M // NODE_BLOCK)
        span = torch.clamp(caps, min=0, max=M)
        live = torch.zeros((G, 1, NB * NODE_BLOCK), dtype=torch.bool, device=dev)
        live[:, 0, :M] = node_ids[None, :] < span[:, None]          # below the cap
        C = min(SEARCH_CHUNK, len(steps))
        summs = torch.empty((C, G, R, NB), dtype=torch.float32, device=dev)
        firsts = torch.empty((C, G), dtype=torch.int32, device=dev)
        openeds = torch.empty_like(firsts)
        spans = torch.empty_like(firsts)
        search = torch.zeros((3, G), dtype=torch.int64, device=dev)
    for k, s in enumerate(steps):
        req = stream[:, s, :]                                       # [G, R]
        b = bits[:, s, :]
        m_p, a_p, x_p = b[:, :TP], b[:, TP:2 * TP], b[:, 2 * TP:3 * TP]  # [G, TP]
        fits = (req[:, :, None] <= free).all(dim=1)                 # [G, M]

        seed = m_p & ~pmt
        dom_pm = (pm & nl_[:, :, None]) | (pmt & ~nl_)[:, :, None]  # [G, TP, M]
        dom_ha = (ha & nl_[:, :, None]) | (hat & ~nl_)[:, :, None]
        h = hl[:, :, None]
        viol = (
            (a_p[:, :, None] & (~h | ~(dom_pm | seed[:, :, None])))
            | (x_p[:, :, None] & dom_pm & h)
            | (m_p[:, :, None] & dom_ha & h)
        )
        gate_open = (viol == 0).all(dim=1)                          # [G, M]
        nv = (
            (a_p & ~((nl_ & seed) | (~nl_ & hl & (pmt | seed))))
            | (x_p & ~nl_ & pmt & hl)
            | (m_p & ~nl_ & hat & hl)
        )
        new_ok = (nv == 0).all(dim=1)                               # [G]
        is_open = node_ids[None, :] < opened[:, None]               # [G, M]

        if S:
            spof, spmt = b[:, 3 * TP], b[:, 3 * TP + 1]             # [G]
            sp_o = ((spof[:, None] >> shifts) & 1) != 0             # [G, S]
            self_i = (spmt[:, None] >> shifts) & 1                  # [G, S] i32
            upd = (self_i != 0) & hl_s
            # group-level; the Pallas form of the minDomains fold
            cnt = st_count + spct
            min_eff_z = torch.minimum(mino_eff, cnt)
            bad_z = sp_o & ~nl_s & hl_s & (cnt + self_i - min_eff_z > skew)
            group_ok = ~bad_z.any(dim=1)                            # [G]
            # hostname-level: the minimum over the OPEN nodes' counts
            dyn_min = torch.where(is_open[:, None, :], spc, BIG_I32).amin(dim=2)
            domnum = st_domnum + opened[:, None]
            min_eff_h = torch.where(mind > domnum, 0, torch.minimum(st_min, dyn_min))
            bad_h = (sp_o & nl_s)[:, :, None] & (
                spc + self_i[:, :, None] - min_eff_h[:, :, None] > skew[:, :, None]
            )
            node_bad = bad_h.any(dim=1)                             # [G, M]
            gate = torch.where(is_open, gate_open & ~node_bad, new_ok[:, None])
            gate &= group_ok[:, None]
        else:
            gate = torch.where(is_open, gate_open, new_ok[:, None])

        first = torch.where(fits & gate, node_ids, BIG_I32).amin(dim=1)  # [G]
        place = first < caps
        if stats is not None:
            i = k % C
            summs[i] = _f32_block_max(free, live)
            firsts[i] = first
            openeds[i] = opened
            searched = active_rows[:, s] & group_ok if S else active_rows[:, s]
            spans[i] = torch.where(searched, span, 0)   # an empty span searches nothing
            if i == C - 1 or k == len(steps) - 1:
                chunk = steps[k - i:k + 1]
                search += _search_counts(
                    summs[:i + 1].flatten(0, 1),
                    stream[:, chunk, :].transpose(0, 1).flatten(0, 1),
                    firsts[:i + 1].flatten(), openeds[:i + 1].flatten(),
                    spans[:i + 1].flatten(), _fit_f32, GROUP_WARPS * WARP_BLOCKS,
                ).unflatten(1, (i + 1, G)).sum(dim=1)
        # only the hit node changes; select, never a multiply by a 0/1
        # flag (inf * 0 is NaN)
        tgt = torch.clamp(first, max=M - 1).long()
        cur = free[rows, :, tgt]                                    # [G, R]
        free[rows, :, tgt] = torch.where(place[:, None], cur - req, cur)
        m_add = torch.where(place[:, None], m_p, zero)              # [G, TP]
        x_add = torch.where(place[:, None], x_p, zero)
        pm[rows, :, tgt] |= m_add
        ha[rows, :, tgt] |= x_add
        pmt |= m_add
        hat |= x_add
        if S:
            u = (place[:, None] & upd).to(torch.int32)              # [G, S]
            spc[rows, :, tgt] += u
            spct += u
        if stats is not None:
            act = active_rows[:, s]
            lim = torch.clamp(opened, max=M - 1)
            need = torch.where(first < BIG_I32, first, lim) + 1
            # the gates run only on tested open nodes that pass the fit
            gated = (fits & is_open & (node_ids[None, :] < need[:, None])).sum(dim=1)
            planes = ((m_p | a_p | x_p) != 0).sum(dim=1)
            if S:
                # a group-level verdict that blocks the step needs no node
                # test; the hostname minima are taken before it
                host_terms = (sp_o & nl_s).sum(dim=1)
                work["open_min_nodes"] += torch.where(act, host_terms * opened, 0).sum()
                act = act & group_ok
                work["host_gate_tests"] += torch.where(act, gated * host_terms, 0).sum()
            work["node_tests"] += torch.where(act, need, 0).sum()
            work["gate_plane_tests"] += torch.where(act, gated * planes, 0).sum()
        opened = torch.maximum(opened, torch.where(place, first + 1, 0))
        placed[:, s] = place
    if stats is not None:
        for key, v in work.items():
            stats[key] = stats.get(key, 0) + int(v)
        search = torch.cat([search, placed.sum(dim=1)[None]])        # [4, G]
        keys = ("summary_tests", "candidate_blocks", "rounds", "placements")
        for key, n in zip(keys, search.sum(dim=1).tolist()):
            stats[key] = stats.get(key, 0) + n
        # the kernel ends with its slowest group: its share of the work
        for key, n in zip(keys[1:], search[1:].amax(dim=1).tolist()):
            stats[f"max_group_{key}"] = max(stats.get(f"max_group_{key}", 0), n)
    return free, opened, placed


def _check_kernel_operands(ops: AffScanOperands):
    stream = ops.stream
    if stream.device.type != "cuda":
        raise ValueError(f"the scan kernel runs on CUDA tensors, got {stream.device}")
    G, P_pad, R = stream.shape
    TP, S = ops.num_planes, ops.num_spread
    NB = 3 * TP + (2 if S else 0)
    named = [
        ("stream", stream, torch.float32, (G, P_pad, R)),
        ("bits", ops.bits, torch.int32, (G, P_pad, NB)),
        ("allocs", ops.allocs, torch.float32, (G, R)),
        ("caps", ops.caps, torch.int32, (G,)),
        ("nl", ops.nl, torch.int32, (TP,)),
        ("hl", ops.hl, torch.int32, (G, TP)),
    ]
    if S:
        named.append(("spstat", ops.spstat, torch.int32, (G, 8, S)))
    for name, t, dtype, shape in named:
        if t is None or t.device != stream.device or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {stream.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor")
    if P_pad % STEP_BLOCK or ops.max_nodes < 1 or S > MAX_SPREAD:
        raise ValueError(
            f"P_pad ({P_pad}) must be a multiple of {STEP_BLOCK}, max_nodes "
            f"({ops.max_nodes}) >= 1, S ({S}) <= {MAX_SPREAD}"
        )


def ffd_scan_aff(ops: AffScanOperands):
    """K3 → (free [G, R, M] f32, opened [G] i32, placed [G, P_pad] bool).
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    args = (ops.stream, ops.bits, ops.allocs, ops.caps, ops.nl, ops.hl, ops.spstat,
            ops.num_planes, ops.num_spread, ops.max_nodes)
    if ops.stream.device.type == "cpu":
        return _scan_plain_aff(*args)
    _check_kernel_operands(ops)
    G, P_pad, R = ops.stream.shape
    dev = ops.stream.device
    M = ops.max_nodes
    free = torch.empty((G, R, M), dtype=torch.float32, device=dev)
    opened = torch.empty((G,), dtype=torch.int32, device=dev)
    placed = torch.empty((G, P_pad), dtype=torch.uint8, device=dev)
    lib = _build.load("ffd_scan_affinity")
    with torch.cuda.device(dev):
        cuda_stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ffd_scan_aff(
            ops.stream.data_ptr(), ops.bits.data_ptr(), ops.allocs.data_ptr(),
            ops.caps.data_ptr(), ops.nl.data_ptr(), ops.hl.data_ptr(),
            ops.spstat.data_ptr() if ops.spstat is not None else None,
            free.data_ptr(), opened.data_ptr(), placed.data_ptr(),
            G, P_pad, R, ops.num_planes, ops.num_spread, M, cuda_stream,
        )
    _build.check(err, "ffd_scan_aff")
    LAUNCHES["ffd_scan_aff"] += 1
    return free, opened, placed.view(torch.bool)


def finish_scan_aff(ops: AffScanOperands, free, opened, placed) -> BinpackResult:
    """Everything after the kernel: un-sort the placement bits to pod
    order, node_used = alloc − free."""
    G, P = ops.order.shape
    scheduled = torch.zeros((G, P), dtype=torch.bool, device=free.device)
    scheduled.scatter_(1, ops.order, placed[:, :P])
    node_used = (ops.allocs[:, :, None] - free).transpose(1, 2)     # [G, M, R]
    return BinpackResult(
        node_count=opened, scheduled=scheduled, node_used=node_used.contiguous()
    )


def ffd_binpack_groups_affinity_cuda(
    pod_req: torch.Tensor,          # [P, R] f32
    pod_masks: torch.Tensor,        # [G, P] bool
    template_allocs: torch.Tensor,  # [G, R] f32
    max_nodes: int,
    match: torch.Tensor,            # [T, P] bool
    aff_of: torch.Tensor,           # [T, P] bool
    anti_of: torch.Tensor,          # [T, P] bool
    node_level: torch.Tensor,       # [T] bool
    has_label: torch.Tensor,        # [G, T] bool
    node_caps: Optional[torch.Tensor] = None,  # [G] i32
    spread: Optional[tuple] = None,  # the 11-tensor spread tuple, S <= 32
) -> BinpackResult:
    """The affinity (+ hard spread) FFD over every node group in one scan:
    the port of ``ffd_binpack_groups_affinity_pallas``. Returns
    BinpackResult(node_count [G] i32, scheduled [G, P] bool, node_used
    [G, max_nodes, R] f32) on the inputs' device."""
    P, R = pod_req.shape
    G = pod_masks.shape[0]
    if P == 0 or G == 0:
        _check_operands(pod_req, pod_masks, template_allocs, match, aff_of, anti_of,
                        node_level, has_label, node_caps)
        dev = pod_req.device
        return BinpackResult(
            node_count=torch.zeros((G,), dtype=torch.int32, device=dev),
            scheduled=torch.zeros((G, P), dtype=torch.bool, device=dev),
            node_used=torch.zeros((G, max_nodes, R), dtype=torch.float32, device=dev),
        )
    ops = prepare_scan_aff(
        pod_req, pod_masks, template_allocs, max_nodes, match, aff_of, anti_of,
        node_level, has_label, node_caps, spread,
    )
    return finish_scan_aff(ops, *ffd_scan_aff(ops))
