"""The tiled predicate fit with an online reduction, on a hand-written CUDA
kernel — the counterpart of ``autoscaler_tpu/ops/pallas_fit.py``.

For each pod p, over every node n,

    fits[p, n] = all_r(pod_req[p, r] <= free[n, r])
                 & class_mask[pod_class[p], node_class[n]] & node_valid[n]

(a pod class outside [0, CP) or a node class outside [0, CN) never fits),
reduced to ``any_fit [P]``, ``fit_count [P]`` and ``first_fit [P]`` (the
lowest node, -1 if none) without materializing [P, N].

``fit_reduce_cuda`` is the counterpart of ``pallas_fit_reduce``: for CUDA
tensors it launches K4 from ``csrc/fit_reduce.cu`` and counts the launch
in ``LAUNCHES``; for CPU tensors it runs the plain PyTorch version
``_fit_reduce_plain``, chunked over pods so that it never holds
[P, N, R]. There is no fallback from one to the other. The Pallas tile
arguments (``tp``, ``tn``) were the TPU's tiling and have no counterpart.

``fit_reduce_rows`` is the same kernel with the class test replaced by a
given [S, N] bool row a pod (``fit_reduce_rows`` in the same source, its
launches counted in ``LAUNCHES``), where a slot vector marks padding rows,
which count nothing; its plain version is ``_fit_reduce_rows_plain``.

``live_resources`` is the kernel's rule for the compares it leaves out:
in each (pod block, node tile) of its partition, a resource whose smallest
free value (over the nodes that can pass the gate) is at least the block's
largest request (over its live pods) cannot fail a compare. The plain
versions' work counts use it.

``fit_reduce_exact`` gives a ``SnapshotTensors`` the dense path's exact
verdicts: K4 reduces the class-structured bulk of a factored snapshot, and
the few pods whose rows the class factors get wrong (exception-row pods
and the targets of the single-cell overrides) are reduced again from their
true rows through ``fit_reduce_rows`` and patched in. Every size there is
static (E exception slots, K cell slots), so the patch never waits on the
host, as the JAX package's twin runs under ``jit``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from autoscaler_tpu_torch.ops import _build

BIG_I32 = 2**31 - 1
# pairs the plain version tests at once: pods a chunk = this // N
PLAIN_CHUNK_PAIRS = 1 << 24
# the kernel's partition: pods a block (kThreads x kPods) and nodes a tile
# (kTile) of csrc/fit_reduce.cu, which a test reads back from the source
BLOCK_PODS = 512
TILE = 256

# Launch counts of the kernel's two entries: each wrapper adds one where it
# launches its entry, and nowhere else.
LAUNCHES = {"fit_reduce": 0, "fit_reduce_rows": 0}


class FitReduction(NamedTuple):
    any_fit: torch.Tensor    # [P] bool
    fit_count: torch.Tensor  # [P] i32
    first_fit: torch.Tensor  # [P] i32 node index, -1 if none


def _check_operands(pod_req, free, pod_class, node_class, class_mask, node_valid):
    if not isinstance(pod_req, torch.Tensor) or pod_req.dim() != 2:
        raise ValueError("pod_req must be a 2-d tensor")
    P, R = pod_req.shape
    N = free.shape[0] if isinstance(free, torch.Tensor) and free.dim() == 2 else -1
    for name, t, dtype, shape in (
        ("pod_req", pod_req, torch.float32, (P, R)),
        ("free", free, torch.float32, (N, R)),
        ("pod_class", pod_class, torch.int32, (P,)),
        ("node_class", node_class, torch.int32, (N,)),
        ("node_valid", node_valid, torch.bool, (N,)),
    ):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a {dtype} tensor of shape {shape}")
        if t.device != pod_req.device:
            raise ValueError(f"{name} is on {t.device}, pod_req on {pod_req.device}")
    if (
        not isinstance(class_mask, torch.Tensor) or class_mask.dtype != torch.bool
        or class_mask.dim() != 2 or class_mask.device != pod_req.device
    ):
        raise ValueError(f"class_mask must be a 2-d bool tensor on {pod_req.device}")


def _and_resource_fits(fits: torch.Tensor, req: torch.Tensor, free: torch.Tensor,
                       compares: Optional[torch.Tensor] = None,
                       live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fits [S, N] &= all_r(req [S, R] <= free [N, R]) in place, one
    resource axis at a time so [S, N, R] is never held. ``compares`` [2],
    when given, adds the compares of the pairs still true before each axis
    (up to and including the first that fails), and those of them on a
    resource that ``live`` [S, T, R] (the rows' live resources in each node
    tile) keeps."""
    if compares is not None:
        tile = torch.arange(free.shape[0], device=free.device) // TILE
    for r in range(req.shape[1]):
        if compares is not None:
            compares[0] += fits.sum()
            compares[1] += (fits & live[:, :, r][:, tile]).sum()
        fits &= req[:, r, None] <= free[None, :, r]
    return fits


def _order_keys(x: torch.Tensor, nan_key: int) -> torch.Tensor:
    """The kernel's order-preserving keys of f32 values, as int64 in
    [0, 2^32): key(a) <= key(b) implies a <= b; NaN at ``nan_key``."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(b >= 2**31, b ^ 0xFFFFFFFF, b | 2**31)
    return torch.where(torch.isnan(x), nan_key, key)


def live_resources(pod_req: torch.Tensor, free: torch.Tensor, pod_active: torch.Tensor,
                   node_can: torch.Tensor) -> torch.Tensor:
    """[B, T, R] bool over the kernel's pod blocks (BLOCK_PODS pods) and
    node tiles (TILE nodes): whether a compare on the resource can fail
    there, as the kernel decides it: the largest request of the block's
    active pods keys above the smallest free value of the tile's nodes that
    can pass (a NaN keeps its resource live). A block without an active pod
    has none; the kernel skips it."""
    top = 2**32 - 1
    R = pod_req.shape[1]
    hi = torch.where(pod_active[:, None], _order_keys(pod_req, top), 0)
    hi = torch.nn.functional.pad(hi, (0, 0, 0, -hi.shape[0] % BLOCK_PODS))
    lo = torch.where(node_can[:, None], _order_keys(free, 0), top)
    lo = torch.nn.functional.pad(lo, (0, 0, 0, -lo.shape[0] % TILE), value=top)
    hi = hi.view(-1, BLOCK_PODS, R).amax(dim=1)
    lo = lo.view(-1, TILE, R).amin(dim=1)
    return hi[:, None, :] > lo[None, :, :]


def _work_stats(stats: dict, tests_key: str, tests: int, compares: torch.Tensor,
                live: torch.Tensor, run: torch.Tensor) -> None:
    """Add a plain version's work counts to ``stats``: the gate tests, the
    compares up to the first that fails (``compares``), the same on live
    resources only (``live_compares``), and how many (block, tile) pairs
    of the blocks that run hold each number of live resources."""
    stats[tests_key] = stats.get(tests_key, 0) + tests
    stats["compares"] = stats.get("compares", 0) + int(compares[0])
    stats["live_compares"] = stats.get("live_compares", 0) + int(compares[1])
    held = torch.bincount(live[run].sum(dim=2).flatten(), minlength=live.shape[2] + 1)
    seen = stats.setdefault("live_counts", {})
    for k, n in enumerate(held.tolist()):
        if n:
            seen[k] = seen.get(k, 0) + n


def _resource_fits(req: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """[S, R] × [N, R] → [S, N] bool: all_r(req <= free)."""
    fits = torch.ones((req.shape[0], free.shape[0]), dtype=torch.bool, device=req.device)
    return _and_resource_fits(fits, req, free)


def _reduce(fits: torch.Tensor) -> FitReduction:
    """[S, N] bool verdicts → their FitReduction."""
    count = fits.sum(dim=1, dtype=torch.int32)
    node_ids = torch.arange(fits.shape[1], dtype=torch.int32, device=fits.device)
    first = torch.where(fits, node_ids, BIG_I32).amin(dim=1)
    any_fit = count > 0
    return FitReduction(any_fit, count, torch.where(any_fit, first, -1))


def _empty(P: int, device) -> FitReduction:
    return FitReduction(
        any_fit=torch.zeros((P,), dtype=torch.bool, device=device),
        fit_count=torch.zeros((P,), dtype=torch.int32, device=device),
        first_fit=torch.full((P,), -1, dtype=torch.int32, device=device),
    )


def _fit_reduce_plain(
    pod_req, free, pod_class, node_class, class_mask, node_valid,
    stats: Optional[dict] = None,
) -> FitReduction:
    """Plain version of K4 on K4's operands, chunked over pods. ``stats``,
    when given, gets the work the data needs: ``class_tests`` (one per live
    pair: pod class in range, node valid with its class in range),
    ``compares`` (the resource compares of each pair that passed its class
    test, up to and including the first that fails; R when all pass),
    ``live_compares`` (those of them on the resources ``live_resources``
    keeps, the rest of which cannot fail) and ``live_counts``."""
    P = pod_req.shape[0]
    N = free.shape[0]
    CP, CN = class_mask.shape
    dev = pod_req.device
    if P == 0 or N == 0 or CP == 0 or CN == 0:
        if stats is not None:
            for key in ("class_tests", "compares", "live_compares"):
                stats.setdefault(key, 0)
            stats.setdefault("live_counts", {})
        return _empty(P, dev)
    pod_ok = (pod_class >= 0) & (pod_class < CP)
    node_ok = node_valid & (node_class >= 0) & (node_class < CN)
    nc = node_class.clamp(0, CN - 1).long()
    outs = []
    class_tests = torch.zeros((), dtype=torch.int64, device=dev)
    compares = torch.zeros((2,), dtype=torch.int64, device=dev)
    if stats is not None:
        live = live_resources(pod_req, free, pod_ok, node_ok)
        block = torch.arange(P, device=dev) // BLOCK_PODS
    chunk = max(1, PLAIN_CHUNK_PAIRS // N)
    for s in range(0, P, chunk):
        pc = pod_class[s:s + chunk]
        req = pod_req[s:s + chunk]
        pairs = pod_ok[s:s + chunk, None] & node_ok[None, :]
        fits = class_mask[pc.clamp(0, CP - 1).long()][:, nc] & pairs
        if stats is not None:
            class_tests += pairs.sum()
        outs.append(_reduce(_and_resource_fits(
            fits, req, free, *((compares, live[block[s:s + chunk]]) if stats is not None else ()))))
    if stats is not None:
        run = torch.nn.functional.pad(pod_ok, (0, -P % BLOCK_PODS)).view(-1, BLOCK_PODS).any(dim=1)
        _work_stats(stats, "class_tests", int(class_tests), compares, live, run)
    return FitReduction(*(torch.cat(parts) for parts in zip(*outs)))


def smem_bytes(R: int, CP: int, CN: int) -> int:
    """The dynamic shared memory a K4 launch requests a block, as
    ``csrc/fit_reduce.cu`` computes it for the launch."""
    return int(_build.load("fit_reduce").fit_reduce_smem_bytes(R, CP, CN))


def fit_reduce_cuda(
    pod_req: torch.Tensor,     # [P, R] f32
    free: torch.Tensor,        # [N, R] f32 (alloc - used; 0 rows for invalid)
    pod_class: torch.Tensor,   # [P] i32 (-1 = never schedulable)
    node_class: torch.Tensor,  # [N] i32 (-1 = invalid node)
    class_mask: torch.Tensor,  # [CP, CN] bool
    node_valid: torch.Tensor,  # [N] bool
) -> FitReduction:
    """K4: the tiled fit reduction, the counterpart of ``pallas_fit_reduce``.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    _check_operands(pod_req, free, pod_class, node_class, class_mask, node_valid)
    dev = pod_req.device
    if dev.type == "cpu":
        return _fit_reduce_plain(pod_req, free, pod_class, node_class, class_mask, node_valid)
    if dev.type != "cuda":
        raise ValueError(f"fit_reduce runs on CUDA or CPU tensors, got {dev}")
    operands = (pod_req, free, pod_class, node_class, class_mask, node_valid)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("fit_reduce's operands must be contiguous")
    P, R = pod_req.shape
    N = free.shape[0]
    CP, CN = class_mask.shape
    if P == 0 or N == 0:
        return _empty(P, dev)
    count = torch.zeros((P,), dtype=torch.int32, device=dev)
    first = torch.full((P,), BIG_I32, dtype=torch.int32, device=dev)
    lib = _build.load("fit_reduce")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fit_reduce(
            *(t.data_ptr() for t in operands), count.data_ptr(), first.data_ptr(),
            P, N, R, CP, CN, stream,
        )
    _build.check(err, "fit_reduce")
    LAUNCHES["fit_reduce"] += 1
    any_fit = count > 0
    return FitReduction(any_fit, count, torch.where(any_fit, first, -1))


def _check_rows_operands(pod_req, free, rows, slots):
    if not isinstance(pod_req, torch.Tensor) or pod_req.dim() != 2:
        raise ValueError("pod_req must be a 2-d tensor")
    S, R = pod_req.shape
    N = free.shape[0] if isinstance(free, torch.Tensor) and free.dim() == 2 else -1
    for name, t, dtype, shape in (
        ("pod_req", pod_req, torch.float32, (S, R)),
        ("free", free, torch.float32, (N, R)),
        ("rows", rows, torch.bool, (S, N)),
        ("slots", slots, torch.int32, (S,)),
    ):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a {dtype} tensor of shape {shape}")
        if t.device != pod_req.device:
            raise ValueError(f"{name} is on {t.device}, pod_req on {pod_req.device}")


def _fit_reduce_rows_plain(pod_req, free, rows, slots,
                           stats: Optional[dict] = None) -> FitReduction:
    """Plain version of ``fit_reduce_rows``, chunked over rows: a row whose
    slot is negative counts nothing. ``stats``, when given, gets
    ``row_tests`` (one per pair of a row that is not padding), ``compares``
    (the resource compares of each pair whose row is true, up to and
    including the first that fails), ``live_compares`` and
    ``live_counts`` (as for ``_fit_reduce_plain``, every node able to
    pass)."""
    S = pod_req.shape[0]
    N = free.shape[0]
    dev = pod_req.device
    real = slots >= 0
    compares = torch.zeros((2,), dtype=torch.int64, device=dev)
    outs = []
    if stats is not None:
        live = live_resources(pod_req, free, real, torch.ones((N,), dtype=torch.bool, device=dev))
        block = torch.arange(S, device=dev) // BLOCK_PODS
    if S and N:
        chunk = max(1, PLAIN_CHUNK_PAIRS // N)
        for s in range(0, S, chunk):
            outs.append(_reduce(_and_resource_fits(
                rows[s:s + chunk] & real[s:s + chunk, None], pod_req[s:s + chunk], free,
                *((compares, live[block[s:s + chunk]]) if stats is not None else ()))))
    if stats is not None:
        run = torch.nn.functional.pad(real, (0, -S % BLOCK_PODS)).view(-1, BLOCK_PODS).any(dim=1)
        _work_stats(stats, "row_tests", int(real.sum()) * N, compares, live, run)
    if not outs:
        return _empty(S, dev)
    return FitReduction(*(torch.cat(parts) for parts in zip(*outs)))


def launch_geometry(P: int, N: int, R: int, CP: int = 0, CN: int = 0, rows: bool = False):
    """(grid.x, grid.y, resident blocks an SM) of a K4 launch (its rows
    entry when ``rows``) on the current card, as ``csrc/fit_reduce.cu``
    computes them; launches nothing."""
    out = (ctypes.c_int * 3)()
    err = _build.load("fit_reduce").fit_reduce_geometry(P, N, R, CP, CN, int(rows), out)
    _build.check(err, "fit_reduce_geometry")
    return tuple(out)


def rows_smem_bytes(R: int) -> int:
    """The dynamic shared memory a ``fit_reduce_rows`` launch requests a
    block, as ``csrc/fit_reduce.cu`` computes it for the launch."""
    return int(_build.load("fit_reduce").fit_reduce_rows_smem_bytes(R))


def fit_reduce_rows(
    pod_req: torch.Tensor,  # [S, R] f32
    free: torch.Tensor,     # [N, R] f32
    rows: torch.Tensor,     # [S, N] bool
    slots: torch.Tensor,    # [S] i32, negative for padding rows
) -> FitReduction:
    """K4's body with the class test replaced by ``rows``: for each row s,
    the count and first node n of all_r(pod_req[s] <= free[n]) & rows[s, n];
    a row whose slot is negative counts nothing, and the kernel reads
    neither it nor its request. CUDA tensors launch the kernel's rows entry;
    CPU tensors run the plain version."""
    _check_rows_operands(pod_req, free, rows, slots)
    dev = pod_req.device
    if dev.type == "cpu":
        return _fit_reduce_rows_plain(pod_req, free, rows, slots)
    if dev.type != "cuda":
        raise ValueError(f"fit_reduce_rows runs on CUDA or CPU tensors, got {dev}")
    if not all(t.is_contiguous() for t in (pod_req, free, rows, slots)):
        raise ValueError("fit_reduce_rows's operands must be contiguous")
    S, R = pod_req.shape
    N = free.shape[0]
    if S == 0 or N == 0:
        return _empty(S, dev)
    count = torch.zeros((S,), dtype=torch.int32, device=dev)
    first = torch.full((S,), BIG_I32, dtype=torch.int32, device=dev)
    lib = _build.load("fit_reduce")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fit_reduce_rows(
            pod_req.data_ptr(), free.data_ptr(), rows.data_ptr(), slots.data_ptr(),
            count.data_ptr(), first.data_ptr(), S, N, R, stream,
        )
    _build.check(err, "fit_reduce_rows")
    LAUNCHES["fit_reduce_rows"] += 1
    any_fit = count > 0
    return FitReduction(any_fit, count, torch.where(any_fit, first, -1))


def special_pods(snap) -> torch.Tensor:
    """[E + K] i64, the pods of a factored snapshot whose rows the class
    factors get wrong, in static slots: slot e < E holds the pod whose
    exception row is e, slot E + k the target of cell k; -1 where there is
    none. Each pod fills at most one slot (the packer bakes the cells of an
    exception-row pod into its row), and nothing here waits on the host."""
    P = snap.num_pods
    E = snap.exc_rows.shape[0]
    dev = snap.device
    pods = torch.arange(P, device=dev)
    # a pod without a row writes a slot of its own past E, so no two
    # writes meet and the slots past E are dropped
    slot = torch.where(snap.pod_exc >= 0, snap.pod_exc.long(), E + pods)
    exc = torch.full((E + P,), -1, dtype=torch.int64, device=dev)
    exc.scatter_(0, slot, pods)
    return torch.cat([exc[:E], snap.cell_pod.long()])


def special_rows(snap) -> torch.Tensor:
    """[E + K, N] bool, the true rows of ``special_pods``' slots with the
    node validity folded in: the exception rows as they are, and for cell k
    its target's class row with the cell's value at ``cell_node[k]``. A
    slot without a pod gets a row all the same, which the rows entry, told
    the slots, never reads."""
    E, N = snap.exc_rows.shape
    K = snap.cell_pod.shape[0]
    CP, CN = snap.class_mask.shape
    dev = snap.device
    rows = torch.empty((E + K, N), dtype=torch.bool, device=dev)
    torch.logical_and(snap.exc_rows, snap.node_valid[None, :], out=rows[:E])
    # each pod class's row over the nodes (a last column that never passes
    # stands for invalid and classless nodes), and a last row that never
    # passes for a class out of range; each cell slot copies its target's
    nc = snap.node_class
    col = torch.where(snap.node_valid & (nc >= 0) & (nc < CN), nc, CN).long()
    mask = torch.zeros((CP + 1, CN + 1), dtype=torch.bool, device=dev)
    mask[:CP, :CN] = snap.class_mask
    class_rows = torch.index_select(mask, 1, col)
    pc = snap.pod_class[snap.cell_pod.long().clamp(min=0)]
    torch.index_select(class_rows, 0, torch.where((pc >= 0) & (pc < CP), pc, CP).long(),
                       out=rows[E:])
    cell_node = snap.cell_node.long()
    rows[E + torch.arange(K, device=dev), cell_node] = snap.cell_val & snap.node_valid[cell_node]
    return rows


def patch_reduction(base: FitReduction, special: torch.Tensor, part: FitReduction,
                    pod_valid: torch.Tensor) -> FitReduction:
    """``base`` with each special slot's result written over its pod's
    (invalid pods fit nowhere). The slots without a pod write into one
    extra row, which is sliced off."""
    P = base.any_fit.shape[0]
    ok = (special >= 0) & pod_valid[special.clamp(min=0)]
    patch = (part.any_fit & ok, torch.where(ok, part.fit_count, 0),
             torch.where(ok, part.first_fit, -1))
    idx = torch.where(special >= 0, special, P)
    out = []
    for whole, value in zip(base, patch):
        longer = torch.cat([whole, whole.new_zeros((1,))])
        longer[idx] = value
        out.append(longer[:P])
    return FitReduction(*out)


def fit_reduce_exact(snap) -> FitReduction:
    """Tiled (P × N) fit reduction over a SnapshotTensors with the dense
    path's exact verdicts, never holding [P, N] for a factored snapshot:
    K4 over the class factors, then the special pods' true rows through
    ``fit_reduce_rows``, patched in. Dense-mask snapshots reduce their mask
    directly in PyTorch."""
    free = snap.free()
    if snap.sched_mask is not None:
        fits = _resource_fits(snap.pod_req, free)
        fits &= snap.sched_mask & snap.pod_valid[:, None] & snap.node_valid[None, :]
        return _reduce(fits)

    base = fit_reduce_cuda(
        snap.pod_req, free, snap.pod_class.to(torch.int32),
        snap.node_class.to(torch.int32), snap.class_mask, snap.node_valid,
    )
    special = special_pods(snap)
    part = fit_reduce_rows(snap.pod_req[special.clamp(min=0)], free, special_rows(snap),
                           special.to(torch.int32))
    return patch_reduction(base, special, part, snap.pod_valid)


def reference_fit_reduce(pod_req, free, pod_class, node_class, class_mask, node_valid):
    """Dense numpy oracle for the parity tests."""
    P, N = pod_req.shape[0], free.shape[0]
    fits = np.all(pod_req[:, None, :] <= free[None, :, :], axis=-1)
    pc = np.asarray(pod_class)
    nc = np.asarray(node_class)
    cm = np.asarray(class_mask)
    ok_class = np.zeros((P, N), bool)
    valid_p = pc >= 0
    valid_n = (nc >= 0) & np.asarray(node_valid)
    ok_class[np.ix_(valid_p, valid_n)] = cm[np.ix_(pc[valid_p], nc[valid_n])]
    fits = fits & ok_class
    any_fit = fits.any(axis=1)
    count = fits.sum(axis=1).astype(np.int32)
    first = np.where(any_fit, fits.argmax(axis=1), -1).astype(np.int32)
    return any_fit, count, first
