"""A numpy model of how K4 (autoscaler_tpu_torch/csrc/fit_reduce.cu)
splits its work: pod blocks of kThreads x kPods pods, kPods a thread; the
node axis cut into tiles of kTile nodes, the tiles split over grid.y for
kWaves waves of blocks; the nodes padded to whole tiles with records that
never fit; the gate of a pair (a register mask over CN <= kMaxBitClasses
node classes, the byte lookup above, or the rows entry's staged row bits);
blocks of padding pods (and of the rows entry's padding slots) leaving at
once; the resources left out of the compares where none can fail; the
splits merged with integer add and min. The constants are read back from
the kernel source, and the model must equal the numpy oracle
``reference_fit_reduce`` and the plain versions exactly on ragged shapes,
and count the same work as the plain versions' ``stats``."""
import re

import numpy as np
import pytest
import torch

from autoscaler_tpu_torch.ops import _build
from autoscaler_tpu_torch.ops import fit_reduce as tfr
from torch_parity import fit_case, rows_case, to_np

INT_MAX = 2**31 - 1
NAMES = ("kThreads", "kPods", "kTile", "kWaves", "kMaxBitClasses", "kMaxRegR")


def cu_constants():
    text = _build.source("fit_reduce").read_text()
    return {
        name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
        for name in NAMES
    }


C = cu_constants()
BLOCK_PODS = C["kThreads"] * C["kPods"]
TILE = C["kTile"]


def geometry(P, N, sms, per_sm):
    """(pod blocks, splits, tiles a split), as ``launch`` computes them."""
    pod_blocks = -(-P // BLOCK_PODS)
    num_tiles = -(-N // TILE)
    target = sms * max(per_sm, 1) * C["kWaves"]
    want = -(-target // pod_blocks)
    splits = max(1, min(want, num_tiles))
    per_split = -(-num_tiles // splits)
    return pod_blocks, -(-num_tiles // per_split), per_split


def vcmpne4(words):
    """__vcmpne4(w, 0): 0xff in each byte of w that is not zero."""
    out = np.zeros_like(words)
    for k in range(4):
        out |= np.where((words >> (8 * k)) & 0xFF, np.uint32(0xFF << (8 * k)), np.uint32(0))
    return out


def nibbles(words):
    """The kernel's byte-to-bit packing of one 32-bit word of four row
    bytes: ((__vcmpne4(w, 0) & 0x01010101) * 0x01020408) >> 24, in 32-bit
    arithmetic."""
    ones = (vcmpne4(words) & np.uint32(0x01010101)).astype(np.uint64)
    return ((ones * 0x01020408) & 0xFFFFFFFF) >> 24


def staged_row_bits(rows_u8, aligned):
    """[pods, 32 w] row bytes → [pods, w] words, by the aligned path (eight
    words of four bytes, each packed to a nibble) or bit by bit."""
    pods, n = rows_u8.shape
    groups = rows_u8.reshape(pods, n // 32, 8, 4).astype(np.uint32)
    if aligned:
        words = (groups[..., 0] | groups[..., 1] << 8 | groups[..., 2] << 16
                 | groups[..., 3] << 24)
        return (nibbles(words) << (4 * np.arange(8, dtype=np.uint64))).sum(axis=-1)
    bits = (rows_u8.reshape(pods, n // 32, 32) != 0).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(axis=-1)


def order_keys(x, nan_key):
    """The kernel's order-preserving uint32 keys of f32 values; NaN at
    ``nan_key``."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    key = np.where(b >= 2**31, b ^ 0xFFFFFFFF, b | 2**31)
    return np.where(np.isnan(x), nan_key, key)


def live_resources(preq, active, rec, can_pass):
    """[R] bool: the resources of a (block, tile) whose compares can fail:
    the block's largest request (over live pods) keys above the smallest
    free value (over nodes whose gate can pass)."""
    hi = np.where(active[:, None], order_keys(preq, 2**32 - 1), 0).max(axis=0)
    lo = np.where(can_pass[:, None], order_keys(rec, 0), 2**32 - 1).min(axis=0)
    return hi > lo


def model_fit_reduce(req, free, pod_class=None, node_class=None, class_mask=None,
                     node_valid=None, rows=None, slots=None, sms=132, per_sm=8, stats=None):
    """K4's launch in numpy: the class entry, or the rows entry when
    ``rows`` [P, N] is given (``slots`` [P] marking padding rows negative).
    → (any, count, first). ``stats`` gets the launch's shape, the live
    resources of each (block, tile) the compacting kernel scans, and the
    compares the data needs (``live_compares``: on the live resources of
    each pair whose gate passes, up to the first that fails)."""
    P, R = req.shape
    N = free.shape[0]
    by_rows = rows is not None
    CP, CN = (0, 0) if by_rows else class_mask.shape
    bits_gate = not by_rows and R <= C["kMaxRegR"] and CN <= C["kMaxBitClasses"]
    # the compacting kernel: R <= kMaxRegR with the register mask or rows
    compacting = R <= C["kMaxRegR"] and (by_rows or bits_gate)
    pod_blocks, splits, per_split = geometry(P, N, sms, per_sm)
    num_tiles = -(-N // TILE)
    count = np.zeros(P, np.int64)
    first = np.full(P, INT_MAX, np.int64)
    stats = {} if stats is None else stats
    stats.update(grid=(pod_blocks, splits), blocks_left=0, blocks_run=0, live_counts=[],
                 live_compares=0)
    for bx in range(pod_blocks):
        # slot i = q * kThreads + tid holds pod pod0 + i
        pods = bx * BLOCK_PODS + np.arange(BLOCK_PODS)
        inside = pods < P
        safe = np.minimum(pods, P - 1)
        if by_rows:
            active = inside if slots is None else inside & (slots[safe] >= 0)
        else:
            pc = np.where(inside, pod_class[safe], -1)
            active = (pc >= 0) & (pc < CP)
            pmask = np.zeros(BLOCK_PODS, np.uint64)
            if bits_gate:
                for c in range(CN):
                    row_c = class_mask[np.clip(pc, 0, CP - 1), c] & active
                    pmask |= row_c.astype(np.uint64) << np.uint64(c)
        preq = np.where(active[:, None], req[safe], 0).astype(np.float32)
        for by in range(splits):
            t0, t1 = by * per_split, min((by + 1) * per_split, num_tiles)
            if t0 >= t1:
                continue
            if not active.any():
                stats["blocks_left"] += 1
                continue
            stats["blocks_run"] += 1
            cnt = np.zeros(BLOCK_PODS, np.int64)
            fst = np.full(BLOCK_PODS, INT_MAX, np.int64)
            for t in range(t0, t1):
                n0 = t * TILE
                tn = min(TILE, N - n0)
                rec = np.zeros((TILE, R), np.float32)
                rec[:tn] = free[n0:n0 + tn]
                if by_rows:
                    tile = np.zeros((BLOCK_PODS, TILE), np.uint8)
                    tile[active, :tn] = rows[pods[active], n0:n0 + tn]
                    words = staged_row_bits(tile, aligned=N % 16 == 0)
                    gate = ((words[:, np.arange(TILE) // 32]
                             >> (np.arange(TILE, dtype=np.uint64) % 32)) & 1) != 0
                else:
                    code = np.full(TILE, -1, np.int64)
                    nc = node_class[n0:n0 + tn]
                    code[:tn] = np.where(node_valid[n0:n0 + tn] & (nc >= 0) & (nc < CN), nc, -1)
                    if bits_gate:
                        sel = np.where(code >= 0, np.uint64(1) << code.clip(0).astype(np.uint64),
                                       np.uint64(0))
                        gate = (pmask[:, None] & sel[None, :]) != 0
                    else:
                        gate = (active[:, None] & (code >= 0)[None, :]
                                & class_mask[np.clip(pc, 0, CP - 1)][:, code.clip(0)])
                can_pass = np.arange(TILE) < tn
                if not by_rows:
                    can_pass &= code >= 0
                need = live_resources(preq, active, rec, can_pass)
                live = need if compacting else np.ones(R, bool)
                if compacting:
                    stats["live_counts"].append(int(live.sum()))
                fails = ~(preq[:, None, need] <= rec[None, :, need])
                upto = np.where(fails.any(axis=-1), fails.argmax(axis=-1) + 1, need.sum())
                stats["live_compares"] += int(upto[gate].sum())
                ok = gate & np.all(preq[:, None, live] <= rec[None, :, live], axis=-1)
                cnt += ok.sum(axis=1)
                fst = np.minimum(fst, np.where(ok.any(axis=1), n0 + ok.argmax(axis=1), INT_MAX))
            # the block's atomics: one add and one min a pod that fits
            hit = active & (cnt > 0)
            np.add.at(count, pods[hit], cnt[hit])
            np.minimum.at(first, pods[hit], fst[hit])
    any_fit = count > 0
    return any_fit, count.astype(np.int32), np.where(any_fit, first, -1).astype(np.int32)


def assert_same(want, got):
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), to_np(b))


# (P, N, R, CP, CN): P not a multiple of the block, N not a multiple of the
# tile, N < 32, R = 1 / 8 / 9 (the generic path), CN = 32 / 33 (the last
# width of the register mask, the first of the byte lookup), CP = 64 / 65
RAGGED = [
    (700, 300, 6, 4, 3),
    (BLOCK_PODS + 1, 20, 6, 8, 8),
    (130, 2 * TILE + 7, 1, 8, 8),
    (300, 400, 8, 64, 32),
    (300, 400, 9, 65, 33),
    (260, TILE - 1, 6, 65, 33),
    (260, 3 * TILE, 8, 64, 33),
]


def test_partition_constants_match_the_source():
    """The plain versions' work counts split the pods and nodes as the
    kernel does."""
    assert (tfr.BLOCK_PODS, tfr.TILE) == (BLOCK_PODS, TILE)


def assert_same_work(model_stats, plain_stats, compacting=True):
    """The plain version's live compares (and, where the kernel compacts,
    its live resources a (block, tile)) are the model's."""
    assert plain_stats["live_compares"] == model_stats["live_compares"]
    assert plain_stats["live_compares"] <= plain_stats["compares"]
    if compacting:
        held = {}
        for k in model_stats["live_counts"]:
            held[k] = held.get(k, 0) + 1
        assert plain_stats["live_counts"] == held


@pytest.mark.parametrize("sms,per_sm", [(132, 8), (2, 1)])
@pytest.mark.parametrize("P,N,R,CP,CN", RAGGED)
def test_model_equals_the_oracle_and_the_plain_version(P, N, R, CP, CN, sms, per_sm):
    case = fit_case(P * 7 + N, P, N, R, CP, CN)
    stats, plain_stats = {}, {}
    got = model_fit_reduce(*case, sms=sms, per_sm=per_sm, stats=stats)
    assert_same(tfr.reference_fit_reduce(*case), got)
    assert_same(tfr._fit_reduce_plain(*(torch.tensor(a) for a in case), stats=plain_stats), got)
    assert stats["blocks_run"] > 0
    # each (block, tile) is scanned by one split, so its live resources
    # pair up with the model's wherever the kernel compacts
    assert_same_work(stats, plain_stats,
                     compacting=R <= C["kMaxRegR"] and CN <= C["kMaxBitClasses"])


def test_split_geometry():
    """The node split aims at kWaves waves of resident blocks and never
    leaves an empty split; one pod block on a small card takes every tile
    in one split only when the card asks for one wave."""
    P, N = 100_000, 15_000
    pod_blocks, splits, per_split = geometry(P, N, 132, 8)
    assert pod_blocks == -(-P // BLOCK_PODS)
    assert (splits - 1) * per_split < -(-N // TILE) <= splits * per_split
    assert pod_blocks * splits >= 132 * 8 * C["kWaves"] * 0.5
    assert geometry(BLOCK_PODS, 10 * TILE, 1, 1)[1] == min(10, C["kWaves"])


def test_padding_blocks_leave_at_once():
    """Blocks whose pods are all classless (or beyond P) stage nothing, and
    their pods keep count 0."""
    P, N = 3 * BLOCK_PODS + 5, 2 * TILE + 3
    case = list(fit_case(11, P, N, 6, 8, 8))
    case[2][BLOCK_PODS:2 * BLOCK_PODS] = -1            # the second block: all padding
    case[2][3 * BLOCK_PODS:] = -1                     # the last block: all padding
    stats = {}
    got = model_fit_reduce(*case, sms=2, per_sm=1, stats=stats)
    assert_same(tfr.reference_fit_reduce(*case), got)
    pod_blocks, splits, _ = geometry(P, N, 2, 1)
    assert stats["blocks_left"] == 2 * splits
    assert stats["blocks_run"] == (pod_blocks - 2) * splits
    assert not got[1][BLOCK_PODS:2 * BLOCK_PODS].any()


@pytest.mark.parametrize("S,N,R", [(5, 20, 6), (BLOCK_PODS + 3, 2 * TILE + 16, 6),
                                   (40, TILE + 5, 9), (33, 64, 1)])
def test_rows_model_equals_the_plain_version(S, N, R):
    """The rows entry: the row bits staged by the aligned path when N is a
    multiple of 16, else byte by byte; R = 9 takes the generic path."""
    req, free, rows, slots = rows_case(S + N, S, N, R)
    stats, plain_stats = {}, {}
    got = model_fit_reduce(req, free, rows=rows, slots=slots, sms=2, per_sm=1, stats=stats)
    fits = np.all(req[:, None, :] <= free[None, :, :], axis=-1) & rows
    count = fits.sum(axis=1)
    assert_same((count > 0, count, np.where(count > 0, fits.argmax(axis=1), -1)), got)
    plain = tfr._fit_reduce_rows_plain(*(torch.tensor(a) for a in (req, free, rows, slots)),
                                       stats=plain_stats)
    assert_same(got, plain)
    assert_same_work(stats, plain_stats, compacting=False)


@pytest.mark.parametrize("S,N,R", [(3 * BLOCK_PODS + 7, TILE + 40, 6), (300, 2 * TILE, 9)])
def test_rows_model_skips_padding_slots(S, N, R):
    """Padding slots (negative) count nothing and their rows are never
    read: a block of them leaves at once, and the requests of the others
    alone decide which resources are live. The plain version agrees."""
    req, free, rows, slots = rows_case(S + 3 * N, S, N, R, padding=0.4)
    slots[BLOCK_PODS:2 * BLOCK_PODS] = -1          # a block of padding only (when S holds it)
    req[slots < 0] = np.float32(1e30)              # requests no real row would make
    stats, plain_stats = {}, {}
    got = model_fit_reduce(req, free, rows=rows, slots=slots, sms=2, per_sm=1, stats=stats)
    fits = np.all(req[:, None, :] <= free[None, :, :], axis=-1) & rows & (slots >= 0)[:, None]
    count = fits.sum(axis=1)
    assert_same((count > 0, count, np.where(count > 0, fits.argmax(axis=1), -1)), got)
    plain = tfr._fit_reduce_rows_plain(*(torch.tensor(a) for a in (req, free, rows, slots)),
                                       stats=plain_stats)
    assert_same(got, plain)
    assert not got[1][slots < 0].any()
    assert_same_work(stats, plain_stats, compacting=False)
    if S >= 2 * BLOCK_PODS:
        assert stats["blocks_left"] > 0


def test_row_bit_packing_of_any_nonzero_byte():
    """The aligned path's nibble trick gives one bit a nonzero byte, for
    every byte value, as the byte-by-byte path does."""
    rng = np.random.default_rng(5)
    rows_u8 = rng.integers(0, 256, (64, 256)).astype(np.uint8)
    rows_u8[rng.random((64, 256)) < 0.4] = 0
    np.testing.assert_array_equal(staged_row_bits(rows_u8, True), staged_row_bits(rows_u8, False))
    every = np.arange(256, dtype=np.uint32)
    assert (nibbles(every) == (every != 0)).all()
    assert (nibbles(every << 24) == np.where(every != 0, 8, 0)).all()


def test_dead_resources_leave_the_compares_exact():
    """Free values and requests at the edges of f32 order: negative free
    capacity, -0.0 against +0.0, +inf requests and capacities, NaN on
    both sides, and resources no pod requests (dead in every tile, as on
    the fit bench's operands). The compacted compares equal the plain
    ones, and the dead resource is found."""
    rng = np.random.default_rng(3)
    P, N, R = 600, 700, 7
    req, free, pod_class, node_class, class_mask, node_valid = fit_case(3, P, N, R, 8, 8)
    req[:, 5:] = 0                              # requested by no pod
    free[:, 6] = 0                              # ... and 0 <= 0 always
    edges = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, -1.0, 1e30], np.float32)
    for a in (req, free):
        where = rng.random(a[:, :4].shape) < 0.02
        a[:, :4][where] = rng.choice(edges, where.sum())
    free[rng.random(N) < 0.05, 5] = -0.0
    stats, plain_stats = {}, {}
    got = model_fit_reduce(req, free, pod_class, node_class, class_mask, node_valid,
                           sms=2, per_sm=1, stats=stats)
    assert_same(tfr.reference_fit_reduce(req, free, pod_class, node_class, class_mask,
                                         node_valid), got)
    case = (req, free, pod_class, node_class, class_mask, node_valid)
    assert_same(tfr._fit_reduce_plain(*(torch.tensor(a) for a in case), stats=plain_stats), got)
    assert_same_work(stats, plain_stats)
    # resource 6 is dead everywhere; resource 5 stays live where a -0.0
    # free value keys below the +0.0 requests (the keys order -0.0 first)
    assert max(stats["live_counts"]) == R - 1 and got[1].any()


def test_fit_bench_operands_leave_two_live_resources():
    """The fit bench's operands (cut to 3000 pods x 2000 nodes): only cpu and
    memory can fail a compare; the zero resources and the pods count
    (1 against 110) are dead in every tile."""
    from autoscaler_tpu_torch.utils.workload import build_fit_workload

    case = tuple(a[:3000] if a.shape[0] == 100_000 else a[:2000] if a.shape[0] == 15_000 else a
                 for a in build_fit_workload())
    stats, plain_stats = {}, {}
    got = model_fit_reduce(*case, stats=stats)
    assert_same(tfr.reference_fit_reduce(*case), got)
    assert set(stats["live_counts"]) == {2}
    tfr._fit_reduce_plain(*(torch.tensor(a) for a in case), stats=plain_stats)
    assert plain_stats["live_counts"] == {2: len(stats["live_counts"])}
    assert plain_stats["live_compares"] == stats["live_compares"] < plain_stats["compares"]
