"""Resident device arena: the packed snapshot tensors stay on their
device across reconcile ticks, and the host ships *delta programs* —
(row-index, payload) scatter batches for the rows the incremental packer
dirtied — instead of re-uploading dense tensors every loop. The port of
``autoscaler_tpu/snapshot/arena.py``; every piece takes a ``device=``
(None = the first CUDA card; raises without one unless the caller asks
for "cpu").

Three pieces:

- ``DeltaProgram`` — what one ``IncrementalPacker.update()`` changed, as
  scatter ops (unique sorted indices) plus the small shape-flexible aux
  fields (factored-mask factors) and the full host arrays (seed fodder for
  init / bucket promotion / fault recovery).
- ``DeviceArena`` — double-buffered resident buffers with an in-place
  delta apply (ops/arena_apply.py). Deltas are applied to the *lagging*
  generation (which is one tick behind and carries the previous tick's
  deltas as a pending replay), then the generations swap — so a tick
  that faults mid-apply corrupts only the lagging side and the live
  arena keeps serving; the packer serves the faulted tick from a cold
  upload to its own device and the arena reseeds on the next one
  (rollback).
- ``OperandArena`` — a content-addressed device cache for estimator
  dispatch operands, keyed by device too, so an unchanged pending-pod set
  re-dispatches against resident tensors instead of re-uploading
  host-packed arrays every tick.

Donation becomes writing in place. The JAX package donates the lagging
generation's buffer to a jitted scatter when the arena is its sole owner
and otherwise runs an undonated copy-on-write twin. Here the scatter
writes into the lagging buffer in place when nothing outside the arena
holds it, and otherwise clones it first and scatters into the clone.
"Holds" is read two ways, since a torch view keeps its base's storage
alive without always holding the base's Python object: the Python
reference count (a served ``SnapshotTensors``, a dict, ``.to()`` of the
same device) and the storage's use count (views, ``.numpy()`` aliases).
The choice never changes values, only whether a clone is made.

No compile cache exists to warm in PyTorch. ``prewarm`` still walks the
JAX package's bucket ladder with the same calls (its return value is the
same count); that allocates each shape once and loads the scatter kernels
on the device, so the first real tick pays neither.

Buffer-liveness contract (kept from the JAX package): the tensors served
by one ``apply()`` keep their values until the SECOND subsequent apply
unless their holder keeps them (the clone rule above then leaves them
alone). Every in-repo consumer routes through
``ClusterSnapshot.tensors()``, whose cache only serves tensors while the
snapshot version is unchanged.

Threading: every mutation of arena state happens under the instance
lock; walls come from ``trace.timeline_now()``.

Not ported: the perf observatory and the metrics registry (``observatory=``
and ``metrics=`` raise ``NotImplementedError``; ROADMAP queue 1 item 3).
"""
from __future__ import annotations

import hashlib
import logging
import sys
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autoscaler_tpu_torch import trace
from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.fleet.buckets import (
    DEFAULT_ARENA_BUCKETS,
    BucketError,
    BucketSpec,
    parse_buckets,
)
from autoscaler_tpu_torch.ops.arena_apply import (
    arena_scatter_cols,
    arena_scatter_rows,
    arena_scatter_vec,
)
from autoscaler_tpu_torch.perf import array_bytes

# the delta-axis ladder the JAX package pads its batches to (a small
# closed set of traced shapes there); here only prewarm walks it
_K_BASE = 8

# a buffer the arena alone holds, seen from _writable_locked: Python
# references (the generation dict, _scatter_locked's local, the parameter,
# getrefcount's own argument) and storage uses (the buffer, the storage
# object the count is read through)
_SOLE_REFS = 4
_SOLE_STORAGE_USES = 2


def _storage_uses(t: torch.Tensor) -> Optional[int]:
    """How many tensors (and storage objects) share ``t``'s storage: views
    and ``.numpy()`` aliases count here even where they leave the base's
    Python reference count alone. None when this torch cannot say."""
    use_count = getattr(torch._C, "_storage_Use_Count", None)
    if use_count is None:
        return None
    return int(use_count(t.untyped_storage()._cdata))


class ArenaError(RuntimeError):
    """A delta apply failed; the live generation is intact (rollback)."""


def parse_arena_buckets(spec: str) -> List[BucketSpec]:
    """``--arena-buckets`` parser: the fleet PxGxR grammar re-read as
    (pods, nodes, resources) — same power-of-two validation, same
    exact-pad safety rules (padding rows are masked invalid)."""
    try:
        return parse_buckets(spec)
    except BucketError as e:
        raise BucketError(f"--arena-buckets: {e}") from None


def delta_bucket(k: int) -> int:
    """Smallest rung of the power-of-eight delta ladder >= max(k, 1)."""
    size = _K_BASE
    while size < k:
        size *= _K_BASE
    return size


def delta_ladder(axis: int) -> List[int]:
    """Every delta-bucket rung an axis of this length can produce."""
    out = [_K_BASE]
    while out[-1] < axis:
        out.append(out[-1] * _K_BASE)
    return out


@dataclass
class DeltaOp:
    """One scatter batch: replace ``idx`` rows (axis 0) or columns
    (axis 1) of ``field`` with ``payload``. ``idx`` is int32 on the host,
    unique and sorted (emitted from sets), un-padded."""

    field: str
    axis: int
    idx: np.ndarray
    payload: np.ndarray


@dataclass
class DeltaProgram:
    """Everything one packer update changed. ``host`` always carries the
    full host arrays of every managed field — the seed source for init,
    bucket promotion, and post-fault reseeds; on a steady tick it is
    only referenced, never transferred."""

    ops: List[DeltaOp] = field(default_factory=list)
    aux: Dict[str, np.ndarray] = field(default_factory=dict)
    host: Dict[str, np.ndarray] = field(default_factory=dict)
    reseed: bool = False          # packer did a full rebuild (promotion)
    reseed_reason: str = ""       # capacity_growth | schema_change

    def delta_rows(self) -> int:
        return sum(int(op.idx.size) for op in self.ops)


def _zero_stats() -> Dict[str, int]:
    return {
        "applies": 0,
        "delta_rows": 0,
        "delta_bytes": 0,
        "full_uploads": 0,
        "promotions": 0,
        "rollbacks": 0,
        "aux_uploads": 0,
    }


def _refuse_unported(observatory: Any, metrics: Any) -> None:
    asked = [name for name, on in (("observatory", observatory is not None),
                                   ("metrics", metrics is not None)) if on]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not ported yet (ROADMAP queue 1, the "
            "estimator services item)"
        )


class DeviceArena:
    """Double-buffered resident snapshot buffers with an in-place delta
    apply, on ``device`` (None = the first CUDA card).

    ``apply()`` is called by the incremental packer from the control loop.
    ``fault_hook`` lets a load generator or a test script an apply fault
    to exercise the rollback path."""

    def __init__(
        self,
        buckets: str = DEFAULT_ARENA_BUCKETS,
        observatory: Any = None,
        metrics: Any = None,
        device=None,
    ):
        _refuse_unported(observatory, metrics)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self.buckets = parse_arena_buckets(buckets)
        # the fault seam: returns a truthy fault kind to fail this apply
        self.fault_hook: Optional[Callable[[], Optional[str]]] = None
        self._bufs: List[Dict[str, torch.Tensor]] = [{}, {}]
        self._live = 0
        self._need_seed = [True, True]
        self._pending: List[DeltaOp] = []
        # aux fields (factored-mask factors) are shape-flexible and small:
        # ONE generation-independent copy, replaced wholesale when dirty
        self._aux: Dict[str, torch.Tensor] = {}
        self._stats = _zero_stats()
        self._seeded_once = False
        self._coverage_warned: set = set()
        # buffers cloned because something outside the arena held them
        # (not a JAX stat: what the copy-on-write rule cost so far)
        self.clones = 0

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        # a copy: torch.from_numpy (or .to() on the same device) would
        # alias the packer's host arrays, which it mutates in place
        return torch.tensor(arr, device=self.device)

    # -- apply ---------------------------------------------------------------
    def apply(self, program: DeltaProgram) -> Dict[str, torch.Tensor]:
        """Apply one tick's delta program; returns the live buffer dict
        (managed fields + aux). Raises ArenaError on a faulted apply —
        the live generation is untouched and the caller serves the tick
        from a cold upload instead."""
        with self._lock:
            return self._apply_locked(program)

    def _apply_locked(self, program: DeltaProgram) -> Dict[str, torch.Tensor]:
        self._stats["applies"] += 1
        if program.reseed:
            # the packer rebuilt from scratch (bucket promotion / schema
            # change): every resident shape is wrong — both generations
            # reseed, and the stats record WHY the full upload happened
            self._need_seed = [True, True]
            self._pending = []
            self._stats["promotions"] += 1
        target = 1 - self._live
        idle = (
            not self._need_seed[target]
            and not self._pending
            and not program.ops
            and not program.aux
        )
        if idle:
            # nothing changed anywhere: serve the live generation as-is
            # (same tensor objects — the zero-cost steady-state tick)
            return self._live_view_locked()
        hook = self.fault_hook
        seeded = False
        try:
            if hook is not None:
                kind = hook()
                if kind:
                    # mark the target corrupted BEFORE raising: the next
                    # apply must reseed it rather than trust its contents
                    self._need_seed[target] = True
                    raise ArenaError(f"injected arena fault: {kind}")
            if self._need_seed[target]:
                if not program.reseed and self._seeded_once:
                    # not a packer-forced promotion: this seed is the
                    # recovery from a prior faulted apply — the stats
                    # pair its full uploads with a rollback count
                    self._stats["rollbacks"] += 1
                self._seed_locked(target, program)
                seeded = True
            else:
                self._scatter_locked(target, self._pending + program.ops)
            for name, arr in program.aux.items():
                self._aux[name] = self._upload(arr)
                self._stats["aux_uploads"] += 1
                self._stats["delta_bytes"] += int(arr.nbytes)
        except ArenaError:
            self._stats["rollbacks"] += 1
            raise
        except Exception as e:  # noqa: BLE001 — any apply failure rolls back
            self._need_seed[target] = True
            self._stats["rollbacks"] += 1
            raise ArenaError(f"arena apply failed: {e}") from e
        self._live = target
        # a seed leaves BOTH generations current — nothing pends; a scatter
        # leaves the new lagging side one tick behind, owing these ops
        self._pending = [] if seeded else list(program.ops)
        self._stats["delta_rows"] += 0 if seeded else program.delta_rows()
        return self._live_view_locked()

    def _seed_locked(self, target: int, program: DeltaProgram) -> None:
        """Full host→device upload of every managed field into ``target``,
        then a device-side clone into the other generation so the next
        steady tick scatters instead of re-seeding (a clone is not a
        full upload: no host transfer happens)."""
        bufs = {}
        for name, arr in program.host.items():
            bufs[name] = self._upload(arr)
            self._stats["full_uploads"] += 1
            self._stats["delta_bytes"] += int(arr.nbytes)
        self._bufs[target] = bufs
        other = 1 - target
        self._bufs[other] = {name: buf.clone() for name, buf in bufs.items()}
        self._need_seed = [False, False]
        self._pending = []
        if not self._seeded_once:
            self._seeded_once = True
        trace.add_event(
            "arena.seed",
            fields=len(bufs),
            reason=program.reseed_reason or "init",
        )
        self._check_prewarm_coverage_locked(bufs)

    def _check_prewarm_coverage_locked(self, bufs: Dict[str, torch.Tensor]) -> None:
        """Warn when the seeded world shape has no matching prewarm
        bucket: prewarm only allocated and loaded the shapes of the
        --arena-buckets ladder (the real PP/NN come from the packer's pow2
        bucketing, the real R from the extended schema)."""
        pod_req = bufs.get("pod_req")
        node_alloc = bufs.get("node_alloc")
        if pod_req is None or node_alloc is None:
            return
        PP, R = pod_req.shape
        NN = node_alloc.shape[0]
        covered = any(
            b.pods == PP and b.groups == NN and R <= b.resources
            for b in self.buckets
        )
        if not covered and (PP, NN, R) not in self._coverage_warned:
            self._coverage_warned.add((PP, NN, R))
            trace.add_event("arena.prewarm_miss", P=PP, N=NN, R=R)
            logging.getLogger("arena").warning(
                "arena world shape (P=%d, N=%d, R=%d) matches no "
                "--arena-buckets entry (%s): add a %dx%dx%d bucket to have "
                "prewarm allocate it",
                PP, NN, R,
                ",".join(b.key for b in self.buckets),
                PP, NN, max(R, 8),
            )

    def _writable_locked(self, buf: torch.Tensor) -> torch.Tensor:
        """The buffer to scatter into: ``buf`` itself when the arena is its
        sole owner, else a clone (the copy-on-write twin of the JAX
        package's undonated apply). Tensors served from this generation
        two applies ago may still be held by a caller, whole or through a
        view; writing under them would change what they read. Any extra
        Python reference or storage use → clone (a device-side copy, still
        no host transfer). The choice never changes values."""
        uses = _storage_uses(buf)
        if (sys.getrefcount(buf) <= _SOLE_REFS
                and uses is not None and uses <= _SOLE_STORAGE_USES):
            return buf
        self.clones += 1
        return buf.clone()

    def _scatter_locked(self, target: int, ops: Sequence[DeltaOp]) -> None:
        bufs = self._bufs[target]
        for op in ops:
            buf = bufs[op.field]
            if op.axis == 0:
                fn = arena_scatter_vec if buf.ndim == 1 else arena_scatter_rows
            else:
                fn = arena_scatter_cols
            bufs[op.field] = fn(self._writable_locked(buf), op.idx, op.payload)
            self._stats["delta_bytes"] += int(op.payload.nbytes)

    def _live_view_locked(self) -> Dict[str, torch.Tensor]:
        view = dict(self._bufs[self._live])
        view.update(self._aux)
        return view

    # -- queries -------------------------------------------------------------
    def live(self) -> Dict[str, torch.Tensor]:
        with self._lock:
            return self._live_view_locked()

    def device_bytes(self) -> int:
        """Both generations plus the aux pool, a pure function of world
        shapes."""
        with self._lock:
            return array_bytes(
                [list(self._bufs[0].values()), list(self._bufs[1].values()),
                 list(self._aux.values())]
            )

    def take_stats(self) -> Dict[str, int]:
        """This tick's counters, reset on read."""
        with self._lock:
            stats, self._stats = self._stats, _zero_stats()
            return stats

    # -- prewarm -------------------------------------------------------------
    def prewarm(self, R: int, dense: Optional[bool] = None) -> int:
        """Walk the JAX package's apply-kernel ladder for every configured
        bucket: each (shape, delta rung) once in place and once through
        the copy-on-write clone, so the first real tick neither allocates
        these shapes anew nor loads a scatter kernel. ``R`` is the world's
        real resource width (the bucket's R is only a cap); ``dense``
        gates the [P, N] mask shapes (None = both forms). Returns the
        number of scatter calls issued (the JAX package's count)."""
        with self._lock:
            return self._prewarm_locked(R, dense)

    def _prewarm_call(self, fn, shape, dtype, K: int, axis: int, clone: bool) -> None:
        """One scatter of a K-entry batch into a zero buffer: its first
        min(K, axis length) entries real, the rest padding (dropped)."""
        axis_len = shape[axis]
        buf = torch.zeros(shape, dtype=dtype, device=self.device)
        if clone:
            buf = buf.clone()
        idx = np.full((K,), axis_len, np.int32)
        real = min(K, axis_len)
        idx[:real] = np.arange(real, dtype=np.int32)
        payload_shape = list(shape)
        payload_shape[axis] = K
        payload = torch.zeros(payload_shape, dtype=dtype, device=self.device)
        fn(buf, idx, payload)

    def _prewarm_locked(self, R: int, dense: Optional[bool]) -> int:
        calls = 0
        for bucket in self.buckets:
            P, N = bucket.pods, bucket.groups
            r = min(R, bucket.resources)
            specs: List[Tuple[Tuple[int, ...], torch.dtype, int]] = [
                ((N, r), torch.float32, N),   # node_alloc / node_used rows
                ((P, r), torch.float32, P),   # pod_req rows
                ((N,), torch.bool, N),        # node_valid
                ((N,), torch.int32, N),       # node_group / node_class
                ((P,), torch.bool, P),        # pod_valid
                ((P,), torch.int32, P),       # pod_node / pod_class
            ]
            for shape, dtype, axis_len in specs:
                kern = arena_scatter_vec if len(shape) == 1 else arena_scatter_rows
                for K in delta_ladder(axis_len):
                    for clone in (False, True):
                        self._prewarm_call(kern, shape, dtype, K, 0, clone)
                        calls += 1
            if dense is not False:
                for K in delta_ladder(P):
                    for clone in (False, True):
                        self._prewarm_call(arena_scatter_rows, (P, N), torch.bool, K, 0, clone)
                        calls += 1
                for K in delta_ladder(N):
                    for clone in (False, True):
                        self._prewarm_call(arena_scatter_cols, (P, N), torch.bool, K, 1, clone)
                        calls += 1
        trace.add_event("arena.prewarm", calls=calls, buckets=len(self.buckets))
        return calls


class OperandArena:
    """Content-addressed device residence for estimator dispatch operands.

    The estimator packs pending pods and group templates into host numpy
    arrays every dispatch; in steady state those arrays are byte-identical
    tick over tick, and re-uploading them re-pays the host→device transfer
    each time. This cache keys on (device, shape, dtype, content digest)
    and hands back the resident tensor on a hit, so a tensor resident on
    one device never serves a request for another. Bounded LRU. Consumers
    must not write into what it hands back."""

    def __init__(self, max_entries: int = 128, device=None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, torch.Tensor]" = OrderedDict()
        self._max = max(int(max_entries), 1)
        self._hits = 0
        self._misses = 0

    def resident(self, arr: Any, device=None) -> torch.Tensor:
        """``arr`` as a tensor on ``device`` (None = the arena's own): the
        resident one when the same bytes were asked for there before, else
        a new copy, kept."""
        dev = self.device if device is None else resolve_device(device)
        arr = np.asarray(arr)
        key = (
            str(dev),
            arr.shape,
            arr.dtype.str,
            hashlib.blake2b(arr.tobytes(), digest_size=16).digest(),
        )
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self._hits += 1
                return hit
            self._misses += 1
        resident = torch.tensor(arr, device=dev)   # a copy, never an alias
        with self._lock:
            self._entries[key] = resident
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)
        return resident

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "entries": len(self._entries),
            }

    def device_bytes(self) -> int:
        with self._lock:
            return array_bytes(list(self._entries.values()))
