"""Incremental (delta) re-pack: packed tensors persist across reconcile
loops and pod/node deltas touch only dirty rows/columns. The port of
``autoscaler_tpu/snapshot/incremental.py``: the same slots, caches, dirty
sets and row order, with the tensors on the packer's device (None = the
first CUDA card; raises without one unless the caller asks for "cpu").

The full packer (snapshot/packer.py) re-flattens the whole world every
loop — O(P + N) Python per loop even when nothing changed. The reference's
DeltaClusterSnapshot exists precisely to avoid O(world) work per loop
(cluster-autoscaler/simulator/clustersnapshot/delta.go:26-42); this module
is the tensor-side analog: a ``IncrementalPacker`` held across loops by the
autoscaler diffs each listing against its previous state by object
identity (the kube watch cache keeps the same Python object until a
resource actually changes), re-deriving rows only for objects that
appeared, vanished, or changed. Steady-state cost is O(delta + cheap
vectorized numpy), not O(world) Python.

What is cached per object (the expensive Python work of pack()):
- per-pod: request row, predicate-profile key + class id, the effective
  copy carrying node_name=assignment, interpod/spread/port/CSI flags;
- per-node: allocatable row, static profile key + class id;
- the (pod-profile x node-profile) verdict matrix, grown as new profiles
  appear — never recomputed for known pairs.

What is recomputed per update, over small sets only:
- node port/CSI occupancy (only pods that mount host ports / CSI volumes);
- the sparse self-cell overrides and the affinity/spread exception rows
  (only when a delta can affect them);
- node_used (one vectorized np.add.at over placed pods — C speed).

Slot management: rows are stable across loops; removals swap-fill the hole
with the last live row so arrays stay compact and SnapshotMeta stays
index-aligned with the tensors. Row ORDER therefore diverges from a fresh
pack after removals — semantically irrelevant (the kernels score-sort pods
internally; per-row verdicts are order-free), and parity tests compare by
pod key / node name, not position.

Output parity: update() is semantically identical to pack() of the same
objects — equal per-(pod key, node name) mask verdicts, requests,
allocatables, used, assignments — and, update for update, equal row for
row and bit for bit to the JAX package's packer
(tests/test_torch_incremental.py).

Copy, don't alias: the packer mutates its host arrays in place on later
updates, so every upload is a copy (``torch.tensor``); ``torch.from_numpy``
or ``.to("cpu")`` would let served CPU tensors change under their holder.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from autoscaler_tpu_torch import trace
from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.kube.objects import NUM_RESOURCES, Node, Pod
from autoscaler_tpu_torch.perf import array_bytes
from autoscaler_tpu_torch.snapshot.arena import ArenaError, DeltaOp, DeltaProgram
from autoscaler_tpu_torch.snapshot.packer import (
    DENSE_MASK_CELL_LIMIT,
    SnapshotMeta,
    _ProfileGroups,
    _apply_row_rules,
    _class_verdict,
    _legacy_conflict_nodes,
    _node_profile_key,
    _pod_csi_counts,
    _pod_profile_key,
    _RowView,
    _self_cell_value,
    extended_schema,
    resources_row,
)
from autoscaler_tpu_torch.snapshot.tensors import SnapshotTensors, bucket_size


class _PodSlot:
    __slots__ = (
        "key", "orig", "eff", "assign", "prof_key", "class_id", "gen",
        "stamp", "has_interpod", "has_anti", "has_hard_spread", "has_portcsi",
        "has_rwop", "has_legacy", "sel_keys", "csi_drivers",
    )

    def __init__(self, key: str, pod: Pod, assign: str, gen: int):
        self.key = key
        self.gen = gen
        self.stamp = gen  # liveness stamp: which update() last saw this key
        self.assign = assign
        self.refresh(pod)

    def refresh(self, pod: Pod) -> None:
        self.orig = pod
        self.eff = pod  # fixed up by _sync_eff once assign is known
        self.prof_key = (
            _pod_profile_key(pod),
            tuple(sorted(pod.host_ports)),
            _pod_csi_counts(pod),
        )
        self.class_id = -1
        aff = pod.affinity
        self.has_interpod = bool(
            aff and (aff.pod_affinity or aff.pod_anti_affinity)
        )
        self.has_anti = bool(aff and aff.pod_anti_affinity)
        self.has_hard_spread = any(
            c.when_unsatisfiable == "DoNotSchedule" for c in pod.topology_spread
        )
        self.has_portcsi = bool(pod.host_ports or pod.csi_volumes)
        self.has_rwop = bool(pod.rwop_handles)
        self.has_legacy = bool(pod.legacy_volumes)
        keys: Set[str] = set(pod.node_selector.keys())
        if aff:
            for term in aff.node_selector_terms:
                keys.update(k for k, _ in term.match_labels)
                keys.update(r.key for r in term.match_expressions)
        for vol_terms in pod.volume_node_affinity:
            for term in vol_terms:
                keys.update(k for k, _ in term.match_labels)
                keys.update(r.key for r in term.match_expressions)
        self.sel_keys = frozenset(keys)
        self.csi_drivers = frozenset(d for d, _ in pod.csi_volumes)

    def sync_eff(self) -> None:
        """eff carries node_name = assignment (consumers read it as the
        effective placement, e.g. scaledown eligibility's DS exclusion)."""
        if self.assign == self.orig.node_name:
            self.eff = self.orig
        elif self.eff is self.orig or self.eff.node_name != self.assign:
            eff = copy.copy(self.orig)
            eff.node_name = self.assign
            self.eff = eff


def _node_mut_fp(node: Node):
    """Fingerprint of the fields the autoscaler itself mutates between loops
    (taint/cordon via the cluster API) — cheap O(#taints) defense against an
    API implementation that mutates listed Node objects in place instead of
    replacing them (the real client always parses fresh objects; FakeClusterAPI
    copies on write). Identity diffing alone would miss such mutations and
    serve a stale schedulability verdict for the node."""
    return (
        node.unschedulable,
        node.ready,
        tuple((t.key, t.value, t.effect) for t in node.taints),
    )


class _NodeSlot:
    __slots__ = (
        "name", "obj", "static_key", "full_key", "class_id", "stamp", "mut_fp",
    )

    def __init__(self, node: Node, stamp: int):
        self.name = node.name
        self.obj = node
        self.static_key = None
        self.full_key = None
        self.class_id = -1
        self.stamp = stamp
        self.mut_fp = _node_mut_fp(node)


_EMPTY: Dict = {}


def _check_arena_device(arena, device: torch.device) -> None:
    if arena.device != device:
        raise ValueError(
            f"the arena lives on {arena.device}, the packer on {device}: "
            "a packer serves its tensors from one device"
        )


class IncrementalPacker:
    """Persistent packed-tensor state with O(delta) updates.

    One instance lives across reconcile loops (StaticAutoscaler owns it) and
    is threaded into each loop's ClusterSnapshot; every ``tensors()`` call
    becomes a diff against the previous materialization instead of a full
    re-flatten. Not thread-safe — the control loop is the only caller.
    """

    def __init__(self, dense_mask: Optional[bool] = None, arena=None, device=None):
        self.device = resolve_device(device)
        if arena is not None:
            _check_arena_device(arena, self.device)
        self._force_dense = dense_mask
        self._gen = 0
        self.full_packs = 0
        self.incremental_updates = 0
        # resident device arena (snapshot/arena.DeviceArena): when attached,
        # _assemble emits a delta program (row scatters for the dirtied
        # rows) instead of re-uploading dense tensors; None = cold path
        self._arena = arena
        self._arena_reseed = True          # next program must full-seed
        self._arena_reseed_reason = "init"
        # flight-journal seam (the JAX package's journal; not ported, so
        # nothing attaches here yet): when attached, every
        # update() hands its (tensors, meta) to the sink — the recorder
        # keeps the tick's FIRST materialization (the decision-input state)
        # and journals it. last_repack_reason is the sticky twin of
        # _arena_reseed_reason (which _assemble_arena consumes): the journal
        # reads it after the fact to stamp keyframe promotions.
        self.journal_sink = None
        self.last_repack_reason = "init"
        self.last_dirty: Dict[str, int] = {}
        # a faulted apply may have dropped that tick's aux uploads on the
        # floor — resend every aux field until an apply SUCCEEDS, or the
        # arena would serve stale factored-mask factors forever
        self._arena_resend_aux = False
        # named extended-resource column schema (packer.extended_schema);
        # a schema change resizes the resource axis → full rebuild
        self._ext_schema: tuple = ()
        self._reset(8, 8)

    # ------------------------------------------------------------------ state
    def _reset(self, PP: int, NN: int) -> None:
        R = NUM_RESOURCES + len(self._ext_schema)
        self._PP, self._NN = PP, NN
        self._dense = (
            self._force_dense
            if self._force_dense is not None
            else PP * NN <= DENSE_MASK_CELL_LIMIT
        )
        self._pod_slots: List[_PodSlot] = []
        self._pod_rows: Dict[str, int] = {}
        self._node_slots: List[_NodeSlot] = []
        self._node_rows: Dict[str, int] = {}
        self._assign_index: Dict[str, Set[int]] = {}  # assign name → pod rows
        self._eff_list: List[Pod] = []       # slot-parallel effective pods
        self._pod_node_stale: Set[int] = set()  # rows whose pod_node must refresh
        self._portcsi_rows: Set[int] = set()
        self._interpod_rows: Set[int] = set()
        self._spread_rows: Set[int] = set()
        self._anti_rows: Set[int] = set()       # rows with own anti terms
        self._rwop_rows: Set[int] = set()       # rows mounting RWOP claims
        self._legacy_rows: Set[int] = set()     # rows with legacy in-tree vols
        self._anti_match_rows: Set[int] = set()  # rows matched by placed anti
        self._anti_sig: tuple = ()
        self._legacy_sig: tuple = ()
        self._legacy_conf: Dict[int, set] = {}  # row -> blocked node rows
        self._exc_prev: Set[int] = set()
        self._exc_shape_dirty = False  # exc membership moved/died this update
        self._override_prev: Set[Tuple[int, int]] = set()
        # refcounts for the global key sets
        self._relkey_count: Dict[str, int] = {}
        self._csidrv_count: Dict[str, int] = {}
        self._relevant_keys: frozenset = frozenset()
        self._csi_relevant: frozenset = frozenset()
        # node dynamic occupancy (only nonempty nodes appear)
        self._node_dyn: Dict[int, Tuple[Dict, Dict]] = {}
        # profile tables
        self._pod_profiles: Dict[tuple, int] = {}
        self._pod_exemplar: List[Pod] = []
        self._node_profiles: Dict[tuple, int] = {}
        self._node_exemplar: List[Tuple[Node, Dict, Dict]] = []
        self._class_mask = np.zeros((8, 8), bool)
        # host arrays
        self._node_alloc = np.zeros((NN, R), np.float32)
        self._node_used = np.zeros((NN, R), np.float32)
        self._node_valid = np.zeros((NN,), bool)
        self._node_group = np.full((NN,), -1, np.int32)
        self._pod_req = np.zeros((PP, R), np.float32)
        self._pod_valid = np.zeros((PP,), bool)
        self._pod_node = np.full((PP,), -1, np.int32)
        self._pod_priority = np.zeros((PP,), np.int32)
        self._pod_preempt = np.zeros((PP,), bool)
        # int32 natively: _assemble hands these straight to _upload, and a
        # per-loop astype would be an O(world) copy even on idle loops
        self._pod_class = np.full((PP,), -1, np.int32)
        self._node_class = np.full((NN,), -1, np.int32)
        self._mask = np.zeros((PP, NN), bool) if self._dense else None
        self._group_map: Dict[str, str] = {}
        self._group_names: List[str] = []
        self._group_index: Dict[str, int] = {}
        self._dev: Dict[str, object] = {}
        self._dirty_fields: Set[str] = set()
        self._exc_rows_np = np.zeros((1, NN), bool)
        self._pod_exc_np = np.full((PP,), -1, np.int32)
        self._cells: List[Tuple[int, int, bool]] = []
        # row-level dirt for the arena's delta programs (supersets of the
        # field-level _dirty_fields; cleared every _assemble)
        self._d_pod_rows: Set[int] = set()     # pod_req/pod_valid/pod_class
        self._d_pod_node: Set[int] = set()     # pod_node entries
        self._d_node_rows: Set[int] = set()    # node_alloc/valid/class/group
        self._d_node_group_all = False         # group-map remap: all rows
        self._mask_rows_d: Set[int] = set()    # dense mask row refreshes
        self._mask_cols_d: Set[int] = set()    # dense mask column refreshes
        self._mask_bulk = False                # dense mask bulk rebuild
        # shadow of the last node_used the device saw: the recompute is a
        # full vectorized rebuild, so changed rows come from a diff
        self._node_used_shadow = np.zeros((NN, R), np.float32)

    # ------------------------------------------------------------- public API
    def update(
        self,
        nodes: Sequence[Node],
        pod_items,
        assigns: Dict[str, str],
        group_of_node: Optional[Dict[str, str]] = None,
    ) -> Tuple[SnapshotTensors, SnapshotMeta]:
        """Diff the listing against the previous state and rebuild only what
        changed. pod_items yields (pod key, pod object) pairs (a dict items
        view works); assigns maps pod key → assigned node NAME (absent/"" =
        pending; may reference an unlisted node, which packs as pending
        exactly like packer.pack does)."""
        group_of_node = group_of_node or {}
        pod_items = list(pod_items)
        P, N = len(pod_items), len(nodes)
        PP, NN = bucket_size(P), bucket_size(N)
        ext = extended_schema((p.requests for _, p in pod_items))
        if ext != self._ext_schema:
            # the resource axis itself changes width: every cached row is
            # the wrong shape — rebuild from scratch under the new schema
            self._ext_schema = ext
            self._reset(max(PP, self._PP), max(NN, self._NN))
            self.full_packs += 1
            # a full re-pack invalidates every resident arena shape: the
            # delta program becomes a reseed (bucket promotion / schema
            # change is the ONE sanctioned full re-upload)
            self._arena_reseed = True
            self._arena_reseed_reason = "schema_change"
            self.last_repack_reason = "schema_change"
            # on the tick trace a full re-pack is THE classic "why was this
            # tick slow" answer — stamp it with its cause
            trace.add_event("snapshot.full_repack", reason="schema_change")
        elif PP > self._PP or NN > self._NN or self._profiles_bloated():
            self._reset(max(PP, self._PP), max(NN, self._NN))
            self.full_packs += 1
            self._arena_reseed = True
            self._arena_reseed_reason = "capacity_growth"
            self.last_repack_reason = "capacity_growth"
            trace.add_event("snapshot.full_repack", reason="capacity_growth")
        else:
            self.incremental_updates += 1
        self._gen += 1
        gen = self._gen

        dirty_pod_rows: Set[int] = set()
        dirty_node_rows: Set[int] = set()
        structural = False  # any node/assignment/placement change at all

        # ---- diff nodes (stamp = liveness; no per-update seen set).
        # Removals run BEFORE additions: adding first can transiently push
        # the slot count past the bucket capacity when churn replaces nodes
        # at a full bucket (e.g. 8 slots, one vanished + one new = peak 9
        # in an 8-row array — an IndexError a 55-minute chaos soak caught).
        node_rows_get = self._node_rows.get
        node_slots = self._node_slots
        new_nodes: List[Node] = []
        for node in nodes:
            row = node_rows_get(node.name)
            if row is None:
                new_nodes.append(node)
            else:
                slot = node_slots[row]
                slot.stamp = gen
                if node is not slot.obj or _node_mut_fp(node) != slot.mut_fp:
                    self._change_node(row, node)
                    dirty_node_rows.add(row)
                    structural = True
        if len(self._node_rows) + len(new_nodes) > N:
            for name in [s.name for s in node_slots if s.stamp != gen]:
                self._remove_node(name, dirty_node_rows)
                structural = True
        for node in new_nodes:
            row = self._add_node(node)
            dirty_node_rows.add(row)
            structural = True

        # ---- diff pods (same removals-before-additions discipline) ------
        pod_rows_get = self._pod_rows.get
        pod_slots = self._pod_slots
        assign_get = assigns.get
        new_pods: List[Tuple[str, Pod]] = []
        for key, pod in pod_items:
            row = pod_rows_get(key)
            if row is None:
                new_pods.append((key, pod))
            else:
                slot = pod_slots[row]
                slot.stamp = gen
                if pod is not slot.orig:
                    self._change_pod(row, pod)
                    dirty_pod_rows.add(row)
                    structural = True
                assign = assign_get(key, "")
                if assign != slot.assign:
                    self._reassign(row, assign)
                    structural = True
        if len(self._pod_rows) + len(new_pods) > P:
            for key in [s.key for s in pod_slots if s.stamp != gen]:
                self._remove_pod(key, dirty_pod_rows)
                structural = True
        for key, pod in new_pods:
            dirty_pod_rows.add(self._add_pod(key, pod, assign_get(key, "")))
            structural = True

        n, p = len(self._node_slots), len(self._pod_slots)

        # ---- global key sets → node static keys -------------------------
        relevant = frozenset(self._relkey_count)
        csi_rel = frozenset(self._csidrv_count)
        if relevant != self._relevant_keys or csi_rel != self._csi_relevant:
            self._relevant_keys = relevant
            self._csi_relevant = csi_rel
            dirty_node_rows.update(range(n))  # every static key changes shape
        for j in list(dirty_node_rows):
            if j >= n:
                continue
            slot = self._node_slots[j]
            slot.static_key = _node_profile_key(slot.obj, self._relevant_keys)

        # ---- node dynamic occupancy (ports / CSI) -----------------------
        new_dyn: Dict[int, Tuple[Dict, Dict]] = {}
        for i in self._portcsi_rows:
            j = int(self._pod_node_of(i))
            if j < 0:
                continue
            pod = self._pod_slots[i].orig
            ports, attached = new_dyn.setdefault(j, ({}, {}))
            for prt in pod.host_ports:
                ports[prt] = ports.get(prt, 0) + 1
            for driver, handle in pod.csi_volumes:
                attached.setdefault(driver, set()).add(handle)
        for j in set(self._node_dyn) | set(new_dyn):
            if j < n and self._node_dyn.get(j) != new_dyn.get(j):
                dirty_node_rows.add(j)
        self._node_dyn = new_dyn

        # ---- node profile ids -------------------------------------------
        for j in dirty_node_rows:
            if j >= n:
                continue
            slot = self._node_slots[j]
            ports, attached = self._node_dyn.get(j, (_EMPTY, _EMPTY))
            csi_key = tuple(
                sorted(
                    (d, len(attached.get(d, ())),
                     slot.obj.csi_attach_limits.get(d, -1))
                    for d in self._csi_relevant
                )
            )
            slot.full_key = (slot.static_key, tuple(sorted(ports.items())), csi_key)
            slot.class_id = self._node_profile_id(slot, ports, attached)
            self._node_class[j] = slot.class_id
            self._node_alloc[j] = resources_row(
                slot.obj.allocatable, slot.obj.allocatable.pods,
                self._ext_schema,
            )
            self._node_valid[j] = True

        # ---- pod profile ids + req rows ---------------------------------
        for i in dirty_pod_rows:
            if i >= p:
                continue
            slot = self._pod_slots[i]
            slot.class_id = self._pod_profile_id(slot)
            self._pod_class[i] = slot.class_id
            self._pod_req[i] = resources_row(slot.orig.requests, 1.0, self._ext_schema)
            self._pod_valid[i] = True
            self._pod_priority[i] = slot.orig.priority
            self._pod_preempt[i] = slot.orig.preemption_policy != "Never"

        # ---- group map ---------------------------------------------------
        if group_of_node != self._group_map:
            self._d_node_group_all = True
            self._group_map = dict(group_of_node)
            self._group_index = {}
            self._group_names = []
            for g in self._group_map.values():
                if g not in self._group_index:
                    self._group_index[g] = len(self._group_names)
                    self._group_names.append(g)
            for j in range(n):
                g = self._group_map.get(self._node_slots[j].name)
                self._node_group[j] = self._group_index[g] if g is not None else -1
            self._dirty_fields.add("node_group")
        else:
            for j in dirty_node_rows:
                if j < n:
                    g = self._group_map.get(self._node_slots[j].name)
                    self._node_group[j] = (
                        self._group_index[g] if g is not None else -1
                    )
                    self._dirty_fields.add("node_group")

        # ---- pod_node (targeted) + node_used (vectorized) ---------------
        if self._pod_node_stale:
            for i in self._pod_node_stale:
                if i < p:
                    self._pod_node[i] = self._pod_node_of(i)
                    self._d_pod_node.add(i)
            self._pod_node_stale.clear()
            self._dirty_fields.add("pod_node")
        if structural or dirty_pod_rows:
            self._node_used[:] = 0.0
            placed = self._pod_node[:p] >= 0
            if placed.any():
                np.add.at(
                    self._node_used,
                    self._pod_node[:p][placed],
                    self._pod_req[:p][placed],
                )
            self._dirty_fields.update(("pod_node", "node_used"))

        # ---- exception machinery ----------------------------------------
        anti_sig = tuple(
            sorted(
                (self._pod_slots[i].key, self._pod_slots[i].gen,
                 self._pod_slots[i].assign)
                for i in self._anti_rows
                if self._pod_node_of(i) >= 0
            )
        )
        if anti_sig != self._anti_sig:
            self._anti_sig = anti_sig
            self._anti_match_rows = self._scan_anti_matches(range(p))
        elif dirty_pod_rows and anti_sig:
            hits = self._scan_anti_matches(i for i in dirty_pod_rows if i < p)
            self._anti_match_rows -= {i for i in dirty_pod_rows if i < p}
            self._anti_match_rows |= hits
        # RWOP conflict rows: cheap per-update recount over the (tiny) set of
        # pods that mount RWOP claims — membership depends on OTHER pods'
        # liveness/placement, so it cannot be a static per-slot flag. Same
        # semantics as packer._rwop_conflict_rows: only live PLACED sharers
        # count, a pod's own usage never blocks it, terminating pods are
        # neither counted nor blocked.
        rwop_conflicts: Set[int] = set()
        if self._rwop_rows:
            cnt: Dict[str, int] = {}
            for i in self._rwop_rows:
                pod = self._pod_slots[i].orig
                if pod.deletion_ts is None and self._pod_node_of(i) >= 0:
                    for h in set(pod.rwop_handles):
                        cnt[h] = cnt.get(h, 0) + 1
            if cnt:
                for i in self._rwop_rows:
                    pod = self._pod_slots[i].orig
                    if pod.deletion_ts is not None:
                        continue
                    own = 1 if self._pod_node_of(i) >= 0 else 0
                    if any(
                        cnt.get(h, 0) - own >= 1
                        for h in set(pod.rwop_handles)
                    ):
                        rwop_conflicts.add(i)
        # Legacy same-volume conflict rows (VolumeRestrictions in-tree
        # rules): recomputed over the (tiny) legacy-volume row set each
        # update. The blocked set is NODE-level, so a sharer merely MOVING
        # between nodes changes the veto without changing exc membership —
        # a placement signature over the legacy users forces the exception
        # rebuild in that case (same trick as anti_sig above).
        legacy_conflicts: Set[int] = set()
        legacy_conf: Dict[int, set] = {}
        legacy_sig: tuple = ()
        if len(self._legacy_rows) >= 2:
            lrows = sorted(self._legacy_rows)
            conf = _legacy_conflict_nodes(
                [self._pod_slots[i].orig for i in lrows],
                [self._pod_node_of(i) for i in lrows],
            )
            legacy_conf = {lrows[k]: v for k, v in conf.items()}
            legacy_conflicts = set(legacy_conf)
            legacy_sig = tuple(
                sorted(
                    (self._pod_slots[i].key, self._pod_slots[i].gen,
                     self._pod_slots[i].assign)
                    for i in lrows
                    if self._pod_node_of(i) >= 0
                )
            )
        if legacy_sig != self._legacy_sig:
            self._legacy_sig = legacy_sig
            self._exc_shape_dirty = True
        self._legacy_conf = legacy_conf
        exc = (
            self._interpod_rows | self._spread_rows | self._anti_match_rows
            | rwop_conflicts | legacy_conflicts
        )
        exc = {i for i in exc if i < p}
        exc_dirty = (
            (exc or self._exc_prev or self._exc_shape_dirty)
            and (structural or dirty_pod_rows or dirty_node_rows
                 or exc != self._exc_prev or self._exc_shape_dirty)
        )
        self._exc_shape_dirty = False

        # ---- overrides (sparse self-cells) ------------------------------
        overrides = self._compute_overrides()

        # ---- mask maintenance -------------------------------------------
        if self._dense:
            self._update_dense_mask(
                n, p, dirty_pod_rows, dirty_node_rows, overrides, exc,
                bool(exc_dirty),
            )
        else:
            self._update_factored(n, p, overrides, exc, bool(exc_dirty))
        self._exc_prev = exc
        self._override_prev = {(i, j) for i, j, _ in overrides}

        if dirty_pod_rows:
            self._dirty_fields.update(
                ("pod_req", "pod_valid", "pod_class",
                 "pod_priority", "pod_preempt")
            )
        if dirty_node_rows:
            self._dirty_fields.update(
                ("node_alloc", "node_valid", "node_class")
            )
        # row-level dirt for the arena's delta program (in-bounds rows only;
        # removal/move sites recorded their swap-fill rows already)
        self._d_pod_rows.update(i for i in dirty_pod_rows if i < self._PP)
        self._d_node_rows.update(j for j in dirty_node_rows if j < self._NN)

        # this update's row dirt (swap-fill moves included), for callers
        # that report what an update cost; _assemble clears the sets
        self.last_dirty = {
            "pod_rows": len(self._d_pod_rows),
            "pod_node": len(self._d_pod_node),
            "node_rows": len(self._d_node_rows),
        }
        tensors, meta = self._assemble(), self._build_meta()
        if self.journal_sink is not None:
            self.journal_sink(tensors, meta, self)
        return tensors, meta

    # --------------------------------------------------------- slot plumbing
    def _pod_node_of(self, i: int) -> int:
        return self._node_rows.get(self._pod_slots[i].assign, -1)

    def _register_pod_flags(self, row: int, slot: _PodSlot) -> None:
        if slot.has_portcsi:
            self._portcsi_rows.add(row)
        if slot.has_interpod:
            self._interpod_rows.add(row)
        if slot.has_hard_spread:
            self._spread_rows.add(row)
        if slot.has_anti:
            self._anti_rows.add(row)
        if slot.has_rwop:
            self._rwop_rows.add(row)
        if slot.has_legacy:
            self._legacy_rows.add(row)
        for k in slot.sel_keys:
            self._relkey_count[k] = self._relkey_count.get(k, 0) + 1
        for d in slot.csi_drivers:
            self._csidrv_count[d] = self._csidrv_count.get(d, 0) + 1

    def _unregister_pod_flags(self, row: int, slot: _PodSlot) -> None:
        self._portcsi_rows.discard(row)
        self._interpod_rows.discard(row)
        self._spread_rows.discard(row)
        self._anti_rows.discard(row)
        self._anti_match_rows.discard(row)
        self._rwop_rows.discard(row)
        self._legacy_rows.discard(row)
        for k in slot.sel_keys:
            c = self._relkey_count[k] - 1
            if c:
                self._relkey_count[k] = c
            else:
                del self._relkey_count[k]
        for d in slot.csi_drivers:
            c = self._csidrv_count[d] - 1
            if c:
                self._csidrv_count[d] = c
            else:
                del self._csidrv_count[d]

    def _add_pod(self, key: str, pod: Pod, assign: str) -> int:
        row = len(self._pod_slots)
        slot = _PodSlot(key, pod, assign, self._gen)
        slot.sync_eff()
        self._pod_slots.append(slot)
        self._eff_list.append(slot.eff)
        self._pod_rows[key] = row
        self._pod_node_stale.add(row)
        if assign:
            self._assign_index.setdefault(assign, set()).add(row)
        self._register_pod_flags(row, slot)
        return row

    def _change_pod(self, row: int, pod: Pod) -> None:
        slot = self._pod_slots[row]
        self._unregister_pod_flags(row, slot)
        stamp = slot.stamp
        slot.refresh(pod)
        slot.stamp = stamp
        slot.gen = self._gen
        slot.sync_eff()
        self._eff_list[row] = slot.eff
        self._register_pod_flags(row, slot)

    def _reassign(self, row: int, assign: str) -> None:
        slot = self._pod_slots[row]
        if slot.assign:
            s = self._assign_index.get(slot.assign)
            if s is not None:
                s.discard(row)
                if not s:
                    del self._assign_index[slot.assign]
        slot.assign = assign
        if assign:
            self._assign_index.setdefault(assign, set()).add(row)
        slot.sync_eff()
        self._eff_list[row] = slot.eff
        self._pod_node_stale.add(row)

    def _remove_pod(self, key: str, dirty: Set[int]) -> None:
        """Swap-fill the hole with the last live row; the moved slot's dirty
        flag (if any) follows it to its new row."""
        row = self._pod_rows.pop(key)
        slot = self._pod_slots[row]
        self._unregister_pod_flags(row, slot)
        if slot.assign:
            s = self._assign_index.get(slot.assign)
            if s is not None:
                s.discard(row)
                if not s:
                    del self._assign_index[slot.assign]
        last = len(self._pod_slots) - 1
        dirty.discard(row)  # the removed pod's pending dirtiness dies with it
        self._pod_node_stale.discard(row)
        # membership of the REMOVED row in the previous-exception/override
        # bookkeeping dies with it — but the DISAPPEARANCE itself must still
        # force an exception rebuild (exc_dirty would otherwise compare
        # empty == empty while the factored pod_exc table still maps rows)
        if row in self._exc_prev:
            self._exc_prev.discard(row)
            self._exc_shape_dirty = True
        if any(i == row for (i, _j) in self._override_prev):
            self._override_prev = {
                (i, j) for (i, j) in self._override_prev if i != row
            }
            self._exc_shape_dirty = True
        if row != last:
            self._move_pod_row(last, row)
            if last in dirty:
                dirty.discard(last)
                dirty.add(row)
        self._pod_slots.pop()
        self._eff_list.pop()
        self._pod_node_stale.discard(last)
        self._pod_valid[last] = False
        self._pod_class[last] = -1
        self._pod_node[last] = -1
        self._pod_req[last] = 0.0
        self._pod_priority[last] = 0
        self._pod_preempt[last] = False
        if self._mask is not None:
            self._mask[last, :] = False
            # the swap-fill rewrote host rows in place — the device copy is
            # stale even though no row is "dirty" in the profile sense
            self._dirty_fields.add("sched_mask")
            self._mask_rows_d.update((row, last))
        self._dirty_fields.update(
            ("pod_valid", "pod_class", "pod_node", "pod_req",
             "pod_priority", "pod_preempt")
        )
        self._d_pod_rows.update((row, last))
        self._d_pod_node.update((row, last))

    def _move_pod_row(self, src: int, dst: int) -> None:
        slot = self._pod_slots[src]
        self._pod_slots[dst] = slot
        self._pod_rows[slot.key] = dst
        for coll in (
            self._portcsi_rows, self._interpod_rows, self._spread_rows,
            self._anti_rows, self._anti_match_rows, self._rwop_rows,
            self._legacy_rows,
        ):
            if src in coll:
                coll.discard(src)
                coll.add(dst)
        if slot.assign:
            s = self._assign_index.get(slot.assign)
            if s is not None:
                s.discard(src)
                s.add(dst)
        if src in self._pod_node_stale:
            self._pod_node_stale.discard(src)
            self._pod_node_stale.add(dst)
        # previous-exception/override bookkeeping must follow the moved row,
        # or a conflict that CLEARS in the same update as a swap-fill resets
        # the wrong (dead) row and leaves the moved pod's mask stale — found
        # by the RWOP incremental-parity test
        if src in self._exc_prev:
            self._exc_prev.discard(src)
            self._exc_prev.add(dst)
            self._exc_shape_dirty = True
        if self._override_prev:
            self._override_prev = {
                (dst if i == src else i, j) for (i, j) in self._override_prev
            }
        self._eff_list[dst] = self._eff_list[src]
        self._pod_req[dst] = self._pod_req[src]
        self._pod_valid[dst] = self._pod_valid[src]
        self._pod_node[dst] = self._pod_node[src]
        self._pod_class[dst] = self._pod_class[src]
        self._pod_priority[dst] = self._pod_priority[src]
        self._pod_preempt[dst] = self._pod_preempt[src]
        self._d_pod_rows.add(dst)
        self._d_pod_node.add(dst)
        if self._mask is not None:
            self._mask[dst, :] = self._mask[src, :]
            self._mask_rows_d.add(dst)

    def _add_node(self, node: Node) -> int:
        row = len(self._node_slots)
        self._node_slots.append(_NodeSlot(node, self._gen))
        self._node_rows[node.name] = row
        # ghost assignments to this name now resolve to a real row
        for i in self._assign_index.get(node.name, ()):
            self._pod_node_stale.add(i)
        return row

    def _change_node(self, row: int, node: Node) -> None:
        slot = self._node_slots[row]
        slot.obj = node
        slot.static_key = None
        slot.mut_fp = _node_mut_fp(node)

    def _remove_node(self, name: str, dirty_nodes: Set[int]) -> None:
        row = self._node_rows.pop(name)
        last = len(self._node_slots) - 1
        # pods assigned (by name) to the vanished node become pending rows
        for i in self._assign_index.get(name, ()):
            self._pod_node_stale.add(i)
        dirty_nodes.discard(row)
        if row != last:
            self._move_node_row(last, row)
            if last in dirty_nodes:
                dirty_nodes.discard(last)
                dirty_nodes.add(row)
        self._node_slots.pop()
        self._node_valid[last] = False
        self._node_class[last] = -1
        self._node_alloc[last] = 0.0
        self._node_used[last] = 0.0
        self._node_group[last] = -1
        self._node_dyn.pop(last, None)
        if self._mask is not None:
            self._mask[:, last] = False
            self._dirty_fields.add("sched_mask")  # column swap-fill happened
            self._mask_cols_d.update((row, last))
        self._dirty_fields.update(
            ("node_valid", "node_class", "node_alloc", "node_used", "node_group")
        )
        self._d_node_rows.update((row, last))

    def _move_node_row(self, src: int, dst: int) -> None:
        slot = self._node_slots[src]
        self._node_slots[dst] = slot
        self._node_rows[slot.name] = dst
        self._node_alloc[dst] = self._node_alloc[src]
        self._node_used[dst] = self._node_used[src]
        self._node_valid[dst] = self._node_valid[src]
        self._node_group[dst] = self._node_group[src]
        self._node_class[dst] = self._node_class[src]
        if src in self._node_dyn:
            self._node_dyn[dst] = self._node_dyn.pop(src)
        else:
            self._node_dyn.pop(dst, None)
        if self._override_prev:
            self._override_prev = {
                (i, dst if j == src else j) for (i, j) in self._override_prev
            }
        if self._mask is not None:
            self._mask[:, dst] = self._mask[:, src]
            self._mask_cols_d.add(dst)
        self._d_node_rows.add(dst)
        # pod_node entries pointing at src must follow the move
        for i in self._assign_index.get(slot.name, ()):
            self._pod_node_stale.add(i)

    # ------------------------------------------------------------- profiles
    def _profiles_bloated(self) -> bool:
        return (
            len(self._pod_profiles) > 1024 or len(self._node_profiles) > 1024
        )

    def _grow_class_mask(self, cp: int, cn: int) -> None:
        CP, CN = self._class_mask.shape
        if cp <= CP and cn <= CN:
            return
        grown = np.zeros((max(CP, bucket_size(cp)), max(CN, bucket_size(cn))), bool)
        grown[:CP, :CN] = self._class_mask
        self._class_mask = grown

    def _pod_profile_id(self, slot: _PodSlot) -> int:
        pid = self._pod_profiles.get(slot.prof_key)
        if pid is None:
            pid = len(self._pod_profiles)
            self._pod_profiles[slot.prof_key] = pid
            self._pod_exemplar.append(slot.orig)
            self._grow_class_mask(pid + 1, len(self._node_exemplar))
            for nj, (node, ports, attached) in enumerate(self._node_exemplar):
                self._class_mask[pid, nj] = _class_verdict(
                    slot.orig, node, ports, attached
                )
            self._dirty_fields.add("class_mask")
        return pid

    def _node_profile_id(
        self, slot: _NodeSlot, ports: Dict, attached: Dict
    ) -> int:
        nid = self._node_profiles.get(slot.full_key)
        if nid is None:
            nid = len(self._node_profiles)
            self._node_profiles[slot.full_key] = nid
            # frozen copies: the live dyn dicts are rebuilt (and the old ones
            # dropped) every update, but the exemplar must never drift
            self._node_exemplar.append(
                (slot.obj, dict(ports), {d: set(h) for d, h in attached.items()})
            )
            self._grow_class_mask(len(self._pod_exemplar), nid + 1)
            for pi, pod in enumerate(self._pod_exemplar):
                self._class_mask[pi, nid] = _class_verdict(
                    pod, slot.obj, ports, attached
                )
            self._dirty_fields.add("class_mask")
        return nid

    # --------------------------------------------------- dynamic mask pieces
    def _scan_anti_matches(self, rows) -> Set[int]:
        """Rows matched by some OTHER placed pod's anti-affinity term (the
        symmetric rule's exception set, packer._exception_pods). The rows
        are grouped by pod profile, so each term is tested once a profile
        (packer._ProfileGroups); the set is the one a test per row gives."""
        terms = []
        for qi in self._anti_rows:
            if self._pod_node_of(qi) >= 0:
                q = self._pod_slots[qi].orig
                for term in q.affinity.pod_anti_affinity:
                    terms.append((qi, q, term))
        out: Set[int] = set()
        if not terms:
            return out
        rows = list(rows)
        groups = _ProfileGroups([self._pod_slots[i].orig for i in rows], rows)
        for qi, q, term in terms:
            out.update(i for i in groups.matched_rows(term, q.namespace).tolist() if i != qi)
        return out

    def _compute_overrides(self) -> List[Tuple[int, int, bool]]:
        """Self-cell corrections for placed port/CSI pods (their class
        verdict on their OWN node wrongly counts their own contribution) —
        packer._self_cell_overrides over the portcsi subset only."""
        out: List[Tuple[int, int, bool]] = []
        for i in sorted(self._portcsi_rows):
            j = self._pod_node_of(i)
            if j < 0:
                continue
            pod = self._pod_slots[i].orig
            node = self._node_slots[j].obj
            ports, attached = self._node_dyn.get(j, (_EMPTY, _EMPTY))
            out.append((i, int(j), _self_cell_value(pod, node, ports, attached)))
        return out

    def _class_row(self, i: int, n: int) -> np.ndarray:
        return self._class_mask[self._pod_class[i], self._node_class[:n]]

    def _update_dense_mask(
        self,
        n: int,
        p: int,
        dirty_pods: Set[int],
        dirty_nodes: Set[int],
        overrides: List[Tuple[int, int, bool]],
        exc: Set[int],
        exc_dirty: bool,
    ) -> None:
        mask = self._mask
        touched = bool(dirty_pods or dirty_nodes or exc_dirty)
        live_nodes = [j for j in dirty_nodes if j < n]
        reset_rows = [
            i for i in (self._exc_prev - exc) | dirty_pods if i < p
        ]
        if p and (len(live_nodes) > max(8, n // 4)
                  or len(reset_rows) > max(8, p // 4)):
            # bulk rebuild (full builds, mass relists): one vectorized
            # gather beats tens of thousands of per-row writes
            mask[:p, :n] = self._class_mask[self._pod_class[:p]][
                :, self._node_class[:n]
            ]
            touched = True
            self._mask_bulk = True
        else:
            for j in live_nodes:
                mask[:p, j] = self._class_mask[
                    self._pod_class[:p], self._node_class[j]
                ]
                touched = True
                self._mask_cols_d.add(j)
            for i in reset_rows:
                mask[i, :n] = self._class_row(i, n)
                touched = True
                self._mask_rows_d.add(i)
        # cells leaving their special state reset to pure class values
        new_over = {(i, j) for i, j, _ in overrides}
        for i, j in self._override_prev:
            if (i, j) not in new_over and i < p and j < n:
                mask[i, j] = self._class_mask[
                    self._pod_class[i], self._node_class[j]
                ]
                touched = True
                self._mask_rows_d.add(i)
        for i, j, value in overrides:
            if mask[i, j] != value:
                mask[i, j] = value
                touched = True
                self._mask_rows_d.add(i)
        if exc_dirty and exc:
            own_over = {i: (j, v) for i, j, v in overrides}
            for i in exc:
                mask[i, :n] = self._class_row(i, n)
                if i in own_over:
                    j, v = own_over[i]
                    mask[i, j] = v
            # numpy basic slice = shared memory: rule writes land in _mask;
            # the rules engine works on unpadded [*, n] rows
            view = _RowView(mask[:p, :n], {i: i for i in exc})
            _apply_row_rules(
                view,
                [s.obj for s in self._node_slots],
                [s.eff for s in self._pod_slots],
                self._pod_node[:p],
                interpod=True,
                legacy=self._legacy_conf,
            )
            touched = True
            self._mask_rows_d.update(exc)
        if touched:
            self._dirty_fields.add("sched_mask")

    def _update_factored(
        self,
        n: int,
        p: int,
        overrides: List[Tuple[int, int, bool]],
        exc: Set[int],
        exc_dirty: bool,
    ) -> None:
        exc_sorted = sorted(exc)
        if exc_dirty:
            E = len(exc_sorted)
            EE = bucket_size(E, minimum=1)
            rows = np.zeros((max(E, 1), n), bool)  # rules run unpadded
            row_of = {i: e for e, i in enumerate(exc_sorted)}
            own_over = {i: (j, v) for i, j, v in overrides}
            for i, e in row_of.items():
                rows[e] = self._class_row(i, n)
                if i in own_over:
                    j, v = own_over[i]
                    rows[e, j] = v
            if row_of:
                _apply_row_rules(
                    _RowView(rows, row_of),
                    [s.obj for s in self._node_slots],
                    [s.eff for s in self._pod_slots],
                    self._pod_node[:p],
                    interpod=True,
                    legacy=self._legacy_conf,
                )
            padded = np.zeros((EE, self._NN), bool)
            padded[: rows.shape[0], :n] = rows
            self._exc_rows_np = padded
            self._pod_exc_np = np.full((self._PP,), -1, np.int32)
            for i, e in row_of.items():
                self._pod_exc_np[i] = e
            self._dirty_fields.update(("exc_rows", "pod_exc"))
        # overrides already baked into exception rows stay sparse otherwise
        exc_set = set(exc_sorted)
        cells = [(i, j, v) for i, j, v in overrides if i not in exc_set]
        if cells != self._cells:
            self._cells = cells
            self._dirty_fields.add("cells")

    def device_bytes(self) -> int:
        """Total bytes of the packer's persistent device tensors — the perf
        residency ledger's ``snapshot`` pool (run_once stamps it per tick).
        Delegates to ``perf.array_bytes``, the one byte model every
        residency pool shares; a pure function of the packed world's
        shapes, so the figure replays byte-identically under loadgen."""
        return array_bytes(list(self._dev.values()))

    # ----------------------------------------------------- arena delta path
    def attach_arena(self, arena) -> None:
        """Adopt a resident device arena: subsequent ``_assemble`` calls
        emit delta programs against it instead of re-uploading tensors.
        The first program after attach is a full seed."""
        _check_arena_device(arena, self.device)
        self._arena = arena
        self._arena_reseed = True
        self._arena_reseed_reason = "init"
        self._arena_resend_aux = False

    @property
    def arena(self):
        return self._arena

    def _clear_delta_tracking(self) -> None:
        self._d_pod_rows.clear()
        self._d_pod_node.clear()
        self._d_node_rows.clear()
        self._d_node_group_all = False
        self._mask_rows_d.clear()
        self._mask_cols_d.clear()
        self._mask_bulk = False

    def _aux_arrays(self, all_fields: bool) -> Dict[str, np.ndarray]:
        """Factored-mask factors: shape-flexible, small, re-uploaded
        wholesale when dirty (the arena keeps one generation-independent
        copy). Empty in dense mode."""
        out: Dict[str, np.ndarray] = {}
        if self._dense:
            return out
        dirty = self._dirty_fields
        if all_fields or "class_mask" in dirty:
            CP = max(len(self._pod_exemplar), 1)
            CN = max(len(self._node_exemplar), 1)
            CPP, CNN = bucket_size(CP, minimum=8), bucket_size(CN, minimum=8)
            padded = np.zeros((CPP, CNN), bool)
            padded[: self._class_mask.shape[0], : self._class_mask.shape[1]] = (
                self._class_mask
            )
            out["class_mask"] = padded
        if all_fields or "exc_rows" in dirty:
            out["exc_rows"] = self._exc_rows_np
        if all_fields or "pod_exc" in dirty:
            out["pod_exc"] = self._pod_exc_np
        if all_fields or "cells" in dirty:
            K = len(self._cells)
            KK = bucket_size(K, minimum=1)
            cell_pod = np.full((KK,), -1, np.int32)
            cell_node = np.zeros((KK,), np.int32)
            cell_val = np.zeros((KK,), bool)
            for k, (i, j, v) in enumerate(self._cells):
                cell_pod[k], cell_node[k], cell_val[k] = i, j, v
            out["cell_pod"] = cell_pod
            out["cell_node"] = cell_node
            out["cell_val"] = cell_val
        return out

    def _assemble_arena(self) -> SnapshotTensors:
        """Emit this update's delta program and serve tensors from the
        arena's live generation. On an apply fault the live arena is
        intact but one tick behind — this tick serves from a cold upload
        (correct, just unamortized) and the arena reseeds next update."""
        n, p = len(self._node_slots), len(self._pod_slots)
        host: Dict[str, np.ndarray] = dict(
            node_alloc=self._node_alloc,
            node_used=self._node_used,
            node_valid=self._node_valid,
            node_group=self._node_group,
            pod_req=self._pod_req,
            pod_valid=self._pod_valid,
            pod_node=self._pod_node,
            pod_priority=self._pod_priority,
            pod_preempt=self._pod_preempt,
        )
        if self._dense:
            host["sched_mask"] = self._mask
        else:
            host["pod_class"] = self._pod_class
            host["node_class"] = self._node_class
        reseed = self._arena_reseed
        program = DeltaProgram(
            host=host, reseed=reseed,
            reseed_reason=self._arena_reseed_reason,
        )
        if reseed:
            self._node_used_shadow = self._node_used.copy()
        else:
            ops = program.ops

            def rows_op(fname: str, arr: np.ndarray, idx_set) -> None:
                idx = np.asarray(
                    sorted(i for i in idx_set if 0 <= i < arr.shape[0]),
                    np.int32,
                )
                if idx.size:
                    ops.append(DeltaOp(fname, 0, idx, arr[idx]))

            if self._d_pod_rows:
                rows_op("pod_req", self._pod_req, self._d_pod_rows)
                rows_op("pod_valid", self._pod_valid, self._d_pod_rows)
                rows_op("pod_priority", self._pod_priority, self._d_pod_rows)
                rows_op("pod_preempt", self._pod_preempt, self._d_pod_rows)
                if not self._dense:
                    rows_op("pod_class", self._pod_class, self._d_pod_rows)
            if self._d_pod_node:
                rows_op("pod_node", self._pod_node, self._d_pod_node)
            if self._d_node_rows:
                rows_op("node_alloc", self._node_alloc, self._d_node_rows)
                rows_op("node_valid", self._node_valid, self._d_node_rows)
                if not self._dense:
                    rows_op("node_class", self._node_class, self._d_node_rows)
            group_rows = set(self._d_node_rows)
            if self._d_node_group_all:
                group_rows.update(range(n))
            if group_rows:
                rows_op("node_group", self._node_group, group_rows)
            if "node_used" in self._dirty_fields:
                changed = np.flatnonzero(
                    (self._node_used != self._node_used_shadow).any(axis=1)
                )
                if changed.size:
                    ops.append(DeltaOp(
                        "node_used", 0, changed.astype(np.int32),
                        self._node_used[changed],
                    ))
                    self._node_used_shadow[changed] = self._node_used[changed]
            if self._dense and (
                self._mask_bulk or self._mask_rows_d or self._mask_cols_d
            ):
                mrows = set(self._mask_rows_d)
                if self._mask_bulk:
                    # a bulk rebuild rewrote every live row: still a row
                    # scatter (K rides the pow-8 ladder up to the bucket),
                    # never a "full upload" — the ledger reserves that
                    # word for reshape-forced re-seeds
                    mrows.update(range(p))
                rows_op("sched_mask", self._mask, mrows)
                cols = np.asarray(
                    sorted(
                        j for j in self._mask_cols_d
                        if 0 <= j < self._mask.shape[1]
                    ),
                    np.int32,
                )
                if cols.size:
                    ops.append(DeltaOp(
                        "sched_mask", 1, cols, self._mask[:, cols]
                    ))
        program.aux = self._aux_arrays(
            all_fields=reseed or self._arena_resend_aux
        )
        try:
            bufs = self._arena.apply(program)
            self._arena_resend_aux = False
        except ArenaError:
            # rollback: the live generation is intact but stale — serve
            # THIS tick from a cold upload so decisions stay correct, and
            # let the arena reseed on the next update. The next program
            # must also resend EVERY aux field: this tick's aux dirt is
            # cleared below, but the arena never received the uploads —
            # without the resend it would serve stale factored-mask
            # factors after recovery.
            self._arena_resend_aux = True
            trace.add_event("arena.rollback", reason="apply_failed")
            cold = dict(host)
            cold.update(self._aux_arrays(all_fields=True))
            # copies, on the packer's own device (a rollback is never a
            # device fallback): an aliasing upload would let this tick's
            # served tensors mutate when the next update writes rows in place
            bufs = {
                name: torch.tensor(arr, device=self.device)
                for name, arr in cold.items()
            }
        self._arena_reseed = False
        self._arena_reseed_reason = ""
        self._dirty_fields.clear()
        self._clear_delta_tracking()
        common = dict(
            node_alloc=bufs["node_alloc"],
            node_used=bufs["node_used"],
            node_valid=bufs["node_valid"],
            node_group=bufs["node_group"],
            pod_req=bufs["pod_req"],
            pod_valid=bufs["pod_valid"],
            pod_node=bufs["pod_node"],
            pod_priority=bufs["pod_priority"],
            pod_preempt=bufs["pod_preempt"],
        )
        if self._dense:
            return SnapshotTensors(sched_mask=bufs["sched_mask"], **common)
        return SnapshotTensors(
            sched_mask=None,
            pod_class=bufs["pod_class"],
            node_class=bufs["node_class"],
            class_mask=bufs["class_mask"],
            exc_rows=bufs["exc_rows"],
            pod_exc=bufs["pod_exc"],
            cell_pod=bufs["cell_pod"],
            cell_node=bufs["cell_node"],
            cell_val=bufs["cell_val"],
            **common,
        )

    # ------------------------------------------------------------- assembly
    def _upload(self, name: str, arr: np.ndarray) -> object:
        if name in self._dirty_fields or name not in self._dev:
            self._dev[name] = torch.tensor(arr, device=self.device)  # a copy
        return self._dev[name]

    def _assemble(self) -> SnapshotTensors:
        if self._arena is not None:
            return self._assemble_arena()
        self._clear_delta_tracking()
        common = dict(
            node_alloc=self._upload("node_alloc", self._node_alloc),
            node_used=self._upload("node_used", self._node_used),
            node_valid=self._upload("node_valid", self._node_valid),
            node_group=self._upload("node_group", self._node_group),
            pod_req=self._upload("pod_req", self._pod_req),
            pod_valid=self._upload("pod_valid", self._pod_valid),
            pod_node=self._upload("pod_node", self._pod_node),
            pod_priority=self._upload("pod_priority", self._pod_priority),
            pod_preempt=self._upload("pod_preempt", self._pod_preempt),
        )
        if self._dense:
            tensors = SnapshotTensors(
                sched_mask=self._upload("sched_mask", self._mask), **common
            )
        else:
            CP = max(len(self._pod_exemplar), 1)
            CN = max(len(self._node_exemplar), 1)
            CPP, CNN = bucket_size(CP, minimum=8), bucket_size(CN, minimum=8)
            if ("class_mask" in self._dirty_fields
                    or "class_mask" not in self._dev):
                padded = np.zeros((CPP, CNN), bool)
                padded[: self._class_mask.shape[0], : self._class_mask.shape[1]] = (
                    self._class_mask
                )
                self._dev["class_mask"] = torch.tensor(padded, device=self.device)
            if "cells" in self._dirty_fields or "cell_pod" not in self._dev:
                K = len(self._cells)
                KK = bucket_size(K, minimum=1)
                cell_pod = np.full((KK,), -1, np.int32)
                cell_node = np.zeros((KK,), np.int32)
                cell_val = np.zeros((KK,), bool)
                for k, (i, j, v) in enumerate(self._cells):
                    cell_pod[k], cell_node[k], cell_val[k] = i, j, v
                self._dev["cell_pod"] = torch.tensor(cell_pod, device=self.device)
                self._dev["cell_node"] = torch.tensor(cell_node, device=self.device)
                self._dev["cell_val"] = torch.tensor(cell_val, device=self.device)
            tensors = SnapshotTensors(
                sched_mask=None,
                pod_class=self._upload("pod_class", self._pod_class),
                node_class=self._upload("node_class", self._node_class),
                class_mask=self._dev["class_mask"],
                exc_rows=self._upload("exc_rows", self._exc_rows_np),
                pod_exc=self._upload("pod_exc", self._pod_exc_np),
                cell_pod=self._dev["cell_pod"],
                cell_node=self._dev["cell_node"],
                cell_val=self._dev["cell_val"],
                **common,
            )
        self._dirty_fields.clear()
        return tensors

    def _build_meta(self) -> SnapshotMeta:
        meta = SnapshotMeta(
            nodes=[s.obj for s in self._node_slots],
            pods=list(self._eff_list),
            node_index=dict(self._node_rows),
            pod_index=dict(self._pod_rows),
            group_names=list(self._group_names),
            group_index=dict(self._group_index),
            extended_resources=self._ext_schema,
        )
        return meta
