"""JournalRecorder: the black-box flight recorder behind /journalz.

One recorder per autoscaler, same lifecycle as the perf observatory and
the decision explainer: ``begin_tick`` opens the tick, the packer's
journal sink (``observe_update``) captures the tick's FIRST tensor
materialization — which is the decision-input state: ClusterSnapshot
caches tensors per version and ``revert()`` restores the fork-time
version, so everything the tick decided (estimator, expander, preemption
plan) read exactly this materialization — and ``record_tick`` closes the
tick into one journal line: a full keyframe (init, packer reseed, shape
change, options change, or every K ticks) or a byte-level row-scatter
delta against the previous line (codec.py).

The diff is computed against the recorder's own host shadow, not the
packer's dirty sets, so fork/revert churn inside the tick is invisible
and reconstruction is bit-exact by construction. The ring is always on
(bounded memory); ``journal_enabled`` gates only the endpoint, and
``journal_path`` appends the same strict ``record_line`` bytes to disk
for post-mortem reconstruct/diff/replay.

Lock discipline (graftlint GL004): record/observe run on the loop thread,
the JSON surfaces on server threads — every touch of the ring, shadow,
and staging state holds ``_lock``.

The port of ``autoscaler_tpu/journal/recorder.py``. ``observe_update``
takes the port's torch ``SnapshotTensors``: each field is copied once to a
host numpy array (a device-to-host copy on the card), so the journal lines
are byte for byte the JAX package's. ``probe`` runs the port's
``ops/fit.fits_any_node`` on the recorder's ``device`` (None = the first
CUDA card), which is K4 through ``fit_reduce_exact`` on factored snapshots.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from autoscaler_tpu_torch.journal.ledger import (
    SCHEMA,
    record_line,
    summarize,
)
from autoscaler_tpu_torch.journal.codec import (
    delta_ops,
    encode_array,
    names_delta,
    sha256_hex,
)


def _host(value) -> np.ndarray:
    """One served tensor as a host array: a copy, never an alias (the
    packer and the arena write their tensors in place on later updates)."""
    return value.detach().to("cpu", copy=True).numpy()


def options_fingerprint(options_doc: Dict[str, Any]) -> str:
    """sha256 of the strict sorted-key options JSON — the per-record
    effective-configuration stamp (a fingerprint mismatch between journal
    and replay environment is itself a divergence finding)."""
    import json

    return sha256_hex(
        json.dumps(options_doc, sort_keys=True, separators=(",", ":"),
                   default=str)
    )


class JournalRecorder:
    """Delta-encoded per-tick state history with typed reconstruction."""

    def __init__(
        self,
        ring_capacity: int = 64,
        keyframe_interval: int = 16,
        path: str = "",
        options_doc: Optional[Dict[str, Any]] = None,
        metrics=None,
        device=None,
    ) -> None:
        self._device = device
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(ring_capacity), 1))
        self._keyframe_interval = max(int(keyframe_interval), 1)
        self._path = path
        self._metrics = metrics
        self._options_doc = dict(options_doc or {})
        self._options_fp = options_fingerprint(self._options_doc)
        # open-tick staging (loop thread): the first packer materialization
        self._tick: Optional[int] = None
        self._captured = False
        self._notes: Dict[str, Any] = {}
        self._cap_fields: Optional[Dict[str, np.ndarray]] = None
        self._cap_names: Optional[Dict[str, List[Optional[str]]]] = None
        self._cap_ext: List[str] = []
        self._cap_full_packs: Optional[int] = None
        self._cap_reseed_reason = ""
        # shadow of the last RECORDED state — the delta base and the
        # probe's live reference
        self._shadow_fields: Optional[Dict[str, np.ndarray]] = None
        self._shadow_names: Optional[Dict[str, List[Optional[str]]]] = None
        self._shadow_ext: List[str] = []
        self._last_full_packs: Optional[int] = None
        self._since_keyframe = 0

    # ------------------------------------------------------ tick lifecycle
    def begin_tick(self, tick: int) -> None:
        with self._lock:
            self._tick = int(tick)
            self._captured = False
            self._notes = {}
            self._cap_fields = None
            self._cap_names = None

    def note(self, key: str, value: Any) -> None:
        """Attach replay context to the open tick (e.g. the preemption
        pass's eligible pending keys — state the decision path consumed
        that the tensors alone do not carry)."""
        with self._lock:
            if self._tick is not None:
                self._notes[key] = value

    def observe_update(self, tensors, meta, packer=None) -> None:
        """Packer journal sink (IncrementalPacker.journal_sink): host-copy
        the tick's first materialization. Later materializations in the
        same tick are fork-churn the decisions never saw — ignored."""
        with self._lock:
            if self._tick is None or self._captured:
                return
            fields: Dict[str, np.ndarray] = {}
            for f in dataclasses.fields(tensors):
                value = getattr(tensors, f.name)
                if value is not None:
                    fields[f.name] = _host(value)
            # the victim-eligibility channel is a function of Pod objects
            # the journal does not carry — capture it as one more field so
            # `journal replay` can re-run the preemption kernel
            from autoscaler_tpu_torch.preempt.policy import evictable_mask

            fields["pod_evictable"] = np.array(
                evictable_mask(meta.pods, tensors.num_pods)
            )
            pods: List[Optional[str]] = [None] * len(meta.pods)
            for key, row in meta.pod_index.items():
                pods[row] = key
            nodes: List[Optional[str]] = [None] * len(meta.nodes)
            for name, row in meta.node_index.items():
                nodes[row] = name
            self._cap_fields = fields
            self._cap_names = {
                "pods": pods,
                "nodes": nodes,
                "groups": list(meta.group_names),
            }
            self._cap_ext = list(meta.extended_resources)
            if packer is not None:
                self._cap_full_packs = getattr(packer, "full_packs", None)
                self._cap_reseed_reason = getattr(
                    packer, "last_repack_reason", ""
                )
            self._captured = True

    def record_tick(self, explain_rec: Optional[Dict[str, Any]] = None):
        """Close the open tick into one journal record (None before the
        first materialization — the journal starts at first state)."""
        with self._lock:
            tick = self._tick
            self._tick = None
            if tick is None:
                return None
            if self._captured:
                fields = self._cap_fields or {}
                names = self._cap_names or {}
                ext = self._cap_ext
            elif self._shadow_fields is not None:
                # nothing materialized this tick: the decision input was
                # the standing state — journal an empty delta so the tick
                # still reconstructs (and the tick axis stays gap-free
                # from the journal's first record on)
                fields = self._shadow_fields
                names = self._shadow_names or {}
                ext = self._shadow_ext
            else:
                return None
            explain_sha = ""
            if explain_rec is not None:
                from autoscaler_tpu_torch.explain import record_line as explain_line

                explain_sha = sha256_hex(explain_line(explain_rec))
            reason = self._keyframe_reason(fields, ext)
            rec: Dict[str, Any] = {
                "schema": SCHEMA,
                "tick": tick,
                "options_fp": self._options_fp,
                "ids": {"trace": tick, "explain": tick, "perf": tick},
                "explain_sha256": explain_sha,
                "ctx": dict(self._notes),
            }
            if reason is not None:
                rec["kind"] = "keyframe"
                rec["reason"] = reason
                rec["options"] = dict(self._options_doc)
                rec["state"] = {
                    "fields": {
                        k: encode_array(v) for k, v in sorted(fields.items())
                    },
                    "names": {k: list(v) for k, v in sorted(names.items())},
                    "ext": list(ext),
                }
                self._since_keyframe = 0
            else:
                assert self._shadow_fields is not None
                rec["kind"] = "delta"
                rec["state"] = {
                    "ops": delta_ops(self._shadow_fields, fields),
                    "names": {
                        k: names_delta(
                            (self._shadow_names or {}).get(k, []), list(v)
                        )
                        for k, v in sorted(names.items())
                    },
                }
                self._since_keyframe += 1
            self._shadow_fields = dict(fields)
            self._shadow_names = {k: list(v) for k, v in names.items()}
            self._shadow_ext = list(ext)
            if self._cap_full_packs is not None:
                self._last_full_packs = self._cap_full_packs
            self._ring.append(rec)
            path = self._path
        if self._metrics is not None:
            self._metrics.journal_records_total.inc()
            if reason is not None:
                self._metrics.journal_keyframes_total.inc()
        if path:
            with open(path, "a") as f:
                f.write(record_line(rec))
        return rec

    def _keyframe_reason(self, fields, ext) -> Optional[str]:
        """Why this tick is a keyframe, None = delta. Precedence: first
        state, then structure (shape/field-set/schema), then packer reseed
        (promotion/full repack), then the every-K interval."""
        prev = self._shadow_fields
        if prev is None:
            return "init"
        if set(prev) != set(fields) or any(
            prev[k].shape != fields[k].shape or prev[k].dtype != fields[k].dtype
            for k in fields
        ):
            return "shape_change"
        if list(ext) != list(self._shadow_ext):
            return "shape_change"
        if (
            self._cap_full_packs is not None
            and self._last_full_packs is not None
            and self._cap_full_packs != self._last_full_packs
        ):
            return "reseed:" + (self._cap_reseed_reason or "init")
        if self._since_keyframe + 1 >= self._keyframe_interval:
            return "interval"
        return None

    # ---------------------------------------------------------- divergence
    def probe(self) -> Dict[str, Any]:
        """Reconstruct the newest journaled tick from the ring and bit-
        compare it against the live shadow (the host copy of what the
        arena-backed packer actually served), then cross-check the fit
        kernel's verdicts on the reconstructed twin. Any mismatch is
        drift: a codec, shadow, or arena bug surfacing as a metric + trace
        event instead of a silently wrong forensic answer."""
        with self._lock:
            records = [dict(r) for r in self._ring]
            shadow = (
                None
                if self._shadow_fields is None
                else dict(self._shadow_fields)
            )
        if not records or shadow is None:
            return {"checked": False}
        from autoscaler_tpu_torch.journal.reader import JournalError, JournalReader

        tick = records[-1]["tick"]
        out: Dict[str, Any] = {"checked": True, "tick": tick}
        try:
            state = JournalReader(records).reconstruct(tick)
        except JournalError as e:
            out.update(drift=True, error=str(e))
            return out
        drifted = [
            k
            for k in sorted(set(shadow) | set(state.fields))
            if k not in shadow
            or k not in state.fields
            or shadow[k].dtype != state.fields[k].dtype
            or shadow[k].shape != state.fields[k].shape
            or shadow[k].tobytes() != state.fields[k].tobytes()
        ]
        fit_drift = False
        if not drifted:
            from autoscaler_tpu_torch.ops.fit import fits_any_node
            from autoscaler_tpu_torch.journal.reader import tensors_from_fields

            recon = fits_any_node(state.tensors(self._device)).cpu()
            live = fits_any_node(tensors_from_fields(shadow, self._device)).cpu()
            fit_drift = not torch.equal(recon, live)
        out["drift"] = bool(drifted or fit_drift)
        out["fields"] = drifted
        out["fit_drift"] = fit_drift
        return out

    # -------------------------------------------------------- JSON surface
    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def list_json(self) -> str:
        records = self.records()
        from autoscaler_tpu_torch.journal.ledger import stable_json

        return (
            stable_json({
                "schema": SCHEMA,
                "summary": summarize(records),
                "ticks": [
                    {
                        "tick": r["tick"],
                        "kind": r["kind"],
                        "reason": r.get("reason"),
                        "ops": len(r.get("state", {}).get("ops", ())),
                        "explain_sha256": r.get("explain_sha256", ""),
                    }
                    for r in records
                ],
            })
            + "\n"
        )

    def detail_json(self, tick: int) -> Optional[str]:
        from autoscaler_tpu_torch.journal.ledger import stable_json

        with self._lock:
            for r in self._ring:
                if r.get("tick") == tick:
                    return stable_json(r) + "\n"
        return None

    def diff_json(self, tick_a: int, tick_b: int) -> str:
        """Semantic state diff between two ring ticks (the ?diff=a,b
        drill-down); reconstruction failures report as typed errors, never
        as a wrong diff."""
        from autoscaler_tpu_torch.journal.diff import semantic_diff
        from autoscaler_tpu_torch.journal.ledger import stable_json
        from autoscaler_tpu_torch.journal.reader import JournalError, JournalReader

        records = self.records()
        try:
            reader = JournalReader(records)
            doc = semantic_diff(
                reader.reconstruct(tick_a), reader.reconstruct(tick_b)
            )
        except JournalError as e:
            doc = {"error": f"{type(e).__name__}: {e}"}
        return stable_json(doc) + "\n"
