"""JournalReader: time-travel reconstruction with typed failure modes.

``reconstruct(tick)`` replays the latest keyframe at or before the tick
plus every delta after it into a bit-exact ``SnapshotTensors`` twin of
what the live packer served that tick. Corruption never reconstructs
wrong — it raises one of the typed errors below, which is the whole
contract: a forensic tool that silently returns a plausible-but-drifted
state is worse than none.

- TruncatedJournalError: the file ends (or breaks) mid-line — a crashed
  writer's torn append;
- MissingKeyframeError: no keyframe at or before the requested tick (a
  ring that evicted its keyframe, or a file whose head was cut);
- OutOfOrderTickError: the tick axis is not strictly increasing — every
  reconstruction after the inversion would be built on the wrong base;
- SchemaDriftError: a record from another schema, an unknown kind, or a
  delta whose ops no longer fit the keyframe's shapes.

The port of ``autoscaler_tpu/journal/reader.py``: the fields stay numpy
arrays, byte for byte the journal's, and ``tensors(device)`` rebuilds the
port's torch ``SnapshotTensors`` from them on a device (None = the first
CUDA card).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from autoscaler_tpu_torch.journal.codec import (
    apply_names_delta,
    apply_ops,
    decode_array,
)
from autoscaler_tpu_torch.journal.ledger import SCHEMA, load_jsonl


class JournalError(ValueError):
    """Base of every journal read/reconstruction failure."""


class TruncatedJournalError(JournalError):
    """The journal file breaks mid-line (torn append / cut tail)."""


class MissingKeyframeError(JournalError):
    """No keyframe at or before the requested tick."""


class OutOfOrderTickError(JournalError):
    """Tick axis not strictly increasing."""


class SchemaDriftError(JournalError):
    """Record schema/kind/op shape no longer matches this reader."""


# the SnapshotTensors field names — journal fields outside this set (the
# captured pod_evictable channel) ride along in ReconstructedState.fields
# but stay out of the tensors() constructor
def _tensor_field_names() -> frozenset:
    import dataclasses

    from autoscaler_tpu_torch.snapshot.tensors import SnapshotTensors

    return frozenset(f.name for f in dataclasses.fields(SnapshotTensors))


@dataclass
class ReconstructedState:
    """One tick's reconstructed decision-input state."""

    tick: int
    fields: Dict[str, np.ndarray]
    names: Dict[str, List[Optional[str]]]
    ext: List[str] = field(default_factory=list)
    options_fp: str = ""
    options: Dict[str, Any] = field(default_factory=dict)
    explain_sha256: str = ""
    ctx: Dict[str, Any] = field(default_factory=dict)

    def tensors(self, device=None):
        return tensors_from_fields(self.fields, device)

    def evictable(self) -> np.ndarray:
        return self.fields["pod_evictable"]


class JournalReader:
    """Reads a journal (ring records or a JSONL file) and reconstructs."""

    def __init__(self, records: List[Dict[str, Any]]) -> None:
        last_tick: Optional[int] = None
        for i, rec in enumerate(records):
            if not isinstance(rec, dict):
                raise SchemaDriftError(f"record {i}: not an object")
            if rec.get("schema") != SCHEMA:
                raise SchemaDriftError(
                    f"record {i}: schema {rec.get('schema')!r} != {SCHEMA!r}"
                )
            if rec.get("kind") not in ("keyframe", "delta"):
                raise SchemaDriftError(
                    f"record {i}: kind {rec.get('kind')!r} not keyframe|delta"
                )
            tick = rec.get("tick")
            if not isinstance(tick, int):
                raise SchemaDriftError(f"record {i}: tick must be an int")
            if last_tick is not None and tick <= last_tick:
                raise OutOfOrderTickError(
                    f"record {i}: tick {tick} not increasing "
                    f"(prev {last_tick})"
                )
            last_tick = tick
        self._records = records

    @classmethod
    def from_path(cls, path: str) -> "JournalReader":
        try:
            records = load_jsonl(path)
        except ValueError as e:
            raise TruncatedJournalError(str(e)) from None
        return cls(records)

    def ticks(self) -> List[int]:
        return [rec["tick"] for rec in self._records]

    def records(self) -> List[Dict[str, Any]]:
        return list(self._records)

    def reconstruct(self, tick: int) -> ReconstructedState:
        """Bit-exact state at ``tick``: latest keyframe ≤ tick, deltas
        applied forward in order."""
        upto = [r for r in self._records if r["tick"] <= tick]
        if not upto or upto[-1]["tick"] != tick:
            raise MissingKeyframeError(f"tick {tick} not journaled")
        base = None
        for i in range(len(upto) - 1, -1, -1):
            if upto[i]["kind"] == "keyframe":
                base = i
                break
        if base is None:
            raise MissingKeyframeError(
                f"no keyframe at or before tick {tick} (ring evicted it or "
                "the journal head was cut)"
            )
        key = upto[base]
        state = key.get("state", {})
        try:
            fields = {
                name: decode_array(doc)
                for name, doc in state.get("fields", {}).items()
            }
            names = {
                k: list(v) for k, v in state.get("names", {}).items()
            }
            ext = list(state.get("ext", ()))
        except (KeyError, TypeError, ValueError) as e:
            raise SchemaDriftError(
                f"tick {key['tick']}: undecodable keyframe: {e}"
            ) from None
        if not fields:
            raise SchemaDriftError(
                f"tick {key['tick']}: keyframe carries no tensor fields"
            )
        options = dict(key.get("options", {}))
        for rec in upto[base + 1:]:
            st = rec.get("state", {})
            try:
                apply_ops(fields, st.get("ops", []))
                for table, delta in st.get("names", {}).items():
                    names[table] = apply_names_delta(
                        names.get(table, []), delta
                    )
            except (KeyError, TypeError, ValueError) as e:
                raise SchemaDriftError(
                    f"tick {rec['tick']}: delta does not fit its keyframe: "
                    f"{e}"
                ) from None
        last = upto[-1]
        return ReconstructedState(
            tick=tick,
            fields=fields,
            names=names,
            ext=ext,
            options_fp=last.get("options_fp", ""),
            options=options,
            explain_sha256=last.get("explain_sha256", ""),
            ctx=dict(last.get("ctx", {})),
        )


def tensors_from_fields(fields: Dict[str, np.ndarray], device=None):
    """SnapshotTensors on ``device`` (None = the first CUDA card) from a raw
    journal/shadow field dict (drops the non-tensor channels, e.g.
    pod_evictable)."""
    from autoscaler_tpu_torch.snapshot.tensors import tensors_from_numpy

    keep = _tensor_field_names()
    return tensors_from_numpy(
        {k: v for k, v in fields.items() if k in keep}, device
    )
