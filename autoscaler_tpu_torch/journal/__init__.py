"""Black-box flight journal: delta-encoded per-tick state history,
time-travel reconstruction, and live-vs-replay divergence probes.

The ledgers that came before (explain/perf/slo) record *decisions*; this
package records the *state* that produced them — the packed snapshot
tensors, journaled per tick as keyframes plus the arena's row-scatter deltas
through the same strict ``record_line`` choke, stamped with the options
fingerprint and the sha256 of the tick's decision line. On top of it:
``JournalReader.reconstruct`` (bit-exact SnapshotTensors twin with typed
corruption errors), the reconstruct/diff/replay CLI (``__main__``), the
gated /journalz endpoint, and the in-loop divergence probe
(``--journal-probe-interval``).

Same determinism contract as the other rings: every journaled value is a
pure function of the tick's packed state, so two loadgen replays of one
scenario write byte-identical journals (hack/verify.sh gates on exactly
that, then replays every tick against the decision ledger).

Dependency-free at import time (stdlib + numpy): the fit/preemption
kernels are reached lazily by the probe and replay paths, never at
import.

The port's copy of ``autoscaler_tpu/journal/__init__.py``; the replay
(``replay.py``) re-runs the preemption pass through the port's estimator
on a device the caller names.
"""
from autoscaler_tpu_torch.journal.ledger import (
    KEYFRAME_REASONS,
    SCHEMA,
    dump_jsonl,
    load_jsonl,
    record_line,
    stable_json,
    summarize,
    validate_records,
)
from autoscaler_tpu_torch.journal.reader import (
    JournalError,
    JournalReader,
    MissingKeyframeError,
    OutOfOrderTickError,
    ReconstructedState,
    SchemaDriftError,
    TruncatedJournalError,
)
from autoscaler_tpu_torch.journal.recorder import JournalRecorder

__all__ = [
    "JournalError",
    "JournalReader",
    "JournalRecorder",
    "KEYFRAME_REASONS",
    "MissingKeyframeError",
    "OutOfOrderTickError",
    "ReconstructedState",
    "SCHEMA",
    "SchemaDriftError",
    "TruncatedJournalError",
    "dump_jsonl",
    "load_jsonl",
    "record_line",
    "stable_json",
    "summarize",
    "validate_records",
]
