"""Decision provenance: constraint attribution, per-tick DecisionRecords,
/explainz, and the replayable decision ledger.

Layered on the trace taxonomy and the same determinism contract: every
record value is a pure function of the tick's inputs and the closed reason
vocabularies, so two loadgen replays of one scenario write byte-identical
decision ledgers (hack/verify.sh gates on exactly that).

Dependency-free at import time (stdlib only): the attribution kernels live
in ops/ and are reached by the estimator, never from here — this package
defines the vocabularies and assembles/serves the records.

The port's copy of ``autoscaler_tpu/explain/__init__.py``.
"""
from autoscaler_tpu_torch.explain.ledger import (
    SCHEMA,
    dump_jsonl,
    load_jsonl,
    record_line,
    stable_json,
    summarize,
    validate_records,
)
from autoscaler_tpu_torch.explain.reasons import (
    LEDGER_POD_REASONS,
    NUM_REASONS,
    REASON_AFFINITY_SPREAD,
    REASON_CPU,
    REASON_MEMORY,
    REASON_NAMES,
    REASON_NODE_CAP,
    REASON_NONE,
    REASON_NOT_CHOSEN,
    REASON_NO_VIABLE_GROUP,
    REASON_POD_SLOT,
    REASON_RESOURCE,
    REASON_TOPOLOGY,
    SkipReason,
    reason_histogram,
    reason_name,
)
from autoscaler_tpu_torch.explain.record import DecisionExplainer

__all__ = [
    "DecisionExplainer",
    "LEDGER_POD_REASONS",
    "NUM_REASONS",
    "REASON_AFFINITY_SPREAD",
    "REASON_CPU",
    "REASON_MEMORY",
    "REASON_NAMES",
    "REASON_NODE_CAP",
    "REASON_NONE",
    "REASON_NOT_CHOSEN",
    "REASON_NO_VIABLE_GROUP",
    "REASON_POD_SLOT",
    "REASON_RESOURCE",
    "REASON_TOPOLOGY",
    "SCHEMA",
    "SkipReason",
    "dump_jsonl",
    "load_jsonl",
    "reason_histogram",
    "reason_name",
    "record_line",
    "stable_json",
    "summarize",
    "validate_records",
]
