"""Performance observatory: compile telemetry, the cost model,
device-residency accounting, and per-tick perf records.

The port of ``autoscaler_tpu/perf/``, on the same determinism contract:
every duration the observatory records is measured on
``trace.timeline_now()`` (the tracer's injectable clock), and every cost
figure is a pure function of kernel shapes, so two replays of one scenario
under a synthetic clock produce byte-identical perf ledgers.
"""
from autoscaler_tpu_torch.perf.costmodel import (
    analyze_cost,
    default_peak_flops,
    operand_bytes,
    shape_signature,
)
from autoscaler_tpu_torch.perf.ledger import (
    SCHEMA,
    dump_jsonl,
    load_jsonl,
    record_line,
    stable_json,
    summarize,
    validate_records,
)
from autoscaler_tpu_torch.perf.observatory import PerfObservatory
from autoscaler_tpu_torch.perf.residency import (
    POOL_ARENA,
    POOL_KERNEL_OPERANDS,
    POOL_SCENARIO_BATCHES,
    POOL_SNAPSHOT,
    ResidencyLedger,
    array_bytes,
)

__all__ = [
    "POOL_ARENA",
    "POOL_KERNEL_OPERANDS",
    "POOL_SCENARIO_BATCHES",
    "POOL_SNAPSHOT",
    "PerfObservatory",
    "ResidencyLedger",
    "SCHEMA",
    "analyze_cost",
    "array_bytes",
    "default_peak_flops",
    "dump_jsonl",
    "load_jsonl",
    "operand_bytes",
    "record_line",
    "shape_signature",
    "stable_json",
    "summarize",
    "validate_records",
]
