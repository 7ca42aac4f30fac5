"""Fleet mission control: declarative SLOs, per-tenant request-lifecycle
SLIs, and a multi-window error-budget burn-rate engine.

Layered on the trace taxonomy and the same determinism contract as
perf/ and explain/: every SLI event is stamped on an injected clock (the
``trace.timeline_now()`` seam for fleet tickets, the tick's ``now_ts`` for
the control loop), so two loadgen replays of one scenario append
byte-identical ``autoscaler_tpu.slo.window/1`` ledgers — hack/verify.sh
gates on exactly that, and ``bench.py --slo-ledger`` cross-checks the
burn-rate arithmetic.

The port's copy of ``autoscaler_tpu/slo/__init__.py``.
"""
from autoscaler_tpu_torch.slo.engine import SloEngine
from autoscaler_tpu_torch.slo.ledger import (
    SCHEMA,
    load_jsonl,
    record_line,
    stable_json,
    summarize,
    validate_records,
)
from autoscaler_tpu_torch.slo.spec import (
    SLI_FLEET_E2E,
    SLI_PENDING_POD,
    SLI_TICK_DURATION,
    SloError,
    SloSpec,
    control_loop_slos,
    default_slos,
    fleet_slos,
)

__all__ = [
    "SCHEMA",
    "SLI_FLEET_E2E",
    "SLI_PENDING_POD",
    "SLI_TICK_DURATION",
    "SloEngine",
    "SloError",
    "SloSpec",
    "control_loop_slos",
    "default_slos",
    "fleet_slos",
    "load_jsonl",
    "record_line",
    "stable_json",
    "summarize",
    "validate_records",
]
