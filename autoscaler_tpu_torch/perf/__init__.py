"""Performance accounting, as far as the port has it: the byte model of
device residency (``array_bytes``) and the ledgers' JSON serialization
(``ledger``). The observatory, the cost model and the perf ledger's schema
of ``autoscaler_tpu/perf/`` are not ported (ROADMAP queue 1, the estimator
services and profiling items).
"""
from autoscaler_tpu_torch.perf.residency import array_bytes

__all__ = ["array_bytes"]
