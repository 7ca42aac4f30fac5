"""Typed fleet admission/overload errors and the closed outcome vocabulary.

Separate module so both the admission controller and the coalescer can
import them without a cycle, and so the RPC layer's status mapping
(rpc/service.py: FleetOverloadError → RESOURCE_EXHAUSTED + retry-after,
FleetDrainError → UNAVAILABLE + drain detail, FleetDeadlineError →
DEADLINE_EXCEEDED) reads from one source of truth.

The port's copy of ``autoscaler_tpu/fleet/errors.py``.
"""
from __future__ import annotations

# closed admission-outcome vocabulary (metric labels, ledger fields,
# report keys — GL010: these strings reach replay artifacts)
ADMIT_OK = "admitted"
SHED_QUEUE_FULL = "shed_queue_full"
SHED_QUOTA = "shed_quota"
SHED_DRAINING = "shed_draining"
SHED_DEADLINE = "shed_deadline"
SHED_OUTCOMES = (SHED_QUEUE_FULL, SHED_QUOTA, SHED_DRAINING, SHED_DEADLINE)

# closed ticket terminal-outcome vocabulary (every ticket ends in exactly
# one of these — the "zero tickets hang to deadline" audit counts them)
TICKET_RESOLVED = "resolved"
TICKET_FAILED = "failed"
TICKET_EXPIRED = "expired"
TICKET_ABANDONED = "abandoned"
TICKET_OUTCOMES = (
    TICKET_RESOLVED, TICKET_FAILED, TICKET_EXPIRED, TICKET_ABANDONED,
)


class FleetError(RuntimeError):
    """No rung could serve a coalesced batch."""


class FleetAdmissionError(FleetError):
    """Base of the typed admission rejections: ``outcome`` is the closed
    vocabulary label, ``retry_after_s`` the server's pacing hint (0 =
    no useful retry-here time)."""

    outcome: str = "rejected"

    def __init__(self, message: str, retry_after_s: float = 0.0) -> None:
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class FleetOverloadError(FleetAdmissionError):
    """Queue full or tenant over quota — the server is alive but
    shedding; honor ``retry_after_s`` before retrying HERE."""

    def __init__(
        self, message: str, retry_after_s: float, outcome: str = SHED_QUOTA
    ) -> None:
        super().__init__(message, retry_after_s)
        self.outcome = outcome


class FleetDrainError(FleetAdmissionError):
    """The coalescer is draining (sidecar shutting down): fail over to
    another endpoint; retrying here buys nothing."""

    outcome = SHED_DRAINING


class FleetDeadlineError(FleetAdmissionError):
    """The ticket's deadline expired in the queue — shed before it
    consumed a batch slot. Retrying a timed-out estimate doubles load
    exactly when the server is drowning, so the client must NOT resend."""

    outcome = SHED_DEADLINE
