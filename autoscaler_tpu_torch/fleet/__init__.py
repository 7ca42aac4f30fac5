"""Fleet serving: a coalescing multi-tenant batched-estimator service.

Many autoscalers (tenants) post independent scale-up questions; the fleet
service pads them into power-of-two shape buckets, coalesces same-bucket
requests inside a window, answers one batched dispatch per batch (on a
card ONE K1/K2 launch over the batch's S·G groups), and demuxes
per-tenant verdicts that are byte-identical to solo dispatches of the
same operands.

Layers: fleet/buckets.py (shape buckets + exact-pad safety argument),
fleet/coalescer.py (admission queue, batching, circuit-broken dispatch,
demux, pre-warm), fleet/admission.py and fleet/tiers.py (overload armor),
fleet/balance.py (the sidecar client's endpoint health), fleet/ledger.py
(the fleet decision-ledger schema), rpc/service.py BatchEstimate (the
wire surface). The port of ``autoscaler_tpu/fleet/`` (ROADMAP queue 1
item 4, the serving paths); none of it imports ``grpc``.
"""
from autoscaler_tpu_torch.fleet.buckets import (
    DEFAULT_BUCKETS,
    BucketError,
    BucketSpec,
    adhoc_bucket,
    format_buckets,
    pad_operands,
    padding_waste,
    parse_buckets,
    pow2ceil,
    select_bucket,
)
from autoscaler_tpu_torch.fleet.admission import AdmissionController, TokenBucket
from autoscaler_tpu_torch.fleet.balance import EndpointBalancer, EndpointHealth
from autoscaler_tpu_torch.fleet.tiers import (
    DEFAULT_TIER,
    TierError,
    TierPolicy,
    TierSpec,
    parse_tiers,
)
from autoscaler_tpu_torch.fleet.coalescer import (
    OVERFLOW_TENANT,
    ROUTE_BATCHED,
    ROUTE_ORACLE,
    FleetAnswer,
    FleetCoalescer,
    FleetRequest,
    FleetTicket,
)
from autoscaler_tpu_torch.fleet.ledger import (
    FLEET_SCHEMA,
    summarize as summarize_fleet_ledger,
    validate_records as validate_fleet_records,
)
from autoscaler_tpu_torch.fleet.errors import (
    ADMIT_OK,
    SHED_DEADLINE,
    SHED_DRAINING,
    SHED_OUTCOMES,
    SHED_QUEUE_FULL,
    SHED_QUOTA,
    TICKET_ABANDONED,
    TICKET_EXPIRED,
    TICKET_FAILED,
    TICKET_OUTCOMES,
    TICKET_RESOLVED,
    FleetAdmissionError,
    FleetDeadlineError,
    FleetDrainError,
    FleetError,
    FleetOverloadError,
)

__all__ = [
    "ADMIT_OK",
    "DEFAULT_BUCKETS",
    "OVERFLOW_TENANT",
    "ROUTE_BATCHED",
    "ROUTE_ORACLE",
    "SHED_DEADLINE",
    "SHED_DRAINING",
    "SHED_OUTCOMES",
    "SHED_QUEUE_FULL",
    "SHED_QUOTA",
    "TICKET_ABANDONED",
    "TICKET_EXPIRED",
    "TICKET_FAILED",
    "TICKET_OUTCOMES",
    "TICKET_RESOLVED",
    "AdmissionController",
    "BucketError",
    "BucketSpec",
    "DEFAULT_TIER",
    "EndpointBalancer",
    "EndpointHealth",
    "FLEET_SCHEMA",
    "TierError",
    "TierPolicy",
    "TierSpec",
    "parse_tiers",
    "FleetAdmissionError",
    "FleetAnswer",
    "FleetCoalescer",
    "FleetDeadlineError",
    "FleetDrainError",
    "FleetError",
    "FleetOverloadError",
    "FleetRequest",
    "FleetTicket",
    "TokenBucket",
    "adhoc_bucket",
    "format_buckets",
    "pad_operands",
    "padding_waste",
    "parse_buckets",
    "pow2ceil",
    "select_bucket",
    "summarize_fleet_ledger",
    "validate_fleet_records",
]
