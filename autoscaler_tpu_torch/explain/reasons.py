"""The closed reason vocabularies of the decision-provenance layer.

Two vocabularies live here, both CLOSED (free text is banned from the
decision ledger — byte-identical replays need a finite, ordered alphabet):

- **Constraint reason codes** — why a (pod, node-group) pair was left
  unschedulable by the estimator, mirroring the reference's PredicateError
  reasons (simulator/predicatechecker; NodeResourcesFit "Insufficient cpu"
  etc.). The integer codes are ORDERED BY SEVERITY, nearest-to-schedulable
  first, so ``min`` over a pod's per-group codes is "the closest this pod
  came to scheduling anywhere" — the dominant reason the ledger reports.
  The selection order *within* one pair is a fixed priority chain (mask →
  cpu → memory → pod-slot → other resource → affinity/spread → node cap),
  implemented identically by the device kernel
  (ops/binpack.attribute_unschedulable) and its serial oracle twin
  (estimator/reference_impl.attribute_unschedulable_reference).

- **SkipReason** — why a node group never reached estimation at all
  (core/scaleup/orchestrator.py), promoted from free-text strings; CA
  parity: skipped_scale_events_count.

This module is stdlib-only by design: ops/ kernels import the code
constants from here, and the explain subsystem must import without jax.

The port's copy of ``autoscaler_tpu/explain/reasons.py``.
"""
from __future__ import annotations

import enum
from typing import Dict

# -- constraint reason codes (kernel vocabulary) ------------------------------
# Severity order (the MIN across groups is the pod's dominant reason):
# scheduled < ran-out-of-nodes < gated-by-affinity/spread < pod-slot <
# extended-resource < memory < cpu < predicate-mask. A pod blocked only by
# the group cap was one node away from scheduling; a mask-rejected pod was
# never eligible at all.
REASON_NONE = 0             # scheduled (or pad slot)
REASON_NODE_CAP = 1         # fits an empty template; the group ran out of nodes
REASON_AFFINITY_SPREAD = 2  # blocked by dynamic inter-pod affinity / spread
REASON_POD_SLOT = 3         # template's pod-count capacity too small
REASON_RESOURCE = 4         # some other (extended/virtual) resource axis
REASON_MEMORY = 5           # memory request exceeds template allocatable
REASON_CPU = 6              # cpu request exceeds template allocatable
REASON_TOPOLOGY = 7         # non-resource predicate mask (taints, selectors,
                            # node affinity, static spread/affinity vs cluster)

NUM_REASONS = 8

REASON_NAMES = (
    "scheduled",
    "node_cap",
    "affinity_spread",
    "pod_slot",
    "resource",
    "memory",
    "cpu",
    "topology",
)

# ledger-only reasons for pods the kernel found schedulable SOMEWHERE but
# that still ended the tick pending (the chosen option did not cover them,
# or no group was viable at all) — host-assigned, never kernel codes
REASON_NOT_CHOSEN = "not_chosen"
REASON_NO_VIABLE_GROUP = "no_viable_group"
# a pending pod dropped by --expendable-pods-priority-cutoff before it
# reached estimation (static_autoscaler.go:471 parity) — formerly a silent
# disappearance, now a ledgered verdict with its own metric
# (pending_expendable_total)
REASON_EXPENDABLE_BELOW_CUTOFF = "expendable_below_cutoff"

#: every string the decision ledger's per-pod reason map may carry
LEDGER_POD_REASONS = frozenset(REASON_NAMES[1:]) | {
    REASON_NOT_CHOSEN,
    REASON_NO_VIABLE_GROUP,
    REASON_EXPENDABLE_BELOW_CUTOFF,
}

# -- eviction provenance (preemption-engine vocabulary) -----------------------
# Every evicted pod's ledger row carries one of these AND names its evictor
# (the ``by`` field) — an eviction without provenance is the failure mode
# the preemption ledger section exists to prevent. Closed like every other
# ledger vocabulary: byte-identical replays need a finite alphabet.
EVICTION_PREEMPTED_BY = "preempted_by"

#: every string a preemption eviction row's ``reason`` field may carry
EVICTION_REASONS = frozenset({EVICTION_PREEMPTED_BY})


def reason_name(code: int) -> str:
    """Code → ledger name; out-of-range codes degrade loudly, not silently."""
    if 0 <= code < NUM_REASONS:
        return REASON_NAMES[code]
    return f"unknown_{code}"


def reason_histogram(counts) -> Dict[str, int]:
    """[NUM_REASONS] count vector → {name: count} with zero rows dropped and
    the 'scheduled' bucket excluded (it is not a rejection)."""
    out: Dict[str, int] = {}
    for code in range(1, NUM_REASONS):
        c = int(counts[code])
        if c:
            out[REASON_NAMES[code]] = c
    return out


# -- scale-up skip reasons (orchestrator vocabulary) --------------------------
class SkipReason(enum.Enum):
    """Why a node group was excluded from estimation this loop — the closed
    promotion of ScaleUpOrchestrator's former free-text skip strings
    (CA parity: skipped_scale_events_count reasons)."""

    NOT_SAFE = "unhealthy_or_backed_off"   # csr health gate / backoff window
    MAX_SIZE_REACHED = "max_size_reached"  # target already at max size
    NO_TEMPLATE = "no_template"            # template missing or unbuildable

    def __str__(self) -> str:  # render as the ledger string everywhere
        return self.value


#: every string the ledger's skipped_groups map may carry
SKIP_REASON_VALUES = frozenset(r.value for r in SkipReason)
