"""PriorityClass / preemptionPolicy semantics — who may evict whom.

Reference: the scheduler's preemption framework
(pkg/scheduler/framework/preemption/preemption.go) and the API contract:
``preemptionPolicy: Never`` keeps its priority for queue ordering but the
pod never triggers evictions (PodEligibleToPreemptOthers); victims must be
strictly lower priority, and pods the cluster cannot recreate — mirror
(static) pods, DaemonSet pods, controllerless pods — are not evicted
(analogous to the drain rules in simulator/drainability).

Interaction with the CA's expendable cutoff
(--expendable-pods-priority-cutoff, static_autoscaler.go:471): a PENDING
pod below the cutoff never reaches scale-up or preemption at all — it is
dropped (and, here, ledgered as ``expendable_below_cutoff``). A RESIDENT
pod below the cutoff is the archetypal victim: victim eligibility
deliberately ignores the cutoff and looks only at restartability, so the
two filters compose instead of shadowing each other.

These helpers are host-side only; their tensor twin is the
``pod_preempt`` snapshot channel (can_preempt, packed by
snapshot/packer.py) plus the ``evictable_mask`` array handed to
ops/preempt.ffd_binpack_preempt as its own operand.

The port's copy of ``autoscaler_tpu/preempt/policy.py``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from autoscaler_tpu_torch.kube.objects import Pod

# the one spelling of "may not evict anyone" (spec.preemptionPolicy)
PREEMPTION_POLICY_NEVER = "Never"


def can_preempt(pod: Pod) -> bool:
    """May this pod, while pending, displace lower-priority residents?"""
    return pod.preemption_policy != PREEMPTION_POLICY_NEVER


def victim_eligible(pod: Pod) -> bool:
    """May this pod, while resident, be evicted to admit a higher-priority
    pending pod? Mirror/DaemonSet/controllerless pods are immune — evicting
    them loses work the cluster cannot recreate; a pod already terminating
    is not re-evicted."""
    return (
        not pod.mirror
        and not pod.daemonset
        and pod.restartable
        and pod.deletion_ts is None
    )


def evictable_mask(pods: Sequence[Pod], padded: int) -> np.ndarray:
    """[padded] bool victim-eligibility rows aligned with SnapshotMeta.pods
    order (padding rows False) — the kernel operand companion to the
    packed pod_priority/pod_preempt channels."""
    mask = np.zeros((padded,), bool)
    for i, pod in enumerate(pods):
        mask[i] = victim_eligible(pod)
    return mask
