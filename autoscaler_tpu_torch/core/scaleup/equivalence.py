"""Pod equivalence groups — dedup pods by controller + scheduling-relevant
spec so one run of the scan covers many identical pods (the port's copy of
``autoscaler_tpu/core/scaleup/equivalence.py``).

Reference: cluster-autoscaler/core/scaleup/equivalence/groups.go:61.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from autoscaler_tpu_torch.kube.objects import Pod


@dataclass
class PodEquivalenceGroup:
    pods: List[Pod] = field(default_factory=list)

    @property
    def exemplar(self) -> Pod:
        return self.pods[0]


def _spec_fingerprint(pod: Pod) -> Tuple:
    aff = pod.affinity
    # CSI volumes enter as per-driver unique-handle COUNTS: the
    # NodeVolumeLimits verdict depends only on counts
    csi_counts: dict = {}
    for driver, handle in pod.csi_volumes:
        csi_counts.setdefault(driver, set()).add(handle)
    return (
        pod.namespace,
        pod.requests.as_tuple(),
        pod.requests.extended,
        tuple(sorted(pod.node_selector.items())),
        tuple(pod.tolerations),
        tuple(sorted(pod.labels.items())),
        pod.host_ports,
        tuple(sorted((d, len(h)) for d, h in csi_counts.items())),
        (aff.node_selector_terms, aff.pod_affinity, aff.pod_anti_affinity)
        if aff
        else None,
        pod.topology_spread,
        pod.volume_node_affinity,
        pod.rwop_handles,
        pod.legacy_volumes,
        pod.priority,
        pod.preemption_policy,
    )


def build_pod_groups(pods: Sequence[Pod]) -> List[PodEquivalenceGroup]:
    """Pods with a controller owner and identical scheduling spec share a
    group; controller-less pods get singleton groups."""
    groups: Dict[Tuple, PodEquivalenceGroup] = {}
    out: List[PodEquivalenceGroup] = []
    for pod in pods:
        if pod.owner_ref is None or not pod.owner_ref.controller:
            out.append(PodEquivalenceGroup([pod]))
            continue
        key = (pod.owner_ref.kind, pod.owner_ref.name) + _spec_fingerprint(pod)
        if key in groups:
            groups[key].pods.append(pod)
        else:
            g = PodEquivalenceGroup([pod])
            groups[key] = g
            out.append(g)
    return out
