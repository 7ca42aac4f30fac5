"""Test fixture builders (the port's copy of
``autoscaler_tpu/utils/test_utils.py``), modeled on the reference's
cluster-autoscaler/utils/test/test_utils.go (BuildTestNode, BuildTestPod).
Used by the port's tests and by ``chip_smoke.py``."""
from __future__ import annotations

from typing import Dict, List, Optional

from autoscaler_tpu_torch.kube.objects import (
    Affinity,
    LabelSelector,
    Node,
    OwnerRef,
    Pod,
    PodAffinityTerm,
    Resources,
    Taint,
    Toleration,
)

MB = 1024 * 1024
GB = 1024 * MB


def build_test_node(
    name: str,
    cpu_m: float = 1000,
    mem: float = 2 * GB,
    pods: float = 110,
    gpu: float = 0,
    labels: Optional[Dict[str, str]] = None,
    taints: Optional[List[Taint]] = None,
    ready: bool = True,
) -> Node:
    return Node(
        name=name,
        allocatable=Resources(cpu_m=cpu_m, memory=mem, gpu=gpu, pods=pods),
        labels={"kubernetes.io/hostname": name, **(labels or {})},
        taints=list(taints or []),
        ready=ready,
        provider_id=f"test:///{name}",
    )


def build_test_pod(
    name: str,
    cpu_m: float = 100,
    mem: float = 200 * MB,
    namespace: str = "default",
    node_name: str = "",
    labels: Optional[Dict[str, str]] = None,
    node_selector: Optional[Dict[str, str]] = None,
    tolerations: Optional[List[Toleration]] = None,
    affinity: Optional[Affinity] = None,
    owner_kind: str = "ReplicaSet",
    priority: int = 0,
) -> Pod:
    return Pod(
        name=name,
        namespace=namespace,
        requests=Resources(cpu_m=cpu_m, memory=mem),
        labels=dict(labels or {}),
        node_selector=dict(node_selector or {}),
        tolerations=list(tolerations or []),
        affinity=affinity,
        owner_ref=OwnerRef(kind=owner_kind, name=f"{name}-owner") if owner_kind else None,
        priority=priority,
        node_name=node_name,
    )


def anti_affinity(match_labels: Dict[str, str], topology_key: str = "kubernetes.io/hostname") -> Affinity:
    return Affinity(
        pod_anti_affinity=(
            PodAffinityTerm(
                selector=LabelSelector.from_dict(match_labels),
                topology_key=topology_key,
            ),
        )
    )


def pod_affinity(match_labels: Dict[str, str], topology_key: str = "kubernetes.io/hostname") -> Affinity:
    return Affinity(
        pod_affinity=(
            PodAffinityTerm(
                selector=LabelSelector.from_dict(match_labels),
                topology_key=topology_key,
            ),
        )
    )
