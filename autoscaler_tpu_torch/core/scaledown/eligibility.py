"""Scale-down eligibility: which nodes are even candidates.

Reference: cluster-autoscaler/core/scaledown/eligibility/eligibility.go:66
(FilterOutUnremovable: scale-down-disabled annotation, unready policy,
per-nodegroup utilization threshold :164, GPU-aware threshold), with the
utilization pass one reduction on the snapshot's device
(ops/utilization.py) instead of a per-node loop: the counterpart of
``autoscaler_tpu/core/scaledown/eligibility.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autoscaler_tpu_torch.cloudprovider.interface import CloudProvider
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.kube.objects import (
    GPU,
    SCALE_DOWN_DISABLED_ANNOTATION,
    Node,
)
from autoscaler_tpu_torch.ops.utilization import node_utilization
from autoscaler_tpu_torch.simulator.removal import UnremovableNode, UnremovableReason
from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot
from autoscaler_tpu_torch.utils import klogx


@dataclass
class EligibilityChecker:
    options: AutoscalingOptions
    provider: Optional[CloudProvider] = None

    def filter_out_unremovable(
        self,
        snapshot: ClusterSnapshot,
        candidates: Sequence[Node],
        now_ts: float,
        unremovable_cache=None,
    ) -> Tuple[List[str], Dict[str, float], List[UnremovableNode]]:
        """→ (eligible node names, utilization by name, unremovable). One
        utilization kernel call covers all nodes."""
        tensors, meta = snapshot.tensors()
        exclude = self._excluded_usage(tensors, meta)
        util = node_utilization(tensors, exclude_used=exclude).cpu().numpy()
        alloc_gpu = tensors.node_alloc[:, GPU].cpu().numpy()

        eligible: List[str] = []
        utilization: Dict[str, float] = {}
        unremovable: List[UnremovableNode] = []
        # per-loop quota for per-node lines (eligibility.go:71)
        util_quota = klogx.new_logging_quota(20)
        for node in candidates:
            if unremovable_cache is not None and unremovable_cache.is_recently_unremovable(
                node.name, now_ts
            ):
                unremovable.append(
                    UnremovableNode(node, UnremovableReason.RECENTLY_UNREMOVABLE)
                )
                continue
            if node.annotations.get(SCALE_DOWN_DISABLED_ANNOTATION, "").lower() == "true":
                unremovable.append(
                    UnremovableNode(node, UnremovableReason.SCALE_DOWN_DISABLED_ANNOTATION)
                )
                continue
            j = meta.node_index.get(node.name)
            if j is None:
                continue
            u = float(util[j])
            utilization[node.name] = u
            klogx.v(4).up_to(util_quota).info(
                "Node %s utilization %.3f", node.name, u
            )
            group_opts = self._group_options(node)
            threshold = (
                group_opts.scale_down_gpu_utilization_threshold
                if alloc_gpu[j] > 0
                else group_opts.scale_down_utilization_threshold
            )
            if not node.ready:
                # unready nodes are scale-down candidates regardless of
                # utilization (reference eligibility.go: unready path) —
                # unless the operator disabled it (ScaleDownUnreadyEnabled)
                if self.options.scale_down_unready_enabled:
                    eligible.append(node.name)
                else:
                    unremovable.append(
                        UnremovableNode(node, UnremovableReason.UNREADY_NOT_ALLOWED)
                    )
            elif u >= threshold:
                unremovable.append(
                    UnremovableNode(node, UnremovableReason.NOT_UTILIZED_ENOUGH)
                )
            else:
                eligible.append(node.name)
        klogx.v(4).over(util_quota).info(
            "Skipped logging utilization for %d other nodes", -util_quota.left
        )
        return eligible, utilization, unremovable

    def _excluded_usage(self, tensors, meta):
        """[N, R] usage to subtract from the utilization numerator when
        DaemonSet/mirror pods are configured as free (info.go:49
        CalculateUtilization's skipDaemonSetPods/skipMirrorPods), summed on
        the host and handed to the snapshot's device."""
        skip_ds = self.options.ignore_daemonsets_utilization
        skip_mirror = self.options.ignore_mirror_pods_utilization
        if not (skip_ds or skip_mirror):
            return None
        from autoscaler_tpu_torch.snapshot.packer import resources_row

        exclude = np.zeros(tensors.node_alloc.shape, np.float32)
        ext = meta.extended_resources  # rows must match the widened axis
        for pod in meta.pods:
            if not pod.node_name:
                continue
            if (skip_ds and pod.daemonset) or (skip_mirror and pod.mirror):
                j = meta.node_index.get(pod.node_name)
                if j is not None:
                    exclude[j] += resources_row(pod.requests, 1.0, ext)
        return torch.tensor(exclude, device=tensors.device)

    def _group_options(self, node: Node):
        if self.provider is not None:
            group = self.provider.node_group_for_node(node)
            if group is not None:
                return self.options.group_options(group.id())
        return self.options.node_group_defaults
