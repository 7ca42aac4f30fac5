"""Node utilization over the whole cluster in one pass: the counterpart of
``autoscaler_tpu/ops/utilization.py``.

Reference: cluster-autoscaler/simulator/utilization/info.go:35,49,83: a
node's utilization is max(cpu, mem) of requested / allocatable, except on
GPU nodes, where the GPU fraction alone decides; DaemonSet and mirror pods
can be left out of the numerator. The reference computes it node by node
inside the eligibility loop; here it is one [N] reduction on the
snapshot's device. Division is IEEE on the host and on the card alike, so
both give the same bits as the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from autoscaler_tpu_torch.kube.objects import CPU, GPU, MEMORY
from autoscaler_tpu_torch.snapshot.tensors import SnapshotTensors


def node_utilization(
    snap: SnapshotTensors,
    exclude_used: Optional[torch.Tensor] = None,  # [N, R] usage to subtract (daemonset/mirror)
) -> torch.Tensor:
    """[N] f32: each node's utilization under the dominant-resource rule.
    Padding rows are 0."""
    used = snap.node_used if exclude_used is None else snap.node_used - exclude_used
    alloc = snap.node_alloc

    def frac(axis):
        return torch.where(alloc[:, axis] > 0, used[:, axis] / alloc[:, axis], 0.0)

    cpu_mem = torch.maximum(frac(CPU), frac(MEMORY))
    util = torch.where(alloc[:, GPU] > 0, frac(GPU), cpu_mem)
    return torch.where(snap.node_valid, util, 0.0)
