"""Dense-tensor cluster state: the port's ``SnapshotTensors``, the
counterpart of ``autoscaler_tpu/snapshot/tensors.py``.

The cluster is a frozen struct of torch tensors with the JAX package's
fields, dtypes and ``None``s. Shapes are bucketed (padded) so operand
shapes come from a small set: ``pod_valid`` / ``node_valid`` mask out the
padding rows. The update methods are functional, as in JAX: they return a
new dataclass and leave the inputs untouched.

``tensors_from_numpy`` turns the JAX package's fields, given as a dict of
numpy arrays (what ``DebuggingSnapshotter.dump_tensors`` writes to
``.npz``), into the port's ``SnapshotTensors`` on a device, so a dumped
snapshot can be replayed through the port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, Optional, Union

import numpy as np
import torch

from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.kube.objects import NUM_RESOURCES

Index = Union[int, torch.Tensor]


@dataclass(frozen=True)
class SnapshotTensors:
    """Struct-of-tensors cluster snapshot.

    P = padded pod count, N = padded node count, R = resource axes.

    - node_alloc:  [N, R] f32 — allocatable capacity per node
    - node_used:   [N, R] f32 — sum of requests of pods assigned to the node
    - node_valid:  [N]    bool — real row (not padding)
    - node_group:  [N]    i32  — node-group id, -1 if none
    - pod_req:     [P, R] f32 — per-pod resource requests (pods axis == 1)
    - pod_valid:   [P]    bool
    - pod_node:    [P]    i32  — node index the pod is scheduled on, -1 pending
    - sched_mask:  [P, N] bool | None — precomputed non-resource predicates
    - pod_priority: [P] i32 and pod_preempt: [P] bool — the preemption
      channels (None where the packer skipped them)

    Above the dense-mask limit the packer emits the *factored* form and
    sched_mask is None:

    - pod_class:   [P] i32 — pod predicate-profile id (-1 padding)
    - node_class:  [N] i32 — node profile id (-1 padding)
    - class_mask:  [CP, CN] bool — verdict per (pod profile, node profile)
    - exc_rows:    [E, N] bool — full rows for the few "exception" pods
      whose verdict is not class-structured (inter-pod affinity, spread)
    - pod_exc:     [P] i32 — exception-row index per pod, -1 = class-only
    - cell_pod/cell_node/cell_val: [K] COO single-cell overrides — a placed
      host-port pod's verdict on its OWN node (cell_pod = -1 on padding)

    Read the mask through sched_row()/dense_sched(), which handle both
    forms; the tiled fit kernel (ops/fit_reduce.py) takes the factors.
    """

    node_alloc: torch.Tensor
    node_used: torch.Tensor
    node_valid: torch.Tensor
    node_group: torch.Tensor
    pod_req: torch.Tensor
    pod_valid: torch.Tensor
    pod_node: torch.Tensor
    sched_mask: Optional[torch.Tensor] = None
    pod_priority: Optional[torch.Tensor] = None
    pod_preempt: Optional[torch.Tensor] = None
    pod_class: Optional[torch.Tensor] = None
    node_class: Optional[torch.Tensor] = None
    class_mask: Optional[torch.Tensor] = None
    exc_rows: Optional[torch.Tensor] = None
    pod_exc: Optional[torch.Tensor] = None
    cell_pod: Optional[torch.Tensor] = None
    cell_node: Optional[torch.Tensor] = None
    cell_val: Optional[torch.Tensor] = None

    @property
    def num_nodes(self) -> int:
        return self.node_alloc.shape[0]

    @property
    def num_pods(self) -> int:
        return self.pod_req.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_alloc.device

    def free(self) -> torch.Tensor:
        """[N, R] remaining capacity (alloc - used), zero on padding rows."""
        return torch.where(
            self.node_valid[:, None], self.node_alloc - self.node_used, 0.0
        )

    def sched_rows(self, pods: torch.Tensor) -> torch.Tensor:
        """[S, N] bool — the non-resource verdicts of the pods ``pods`` [S]
        (int, each in [0, P)), in either mask form, in one batched pass.
        Device indices stay on the device: no step makes the host wait."""
        pods = pods.long()
        if self.sched_mask is not None:
            return self.sched_mask.index_select(0, pods)
        N = self.num_nodes
        pc = self.pod_class.index_select(0, pods)
        nc = self.node_class
        rows = self.class_mask.index_select(0, pc.clamp(min=0).long())
        rows = rows.index_select(1, nc.clamp(min=0).long())
        rows &= (pc >= 0)[:, None] & (nc >= 0)[None, :]
        # single-cell overrides aimed at these pods (padding cells carry -1
        # and match no pod); the others drop into a column past the end
        hit = self.cell_pod[None, :] == pods[:, None]
        col = torch.where(hit, self.cell_node.long()[None, :], N)
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0], 1))], dim=1)
        rows = rows.scatter_(1, col, self.cell_val[None, :] & hit)[:, :N]
        e = self.pod_exc.index_select(0, pods)
        exc = self.exc_rows.index_select(0, e.clamp(min=0).long())
        return torch.where((e >= 0)[:, None], exc, rows)

    def sched_row(self, pod_idx: Index) -> torch.Tensor:
        """[N] bool — one pod's non-resource predicate verdicts, in either
        mask form."""
        idx = torch.as_tensor(pod_idx, device=self.device).reshape(1)
        return self.sched_rows(idx)[0]

    def dense_sched(self) -> torch.Tensor:
        """[P, N] bool — the full mask. A passthrough in dense form; in
        factored form it expands classes, cells and exception rows, so use
        it only on worlds small enough to hold [P, N]."""
        if self.sched_mask is not None:
            return self.sched_mask
        pc, nc = self.pod_class, self.node_class
        base = self.class_mask[pc.clamp(min=0)][:, nc.clamp(min=0)]
        base &= (pc >= 0)[:, None] & (nc >= 0)[None, :]
        ok = self.cell_pod >= 0
        base[self.cell_pod[ok].long(), self.cell_node[ok].long()] = self.cell_val[ok]
        has_exc = self.pod_exc >= 0
        exc = self.exc_rows[self.pod_exc.clamp(min=0)]
        return torch.where(has_exc[:, None], exc, base)

    def schedule_pod(self, pod_idx: Index, node_idx: Index) -> "SnapshotTensors":
        """Assign pod → node, adding its request to the node's usage; a new
        snapshot, the inputs untouched."""
        req = self.pod_req[pod_idx]
        node_used = self.node_used.clone()
        node_used[node_idx] = node_used[node_idx] + req
        pod_node = self.pod_node.clone()
        pod_node[pod_idx] = torch.as_tensor(node_idx, dtype=torch.int32)
        return dataclasses.replace(self, node_used=node_used, pod_node=pod_node)

    def unschedule_pod(self, pod_idx: Index) -> "SnapshotTensors":
        """Take the pod off its node (a no-op on usage for a pending pod); a
        new snapshot, the inputs untouched."""
        node_idx = self.pod_node[pod_idx]
        req = self.pod_req[pod_idx]
        valid = node_idx >= 0
        safe = torch.where(valid, node_idx, 0).long()
        node_used = self.node_used.clone()
        node_used[safe] = node_used[safe] + torch.where(valid, -req, torch.zeros_like(req))
        pod_node = self.pod_node.clone()
        pod_node[pod_idx] = -1
        return dataclasses.replace(self, node_used=node_used, pod_node=pod_node)


def bucket_size(n: int, minimum: int = 8) -> int:
    """Round n up to the next power of two (>= minimum) so operand shapes
    come from a small set."""
    size = minimum
    while size < n:
        size *= 2
    return size


def empty_snapshot(num_pods: int, num_nodes: int, device=None) -> SnapshotTensors:
    P, N, R = num_pods, num_nodes, NUM_RESOURCES
    dev = resolve_device(device)
    return SnapshotTensors(
        node_alloc=torch.zeros((N, R), dtype=torch.float32, device=dev),
        node_used=torch.zeros((N, R), dtype=torch.float32, device=dev),
        node_valid=torch.zeros((N,), dtype=torch.bool, device=dev),
        node_group=torch.full((N,), -1, dtype=torch.int32, device=dev),
        pod_req=torch.zeros((P, R), dtype=torch.float32, device=dev),
        pod_valid=torch.zeros((P,), dtype=torch.bool, device=dev),
        pod_node=torch.full((P,), -1, dtype=torch.int32, device=dev),
        sched_mask=torch.zeros((P, N), dtype=torch.bool, device=dev),
    )


# dtype of every field; the i32 fields stay i32 (torch defaults to int64)
FIELD_DTYPES = {
    "node_alloc": np.float32,
    "node_used": np.float32,
    "node_valid": np.bool_,
    "node_group": np.int32,
    "pod_req": np.float32,
    "pod_valid": np.bool_,
    "pod_node": np.int32,
    "sched_mask": np.bool_,
    "pod_priority": np.int32,
    "pod_preempt": np.bool_,
    "pod_class": np.int32,
    "node_class": np.int32,
    "class_mask": np.bool_,
    "exc_rows": np.bool_,
    "pod_exc": np.int32,
    "cell_pod": np.int32,
    "cell_node": np.int32,
    "cell_val": np.bool_,
}


def tensors_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> SnapshotTensors:
    """A snapshot's fields as numpy arrays (the JAX package's
    ``SnapshotTensors`` fields, or a ``dump_tensors`` ``.npz``) → the
    port's ``SnapshotTensors`` on ``device`` (None = the first CUDA card).
    Absent fields stay None; every array is copied, never aliased."""
    dev = resolve_device(device)
    unknown = set(arrays) - set(FIELD_DTYPES)
    if unknown:
        raise ValueError(f"not SnapshotTensors fields: {sorted(unknown)}")
    fields = {
        name: torch.tensor(np.asarray(arrays[name], dtype), device=dev)
        for name, dtype in FIELD_DTYPES.items()
        if name in arrays and arrays[name] is not None
    }
    return SnapshotTensors(**fields)
