"""Object-level binpacking estimator — the Estimate() contract of the
reference, backed by the port's scans (the port of
``autoscaler_tpu/estimator/binpacking.py``).

Reference: cluster-autoscaler/estimator/estimator.go:44 and
binpacking_estimator.go:65. The per-group non-resource predicate check of
ComputeExpansionOption (orchestrator.go:462-484) is folded into the pod
mask built by the host mask engine; the resource arithmetic runs on the
estimator's device.

``estimate_many`` covers every node group in one scan, with the JAX
package's routing:

- the run-compressed route (``ops/binpack.ffd_binpack_groups_runs``) when
  equivalence dedup at least halves the pod count;
- otherwise the plain route, ``ops/ffd_scan.ffd_binpack_groups_cuda``,
  which launches the hand-written kernels K1/K2 for CUDA tensors and runs
  their plain versions for CPU tensors;
- worlds that need the dynamic scan (inter-pod affinity, hard topology
  spread, pending legacy-volume conflicts) raise NotImplementedError: that
  scan and its kernel come with the affinity slice.

Not here yet (ROADMAP queue 1, slice 2): the kernel ladder, metrics,
spans, the perf observatory, decision explain, the operand arena and the
fleet client.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autoscaler_tpu_torch.core.scaleup.equivalence import build_pod_groups
from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.estimator.limiter import ThresholdBasedEstimationLimiter
from autoscaler_tpu_torch.kube.objects import NUM_RESOURCES, Node, Pod
from autoscaler_tpu_torch.ops.binpack import ffd_binpack, ffd_binpack_groups_runs
from autoscaler_tpu_torch.ops.ffd_scan import (
    ffd_binpack_groups_cuda,
    operands_from_numpy,
)
from autoscaler_tpu_torch.snapshot.affinity import (
    has_hard_spread,
    has_interpod_affinity,
    volume_conflict_components,
)
from autoscaler_tpu_torch.snapshot.packer import (
    compute_sched_mask,
    extended_schema,
    resources_row,
)
from autoscaler_tpu_torch.snapshot.tensors import bucket_size

DYNAMIC_NOT_PORTED = (
    "pods with inter-pod affinity, hard topology spread or pending "
    "legacy-volume conflicts need the dynamic affinity scan (JAX kernel "
    "ops/pallas_binpack_affinity.py::_scan_kernel_aff), which comes with the "
    "affinity slice (ROADMAP queue 1, slice 3)"
)


def _pack_pods(
    pods: Sequence[Pod], padded: int, ext: tuple = ()
) -> np.ndarray:
    req = np.zeros((padded, NUM_RESOURCES + len(ext)), np.float32)
    for i, pod in enumerate(pods):
        req[i] = resources_row(pod.requests, 1.0, ext)
    return req


def _estimation_schema(pods: Sequence[Pod]) -> tuple:
    """Named extended-resource columns for one estimate: the union over
    pending pod requests only."""
    return extended_schema((p.requests for p in pods))


def _require_static(pods: Sequence[Pod]) -> None:
    if (
        has_interpod_affinity(pods)
        or has_hard_spread(pods)
        or volume_conflict_components(pods)
    ):
        raise NotImplementedError(DYNAMIC_NOT_PORTED)


def _build_group_arrays(
    pods: Sequence[Pod],
    names: Sequence[str],
    templates: Dict[str, Node],
    pad: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (req [pad,R], masks [G,pad], allocs [G,R]): the packed operands of
    the plain route, the pod axis bucket-padded to ``pad``."""
    ext = _estimation_schema(pods)
    req = _pack_pods(pods, pad, ext)
    masks = np.stack([template_mask(pods, templates[g], pad) for g in names])
    allocs = np.stack(
        [_template_capacity_row(templates[g], ext) for g in names]
    )
    req, allocs = _augment_virtual(
        req, pods, allocs, [templates[g] for g in names]
    )
    return req, masks, allocs


def template_mask(pods: Sequence[Pod], template: Node, padded: int) -> np.ndarray:
    """[padded] bool — which pods pass the template node's non-resource
    predicates (orchestrator.go:470's CheckPredicates per equivalence
    group)."""
    mask = np.zeros((padded,), bool)
    if pods:
        m = compute_sched_mask([template], list(pods), [-1] * len(pods))
        mask[: len(pods)] = m[:, 0]
    return mask


def _template_capacity_row(template: Node, ext: tuple = ()) -> np.ndarray:
    """Pack-capacity row of a template node: allocatable minus daemon
    overhead, with the pods column from the same reduced view."""
    cap = template.packing_capacity()
    return resources_row(cap, cap.pods, ext)


def _augment_virtual(
    req: np.ndarray,            # [P_pad, R] packed requests (rows = row_pods)
    row_pods: Sequence[Pod],    # pods (or run exemplars) backing the rows
    allocs: np.ndarray,         # [G, R] template capacity rows
    templates_list: Sequence[Node],
) -> Tuple[np.ndarray, np.ndarray]:
    """Append VIRTUAL resource planes that make within-wave host-port and
    CSI-attach accounting on scan-opened nodes exact:

    - one column per distinct host port among the pending pods — capacity 1
      per node, request 1 for pods binding it;
    - one column per distinct CSI driver — capacity = the template's attach
      limit (inf when unlimited), request = the pod's volume count on it.
    """
    ports = sorted({prt for pod in row_pods for prt in pod.host_ports})
    drivers = sorted({d for pod in row_pods for d, _ in pod.csi_volumes})
    V = len(ports) + len(drivers)
    if V == 0:
        return req, allocs
    extra = np.zeros((req.shape[0], V), np.float32)
    port_col = {prt: k for k, prt in enumerate(ports)}
    drv_col = {d: len(ports) + k for k, d in enumerate(drivers)}
    for i, pod in enumerate(row_pods):
        for prt in pod.host_ports:
            extra[i, port_col[prt]] = 1.0
        for d, _handle in pod.csi_volumes:
            extra[i, drv_col[d]] += 1.0
    alloc_extra = np.zeros((allocs.shape[0], V), np.float32)
    alloc_extra[:, : len(ports)] = 1.0
    for gi, tmpl in enumerate(templates_list):
        for d, k in drv_col.items():
            lim = (tmpl.csi_attach_limits or {}).get(d)
            alloc_extra[gi, k] = np.inf if lim is None else float(lim)
    return (
        np.concatenate([req, extra], axis=1),
        np.concatenate([allocs, alloc_extra], axis=1),
    )


class BinpackingNodeEstimator:
    """Node-count estimator with the reference's Estimate contract. Its
    scans run on ``device`` (None = the first CUDA card; raises without
    one unless ``device="cpu"``)."""

    def __init__(
        self,
        limiter: Optional[ThresholdBasedEstimationLimiter] = None,
        device=None,
    ):
        self.limiter = limiter or ThresholdBasedEstimationLimiter()
        self.device = resolve_device(device)

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.tensor(arr, device=self.device)  # a copy, never an alias

    def estimate(
        self,
        pods: Sequence[Pod],
        template: Node,
        max_size_headroom: int = 0,
    ) -> Tuple[int, List[Pod]]:
        """→ (node_count, scheduled_pods) for one template."""
        if not pods:
            return 0, []
        _require_static(pods)
        P = bucket_size(len(pods))
        ext = _estimation_schema(pods)
        req = _pack_pods(pods, P, ext)
        mask = template_mask(pods, template, P)
        alloc = _template_capacity_row(template, ext)
        req, alloc2d = _augment_virtual(req, pods, alloc[None, :], [template])
        cap = self.limiter.node_cap(max_size_headroom)
        res = ffd_binpack(
            self._tensor(req),
            self._tensor(mask),
            self._tensor(alloc2d[0]),
            max_nodes=bucket_size(cap, minimum=8),
            node_cap=cap,
        )
        scheduled = res.scheduled.cpu().numpy()
        return int(res.node_count), [p for i, p in enumerate(pods) if scheduled[i]]

    def estimate_many(
        self,
        pods: Sequence[Pod],
        templates: Dict[str, Node],
        headrooms: Optional[Dict[str, int]] = None,
        pod_groups=None,
    ) -> Dict[str, Tuple[int, List[Pod]]]:
        """All node groups in one scan. headrooms[g] is the group's
        remaining size budget (max-size − target); each group's cap is
        min(limiter threshold, headroom)."""
        if not pods or not templates:
            return {g: (0, []) for g in templates}
        _require_static(pods)
        names = sorted(templates)
        groups = pod_groups if pod_groups is not None else build_pod_groups(pods)
        headrooms = headrooms or {}
        caps = np.array(
            [self.limiter.node_cap(headrooms.get(g, 0)) for g in names], np.int32
        )
        if len(groups) * 2 <= len(pods):
            return self._estimate_many_runs(groups, names, templates, caps)
        P = bucket_size(len(pods))
        req, masks, allocs = _build_group_arrays(pods, names, templates, pad=P)
        req_t, masks_t, allocs_t, caps_t = operands_from_numpy(
            req, masks, allocs, caps, self.device
        )
        res = ffd_binpack_groups_cuda(
            req_t, masks_t, allocs_t,
            max_nodes=bucket_size(int(caps.max()), minimum=8),
            node_caps=caps_t,
        )
        counts = res.node_count.cpu().numpy()
        scheds = res.scheduled.cpu().numpy()
        return {
            g: (
                int(counts[gi]),
                [p for i, p in enumerate(pods) if scheds[gi, i]],
            )
            for gi, g in enumerate(names)
        }

    def _estimate_many_runs(
        self,
        groups,
        names: List[str],
        templates: Dict[str, Node],
        caps: np.ndarray,
    ) -> Dict[str, Tuple[int, List[Pod]]]:
        """Equivalence-run route: one scan step per unique pod type. Members
        of a run are interchangeable by construction, so 'schedule k of this
        run' expands to its first k member pods."""
        U = bucket_size(len(groups))
        exemplars = [g.exemplar for g in groups]
        ext = _estimation_schema(exemplars)
        run_req = _pack_pods(exemplars, U, ext)
        run_counts = np.zeros((U,), np.int32)
        run_counts[: len(groups)] = [len(g.pods) for g in groups]
        masks = np.stack([template_mask(exemplars, templates[g], U) for g in names])
        allocs = np.stack(
            [_template_capacity_row(templates[g], ext) for g in names]
        )
        run_req, allocs = _augment_virtual(
            run_req, exemplars, allocs, [templates[g] for g in names]
        )
        res = ffd_binpack_groups_runs(
            self._tensor(run_req),
            self._tensor(run_counts),
            self._tensor(masks),
            self._tensor(allocs),
            max_nodes=bucket_size(int(caps.max()), minimum=8),
            node_caps=self._tensor(caps),
        )
        counts = res.node_count.cpu().numpy()
        placed = res.placed_counts.cpu().numpy()
        out: Dict[str, Tuple[int, List[Pod]]] = {}
        for gi, g in enumerate(names):
            sched: List[Pod] = []
            for ui, grp in enumerate(groups):
                sched.extend(grp.pods[: placed[gi, ui]])
            out[g] = (int(counts[gi]), sched)
        return out
