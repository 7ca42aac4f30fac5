"""Object-level binpacking estimator — the Estimate() contract of the
reference, backed by the port's scans (the port of
``autoscaler_tpu/estimator/binpacking.py``).

Reference: cluster-autoscaler/estimator/estimator.go:44 and
binpacking_estimator.go:65. The per-group non-resource predicate check of
ComputeExpansionOption (orchestrator.go:462-484) is folded into the pod
mask built by the host mask engine; the resource arithmetic runs on the
estimator's device.

``estimate_many`` covers every node group in one scan, with the JAX
package's routing. Worlds without inter-pod affinity, hard topology spread
or pending legacy-volume conflicts take:

- the run-compressed route (``ops/binpack.ffd_binpack_groups_runs``) when
  equivalence dedup at least halves the pod count;
- otherwise the plain route: ``ops/ffd_scan``'s glue and the hand-written
  kernels K1/K2 for CUDA tensors (their plain versions for CPU tensors),
  when the carry of the kernel planes fits one block's shared memory; else
  the torch loop ``ops/binpack.ffd_binpack_groups``, on the same device.
  ``ROUTES`` counts which of the two served (``scan_route``, the gate).

Worlds that need the dynamic (term-gated) scan take:

- the runs-affinity route (``ops/binpack.ffd_binpack_groups_runs_affinity``,
  a torch loop) when no legacy volume conflicts, dedup halves the pods and
  the runs, with the term-involved groups expanded into singletons, still
  halve them;
- otherwise the per-pod dynamic route: ``ops/ffd_scan_affinity.
  ffd_binpack_groups_affinity_cuda``, the hand-written kernel K3 for CUDA
  tensors (its plain version for CPU tensors), when the spread terms fit
  its bitset (S <= 32) and its carry fits one block's shared memory; else
  the torch loop ``ops/binpack.ffd_binpack_groups_affinity``, on the same
  device. ``ROUTES`` counts which of the two served (``kernel_route``).

Both gates check the shapes before the call, as the JAX package's
``pallas_gate`` does; a launch that fails still raises.

``estimate`` (one template) runs ``ffd_binpack``, or the torch loop
``ffd_binpack_groups_affinity`` with one group in a dynamic world, as the
JAX package runs its XLA scans there.

With ``operand_arena=`` (``snapshot/arena.OperandArena``) every operand
upload goes through its content-keyed cache (the JAX package's ``_dev``):
an operand byte-identical to one uploaded before to the same device is
served resident instead of copied again. Results are the same either way.

Every estimate leaves its constraint attribution in ``last_explain``
(per-group fit counts with rejection-reason histograms, and each pod's
dominant reason), as the JAX package's estimator does: one batched pass of
``ops/binpack.attribute_unschedulable`` and ``attribution_summary`` on the
estimate's device over the route's own operands and verdict, then two
small host fetches. The JAX package falls back to a serial oracle when its
attribution fails; the port has no such fallback: a failure raises, as
every other failure of the port's estimator does.

Not here yet (ROADMAP queue 1): the kernel ladder and its native and
Python rungs, metrics, spans, the perf observatory and the fleet client.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autoscaler_tpu_torch.core.scaleup.equivalence import build_pod_groups
from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.estimator.limiter import ThresholdBasedEstimationLimiter
from autoscaler_tpu_torch.explain.reasons import reason_histogram, reason_name
from autoscaler_tpu_torch.kube.objects import NUM_RESOURCES, Node, Pod
from autoscaler_tpu_torch.ops import ffd_scan, ffd_scan_affinity
from autoscaler_tpu_torch.ops.binpack import (
    attribute_unschedulable,
    attribution_summary,
    ffd_binpack,
    ffd_binpack_groups,
    ffd_binpack_groups_affinity,
    ffd_binpack_groups_runs,
    ffd_binpack_groups_runs_affinity,
)
from autoscaler_tpu_torch.ops.ffd_scan import operands_from_numpy
from autoscaler_tpu_torch.snapshot.affinity import (
    SpreadTermTensors,
    build_affinity_terms,
    build_spread_terms,
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

# Which scan served each per-pod estimate: on the plain route the kernels
# K1/K2 or the torch loop when their carry is too wide; on the dynamic
# route the kernel K3 or the torch loop when the term state is too wide.
ROUTES = {"ffd_scan": 0, "binpack_loop": 0, "ffd_scan_aff": 0, "affinity_loop": 0}


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


def _build_group_arrays(
    pods: Sequence[Pod],
    names: Sequence[str],
    templates: Dict[str, Node],
    pad: int,
    interpod: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (req [pad,R], masks [G,pad], allocs [G,R]): the packed operands of
    the per-pod routes, the pod axis bucket-padded to ``pad``.
    interpod=False leaves inter-pod affinity to the dynamic scan."""
    ext = _estimation_schema(pods)
    req = _pack_pods(pods, pad, ext)
    masks = np.stack(
        [template_mask(pods, templates[g], pad, interpod=interpod) for g in names]
    )
    allocs = np.stack(
        [_template_capacity_row(templates[g], ext) for g in names]
    )
    req, allocs = _augment_virtual(
        req, pods, allocs, [templates[g] for g in names]
    )
    return req, masks, allocs


def template_mask(
    pods: Sequence[Pod], template: Node, padded: int, interpod: bool = True
) -> np.ndarray:
    """[padded] bool — which pods pass the template node's non-resource
    predicates (orchestrator.go:470's CheckPredicates per equivalence
    group). interpod=False leaves inter-pod affinity to the dynamic scan;
    the hard-spread rows apply either way."""
    mask = np.zeros((padded,), bool)
    if pods:
        m = compute_sched_mask(
            [template], list(pods), [-1] * len(pods), interpod=interpod
        )
        mask[: len(pods)] = m[:, 0]
    return mask


def _spread_tuple(sp: SpreadTermTensors, conv=np.asarray) -> tuple:
    """SpreadTermTensors → the scans' 11-array tuple (pod-axis rows
    transposed to [P, S] for per-step gathers); ``conv`` puts each array
    where the scan runs."""
    return (
        conv(np.ascontiguousarray(sp.sp_of.T)),
        conv(np.ascontiguousarray(sp.sp_match.T)),
        conv(sp.node_level),
        conv(sp.max_skew),
        conv(sp.min_domains),
        conv(sp.has_label),
        conv(sp.static_count),
        conv(sp.min_others),
        conv(sp.static_min),
        conv(sp.static_domnum),
        conv(sp.force_zero),
    )


def scan_route(device: torch.device, planes: int, max_nodes: int) -> str:
    """The plain route's gate, on the shapes alone: "ffd_scan" unless, on a
    CUDA card, K1/K2's carry of ``planes`` kernel planes (fixed by
    ``ffd_scan.plan_scan``) over ``max_nodes`` nodes asks for more shared memory
    than a block may use; then "binpack_loop". The CPU runs K1/K2's plain
    versions, which have no shared-memory limit."""
    if device.type == "cuda" and ffd_scan.smem_bytes(planes, max_nodes) > ffd_scan.SMEM_PER_BLOCK:
        return "binpack_loop"
    return "ffd_scan"


def kernel_route(device: torch.device, R: int, T: int, S: int, max_nodes: int) -> str:
    """The per-pod dynamic route's gate, on the shapes alone: "ffd_scan_aff"
    when the spread terms fit K3's bitset (S <= 32, S = 0 when no pod
    declares one) and, on a CUDA card, K3's carry fits one block's shared
    memory; else "affinity_loop". The CPU runs K3's plain version, which
    has no shared-memory limit."""
    if S > ffd_scan_affinity.MAX_SPREAD:
        return "affinity_loop"
    if device.type == "cuda":
        TP = max((T + 31) // 32, 1)
        smem = ffd_scan_affinity.affinity_smem_bytes(R, TP, S, max_nodes)
        if smem > ffd_scan.SMEM_PER_BLOCK:
            return "affinity_loop"
    return "ffd_scan_aff"


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
    one unless ``device="cpu"``). ``operand_arena``: an ``OperandArena``
    that keeps the operands resident across calls (None = plain uploads)."""

    def __init__(
        self,
        limiter: Optional[ThresholdBasedEstimationLimiter] = None,
        device=None,
        operand_arena=None,
    ):
        self.limiter = limiter or ThresholdBasedEstimationLimiter()
        self.device = resolve_device(device)
        self.operand_arena = operand_arena
        # decision provenance: the last estimate's constraint attribution,
        # read by the orchestrator into ScaleUpResult.estimator_explain. The
        # routes park their device operands and verdict in _explain_scratch;
        # _finish_explain turns them into reason codes.
        self.last_explain: Dict = {"groups": {}, "pod_reasons": {}}
        self._explain_scratch: Optional[Dict] = None

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        """One operand on the estimator's device: the operand arena's
        resident copy when one is attached, else a plain copy (never an
        alias of ``arr``)."""
        if self.operand_arena is not None:
            return self.operand_arena.resident(arr, self.device)
        return torch.tensor(arr, device=self.device)

    def estimate(
        self,
        pods: Sequence[Pod],
        template: Node,
        max_size_headroom: int = 0,
        cluster=None,  # (nodes, pods, node_of): static spread context
    ) -> Tuple[int, List[Pod]]:
        """→ (node_count, scheduled_pods) for one template."""
        if not pods:
            return 0, []
        P = bucket_size(len(pods))
        ext = _estimation_schema(pods)
        req = _pack_pods(pods, P, ext)
        vol_comps = volume_conflict_components(pods)
        dynamic = (
            has_interpod_affinity(pods) or has_hard_spread(pods) or bool(vol_comps)
        )
        mask = template_mask(pods, template, P, interpod=not dynamic)
        alloc = _template_capacity_row(template, ext)
        req, alloc2d = _augment_virtual(req, pods, alloc[None, :], [template])
        cap = self.limiter.node_cap(max_size_headroom)
        max_nodes = bucket_size(cap, minimum=8)
        req_t = self._tensor(req)
        masks_t = self._tensor(mask[None, :])
        allocs_t = self._tensor(alloc2d)
        involved = np.zeros((P,), bool)
        if dynamic:
            terms = build_affinity_terms(
                pods, [template], pad_pods=P, bucket_terms=True,
                volume_components=vol_comps,
            )
            sp = build_spread_terms(
                pods, [template], pad_pods=P, bucket_terms=True, cluster=cluster
            )
            involved = _involved(terms, sp)
            res = ffd_binpack_groups_affinity(
                req_t,
                masks_t,
                allocs_t,
                max_nodes=max_nodes,
                match=self._tensor(terms.match),
                aff_of=self._tensor(terms.aff_of),
                anti_of=self._tensor(terms.anti_of),
                node_level=self._tensor(terms.node_level),
                has_label=self._tensor(terms.has_label),
                node_caps=self._tensor(np.array([cap], np.int32)),
                spread=_spread_tuple(sp, conv=self._tensor),
            )
            sched_t = res.scheduled
        else:
            res = ffd_binpack(
                req_t, masks_t[0], allocs_t[0], max_nodes=max_nodes, node_cap=cap,
            )
            sched_t = res.scheduled[None, :]
        count = int(res.node_count.reshape(-1)[0])
        scheduled = sched_t[0].cpu().numpy()
        out = count, [p for i, p in enumerate(pods) if scheduled[i]]
        self._explain_scratch = {
            "kind": "pods", "names": ["template"], "req": req_t, "masks": masks_t,
            "allocs": allocs_t, "involved": self._tensor(involved),
            "scheduled": sched_t,
        }
        self._finish_explain(pods, {"template": out})
        return out

    def estimate_many(
        self,
        pods: Sequence[Pod],
        templates: Dict[str, Node],
        headrooms: Optional[Dict[str, int]] = None,
        pod_groups=None,
        cluster=None,  # (nodes, pods, node_of): static spread context
    ) -> Dict[str, Tuple[int, List[Pod]]]:
        """All node groups in one scan. headrooms[g] is the group's
        remaining size budget (max-size − target); each group's cap is
        min(limiter threshold, headroom)."""
        if not pods or not templates:
            self._explain_scratch = None
            self.last_explain = {"groups": {}, "pod_reasons": {}}
            return {g: (0, []) for g in templates}
        result = self._estimate_many_inner(
            pods, templates, headrooms, pod_groups, cluster
        )
        self._finish_explain(pods, result)
        return result

    def _estimate_many_inner(self, pods, templates, headrooms, pod_groups, cluster):
        names = sorted(templates)
        # computed once and threaded through: the component build is
        # O(pods × volumes)
        vol_comps = volume_conflict_components(pods)
        dynamic = (
            has_interpod_affinity(pods) or has_hard_spread(pods) or bool(vol_comps)
        )
        groups = pod_groups if pod_groups is not None else build_pod_groups(pods)
        headrooms = headrooms or {}
        caps = np.array(
            [self.limiter.node_cap(headrooms.get(g, 0)) for g in names], np.int32
        )
        if not dynamic:
            if len(groups) * 2 <= len(pods):
                return self._estimate_many_runs(groups, names, templates, caps)
        elif not vol_comps and len(groups) * 2 <= len(pods):
            # Conflict worlds stay per pod: run compression builds terms
            # from group exemplars, and one exemplar of a set of identical
            # sharers can never form a conflict component. The group count
            # lower-bounds the run count, so worlds that can never compress
            # skip the term build.
            runs, group_terms, group_of_run, run_inv, group_sp = (
                self._expand_affinity_runs(groups, templates, names, cluster)
            )
            if len(runs) * 2 <= len(pods):
                return self._estimate_many_runs_affinity(
                    runs, group_terms, group_of_run, run_inv, names, templates,
                    caps, group_sp,
                )
        P = bucket_size(len(pods))
        req, masks, allocs = _build_group_arrays(
            pods, names, templates, pad=P, interpod=not dynamic
        )
        scan_cap = bucket_size(int(caps.max()), minimum=8)
        if dynamic:
            res, ops = self._estimate_many_dynamic(
                pods, names, templates, req, masks, allocs, caps, scan_cap,
                vol_comps, cluster,
            )
        else:
            res, ops = self._estimate_many_plain(req, masks, allocs, caps, scan_cap)
        self._explain_scratch = {
            "kind": "pods", "names": names, **ops, "scheduled": res.scheduled,
        }
        counts = res.node_count.cpu().numpy()
        scheds = res.scheduled.cpu().numpy()
        return {
            g: (
                int(counts[gi]),
                [p for i, p in enumerate(pods) if scheds[gi, i]],
            )
            for gi, g in enumerate(names)
        }

    def _estimate_many_plain(self, req, masks, allocs, caps, scan_cap):
        """The plain per-pod route: the glue's host probe fixes the kernel
        planes, the shape gate picks K1/K2 or the torch loop, and only the
        route taken builds its operands, on the estimator's device.
        → (result, the attribution's operands)."""
        req_t, masks_t, allocs_t, caps_t = operands_from_numpy(
            req, masks, allocs, caps, self.device, upload=self._tensor
        )
        ops = {
            "req": req_t, "masks": masks_t, "allocs": allocs_t,
            "involved": torch.zeros(req.shape[0], dtype=torch.bool, device=self.device),
        }
        plan = ffd_scan.plan_scan(req_t, allocs_t)
        route = scan_route(self.device, plan.planes, scan_cap)
        ROUTES[route] += 1
        if route == "ffd_scan":
            return ffd_scan.ffd_binpack_groups_cuda(
                req_t, masks_t, allocs_t, max_nodes=scan_cap, node_caps=caps_t, scan_plan=plan
            ), ops
        return ffd_binpack_groups(
            req_t, masks_t, allocs_t, max_nodes=scan_cap, node_caps=caps_t
        ), ops

    def _estimate_many_dynamic(
        self, pods, names, templates, req, masks, allocs, caps, scan_cap,
        vol_comps, cluster,
    ):
        """The per-pod dynamic route: term and spread tensors, the shape
        gate, then K3 or the torch loop on the estimator's device.
        → (result, the attribution's operands)."""
        P = req.shape[0]
        tmpl_list = [templates[g] for g in names]
        terms = build_affinity_terms(
            pods, tmpl_list, pad_pods=P, bucket_terms=True,
            volume_components=vol_comps,
        )
        sp = build_spread_terms(
            pods, tmpl_list, pad_pods=P, bucket_terms=True, cluster=cluster
        )
        # bucket_terms pads S, so "spread in play" means a pod DECLARES a
        # term, not S > 0 (padded terms are inert)
        has_spread = bool(sp.sp_of.any())
        spread = _spread_tuple(sp)
        route = kernel_route(
            self.device, req.shape[1], terms.match.shape[0],
            sp.num_terms if has_spread else 0, scan_cap,
        )
        ROUTES[route] += 1
        ops = ffd_scan_affinity.affinity_operands_from_numpy(
            req, masks, allocs, terms.match, terms.aff_of, terms.anti_of,
            terms.node_level, terms.has_label, caps,
            spread=spread if has_spread or route == "affinity_loop" else None,
            device=self.device, upload=self._tensor,
        )
        explain_ops = {
            "req": ops["pod_req"], "masks": ops["pod_masks"],
            "allocs": ops["template_allocs"],
            "involved": self._tensor(_involved(terms, sp)),
        }
        if route == "ffd_scan_aff":
            return ffd_scan_affinity.ffd_binpack_groups_affinity_cuda(
                **ops, max_nodes=scan_cap
            ), explain_ops
        return ffd_binpack_groups_affinity(**ops, max_nodes=scan_cap), explain_ops

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
        run_req_t, counts_t = self._tensor(run_req), self._tensor(run_counts)
        masks_t, allocs_t = self._tensor(masks), self._tensor(allocs)
        res = ffd_binpack_groups_runs(
            run_req_t,
            counts_t,
            masks_t,
            allocs_t,
            max_nodes=bucket_size(int(caps.max()), minimum=8),
            node_caps=self._tensor(caps),
        )
        members = [g.pods for g in groups]
        self._explain_scratch = {
            "kind": "runs", "names": names, "req": run_req_t, "masks": masks_t,
            "allocs": allocs_t, "counts": counts_t, "members": members,
            "involved": torch.zeros(U, dtype=torch.bool, device=self.device),
            "placed": res.placed_counts,
        }
        return _expand_run_result(res, members, names)

    @staticmethod
    def _expand_affinity_runs(
        groups,
        templates: Dict[str, Node],
        names: List[str],
        cluster=None,
    ):
        """→ (runs, group_terms, group_of_run, run_inv, group_spread):
        equivalence runs with the term-involved groups expanded into
        singletons, the term tensors built once over the group exemplars,
        each run's source-group index (so the run-axis term columns are a
        gather, not a rebuild) and the per-run involvement mask. A group is
        involved iff its exemplar matches any term's selector or holds any
        required (anti-)affinity term or hard spread constraint; exemplars
        stand for their group because the equivalence fingerprint includes
        labels, affinity and topology spread."""
        exemplars = [g.exemplar for g in groups]
        tmpl_list = [templates[g] for g in names]
        terms = build_affinity_terms(
            exemplars, tmpl_list, bucket_terms=True,
            volume_components=(),  # conflict worlds never reach this route
        )
        spread = build_spread_terms(
            exemplars, tmpl_list, bucket_terms=True, cluster=cluster
        )
        inv = (
            (terms.match | terms.aff_of | terms.anti_of).any(axis=0)
            | (spread.sp_of | spread.sp_match).any(axis=0)
        )
        runs: List[Tuple[Pod, List[Pod]]] = []
        group_of_run: List[int] = []
        for gi, grp in enumerate(groups):
            if inv[gi]:
                runs.extend((p, [p]) for p in grp.pods)
                group_of_run.extend([gi] * len(grp.pods))
            else:
                runs.append((grp.exemplar, grp.pods))
                group_of_run.append(gi)
        group_of_run_arr = np.asarray(group_of_run, np.int64)
        return runs, terms, group_of_run_arr, inv[group_of_run_arr], spread

    def _estimate_many_runs_affinity(
        self,
        runs: List[Tuple[Pod, List[Pod]]],
        group_terms,
        group_of_run: np.ndarray,
        run_inv: np.ndarray,
        names: List[str],
        templates: Dict[str, Node],
        caps: np.ndarray,
        group_spread: SpreadTermTensors,
    ) -> Dict[str, Tuple[int, List[Pod]]]:
        """Runs-affinity route: ``ffd_binpack_groups_runs_affinity`` with
        the involved runs expanded to singletons. Term columns are gathered
        from the group-exemplar tensors through ``group_of_run``."""
        U = bucket_size(len(runs))
        run_exemplars = [ex for ex, _ in runs]
        ext = _estimation_schema(run_exemplars)
        run_req = _pack_pods(run_exemplars, U, ext)
        run_counts = np.zeros((U,), np.int32)
        run_counts[: len(runs)] = [len(members) for _, members in runs]
        masks = np.stack(
            [
                template_mask(run_exemplars, templates[g], U, interpod=False)
                for g in names
            ]
        )
        allocs = np.stack(
            [_template_capacity_row(templates[g], ext) for g in names]
        )
        run_req, allocs = _augment_virtual(
            run_req, run_exemplars, allocs, [templates[g] for g in names]
        )
        involved = np.zeros((U,), bool)
        involved[: len(runs)] = run_inv

        def to_runs(col_mat: np.ndarray) -> np.ndarray:
            out = np.zeros((col_mat.shape[0], U), bool)
            out[:, : len(runs)] = col_mat[:, group_of_run]
            return out

        run_sp = dataclasses.replace(
            group_spread,
            sp_of=to_runs(group_spread.sp_of),
            sp_match=to_runs(group_spread.sp_match),
        )
        run_req_t, counts_t = self._tensor(run_req), self._tensor(run_counts)
        masks_t, allocs_t = self._tensor(masks), self._tensor(allocs)
        involved_t = self._tensor(involved)  # feeds the scan and the attribution
        res = ffd_binpack_groups_runs_affinity(
            run_req_t,
            counts_t,
            masks_t,
            allocs_t,
            max_nodes=bucket_size(int(caps.max()), minimum=8),
            involved=involved_t,
            match=self._tensor(to_runs(group_terms.match)),
            aff_of=self._tensor(to_runs(group_terms.aff_of)),
            anti_of=self._tensor(to_runs(group_terms.anti_of)),
            node_level=self._tensor(group_terms.node_level),
            has_label=self._tensor(group_terms.has_label),
            node_caps=self._tensor(caps),
            spread=_spread_tuple(run_sp, conv=self._tensor),
        )
        members = [m for _, m in runs]
        self._explain_scratch = {
            "kind": "runs", "names": names, "req": run_req_t, "masks": masks_t,
            "allocs": allocs_t, "counts": counts_t, "members": members,
            "involved": involved_t, "placed": res.placed_counts,
        }
        return _expand_run_result(res, members, names)

    # -- decision provenance (explain/) ---------------------------------------
    def _finish_explain(self, pods, result) -> None:
        """Turn the serving route's parked operands and verdict into
        ``last_explain``: per-group fit counts with rejection-reason
        histograms, and each pod's dominant reason (the closest it came to
        scheduling anywhere). A pure function of the packed operands, so
        the DecisionRecord built from it is the JAX package's."""
        scratch, self._explain_scratch = self._explain_scratch, None
        if scratch is None or not pods:
            self.last_explain = {"groups": {}, "pod_reasons": {}}
            return
        if scratch["kind"] == "runs":
            hist, pod_reasons = self._explain_runs(scratch)
        else:
            hist, pod_reasons = self._explain_pods(scratch, pods)
        groups: Dict[str, Dict] = {}
        for gi, g in enumerate(scratch["names"]):
            count, sched = result.get(g, (0, []))
            groups[g] = {
                "fit_nodes": int(count),
                "scheduled": len(sched),
                "reasons": reason_histogram(hist[gi]),
            }
        self.last_explain = {"groups": groups, "pod_reasons": pod_reasons}

    @staticmethod
    def _attribution(scratch, scheduled, weights):
        """(hist [G, NUM_REASONS], dominant [P]) as numpy: one batched pass
        on the operands' device, then two small fetches."""
        reasons = attribute_unschedulable(
            scratch["req"], scratch["masks"], scratch["allocs"], scheduled,
            scratch["involved"],
        )
        hist, dom = attribution_summary(reasons, weights)
        return hist.cpu().numpy(), dom.cpu().tolist()

    def _explain_pods(self, scratch, pods):
        """Per-pod attribution over the route's [G, P_pad] verdict; padding
        rows count as unplaced with zero weight, so they never reach a
        histogram."""
        sched = scratch["scheduled"]
        G, P_pad = sched.shape
        valid = torch.arange(P_pad, device=sched.device) < len(pods)
        weights = valid.to(torch.int32).expand(G, P_pad)
        hist, dom = self._attribution(scratch, sched & valid, weights)
        pod_reasons = {p.key(): reason_name(dom[i]) for i, p in enumerate(pods)}
        return hist, pod_reasons

    def _explain_runs(self, scratch):
        """Run-compressed attribution: a run counts as scheduled when every
        member placed; histogram weights are the unplaced member counts, so
        'memory=40' means forty pods, not one run of forty. Every member
        inherits the run's dominant reason (members are interchangeable by
        the equivalence-group construction)."""
        counts = scratch["counts"][None, :]
        placed = torch.minimum(scratch["placed"], counts)
        weights = (counts - placed).clamp(min=0).to(torch.int32)
        hist, dom = self._attribution(scratch, placed >= counts, weights)
        pod_reasons: Dict[str, str] = {}
        for u, members in enumerate(scratch["members"]):
            rname = reason_name(dom[u])
            for p in members:
                pod_reasons[p.key()] = rname
        return hist, pod_reasons


def _involved(terms, sp) -> np.ndarray:
    """[P] bool — the pod matches a term's selector, holds a required
    (anti-)affinity term or a hard spread constraint, or is counted by one."""
    return (
        (terms.match | terms.aff_of | terms.anti_of).any(axis=0)
        | (sp.sp_of | sp.sp_match).any(axis=0)
    )


def _expand_run_result(res, members: List[List[Pod]], names: List[str]):
    """A run scan's result → {group: (node_count, scheduled pods)}: 'k of
    this run placed' expands to the run's first k member pods."""
    counts = res.node_count.cpu().numpy()
    placed = res.placed_counts.cpu().numpy()
    out: Dict[str, Tuple[int, List[Pod]]] = {}
    for gi, g in enumerate(names):
        sched: List[Pod] = []
        for ui, run_members in enumerate(members):
            sched.extend(run_members[: placed[gi, ui]])
        out[g] = (int(counts[gi]), sched)
    return out
