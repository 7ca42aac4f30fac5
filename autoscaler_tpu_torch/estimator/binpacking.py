"""Object-level binpacking estimator — the Estimate() contract of the
reference, backed by the port's scans and served through a kernel ladder
(the port of ``autoscaler_tpu/estimator/binpacking.py``).

Reference: cluster-autoscaler/estimator/estimator.go:44 and
binpacking_estimator.go:65. The per-group non-resource predicate check of
ComputeExpansionOption (orchestrator.go:462-484) is folded into the pod
mask built by the host mask engine; the resource arithmetic runs on the
estimator's device.

``estimate_many`` covers every node group in one scan, with the JAX
package's routing, and walks each dispatch down the kernel ladder
(``estimator/ladder.py``): the hand-written CUDA kernels (rung ``cuda``),
the torch loops of ``ops/binpack.py`` on the estimator's device (``torch``),
the native serial FFD (``native``, ``native_bridge``) and the Python oracle
(``python``, ``reference_impl``). Every rung computes the same answer;
each sits behind a circuit breaker. Worlds without inter-pod affinity,
hard topology spread or pending legacy-volume conflicts take:

- the run-compressed route (torch rung, route ``torch_runs``:
  ``ops/binpack.ffd_binpack_groups_runs``) when equivalence dedup at least
  halves the pod count; the cuda rung is skipped with reason ``dedup``;
- otherwise the plain per-pod route: K1/K2 (route ``cuda``, through
  ``ops/ffd_scan``'s glue) when the device is CUDA and the carry of the
  kernel planes fits one block's shared memory, else the torch loop
  ``ffd_binpack_groups`` (route ``torch_scan``, reason ``not_cuda`` or
  ``smem``).

Worlds that need the dynamic (term-gated) scan take:

- the runs-affinity route (``torch_runs``:
  ``ops/binpack.ffd_binpack_groups_runs_affinity``) when no legacy volume
  conflicts, dedup halves the pods and the runs, with the term-involved
  groups expanded into singletons, still halve them;
- otherwise the per-pod dynamic route: K3 (``cuda_affinity``, through
  ``ops/ffd_scan_affinity``'s glue) when the device is CUDA, the spread
  terms fit its bitset (S <= 32) and its carry fits one block's shared
  memory, else the torch loop ``ffd_binpack_groups_affinity``
  (``torch_scan``, reason ``not_cuda``, ``spread_width`` or ``smem``).

Below the device rungs, the native and Python rungs serve every route but
the spread worlds (no host twin counts topology spread). A rung that
raises, or a fault injected through ``ladder.fault_hook``, is a fault: it
is logged at WARNING on the ``estimator`` logger and counted. Off a CUDA
device the dispatch then descends, as in the JAX package. On a CUDA device
the hand kernels have no fallback: a fault of the cuda rung (a failed
build of its source, a launch error, an asynchronous error at the fetch,
an injected fault) is recorded on its breaker and raised, an open cuda
breaker raises instead of skipping the rung, and no dispatch is forced.
Only the shape gates (``smem``, ``spread_width``), dedup routing and a
dispatch no hand kernel serves (``estimate``, the preemption pass) send a
card dispatch below the cuda rung, to the torch rung on the card, which
is then as strict: a card dispatch is served on the card or fails, never
on the host rungs. Device results are fetched to the host
inside the serving rung's ``try``, so an asynchronous CUDA error lands on
the ladder; the host rungs read only the numpy operands, never a device
tensor.

``estimate`` (one template) walks the torch, native and Python rungs:
``ffd_binpack`` (``torch_single``), or ``ffd_binpack_groups_affinity``
with one group (``torch_scan``) in a dynamic world, as the JAX package
walks its XLA scans there.

Each rung engagement is one ``deviceDispatch`` span under the ``estimate``
span, the serving route lands on ``estimator_kernel_route_total`` with the
last skip or fault reason, and each served dispatch is handed to the perf
observatory (compile-vs-execute split, cost model, operand bytes) under a
``torch.profiler.record_function`` named ``autoscaler/estimator/<route>``.

With ``operand_arena=`` (``snapshot/arena.OperandArena``) every operand
upload goes through its content-keyed cache: an operand byte-identical to
one uploaded before to the same device is served resident instead of
copied again. Results are the same either way.

Every estimate leaves its constraint attribution in ``last_explain``
(per-group fit counts with rejection-reason histograms, and each pod's
dominant reason): one batched pass of ``ops/binpack.attribute_unschedulable``
and ``attribution_summary`` on the estimator's device over the serving
route's operands and verdict, then two small host fetches; when that pass
fails, the serial oracle twin (``reference_impl.
attribute_unschedulable_reference``) answers from the numpy operands.

``estimate_preemption`` packs a snapshot's pending pods onto its existing
nodes, evicting lower-priority residents where they fit nowhere
(``ops/preempt.ffd_binpack_preempt``, route ``torch_preempt``). No hand
kernel serves it: the cuda rung takes the automatic ``unsupported`` skip,
and on a CUDA device the torch rung is the card's rung, strict as
every device rung is there; off the card the Python oracle is its host
twin.

With ``fleet_client=`` (``gym/env.FleetEstimatorClient`` over a shared
``fleet/coalescer.FleetCoalescer``) a plain estimate of a world without
dynamic constraints rides the coalescer's admission queue instead of this
estimator's ladder (route ``fleet_coalesced``): its packed operands join
other estimators' in one batched dispatch, with identical answers. A
fleet failure — admission, overload, deadline or drain, a coalescer that
never answers — falls back to the solo ladder, as in the JAX package; on
a CUDA device a batch that failed on the card's rung (a kernel fault)
raises instead.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autoscaler_tpu_torch import native_bridge, trace
from autoscaler_tpu_torch.core.scaleup.equivalence import build_pod_groups
from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.estimator.ladder import (
    HOST_LEVEL_SKIP_REASONS,
    RUNG_CUDA,
    RUNG_NATIVE,
    RUNG_PYTHON,
    RUNG_TORCH,
    KernelLadder,
)
from autoscaler_tpu_torch.estimator.limiter import ThresholdBasedEstimationLimiter
from autoscaler_tpu_torch.estimator.reference_impl import (
    attribute_unschedulable_reference,
    ffd_binpack_preempt_reference,
    ffd_binpack_reference,
    ffd_binpack_reference_affinity,
)
from autoscaler_tpu_torch.explain.reasons import NUM_REASONS, reason_histogram, reason_name
from autoscaler_tpu_torch.kube.objects import CPU, MEMORY, NUM_RESOURCES, Node, Pod
from autoscaler_tpu_torch.metrics import metrics as metrics_mod
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
from autoscaler_tpu_torch.ops.preempt import SchedRows, ffd_binpack_preempt
from autoscaler_tpu_torch.ops.telemetry import kernel_observer
from autoscaler_tpu_torch.trace.device import device_annotation
from autoscaler_tpu_torch.perf import PerfObservatory, default_peak_flops
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
from autoscaler_tpu_torch.utils.errors import AutoscalerError, ErrorType

logger = logging.getLogger("estimator")


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
    pad: Optional[int] = None,
    interpod: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (req [P,R], masks [G,P], allocs [G,R]): the ONE packed-array build
    shared by the device rungs and the host rungs, so the packing schema
    cannot diverge between rungs. ``pad`` bucket-pads the pod axis for the
    device rungs (None: the exact pod count). interpod=False leaves
    inter-pod affinity to the dynamic scan."""
    P = pad if pad is not None else len(pods)
    ext = _estimation_schema(pods)
    req = _pack_pods(pods, P, ext)
    masks = np.stack(
        [template_mask(pods, templates[g], P, interpod=interpod) for g in names]
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


def plain_gate(device: torch.device, planes: int, max_nodes: int):
    """The cuda rung's gate on the plain per-pod route, on the shapes alone
    (as the JAX package's ``pallas_gate``): None when K1/K2 can serve, else
    (reason, detail) — ``not_cuda`` off a CUDA device, ``smem`` when the
    carry of ``planes`` kernel planes (fixed by ``ffd_scan.plan_scan``)
    over ``max_nodes`` nodes asks for more shared memory than a block may
    use. Reading the shared memory loads (and at first use builds) the
    kernel library."""
    detail = f"cap={max_nodes} planes={planes}"
    if device.type != "cuda":
        return ("not_cuda", detail)
    smem = ffd_scan.smem_bytes(planes, max_nodes)
    if smem > ffd_scan.SMEM_PER_BLOCK:
        return ("smem", f"{detail} smem={smem}B budget={ffd_scan.SMEM_PER_BLOCK}B")
    return None


def affinity_gate(device: torch.device, R: int, T: int, S: int, max_nodes: int):
    """The cuda rung's gate on the per-pod dynamic route, on the shapes
    alone: None when K3 can serve, else (reason, detail) — ``not_cuda`` off
    a CUDA device, ``spread_width`` when the spread terms overflow K3's
    bitset (S > 32; S = 0 when no pod declares one), ``smem`` when K3's
    carry asks for more shared memory than a block may use."""
    TP = max((T + 31) // 32, 1)
    detail = f"T={T} planes={TP} S={S} cap={max_nodes} R={R}"
    if device.type != "cuda":
        return ("not_cuda", detail)
    if S > ffd_scan_affinity.MAX_SPREAD:
        return ("spread_width", detail)
    smem = ffd_scan_affinity.affinity_smem_bytes(R, TP, S, max_nodes)
    if smem > ffd_scan.SMEM_PER_BLOCK:
        return ("smem", f"{detail} smem={smem}B budget={ffd_scan.SMEM_PER_BLOCK}B")
    return None


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
    device rungs run on ``device`` (None = the first CUDA card; raises
    without one unless ``device="cpu"``).

    ``metrics``: an AutoscalerMetrics (None = no recording). ``ladder``: the
    circuit-broken rung state (None = a private ``KernelLadder``).
    ``observatory``: a ``perf.PerfObservatory`` (None = a private one
    without metrics). ``operand_arena``: an ``OperandArena`` that keeps the
    operands resident across calls (None = plain uploads)."""

    def __init__(
        self,
        limiter: Optional[ThresholdBasedEstimationLimiter] = None,
        metrics=None,
        ladder: Optional[KernelLadder] = None,
        observatory=None,
        operand_arena=None,
        fleet_client=None,
        device=None,
    ):
        # the fleet-coalesced lane: plain packed estimates go to a SHARED
        # coalescer's admission queue (gym/env.FleetEstimatorClient)
        self.fleet_client = fleet_client
        self.limiter = limiter or ThresholdBasedEstimationLimiter()
        self.device = resolve_device(device)
        self.metrics = metrics
        self.ladder = ladder or KernelLadder()
        self.ladder.bind_metrics(metrics)
        self.operand_arena = operand_arena
        # the one implementation of the compile-vs-execute split; a bare
        # estimator gets a private metrics-less observatory, StaticAutoscaler
        # threads in its own (ringed, /perfz-served)
        self.observatory = observatory or PerfObservatory(
            metrics=metrics, peak_flops=default_peak_flops(self.device)
        )
        # decision provenance: the last estimate's constraint attribution,
        # read by the orchestrator into ScaleUpResult.estimator_explain. The
        # array-building sites park their numpy operands in _explain_scratch
        # (a device rung that serves adds its device operands and verdict
        # under "dev"); _finish_explain turns them into reason codes.
        self.last_explain: Dict = {"groups": {}, "pod_reasons": {}}
        self._explain_scratch: Optional[Dict] = None

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        """One operand on the estimator's device: the operand arena's
        resident copy when one is attached, else a plain copy (never an
        alias of ``arr``)."""
        if self.operand_arena is not None:
            return self.operand_arena.resident(arr, self.device)
        return torch.tensor(arr, device=self.device)

    # -- the single-template entry -------------------------------------------
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
        with trace.span(
            metrics_mod.ESTIMATE, metrics=self.metrics,
            single_template=True, pods=len(pods),
        ) as sp:
            count, scheduled = self._estimate_inner(
                pods, template, max_size_headroom, cluster
            )
            self._finish_explain(pods, {"template": (count, scheduled)}, span=sp)
            return count, scheduled

    def _estimate_inner(self, pods, template, max_size_headroom, cluster):
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
        alloc = alloc2d[0]
        scratch = self._explain_scratch = {
            "kind": "pods", "names": ["template"], "req": req,
            "masks": mask[None, :], "allocs": alloc2d,
            "involved": np.zeros((P,), bool),
        }
        cap = self.limiter.node_cap(max_size_headroom)
        max_nodes = bucket_size(cap, minimum=8)
        if dynamic:
            terms = build_affinity_terms(
                pods, [template], pad_pods=P, bucket_terms=True,
                volume_components=vol_comps,
            )
            sp = build_spread_terms(
                pods, [template], pad_pods=P, bucket_terms=True, cluster=cluster
            )
            has_spread = bool(sp.sp_of.any())
            scratch["involved"] = _involved(terms, sp)

            def torch_fn():
                req_t = self._tensor(req)
                masks_t = self._tensor(mask[None, :])
                allocs_t = self._tensor(alloc2d)
                res = ffd_binpack_groups_affinity(
                    req_t, masks_t, allocs_t,
                    max_nodes=max_nodes,
                    match=self._tensor(terms.match),
                    aff_of=self._tensor(terms.aff_of),
                    anti_of=self._tensor(terms.anti_of),
                    node_level=self._tensor(terms.node_level),
                    has_label=self._tensor(terms.has_label),
                    node_caps=self._tensor(np.array([cap], np.int32)),
                    spread=_spread_tuple(sp, conv=self._tensor),
                )
                # the fetch inside the rung's try: an asynchronous device
                # fault surfaces here, on the ladder
                out = int(res.node_count.cpu()[0]), res.scheduled[0].cpu().numpy()
                scratch["dev"] = {
                    "req": req_t, "masks": masks_t, "allocs": allocs_t,
                    "scheduled": res.scheduled,
                }
                return out

            def host_fn(native: bool):
                return lambda: self._host_one_affinity(
                    req, mask, alloc, cap, terms, group_index=0, native=native,
                )

            steps = [
                (RUNG_TORCH, "torch_scan", None, torch_fn),
                (RUNG_NATIVE, "native",
                 self._host_gate(spread_active=has_spread, need_native=True),
                 host_fn(True)),
                (RUNG_PYTHON, "python_ref",
                 self._host_gate(spread_active=has_spread), host_fn(False)),
            ]
        else:
            def torch_fn():
                req_t = self._tensor(req)
                mask_t = self._tensor(mask)
                alloc_t = self._tensor(alloc)
                res = ffd_binpack(
                    req_t, mask_t, alloc_t,
                    max_nodes=max_nodes,
                    node_cap=torch.tensor(cap, dtype=torch.int32, device=self.device),
                )
                out = int(res.node_count.cpu()), res.scheduled.cpu().numpy()
                scratch["dev"] = {
                    "req": req_t, "masks": mask_t[None, :], "allocs": alloc_t[None, :],
                    "scheduled": res.scheduled[None, :],
                }
                return out

            def host_fn(native: bool):
                return lambda: self._host_one_plain(req, mask, alloc, cap, native=native)

            steps = [
                (RUNG_TORCH, "torch_single", None, torch_fn),
                (RUNG_NATIVE, "native", self._host_gate(need_native=True), host_fn(True)),
                (RUNG_PYTHON, "python_ref", None, host_fn(False)),
            ]
        count, scheduled_mask = self._walk_ladder(
            steps, initial_reason="single_template", forced=(steps[0][1], torch_fn),
        )
        return count, [p for i, p in enumerate(pods) if scheduled_mask[i]]

    # -- every group at once -------------------------------------------------
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
        # timeline clock, not the wall: under a synthetic clock the elapsed
        # value — and the over-budget branch below — replay alike
        t0 = trace.timeline_now()
        with trace.span(
            metrics_mod.ESTIMATE, metrics=self.metrics,
            pods=len(pods), groups=len(templates),
        ) as sp_est:
            oa_before = (
                self.operand_arena.stats() if self.operand_arena is not None else None
            )
            result = self._estimate_many_inner(
                pods, templates, headrooms, pod_groups, cluster
            )
            if oa_before is not None:
                # resident-operand reuse rides the estimate span
                oa_after = self.operand_arena.stats()
                sp_est.set_attrs(
                    operand_hits=oa_after["hits"] - oa_before["hits"],
                    operand_misses=oa_after["misses"] - oa_before["misses"],
                )
            self._finish_explain(pods, result, span=sp_est)
        elapsed = trace.timeline_now() - t0
        # the reference budgets max_duration_s PER GROUP; the batched
        # dispatch covers every group at once, so the budget is per-group ×
        # groups. Exceeding it is counted and logged, not an abort.
        budget = self.limiter.max_duration_s * len(templates)
        over = self.limiter.max_duration_s > 0 and elapsed > budget
        if self.metrics is not None and over:
            self.metrics.estimation_over_budget_total.inc()
        if over:
            logger.warning(
                "binpacking dispatch took %.2fs for %d groups — over the "
                "%.1fs budget (--max-nodegroup-binpacking-duration)",
                elapsed, len(templates), budget,
            )
        return result

    def _dedup_skip(self):
        """The cuda rung's pseudo-gate on the run-compressed routes: the
        recorded reason is 'dedup' (routing), and the third element marks
        whether the rung is ALSO host-level unexercisable — off a CUDA
        device a half-open probe landing on a dedup dispatch must still
        resolve the breaker closed (the rung can never fault here), while
        on a card it is released unresolved."""
        return ("dedup", "", self.device.type != "cuda")

    def estimate_preemption(
        self,
        tensors,
        pod_evictable: np.ndarray,
        pod_valid: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, str]:
        """Priority-aware eviction packing of a snapshot's pending pods onto
        its EXISTING nodes (``ops/preempt.ffd_binpack_preempt``) →
        (scheduled [P] bool, placed_node [P] i32, victim_of [P] i32, route).

        ``tensors`` is a SnapshotTensors carrying the preemption channels
        (pod_priority/pod_preempt); ``pod_evictable`` is the host-side
        victim-eligibility mask (preempt/policy.py). The dispatch walks the
        ladder: the cuda rung has no twin (the automatic ``unsupported``
        skip), the torch loop serves on the estimator's device (route
        ``torch_preempt``; on a card its faults raise), and the serial
        oracle is the Python rung. The loop reads the predicate mask a
        chunk of rows at a time (``SchedRows``): the dense [P, N] mask is
        never built on the device. The serving route is returned so the
        decision record carries each eviction's provenance.

        ``pod_valid`` optionally overrides the snapshot's validity rows —
        the engine masks out pending rows the control loop already settled
        elsewhere (expendable drops, filter-out-schedulable absorptions)
        without repacking the snapshot."""
        prio = tensors.pod_priority
        preempt = tensors.pod_preempt
        if prio is None or preempt is None:
            # snapshot packed without the channels: a priority-flat world,
            # nothing may evict
            P = tensors.num_pods
            prio = torch.zeros((P,), dtype=torch.int32, device=tensors.device)
            preempt = torch.zeros((P,), dtype=torch.bool, device=tensors.device)
        evictable = np.asarray(pod_evictable, bool)
        if pod_valid is None:
            valid = tensors.pod_valid
        else:
            valid = self._tensor(np.asarray(pod_valid, bool))
        served = {}

        def mark(label, fn):
            def run():
                out = fn()
                served["route"] = label
                return out
            return run

        def torch_fn():
            res = ffd_binpack_preempt(
                tensors.pod_req, valid, tensors.pod_node, prio, preempt,
                self._tensor(evictable), tensors.node_alloc, tensors.node_used,
                tensors.node_valid, SchedRows(tensors),
            )
            return tuple(x.cpu().numpy() for x in res)

        def python_fn():
            def host(t):
                return t.cpu().numpy()

            return ffd_binpack_preempt_reference(
                host(tensors.pod_req), host(valid), host(tensors.pod_node),
                host(prio), host(preempt), evictable,
                host(tensors.node_alloc), host(tensors.node_used),
                host(tensors.node_valid), host(tensors.dense_sched()),
            )

        with trace.span(
            metrics_mod.PREEMPT_PLAN, metrics=self.metrics,
            pods=tensors.num_pods, nodes=tensors.num_nodes,
        ):
            scheduled, placed, victim_of = self._walk_ladder(
                [
                    (RUNG_CUDA, "cuda_preempt", None, None),
                    (RUNG_TORCH, "torch_preempt", None,
                     mark("torch_preempt", torch_fn)),
                    (RUNG_PYTHON, "python_preempt_ref", None,
                     mark("python_preempt_ref", python_fn)),
                ],
                initial_reason="preempt",
                forced=("python_preempt_ref",
                        mark("python_preempt_ref", python_fn)),
            )
        return scheduled, placed, victim_of, served.get("route", "unknown")

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
        if self.fleet_client is not None and not dynamic:
            # fleet-coalesced lane: run compression is skipped (the
            # batched kernel has no runs twin); per-group verdicts are
            # identical. A fleet failure falls back to the solo walk below.
            out = self._fleet_estimate(pods, names, templates, caps)
            if out is not None:
                return out
        if not dynamic:
            if len(groups) * 2 <= len(pods):
                return self._walk_ladder([
                    (RUNG_CUDA, "cuda", self._dedup_skip, None),
                    (RUNG_TORCH, "torch_runs", None,
                     lambda: self._estimate_many_runs(groups, names, templates, caps)),
                    (RUNG_NATIVE, "native", self._host_gate(need_native=True),
                     lambda: self._host_groups_plain(pods, names, templates, caps, True)),
                    (RUNG_PYTHON, "python_ref", None,
                     lambda: self._host_groups_plain(pods, names, templates, caps, False)),
                ])
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
                has_spread = bool(group_sp.sp_of.any())

                def runs_aff_fn():
                    return self._estimate_many_runs_affinity(
                        runs, group_terms, group_of_run, run_inv, names, templates,
                        caps, group_sp,
                    )

                return self._walk_ladder([
                    (RUNG_CUDA, "cuda", self._dedup_skip, None),
                    (RUNG_TORCH, "torch_runs", None, runs_aff_fn),
                    (RUNG_NATIVE, "native",
                     self._host_gate(spread_active=has_spread, need_native=True),
                     lambda: self._host_groups_affinity(pods, names, templates, caps, True)),
                    (RUNG_PYTHON, "python_ref",
                     self._host_gate(spread_active=has_spread),
                     lambda: self._host_groups_affinity(pods, names, templates, caps, False)),
                ], forced=("torch_runs", runs_aff_fn))
        P = bucket_size(len(pods))
        req, masks, allocs = _build_group_arrays(
            pods, names, templates, pad=P, interpod=not dynamic
        )
        self._explain_scratch = {
            "kind": "pods", "names": names, "req": req, "masks": masks,
            "allocs": allocs, "involved": np.zeros((P,), bool),
        }
        scan_cap = bucket_size(int(caps.max()), minimum=8)
        if dynamic:
            return self._estimate_many_dynamic(
                pods, names, templates, req, masks, allocs, caps, scan_cap,
                vol_comps, cluster,
            )
        return self._estimate_many_plain(pods, names, req, masks, allocs, caps, scan_cap)

    def _assemble(self, pods, names, res, dev_ops) -> Dict[str, Tuple[int, List[Pod]]]:
        """A device rung's result → {group: (count, scheduled pods)}. The
        host fetch runs INSIDE the serving rung's try: CUDA errors surface
        at the next synchronization, and they must land on the ladder, not
        the caller. Parks the rung's device operands and verdict for the
        attribution."""
        counts = res.node_count.cpu().numpy()
        scheds = res.scheduled.cpu().numpy()
        self._explain_scratch["dev"] = {**dev_ops, "scheduled": res.scheduled}
        return {
            g: (int(counts[gi]), [p for i, p in enumerate(pods) if scheds[gi, i]])
            for gi, g in enumerate(names)
        }

    def _estimate_many_plain(self, pods, names, req, masks, allocs, caps, scan_cap):
        """The plain per-pod route: K1/K2 (the cuda rung) when the glue's
        host probe fixes a carry that fits a block, else the torch loop.
        The operands are uploaded once, at the first device rung that
        engages, inside its try."""
        uploaded: Dict[str, torch.Tensor] = {}

        def operands():
            if not uploaded:
                req_t, masks_t, allocs_t, caps_t = ffd_scan.operands_from_numpy(
                    req, masks, allocs, caps, self.device, upload=self._tensor
                )
                uploaded.update(req=req_t, masks=masks_t, allocs=allocs_t, caps=caps_t)
            return uploaded

        planned = {}

        def cuda_gate():
            ops = operands()
            planned["plan"] = ffd_scan.plan_scan(ops["req"], ops["allocs"])
            return plain_gate(self.device, planned["plan"].planes, scan_cap)

        def dev_ops(ops):
            return {
                "req": ops["req"], "masks": ops["masks"], "allocs": ops["allocs"],
                "involved": torch.zeros(req.shape[0], dtype=torch.bool, device=self.device),
            }

        def cuda_fn():
            ops = operands()
            res = ffd_scan.ffd_binpack_groups_cuda(
                ops["req"], ops["masks"], ops["allocs"], max_nodes=scan_cap,
                node_caps=ops["caps"], scan_plan=planned.get("plan"),
            )
            return self._assemble(pods, names, res, dev_ops(ops))

        def torch_fn():
            ops = operands()
            res = ffd_binpack_groups(
                ops["req"], ops["masks"], ops["allocs"], max_nodes=scan_cap,
                node_caps=ops["caps"],
            )
            return self._assemble(pods, names, res, dev_ops(ops))

        return self._walk_ladder([
            (RUNG_CUDA, "cuda", cuda_gate, cuda_fn),
            (RUNG_TORCH, "torch_scan", None, torch_fn),
            (RUNG_NATIVE, "native", self._host_gate(need_native=True),
             lambda: self._host_plain_from_arrays(
                 pods, names, req, masks, allocs, caps, native=True)),
            (RUNG_PYTHON, "python_ref", None,
             lambda: self._host_plain_from_arrays(
                 pods, names, req, masks, allocs, caps, native=False)),
        ], forced=("torch_scan", torch_fn))

    def _estimate_many_dynamic(
        self, pods, names, templates, req, masks, allocs, caps, scan_cap,
        vol_comps, cluster,
    ):
        """The per-pod dynamic route: term and spread tensors, then K3 (the
        cuda rung) behind its shape gate, the torch loop, and the host
        rungs (not for spread worlds)."""
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
        involved = _involved(terms, sp)
        self._explain_scratch["involved"] = involved
        uploaded: Dict[str, object] = {}

        def operands(with_spread: bool) -> dict:
            """The kernel operands on the device, uploaded once (the
            spread tuple at the first rung that reads it)."""
            if "base" not in uploaded:
                uploaded["base"] = ffd_scan_affinity.affinity_operands_from_numpy(
                    req, masks, allocs, terms.match, terms.aff_of, terms.anti_of,
                    terms.node_level, terms.has_label, caps,
                    device=self.device, upload=self._tensor,
                )
            ops = dict(uploaded["base"])
            if with_spread:
                if "spread" not in uploaded:
                    uploaded["spread"] = tuple(
                        self._tensor(np.asarray(a, dt))
                        for a, dt in zip(spread, ffd_scan_affinity.SPREAD_DTYPES)
                    )
                ops["spread"] = uploaded["spread"]
            return ops

        def dev_ops(ops):
            return {
                "req": ops["pod_req"], "masks": ops["pod_masks"],
                "allocs": ops["template_allocs"],
                # a plain upload: the attribution's own operand, which the
                # operand arena does not keep (as the JAX package's)
                "involved": torch.tensor(involved, device=self.device),
            }

        def cuda_gate():
            return affinity_gate(
                self.device, req.shape[1], terms.match.shape[0],
                sp.num_terms if has_spread else 0, scan_cap,
            )

        def cuda_fn():
            ops = operands(with_spread=has_spread)
            res = ffd_scan_affinity.ffd_binpack_groups_affinity_cuda(
                **ops, max_nodes=scan_cap
            )
            return self._assemble(pods, names, res, dev_ops(ops))

        def torch_fn():
            ops = operands(with_spread=True)
            res = ffd_binpack_groups_affinity(
                ops["pod_req"], ops["pod_masks"], ops["template_allocs"],
                max_nodes=scan_cap, spread=ops["spread"], match=ops["match"],
                aff_of=ops["aff_of"], anti_of=ops["anti_of"],
                node_level=ops["node_level"], has_label=ops["has_label"],
                node_caps=ops["node_caps"],
            )
            return self._assemble(pods, names, res, dev_ops(ops))

        return self._walk_ladder([
            (RUNG_CUDA, "cuda_affinity", cuda_gate, cuda_fn),
            (RUNG_TORCH, "torch_scan", None, torch_fn),
            (RUNG_NATIVE, "native",
             self._host_gate(spread_active=has_spread, need_native=True),
             lambda: self._host_affinity_from_arrays(
                 pods, names, req, masks, allocs, caps, terms, native=True)),
            (RUNG_PYTHON, "python_ref",
             self._host_gate(spread_active=has_spread),
             lambda: self._host_affinity_from_arrays(
                 pods, names, req, masks, allocs, caps, terms, native=False)),
        ], forced=("torch_scan", torch_fn))

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
        members = [g.pods for g in groups]
        scratch = self._explain_scratch = {
            "kind": "runs", "names": names, "req": run_req, "masks": masks,
            "allocs": allocs, "counts": run_counts, "members": members,
            "involved": np.zeros((U,), bool),
        }
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
        out = _expand_run_result(res, members, names)
        scratch["dev"] = {
            "req": run_req_t, "masks": masks_t, "allocs": allocs_t, "counts": counts_t,
            "involved": torch.zeros(U, dtype=torch.bool, device=self.device),
            "placed": res.placed_counts,
        }
        return out

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
        inv = _involved(terms, spread)
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
        members = [m for _, m in runs]
        scratch = self._explain_scratch = {
            "kind": "runs", "names": names, "req": run_req, "masks": masks,
            "allocs": allocs, "counts": run_counts, "members": members,
            "involved": involved,
        }

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
        out = _expand_run_result(res, members, names)
        scratch["dev"] = {
            "req": run_req_t, "masks": masks_t, "allocs": allocs_t, "counts": counts_t,
            "involved": involved_t, "placed": res.placed_counts,
        }
        return out

    # -- the kernel ladder (utils/circuit.py + estimator/ladder.py) ----------
    # -- the fleet-coalesced lane -----------------------------------------------
    def _fleet_estimate(
        self, pods, names, templates, caps
    ) -> Optional[Dict[str, Tuple[int, List[Pod]]]]:
        """One plain batched estimate through the shared fleet coalescer:
        submit the packed operands as a FleetRequest, block for the
        demuxed answer. Returns None on a fleet failure (admission,
        overload, deadline or drain; a coalescer that never answers) so
        the solo ladder keeps deciding. On a CUDA device a batch failed
        by the card's rung (a FleetError that is not an admission error)
        is a kernel fault, and raises."""
        from autoscaler_tpu_torch.fleet.errors import FleetAdmissionError, FleetError

        P = bucket_size(len(pods))
        try:
            req, masks, allocs = _build_group_arrays(
                pods, names, templates, interpod=True, pad=P
            )
            self._explain_scratch = {
                "kind": "pods", "names": list(names), "req": req,
                "masks": masks, "allocs": allocs,
                "involved": np.zeros((P,), bool),
            }
            max_nodes = int(caps.max()) if len(caps) else 0
            with trace.span(
                metrics_mod.FLEET_DISPATCH, metrics=self.metrics,
                rung="coalesced", pods=len(pods), groups=len(names),
            ) as sp:
                counts, scheduled = self.fleet_client.estimate_groups(
                    req, masks, allocs, caps, max_nodes
                )
                sp.set_attrs(outcome="ok", route="fleet_coalesced")
        except Exception as e:  # noqa: BLE001 — degrade to the solo ladder
            if (
                self.device.type == "cuda"
                and isinstance(e, FleetError)
                and not isinstance(e, FleetAdmissionError)
            ):
                raise
            logger.warning(
                "fleet-coalesced estimate failed; falling back to the "
                "solo kernel ladder", exc_info=True,
            )
            self._explain_scratch = None
            return None
        self._note_route("fleet_coalesced", "ok")
        counts = np.asarray(counts)
        scheduled = np.asarray(scheduled)
        return {
            g: (
                int(counts[gi]),
                [p for i, p in enumerate(pods) if scheduled[gi, i]],
            )
            for gi, g in enumerate(names)
        }

    def _note_route(self, route: str, reason: str, detail: str = "") -> None:
        """Record which route served a dispatch (the metric always; one log
        line when a dispatch lost its kernel to a real cliff — smem,
        spread_width, a fault — so a fast path lost to a shape stays
        visible)."""
        if self.metrics is not None:
            self.metrics.estimator_kernel_route_total.inc(route=route, reason=reason)
        if reason in ("smem", "spread_width", "kernel_fault", "device_lost"):
            logger.info(
                "estimator dispatch fell back to %s (%s)%s",
                route, reason, f": {detail}" if detail else "",
            )

    def _walk_ladder(self, steps, initial_reason: str = "ok", forced=None):
        """Walk one dispatch down the kernel ladder.

        ``steps`` is an ordered list of ``(rung, route_label, gate, fn)``:
        ``gate()`` returns None when the rung can serve this dispatch, else
        ``(reason, detail[, host_level])`` — an environmental skip that
        leaves the rung's breaker closed; ``fn()`` computes the result
        (raising records a breaker failure). A rung whose breaker is OPEN is
        skipped outright until its cooldown admits a half-open probe. The
        serving rung's route metric carries the most recent skip or failure
        reason, so cuda→torch→native transitions are visible per dispatch.

        On a CUDA device the device rungs (cuda, torch) are strict when
        they have a ``fn`` (not the dedup pseudo-step): their faults are
        recorded and raised, and an open breaker raises, so a broken card
        rung fails the tick instead of being served below it or on the
        host. The torch rung is reached on a card only where the cuda rung
        was routed around (a shape gate, dedup, no twin).

        ``forced`` = (label, fn) runs off a CUDA device when every rung was
        skipped or failed (e.g. a topology-spread dispatch, which no host
        rung supports, with the device rungs broken): the breaker is
        bypassed and exceptions propagate to the crash-only control loop.

        Every rung engagement is one ``deviceDispatch`` span (attributes:
        rung, outcome, reason), siblings under the ``estimate`` span."""
        on_card = self.device.type == "cuda"
        reason, detail = initial_reason, ""
        for rung, label, gate, fn in steps:
            strict = on_card and rung in (RUNG_CUDA, RUNG_TORCH) and fn is not None
            then = "raising" if strict else "descending the ladder"
            with trace.span(
                metrics_mod.DEVICE_DISPATCH, metrics=self.metrics, rung=rung
            ) as sp:
                engaged = self.ladder.begin(rung)
                if engaged == "breaker_open":
                    reason, detail = "breaker_open", f"{rung} rung breaker open"
                    sp.set_attrs(outcome="skipped", reason="breaker_open")
                    if strict:
                        raise AutoscalerError(
                            ErrorType.INTERNAL,
                            f"the {rung} rung's breaker is open after kernel faults; "
                            "on a CUDA device the card's rung has no fallback",
                        )
                    continue
                if engaged is not None:  # an injected device-fault kind
                    logger.warning(
                        "%s kernel rung failed (injected %s); %s", rung, engaged, then,
                    )
                    reason, detail = engaged, f"injected {engaged} on {rung} rung"
                    sp.set_attrs(outcome="fault", reason=engaged)
                    if strict:
                        raise AutoscalerError(ErrorType.INTERNAL, detail)
                    continue
                try:
                    skip = gate() if gate is not None else None
                except Exception:  # noqa: BLE001 — a raising gate (a failed
                    # kernel build, a device fault while probing) is a rung
                    # failure: the begin() above MUST be resolved, or a held
                    # half-open probe slot would leak and wedge the rung
                    self.ladder.record_failure(rung)
                    logger.warning(
                        "%s rung availability gate raised; %s", rung, then,
                        exc_info=True,
                    )
                    reason, detail = "kernel_fault", f"{rung} gate raised"
                    sp.set_attrs(outcome="fault", reason="gate_raised")
                    if strict:
                        raise
                    continue
                if skip is None and fn is None:
                    skip = ("unsupported", f"{rung} rung has no twin for this dispatch")
                if skip is not None:
                    # a gate may append an explicit host-level flag (third
                    # element) when the recorded reason is dispatch-level
                    # routing but the rung is ALSO host-level unexercisable
                    host_level = (
                        skip[2] if len(skip) > 2 else skip[0] in HOST_LEVEL_SKIP_REASONS
                    )
                    reason, detail = skip[0], skip[1]
                    if host_level:
                        # static for this process: a probe landing here closes
                        # the breaker (the rung can never fault on this host)
                        self.ladder.record_unavailable(rung)
                    else:
                        # dispatch-level routing: release a held probe slot
                        # unresolved
                        self.ladder.record_skipped_dispatch(rung)
                    sp.set_attrs(outcome="unavailable", reason=reason)
                    continue
                try:
                    out = self._dispatch(label, fn, sp)
                except Exception:  # noqa: BLE001 — any kernel failure descends
                    # off the card, and raises on it (strict)
                    self.ladder.record_failure(rung)
                    logger.warning("%s kernel rung failed; %s", rung, then, exc_info=True)
                    reason, detail = "kernel_fault", f"{rung} kernel raised"
                    sp.set_attrs(outcome="fault", reason="kernel_raised")
                    if strict:
                        raise
                    continue
                self.ladder.record_success(rung)
                sp.set_attrs(outcome="ok", route=label, fallback_reason=reason)
                self._note_route(label, reason, detail)
                return out
        if forced is not None and not on_card:
            label, fn = forced
            logger.error(
                "every kernel rung skipped or failed (last: %s); forcing the "
                "%s dispatch despite its breaker", reason, label,
            )
            with trace.span(
                metrics_mod.DEVICE_DISPATCH, metrics=self.metrics,
                rung="forced", route=label,
            ) as sp:
                out = self._dispatch(label, fn, sp)
                sp.set_attrs(outcome="ok")
            self._note_route(label, "forced", detail)
            return out
        raise AutoscalerError(
            ErrorType.INTERNAL,
            f"no kernel rung could serve the dispatch (last: {reason})",
        )

    def _dispatch(self, label: str, fn, sp):
        """Run one rung under a ``device_annotation`` (a torch.profiler range) named
        after the route (the span's name on a captured profile; free when
        no profiler runs) and hand the dispatch to the perf observatory,
        which records the compile-vs-execute split per (route, shape
        signature) as span attributes. The kernel-entry observer seam
        (ops/telemetry.kernel_observer) hands the observatory the concrete
        call. The wall comes from ``trace.timeline_now()``, the tracer's
        injectable clock, so under a synthetic clock the attrs replay
        alike."""
        obs = self.observatory
        # a prior rung that faulted after its kernel entry was observed
        # must not leak its call onto this rung's record
        obs.clear_pending()
        t0 = trace.timeline_now()
        with kernel_observer(obs.note_kernel):
            with device_annotation(f"autoscaler/estimator/{label}"):
                out = fn()
        obs.on_dispatch(label, trace.timeline_now() - t0, span=sp)
        return out

    @staticmethod
    def _host_gate(spread_active: bool = False, need_native: bool = False):
        """Availability gate for the host rungs. Topology-spread counting
        has no host twin: spread dispatches bottom out at the torch rung.
        The affinity term factorization (incl. synthetic volume-conflict
        terms) IS supported on both host rungs."""
        def gate():
            if spread_active:
                return ("spread_unsupported", "host rungs lack topology-spread counting")
            if need_native and not native_bridge.available():
                return ("native_unavailable", str(native_bridge.build_error()))
            return None

        return gate

    def _host_plain_from_arrays(
        self, pods, names, req, masks, allocs, caps, native: bool
    ) -> Dict[str, Tuple[int, List[Pod]]]:
        """Host rungs, plain family: serial FFD per group over the SAME
        numpy arrays the device rungs upload (never a device tensor: after
        a device fault the context may be unusable). All rungs share the
        one FFD order spec, so the answer is rung-independent."""
        out: Dict[str, Tuple[int, List[Pod]]] = {}
        for gi, g in enumerate(names):
            count, sched = self._host_one_plain(
                req, masks[gi], allocs[gi], int(caps[gi]), native
            )
            out[g] = (count, [p for i, p in enumerate(pods) if sched[i]])
        return out

    def _host_affinity_from_arrays(
        self, pods, names, req, masks, allocs, caps, terms, native: bool
    ) -> Dict[str, Tuple[int, List[Pod]]]:
        """Host rungs, affinity family (term factorization; spread gated
        upstream by _host_gate)."""
        out: Dict[str, Tuple[int, List[Pod]]] = {}
        for gi, g in enumerate(names):
            count, sched = self._host_one_affinity(
                req, masks[gi], allocs[gi], int(caps[gi]), terms,
                group_index=gi, native=native,
            )
            out[g] = (count, [p for i, p in enumerate(pods) if sched[i]])
        return out

    def _host_groups_plain(
        self, pods, names, templates, caps, native: bool
    ) -> Dict[str, Tuple[int, List[Pod]]]:
        """Per-pod array build for the host rungs when the dispatch had
        chosen run compression: built lazily so the healthy path never
        pays the P-sized packing twice."""
        req, masks, allocs = _build_group_arrays(pods, names, templates)
        self._explain_scratch = {
            "kind": "pods", "names": list(names), "req": req, "masks": masks,
            "allocs": allocs, "involved": np.zeros((len(pods),), bool),
        }
        return self._host_plain_from_arrays(pods, names, req, masks, allocs, caps, native)

    def _host_groups_affinity(
        self, pods, names, templates, caps, native: bool
    ) -> Dict[str, Tuple[int, List[Pod]]]:
        req, masks, allocs = _build_group_arrays(pods, names, templates, interpod=False)
        terms = build_affinity_terms(
            pods, [templates[g] for g in names], pad_pods=len(pods),
            volume_components=(),  # the runs-affinity route excludes conflicts
        )
        self._explain_scratch = {
            "kind": "pods", "names": list(names), "req": req, "masks": masks,
            "allocs": allocs,
            "involved": (terms.match | terms.aff_of | terms.anti_of).any(axis=0),
        }
        return self._host_affinity_from_arrays(
            pods, names, req, masks, allocs, caps, terms, native
        )

    @staticmethod
    def _host_one_plain(req, mask, alloc, cap, native: bool):
        """One template on a host rung → (count, scheduled mask)."""
        if native:
            count, sched = native_bridge.ffd_binpack_native(
                req, mask, alloc, int(cap), cpu_axis=CPU, mem_axis=MEMORY
            )
        else:
            count, sched = ffd_binpack_reference(req, mask, alloc, int(cap))
        return int(count), sched

    @staticmethod
    def _host_one_affinity(req, mask, alloc, cap, terms, group_index: int, native: bool):
        hl = terms.has_label[group_index]
        if native:
            count, sched = native_bridge.ffd_binpack_affinity_native(
                req, mask, alloc, int(cap), terms.match, terms.aff_of, terms.anti_of,
                terms.node_level, hl, cpu_axis=CPU, mem_axis=MEMORY,
            )
        else:
            count, sched = ffd_binpack_reference_affinity(
                req, mask, alloc, int(cap), terms.match, terms.aff_of, terms.anti_of,
                terms.node_level, hl,
            )
        return int(count), sched

    # -- decision provenance (explain/) ---------------------------------------
    def _finish_explain(self, pods, result, span=None) -> None:
        """Turn the serving rung's parked operands and verdict into
        ``last_explain``: per-group fit counts with rejection-reason
        histograms, and each pod's dominant reason (the closest it came to
        scheduling anywhere). Rung-independent — the packed arrays are the
        same whichever rung served — and a pure function of them, so the
        DecisionRecord built from it is the JAX package's."""
        scratch, self._explain_scratch = self._explain_scratch, None
        if scratch is None or not pods:
            self.last_explain = {"groups": {}, "pod_reasons": {}}
            return
        try:
            hist, dom = self._attribution_device(scratch, pods, result)
        except Exception:  # noqa: BLE001 — attribution is observability: it
            # must never take down a decision the ladder already salvaged
            logger.warning(
                "attribution kernel failed; using the serial oracle twin",
                exc_info=True,
            )
            hist, dom = self._attribution_host(scratch, pods, result)
        if scratch["kind"] == "runs":
            pod_reasons = {
                p.key(): reason_name(int(dom[u]))
                for u, members in enumerate(scratch["members"]) for p in members
            }
        else:
            pod_reasons = {p.key(): reason_name(int(dom[i])) for i, p in enumerate(pods)}
        groups: Dict[str, Dict] = {}
        for gi, g in enumerate(scratch["names"]):
            count, sched = result.get(g, (0, []))
            groups[g] = {
                "fit_nodes": int(count),
                "scheduled": len(sched),
                "reasons": reason_histogram(hist[gi]),
            }
        self.last_explain = {"groups": groups, "pod_reasons": pod_reasons}
        if span is not None:
            totals: Dict[str, int] = {}
            for verdict in groups.values():
                for rname, count in verdict["reasons"].items():
                    totals[rname] = totals.get(rname, 0) + count
            if totals:
                top = sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))[0]
                span.set_attrs(
                    explain_top_rejection=f"{top[0]}={top[1]}",
                    explain_rejections=sum(totals.values()),
                )

    def _attribution_device(self, scratch, pods, result):
        """(hist [G, NUM_REASONS], dominant [P]) as numpy: one batched pass
        on the estimator's device over the serving device rung's operands
        and verdict (plain uploads of the numpy ones when a host rung
        served; the operand arena keeps only the kernels' operands), then
        two small fetches. Run routes: a run counts as scheduled when
        every member placed, and the histogram weights are the unplaced
        member counts ('memory=40' means forty pods); pod routes: padding
        rows count as unplaced with zero weight."""
        dev = scratch.get("dev", {})

        def upload(arr):
            return torch.tensor(arr, device=self.device)

        def operand(key):
            return dev[key] if key in dev else upload(scratch[key])

        if scratch["kind"] == "runs":
            counts = operand("counts")[None, :]
            placed = dev["placed"] if "placed" in dev else upload(_run_placed(scratch, result))
            placed = torch.minimum(placed, counts)
            weights = (counts - placed).clamp(min=0).to(torch.int32)
            scheduled = placed >= counts
        else:
            sched = (dev["scheduled"] if "scheduled" in dev
                     else upload(_pod_verdict(scratch, pods, result)))
            G, P_pad = sched.shape
            valid = torch.arange(P_pad, device=sched.device) < len(pods)
            weights = valid.to(torch.int32).expand(G, P_pad)
            scheduled = sched & valid
        reasons = attribute_unschedulable(
            operand("req"), operand("masks"), operand("allocs"), scheduled,
            operand("involved"),
        )
        hist, dom = attribution_summary(reasons, weights)
        return hist.cpu().numpy(), dom.cpu().numpy()

    @staticmethod
    def _attribution_host(scratch, pods, result):
        """The serial oracle twin of ``_attribution_device`` on the numpy
        operands, the verdict rebuilt from the result on the host (no
        device tensor is read)."""
        if scratch["kind"] == "runs":
            counts = np.asarray(scratch["counts"], np.int64)[None, :]
            placed = _run_placed(scratch, result)
            scheduled = placed >= counts     # pad slots: 0 >= 0 → inert
            weights = np.maximum(counts - placed, 0).astype(np.int32)
        else:
            scheduled = _pod_verdict(scratch, pods, result)
            weights = np.zeros(scheduled.shape, np.int32)
            weights[:, : len(pods)] = 1
        reasons = attribute_unschedulable_reference(
            scratch["req"], scratch["masks"], scratch["allocs"], scheduled,
            scratch["involved"],
        )
        hist = np.stack(
            [np.sum(np.where(reasons == code, weights, 0), axis=1)
             for code in range(NUM_REASONS)],
            axis=1,
        )
        return hist, reasons.min(axis=0)


def _pod_verdict(scratch, pods, result) -> np.ndarray:
    """[G, P_pad] bool — the scheduled matrix of a pod route, rebuilt from
    the result's lists by object identity."""
    idx_of = {id(p): i for i, p in enumerate(pods)}
    scheduled = np.zeros((len(scratch["names"]), scratch["req"].shape[0]), bool)
    for gi, g in enumerate(scratch["names"]):
        for p in result.get(g, (0, []))[1]:
            i = idx_of.get(id(p))
            if i is not None:
                scheduled[gi, i] = True
    return scheduled


def _run_placed(scratch, result) -> np.ndarray:
    """[G, U_pad] i32 — members placed per run, rebuilt from the result's
    lists by object identity."""
    run_of = {id(p): u for u, mem in enumerate(scratch["members"]) for p in mem}
    placed = np.zeros((len(scratch["names"]), scratch["req"].shape[0]), np.int32)
    for gi, g in enumerate(scratch["names"]):
        for p in result.get(g, (0, []))[1]:
            u = run_of.get(id(p))
            if u is not None:
                placed[gi, u] += 1
    return placed


def _involved(terms, sp) -> np.ndarray:
    """[P] bool — the pod matches a term's selector, holds a required
    (anti-)affinity term or a hard spread constraint, or is counted by one."""
    return (
        (terms.match | terms.aff_of | terms.anti_of).any(axis=0)
        | (sp.sp_of | sp.sp_match).any(axis=0)
    )


def _expand_run_result(res, members: List[List[Pod]], names: List[str]):
    """A run scan's result → {group: (node_count, scheduled pods)}: 'k of
    this run placed' expands to the run's first k member pods. The host
    fetch runs inside the serving rung's try."""
    counts = res.node_count.cpu().numpy()
    placed = res.placed_counts.cpu().numpy()
    out: Dict[str, Tuple[int, List[Pod]]] = {}
    for gi, g in enumerate(names):
        sched: List[Pod] = []
        for ui, run_members in enumerate(members):
            sched.extend(run_members[: placed[gi, ui]])
        out[g] = (int(counts[gi]), sched)
    return out
