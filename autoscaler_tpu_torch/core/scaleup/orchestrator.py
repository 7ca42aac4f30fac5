"""Scale-up orchestration: from pending pods to cloud IncreaseSize calls,
with all per-group estimation in one batched device dispatch (the port of
``autoscaler_tpu/core/scaleup/orchestrator.py``).

Reference: cluster-autoscaler/core/scaleup/orchestrator/orchestrator.go —
ScaleUp :81, ComputeExpansionOption :444, ExecuteScaleUps :550,
GetCappedNewNodeCount :536, ScaleUpToNodeGroupMinSize :348. The reference
iterates node groups serially, forking the snapshot per group
(:139-179 + :455-484); here every viable group's (predicate mask, FFD
estimate) is computed in a single ffd_binpack_groups dispatch via
BinpackingNodeEstimator.estimate_many, and only the chosen option crosses
back into the (host-side, cloud-API) actuation boundary.

The estimate runs on ``device`` (None = the first CUDA card) through the
port's ``BinpackingNodeEstimator`` and its kernel ladder
(``--kernel-breaker-failure-threshold``, ``--kernel-breaker-cooldown``),
which takes its operands from ``operand_arena`` (a
``snapshot/arena.OperandArena``) when one is given and hands its
dispatches to ``observatory`` (a ``perf.PerfObservatory``). ``metrics=``
feeds ``created_node_groups_total`` and the estimator's route, rung and
breaker series; ``estimator_explain`` carries the estimator's constraint
attribution (``last_explain``). The expander chain takes the JAX package's
arguments: the live priority ConfigMap (``priorities_fetch``), the
priority file and the provider's pricing model, and the preemption churn
filter leads it when ``--preemption-churn-weight`` is above 0.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from autoscaler_tpu_torch.cloudprovider.interface import CloudProvider, NodeGroup
from autoscaler_tpu_torch.clusterstate.registry import ClusterStateRegistry
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.core.scaleup.equivalence import build_pod_groups
from autoscaler_tpu_torch.explain.reasons import SkipReason
from autoscaler_tpu_torch.snapshot.affinity import has_hard_spread
from autoscaler_tpu_torch.core.scaleup.resource_manager import ScaleUpResourceManager
from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
from autoscaler_tpu_torch.estimator.ladder import KernelLadder
from autoscaler_tpu_torch.estimator.limiter import ThresholdBasedEstimationLimiter
from autoscaler_tpu_torch.expander.core import (
    ChainStrategy,
    Option,
    PreemptionChurnFilter,
    Strategy,
    build_strategy,
)
from autoscaler_tpu_torch.kube.objects import Node, Pod
from autoscaler_tpu_torch.utils.errors import to_autoscaler_error


@dataclass
class ScaleUpResult:
    """reference: processors/status ScaleUpStatus."""

    scaled_up: bool = False
    chosen_group: Optional[str] = None
    new_nodes: int = 0
    extra_scale_ups: List[tuple] = field(default_factory=list)  # balancing
    # the ACTUAL executed (group, delta) list, first entry included: with
    # balancing the chosen group can receive zero nodes (balance_scale_up
    # grows the smallest similar group), so deriving the plan from
    # chosen_group + extra_scale_ups misattributes nodes — consumers that
    # record the plan (decision ledger, loadgen log) read this
    executed: List[tuple] = field(default_factory=list)
    pods_triggered: List[Pod] = field(default_factory=list)
    pods_remain_unschedulable: List[Pod] = field(default_factory=list)
    # closed SkipReason enum (explain/reasons.py), promoted from free-text
    # strings: the decision ledger and the scaleup_skipped_groups_total
    # gauge need a finite vocabulary (CA parity: skipped_scale_events_count)
    skipped_groups: Dict[str, SkipReason] = field(default_factory=dict)
    options_considered: int = 0
    error: Optional[str] = None
    # decision provenance (autoscaler_tpu/explain): the expander's full
    # scoring table (ALL candidates, not just the winner), the winning
    # score, and the estimator's constraint attribution for this pass
    expander_table: List[dict] = field(default_factory=list)
    chosen_score: Optional[float] = None
    estimator_explain: Dict = field(default_factory=dict)


class ScaleUpOrchestrator:
    def __init__(
        self,
        provider: CloudProvider,
        options: AutoscalingOptions,
        csr: ClusterStateRegistry,
        estimator: Optional[BinpackingNodeEstimator] = None,
        expander: Optional[Strategy] = None,
        balancing_processor=None,
        template_provider=None,
        node_group_list_processor=None,
        node_info_processor=None,
        binpacking_limiter=None,
        metrics=None,
        priorities_fetch=None,
        observatory=None,
        operand_arena=None,
        device=None,
    ):
        self.provider = provider
        self.options = options
        self.csr = csr
        if estimator is None:
            estimator = BinpackingNodeEstimator(
                limiter=ThresholdBasedEstimationLimiter(
                    max_nodes=options.max_nodes_per_scaleup,
                    max_duration_s=options.max_nodegroup_binpacking_duration_s,
                ),
                metrics=metrics,
                # circuit-broken degradation ladder around the kernel rungs
                ladder=KernelLadder(
                    failure_threshold=options.kernel_breaker_failure_threshold,
                    cooldown_s=options.kernel_breaker_cooldown_s,
                ),
                observatory=observatory,
                operand_arena=operand_arena,
                device=device,
            )
        self.estimator = estimator
        self.expander = expander or build_strategy(
            [n.strip() for n in options.expander.split(",") if n.strip()],
            seed=options.expander_random_seed,
            priorities=options.expander_priorities,
            priorities_path=options.priority_config_file or None,
            priorities_fetch=priorities_fetch,
            grpc_target=options.grpc_expander_url or None,
            rpc_deadline_s=options.rpc_default_deadline_s,
            rpc_failover_targets=options.rpc_addresses,
            rpc_hedge=options.rpc_hedge,
            # the price filter scores against the provider's pricing model
            # (expander/price/price.go); absent model → build_strategy
            # rejects the 'price' entry loudly
            pricing=provider.pricing(),
        )
        # eviction-churn penalty column (--preemption-churn-weight): leads
        # the chain so churn-heavy options are pruned before the tie-break
        # filters; run_once rebinds it to each tick's PreemptionPlan via the
        # scale_up preemption_churn seam. Weight 0 (default) builds nothing
        # — the option table stays byte-identical to pre-preemption ledgers.
        self.churn_filter = None
        if options.preemption_churn_weight > 0:
            self.churn_filter = PreemptionChurnFilter(options.preemption_churn_weight)
            if isinstance(self.expander, ChainStrategy):
                self.expander.filters.insert(0, self.churn_filter)
        self.resource_manager = ScaleUpResourceManager(provider.get_resource_limiter())
        self.balancing_processor = balancing_processor
        # TemplateNodeInfoProvider (processors/nodeinfos.py): prefer a
        # sanitized real node over the cloud's synthetic template
        self.template_provider = template_provider
        # NAP (reference orchestrator.go:124): may extend the candidate list
        # with not-yet-existing autoprovisioned groups
        self.node_group_list_processor = node_group_list_processor
        self.node_info_processor = node_info_processor
        self.binpacking_limiter = binpacking_limiter
        # feeds created_node_groups_total only: the estimator's metric
        # families wait for the kernel ladder
        self.metrics = metrics

    # -- main entry (reference orchestrator.go:81) ---------------------------
    def scale_up(
        self,
        pending_pods: Sequence[Pod],
        cluster_nodes: Sequence[Node],
        now_ts: float,
        pods_of_node=None,
        pending_daemonsets=(),
        preemption_churn=None,
    ) -> ScaleUpResult:
        if not pending_pods:
            return ScaleUpResult()
        # rebind the churn column to this tick's preemption plan (a
        # callable: covered pod keys → evictions left standing); None —
        # preemption off or nothing planned — disengages the filter so the
        # scoring table carries no churn column at all
        if self.churn_filter is not None:
            self.churn_filter.churn_of = preemption_churn

        # Re-read the limiter every pass: providers may fetch it remotely
        # (external gRPC) and a limiter captured once at construction would
        # pin a transient startup failure's unlimited fallback for the
        # process lifetime (reference reads it per loop via
        # context.NewResourceLimiterFromAutoscalingOptions / Refresh).
        self.resource_manager.limiter = self.provider.get_resource_limiter()

        # Equivalence groups shrink reporting/mask work (orchestrator.go:103).
        pod_groups = build_pod_groups(pending_pods)

        nodes_by_group: Dict[str, List[Node]] = {}
        if self.template_provider is not None:
            for node in cluster_nodes:
                g = self.provider.node_group_for_node(node)
                if g is not None:
                    nodes_by_group.setdefault(g.id(), []).append(node)

        all_groups: List[NodeGroup] = list(self.provider.node_groups())
        if self.node_group_list_processor is not None:
            all_groups += self.node_group_list_processor.process(
                self.provider, list(pending_pods), all_groups
            )

        viable: Dict[str, NodeGroup] = {}
        templates: Dict[str, Node] = {}
        headrooms: Dict[str, int] = {}
        skipped: Dict[str, SkipReason] = {}
        for group in all_groups:
            gid = group.id()
            # NAP candidates go through the same gate: they are healthy by
            # default (no readiness history) but a failed create()/increase
            # registered under their deterministic id backs them off too,
            # preventing a per-loop retry storm against the cloud API.
            if not self.csr.is_node_group_safe_to_scale_up(gid, now_ts):
                skipped[gid] = SkipReason.NOT_SAFE
                continue
            headroom = group.max_size() - group.target_size()
            if headroom <= 0:
                skipped[gid] = SkipReason.MAX_SIZE_REACHED
                continue
            template: Optional[Node] = None
            if self.template_provider is not None:
                template = self.template_provider.template_for(
                    group, nodes_by_group.get(gid, []), now_ts,
                    pods_of_node=pods_of_node,
                    pending_daemonsets=pending_daemonsets,
                )
            else:
                try:
                    template = group.template_node_info()
                except Exception as e:  # no template → skip (orchestrator.go:157)
                    # the closed enum cannot carry the exception text the
                    # old free-form string did — log it (typed, so the
                    # error class survives alongside the message) and keep
                    # the diagnostic detail behind a persistent
                    # no_template skip
                    logging.getLogger("scaleup").info(
                        "node group %s skipped: no template (%s)",
                        gid,
                        to_autoscaler_error(e),
                    )
                    skipped[gid] = SkipReason.NO_TEMPLATE
                    continue
            if template is None:
                skipped[gid] = SkipReason.NO_TEMPLATE
                continue
            viable[gid] = group
            templates[gid] = template
            headrooms[gid] = min(headroom, self.options.max_nodes_per_scaleup)

        if not viable:
            return ScaleUpResult(
                pods_remain_unschedulable=list(pending_pods), skipped_groups=skipped
            )

        # NodeInfoProcessor seam (reference processors/nodeinfos): last-touch
        # transform of the template set before estimation.
        if self.node_info_processor is not None:
            templates = self.node_info_processor.process(templates)
        # BinpackingLimiter seam: pre-bound the batched dispatch (the
        # reference's serial StopBinpacking early-exit, adapted to one-shot
        # estimation — see processors/pipeline.py BinpackingLimiter).
        if self.binpacking_limiter is not None:
            viable, templates, headrooms = self.binpacking_limiter.limit_groups(
                viable, templates, headrooms, pending_pods
            )
            if not viable:
                return ScaleUpResult(
                    pods_remain_unschedulable=list(pending_pods),
                    skipped_groups=skipped,
                )

        # Static spread context: topology-spread estimation needs the live
        # cluster's domain counts (the reference's PreFilter runs over the
        # full snapshot, podtopologyspread/common.go:289). Built only when a
        # pending pod actually carries a hard constraint — it is O(world).
        cluster_ctx = None
        if pods_of_node is not None and has_hard_spread(pending_pods):
            cl_pods: List[Pod] = []
            cl_node_of: List[int] = []
            for j, node in enumerate(cluster_nodes):
                for q in pods_of_node(node.name):
                    cl_pods.append(q)
                    cl_node_of.append(j)
            cluster_ctx = (list(cluster_nodes), cl_pods, cl_node_of)

        # ONE batched device dispatch for every group's expansion option
        # (replaces the serial ComputeExpansionOption loop).
        estimates = self.estimator.estimate_many(
            list(pending_pods), templates, headrooms, pod_groups=pod_groups,
            cluster=cluster_ctx,
        )
        # constraint attribution for this pass (estimator/binpacking
        # _finish_explain): per-group rejection-reason histograms + each
        # pod's dominant reason, carried on the result so run_once can
        # assemble the tick's DecisionRecord without re-reaching in
        explain = dict(getattr(self.estimator, "last_explain", None) or {})

        options: List[Option] = []
        for gid, (count, scheduled) in estimates.items():
            if count <= 0 or not scheduled:
                continue
            options.append(Option(node_group=viable[gid], node_count=count, pods=scheduled))

        if not options:
            return ScaleUpResult(
                pods_remain_unschedulable=list(pending_pods),
                skipped_groups=skipped,
                estimator_explain=explain,
            )

        best = self.expander.best_option(options)
        # the expander's scoring table (ChainStrategy publishes it per
        # call; strategies without one leave the provenance fields empty)
        expander_table = list(getattr(self.expander, "last_table", ()) or ())
        chosen_score = getattr(self.expander, "last_score", None)
        if best is None:
            return ScaleUpResult(
                pods_remain_unschedulable=list(pending_pods),
                skipped_groups=skipped,
                estimator_explain=explain,
                expander_table=expander_table,
            )

        # Cap: group headroom, cluster node total, cluster resource limits
        # (GetCappedNewNodeCount :536 + ApplyLimits path :277).
        new_count = min(best.node_count, headrooms[best.node_group.id()])
        if self.options.max_nodes_total > 0:
            room = self.options.max_nodes_total - len(cluster_nodes)
            new_count = min(new_count, max(room, 0))
        left = self.resource_manager.resources_left(cluster_nodes)
        new_count = self.resource_manager.apply_limits(
            new_count, left, templates[best.node_group.id()]
        )
        if new_count <= 0:
            return ScaleUpResult(
                pods_remain_unschedulable=list(pending_pods),
                skipped_groups=skipped,
                options_considered=len(options),
                estimator_explain=explain,
                expander_table=expander_table,
                chosen_score=chosen_score,
            )

        # Balance across similar groups (orchestrator.go:277-318) when enabled.
        scale_ups: List[tuple] = [(best.node_group, new_count)]
        if self.balancing_processor is not None and self.options.balance_similar_node_groups:
            similar = self.balancing_processor.find_similar_node_groups(
                best.node_group, templates, list(viable.values())
            )
            if similar:
                scale_ups = self.balancing_processor.balance_scale_up(
                    [best.node_group] + similar, new_count
                )

        # ExecuteScaleUps (orchestrator.go:550) — the cloud-API boundary.
        executed: List[tuple] = []
        for group, delta in scale_ups:
            if delta <= 0:
                continue
            try:
                if not group.exist():
                    # a NAP candidate won: create the group for real
                    # (orchestrator.go:217 CreateNodeGroup)
                    group = group.create()
                    if self.metrics is not None:
                        self.metrics.created_node_groups_total.inc()
                group.increase_size(delta)
                self.csr.register_or_update_scale_up(group.id(), delta, now_ts)
                executed.append((group.id(), delta))
            except Exception as e:
                # typed wrapping preserves str(e) for non-empty messages,
                # so the decision record and CSR backoff text are unchanged
                err = to_autoscaler_error(e)
                self.csr.register_failed_scale_up(group.id(), str(err), now_ts)
                return ScaleUpResult(
                    error=f"scale-up of {group.id()} failed: {err}",
                    # provenance: the expander DID choose (the cloud then
                    # refused) — the decision record names the winner, the
                    # executed prefix, and every pod left pending, so a
                    # failed tick still explains itself
                    chosen_group=best.node_group.id(),
                    executed=list(executed),
                    pods_remain_unschedulable=list(pending_pods),
                    skipped_groups=skipped,
                    options_considered=len(options),
                    estimator_explain=explain,
                    expander_table=expander_table,
                    chosen_score=chosen_score,
                )

        helped = {p.key() for p in best.pods}
        return ScaleUpResult(
            scaled_up=True,
            chosen_group=best.node_group.id(),
            new_nodes=sum(d for _, d in executed),
            extra_scale_ups=executed[1:],
            executed=list(executed),
            pods_triggered=best.pods,
            pods_remain_unschedulable=[
                p for p in pending_pods if p.key() not in helped
            ],
            skipped_groups=skipped,
            options_considered=len(options),
            estimator_explain=explain,
            expander_table=expander_table,
            chosen_score=chosen_score,
        )

    # -- min-size enforcement (reference orchestrator.go:348) ----------------
    def scale_up_to_node_group_min_size(self, now_ts: float) -> List[tuple]:
        """Raise any group below its min size (--enforce-node-group-min-size)."""
        executed = []
        if not self.options.enforce_node_group_min_size:
            return executed
        for group in self.provider.node_groups():
            delta = group.min_size() - group.target_size()
            if delta > 0 and self.csr.is_node_group_safe_to_scale_up(group.id(), now_ts):
                try:
                    group.increase_size(delta)
                    self.csr.register_or_update_scale_up(group.id(), delta, now_ts)
                    executed.append((group.id(), delta))
                except Exception as e:
                    self.csr.register_failed_scale_up(
                        group.id(), str(to_autoscaler_error(e)), now_ts
                    )
        return executed
