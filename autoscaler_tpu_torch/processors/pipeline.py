"""The processors container — the reference's 18 extension points, with
defaults.

Reference: cluster-autoscaler/processors/processors.go:36
(AutoscalingProcessors struct) and DefaultProcessors. Interfaces without a
TPU-specific twist are small Protocols with default implementations;
heavyweight ones live in sibling modules (nodegroupset.py, nodeinfos.py,
core/podlistprocessor.py). Provider-specific overrides replace fields on the
container, exactly like main.go:406-440 does.

The port's copy of ``autoscaler_tpu/processors/pipeline.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple

from autoscaler_tpu_torch.cloudprovider.interface import CloudProvider, NodeGroup
from autoscaler_tpu_torch.core.podlistprocessor import FilterOutSchedulablePodListProcessor
from autoscaler_tpu_torch.kube.objects import Node, Pod
from autoscaler_tpu_torch.processors.nodegroupset import BalancingNodeGroupSetProcessor
from autoscaler_tpu_torch.processors.nodeinfos import MixedTemplateNodeInfoProvider


class ScaleUpStatusProcessor(Protocol):
    def process(self, result) -> None: ...


class ScaleDownStatusProcessor(Protocol):
    def process(self, result) -> None: ...


@dataclass
class EventingScaleUpStatusProcessor:
    """Default: surface scale-up outcomes as events/log lines (reference
    processors/status/eventing_scale_up_processor.go)."""

    sink: Callable[[str, str], None] = lambda reason, msg: None

    def process(self, result) -> None:
        if result is None:
            return
        if result.scaled_up:
            self.sink(
                "TriggeredScaleUp",
                f"scale-up: group {result.chosen_group} +{result.new_nodes} "
                f"for {len(result.pods_triggered)} pods",
            )
        for pod in result.pods_remain_unschedulable:
            self.sink("NotTriggerScaleUp", f"pod {pod.key()} can't be helped")


@dataclass
class NoOpScaleDownStatusProcessor:
    def process(self, result) -> None:
        return


class CustomResourcesProcessor:
    """GPU/TPU readiness: a node advertising an accelerator label but 0
    allocatable devices is still initializing — treat as unready so
    utilization/scale-down logic doesn't misread it (reference
    processors/customresources/gpu_processor.go)."""

    def __init__(self, gpu_label: str = "cloud.google.com/gke-accelerator"):
        self.gpu_label = gpu_label

    def filter_out_nodes_with_unready_resources(
        self, nodes: Sequence[Node]
    ) -> Tuple[List[Node], List[Node]]:
        ready, not_ready = [], []
        for node in nodes:
            if (
                self.gpu_label in node.labels
                and node.allocatable.gpu == 0
                and node.allocatable.tpu == 0
            ):
                not_ready.append(node)
            else:
                ready.append(node)
        return ready, not_ready


class ScaleDownCandidatesSortingProcessor:
    """Order scale-down candidates: previously-unneeded first so decisions
    stabilize across loops (reference processors/scaledowncandidates/
    previous_candidates.go + sorting)."""

    def __init__(self) -> None:
        self._previous: set = set()

    def sort(self, candidates: Sequence[Node]) -> List[Node]:
        prev = [n for n in candidates if n.name in self._previous]
        rest = [n for n in candidates if n.name not in self._previous]
        return prev + rest

    def update(self, unneeded_names: Sequence[str]) -> None:
        self._previous = set(unneeded_names)


class NodeGroupListProcessor(Protocol):
    """reference processors/nodegroups/NodeGroupListProcessor — may add
    (e.g. NAP candidate) groups to the scale-up consideration set."""

    def process(self, provider, pending_pods, groups) -> List[NodeGroup]: ...


class PassthroughNodeGroupListProcessor:
    def process(self, provider, pending_pods, groups) -> List[NodeGroup]:
        return []


class ScaleDownNodeProcessor:
    """reference processors/nodes/ScaleDownNodeProcessor — pre-filter the
    scale-down candidate list before the planner sees it. Default: pass
    everything through."""

    def get_scale_down_candidates(
        self, nodes: Sequence[Node], all_nodes: Sequence[Node]
    ) -> List[Node]:
        return list(nodes)


class ScaleDownSetProcessor:
    """reference processors/nodes/ScaleDownSetProcessor — final selection of
    the deletion set from the removable candidates. Default mirrors the
    reference's max-parallelism crop (post_filtering_processor.go)."""

    def get_nodes_to_remove(self, candidates: List, max_count: int) -> List:
        if max_count <= 0:
            return list(candidates)
        return list(candidates)[:max_count]


class AutoscalingStatusProcessor:
    """reference processors/status/AutoscalingStatusProcessor — observe the
    cluster state after every iteration. Default: no-op."""

    def process(self, result, now_ts: float) -> None:
        return


class ActionableClusterProcessor:
    """reference processors/actionablecluster — whether the autoscaler should
    act on the cluster at all this iteration. Default: always actionable."""

    def should_autoscale(self, nodes: Sequence[Node], now_ts: float) -> bool:
        return True


class EmptyClusterProcessor(ActionableClusterProcessor):
    """The reference's EmptyClusterProcessor
    (actionablecluster/actionable_cluster_processor.go:40): with
    scale-up-from-zero disabled, a cluster with no nodes — or none ready —
    is not actionable, so the autoscaler must not scale it from nothing."""

    def __init__(self, scale_up_from_zero: bool = True):
        self.scale_up_from_zero = scale_up_from_zero

    def should_autoscale(self, nodes: Sequence[Node], now_ts: float) -> bool:
        if self.scale_up_from_zero:
            return True
        if not nodes:
            return False
        return any(n.ready for n in nodes)


class NodeInfoProcessor:
    """reference processors/nodeinfos/NodeInfoProcessor — post-process the
    template NodeInfos before estimation. Default: identity."""

    def process(self, node_infos: Dict[str, Node]) -> Dict[str, Node]:
        return node_infos


class NodeGroupConfigProcessor:
    """reference processors/nodegroupconfig — resolve per-group autoscaling
    options. Default delegates to AutoscalingOptions.group_options (the
    NodeGroup.GetOptions fallback chain, cloud_provider.go:230)."""

    def options_for(self, options, group_id: str):
        return options.group_options(group_id)


class BinpackingLimiter:
    """reference processors/binpacking/binpacking_limiter.go (InitBinpacking/
    StopBinpacking). The reference stops the serial per-group estimate loop
    early; here every group is estimated in ONE batched device dispatch, so
    the seam pre-bounds the group set (and per-group headrooms) before that
    dispatch. Default: no limiting."""

    def limit_groups(
        self,
        viable: Dict[str, NodeGroup],
        templates: Dict[str, Node],
        headrooms: Dict[str, int],
        pending_pods: Sequence[Pod],
    ) -> Tuple[Dict[str, NodeGroup], Dict[str, Node], Dict[str, int]]:
        return viable, templates, headrooms


class ScaleDownCandidatesObserver(Protocol):
    """reference processors/scaledowncandidates/ObserversList entry."""

    def update(self, unneeded_names: Sequence[str]) -> None: ...


class NodeGroupManager:
    """Node-group autoprovisioning lifecycle (reference processors/nodegroups/
    — NAP creates groups for pods no existing group fits and deletes empty
    autoprovisioned groups). The default implementation is a no-op unless the
    provider supports group creation."""

    def __init__(self, max_autoprovisioned: int = 15):
        self.max_autoprovisioned = max_autoprovisioned

    def remove_unneeded_node_groups(
        self, provider: CloudProvider, metrics=None
    ) -> List[str]:
        removed = []
        for group in provider.node_groups():
            if group.autoprovisioned() and group.target_size() == 0:
                try:
                    group.delete()
                    removed.append(group.id())
                    if metrics is not None:
                        metrics.deleted_node_groups_total.inc()
                except Exception:
                    pass
        return removed


@dataclass
class AutoscalingProcessors:
    """processors.go:36 — one container wired through the control loop.
    16 of the reference's 18 seams; absent: DebuggingSnapshotter lives in
    debugging.py outside the container (same function), and the reference's
    pod-injection PodListProcessor chain is folded into
    FilterOutSchedulablePodListProcessor's currently-drained-nodes input."""

    pod_list_processor: FilterOutSchedulablePodListProcessor = field(
        default_factory=FilterOutSchedulablePodListProcessor
    )
    node_group_list: PassthroughNodeGroupListProcessor = field(
        default_factory=PassthroughNodeGroupListProcessor
    )
    node_group_set: BalancingNodeGroupSetProcessor = field(
        default_factory=BalancingNodeGroupSetProcessor
    )
    template_node_info_provider: MixedTemplateNodeInfoProvider = field(
        default_factory=MixedTemplateNodeInfoProvider
    )
    node_info: NodeInfoProcessor = field(default_factory=NodeInfoProcessor)
    node_group_config: NodeGroupConfigProcessor = field(
        default_factory=NodeGroupConfigProcessor
    )
    binpacking_limiter: BinpackingLimiter = field(default_factory=BinpackingLimiter)
    scale_up_status: EventingScaleUpStatusProcessor = field(
        default_factory=EventingScaleUpStatusProcessor
    )
    scale_down_node: ScaleDownNodeProcessor = field(
        default_factory=ScaleDownNodeProcessor
    )
    scale_down_set: ScaleDownSetProcessor = field(
        default_factory=ScaleDownSetProcessor
    )
    scale_down_status: NoOpScaleDownStatusProcessor = field(
        default_factory=NoOpScaleDownStatusProcessor
    )
    autoscaling_status: AutoscalingStatusProcessor = field(
        default_factory=AutoscalingStatusProcessor
    )
    actionable_cluster: ActionableClusterProcessor = field(
        default_factory=ActionableClusterProcessor
    )
    custom_resources: CustomResourcesProcessor = field(
        default_factory=CustomResourcesProcessor
    )
    scale_down_candidates_sorting: ScaleDownCandidatesSortingProcessor = field(
        default_factory=ScaleDownCandidatesSortingProcessor
    )
    # ObserversList analog: every observer hears the new unneeded set
    scale_down_candidates_observers: List[ScaleDownCandidatesObserver] = field(
        default_factory=list
    )
    node_group_manager: NodeGroupManager = field(default_factory=NodeGroupManager)

    def __post_init__(self) -> None:
        if self.scale_down_candidates_sorting not in self.scale_down_candidates_observers:
            self.scale_down_candidates_observers.append(
                self.scale_down_candidates_sorting
            )

    def notify_scale_down_candidates(self, unneeded_names: Sequence[str]) -> None:
        for obs in self.scale_down_candidates_observers:
            obs.update(unneeded_names)


def default_processors(options=None) -> AutoscalingProcessors:
    """Default wiring; with options, knob-driven processors pick up their
    config (balancing ratios + extra ignored labels, like the reference's
    NewDefaultProcessors(opts))."""
    procs = AutoscalingProcessors()
    if options is not None:
        from autoscaler_tpu_torch.processors.nodegroupset import DEFAULT_IGNORED_LABELS

        procs.node_group_set = BalancingNodeGroupSetProcessor(
            ratios=options.node_group_difference_ratios,
            ignored_labels=set(DEFAULT_IGNORED_LABELS)
            | set(options.balancing_extra_ignored_labels),
            label_keys=list(options.balancing_label_keys),
        )
        procs.template_node_info_provider = MixedTemplateNodeInfoProvider(
            ttl_s=options.node_info_cache_expire_time_s,
            ignored_taints=options.ignored_taints,
        )
        procs.actionable_cluster = EmptyClusterProcessor(
            scale_up_from_zero=options.scale_up_from_zero
        )
        procs.node_group_manager = NodeGroupManager(
            max_autoprovisioned=options.max_autoprovisioned_node_group_count
        )
        # NOTE: AutoprovisioningNodeGroupListProcessor needs a provider-
        # specific group factory, so embedders construct it themselves —
        # pass options.max_autoprovisioned_node_group_count as its
        # max_autoprovisioned_groups to keep the two caps consistent.
    return procs
