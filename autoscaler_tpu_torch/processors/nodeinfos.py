"""Template NodeInfo provider: what would a new node in each group look like.

Reference: cluster-autoscaler/processors/nodeinfosprovider/
mixed_nodeinfos_processor.go:46,75 (MixedTemplateNodeInfoProvider): prefer a
sanitized copy of a real ready node from the group (it reflects true
allocatable + daemonsets), fall back to the cloud provider's synthetic
TemplateNodeInfo, and cache results with a TTL so template computation
doesn't hit the cloud API every loop.

The port's copy of ``autoscaler_tpu/processors/nodeinfos.py``.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.cloudprovider.interface import CloudProvider, NodeGroup
from autoscaler_tpu_torch.kube.objects import (
    DELETION_CANDIDATE_TAINT,
    TO_BE_DELETED_TAINT,
    Node,
    Resources,
)


@dataclass
class _CacheEntry:
    template: Node
    ts: float
    # name of the real node the template was sanitized from ("" when it came
    # from the cloud's synthetic TemplateNodeInfo) — daemon overhead is
    # re-derived per call from this node's live pods, so the cache never
    # pins a charged-vs-uncharged variant
    source_node: str = ""


class MixedTemplateNodeInfoProvider:
    def __init__(self, ttl_s: float = 60.0, ignored_taints: Sequence[str] = ()):
        self.ttl_s = ttl_s
        # --ignore-taint keys (startup taints) also stripped from templates
        # so simulation doesn't block pods on transient node-init taints
        self.ignored_taints = set(ignored_taints)
        self._cache: Dict[str, _CacheEntry] = {}

    def template_for(
        self,
        group: NodeGroup,
        real_nodes: Sequence[Node],
        now_ts: float,
        pods_of_node=None,
        pending_daemonsets: Sequence = (),
    ) -> Optional[Node]:
        """pods_of_node: optional node-name → pods lookup. When the template
        comes from a real node, that node's DaemonSet/mirror pods become the
        template's daemon_overhead — a new node in the group boots the same
        daemonsets, so the estimator must not hand their capacity to pending
        pods (reference simulator/nodes.go:38 addExpectedPods puts those
        pods INTO the template NodeInfo). allocatable stays the node's true
        size: resource limits and group-similarity comparisons are
        unaffected (Node.packing_capacity is the estimator's view).
        pending_daemonsets (--force-ds): DaemonSet objects whose suitable-
        but-not-yet-running members are charged on top (simulator/
        nodes.go:56); pass them at EVERY call site that wants the charge —
        the scale-up path and upcoming-node injection both do."""
        gid = group.id()
        cached = self._cache.get(gid)
        if cached is None or now_ts - cached.ts >= self.ttl_s:
            template: Optional[Node] = None
            source = ""
            ready = [n for n in real_nodes if n.ready and not n.unschedulable]
            if ready:
                template = self._sanitize(ready[0], gid)
                source = ready[0].name
            else:
                try:
                    template = group.template_node_info()
                    if template is not None:
                        template = self._sanitize(template, gid)
                except Exception:
                    template = None
            if template is None:
                return None
            cached = _CacheEntry(template, now_ts, source)
            self._cache[gid] = cached
        # overhead is derived per CALL from the source node's live pods, so
        # callers with and without pods_of_node share one cached base and
        # results don't depend on which caller populated the cache
        overhead = Resources()
        running_ds_names = set()
        if pods_of_node is not None and cached.source_node:
            for p in pods_of_node(cached.source_node) or ():
                # a terminating DS/mirror pod won't exist on a NEW node:
                # charging it would double-count mid-replacement pods and
                # its presence in running_ds_names would suppress the
                # --force-ds recharge (reference skips DeletionTimestamp
                # pods, simulator/nodes.go:41)
                if p.deletion_ts is not None:
                    continue
                if p.daemonset or p.mirror:
                    overhead = overhead + p.effective_requests()
                    if p.daemonset and p.owner_ref is not None:
                        running_ds_names.add(
                            f"{p.namespace}/{p.owner_ref.name}"
                        )
        # --force-ds (simulator/nodes.go:56): DaemonSets suitable for this
        # template but not yet running on its source node will ALSO land on
        # a new node — charge their requests too
        for ds in pending_daemonsets:
            if ds.key() in running_ds_names:
                continue
            if ds.suitable_for(cached.template):
                r = dataclasses.replace(ds.requests, pods=1.0)
                overhead = overhead + r
        if overhead != Resources():
            return dataclasses.replace(cached.template, daemon_overhead=overhead)
        return cached.template

    def process(
        self,
        provider: CloudProvider,
        nodes_by_group: Dict[str, List[Node]],
        now_ts: float,
    ) -> Dict[str, Node]:
        """→ group id → template (TemplateNodeInfoProvider.Process analog)."""
        out: Dict[str, Node] = {}
        for group in provider.node_groups():
            tmpl = self.template_for(group, nodes_by_group.get(group.id(), []), now_ts)
            if tmpl is not None:
                out[group.id()] = tmpl
        return out

    def _sanitize(self, node: Node, gid: str) -> Node:
        """DeepCopyTemplateNode analog (utils/scheduler/scheduler.go:73):
        fresh name, autoscaler-managed + operator-ignored taints stripped."""
        fresh = copy.deepcopy(node)
        fresh = dataclasses.replace(
            fresh,
            name=f"template-{gid}-from-{node.name}",
            provider_id="",
            taints=[
                t
                for t in fresh.taints
                if t.key not in (TO_BE_DELETED_TAINT, DELETION_CANDIDATE_TAINT)
                and t.key not in self.ignored_taints
            ],
        )
        return fresh

    def invalidate(self, group_id: Optional[str] = None) -> None:
        if group_id is None:
            self._cache.clear()
        else:
            self._cache.pop(group_id, None)
