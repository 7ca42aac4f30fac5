"""Real control-plane binding for the VPA components.

Reference: vertical-pod-autoscaler/pkg/recommender/input/cluster_feeder.go
(VPA lister + metrics client), pkg/target/fetcher.go (targetRef → label
selector resolved through the workload object), and the status write the
recommender performs per pass (pkg/recommender/routines/recommender.go
UpdateVPAs → vpa_api_util.UpdateVpaStatusIfNeeded).

Everything speaks plain HTTPS through KubeRestClient; servers without the
VPA CRD or metrics.k8s.io degrade explicitly (empty lists), never silently
mid-run.

The port's copy of ``autoscaler_tpu/vpa/kube_io.py``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from autoscaler_tpu_torch.kube.client import ApiError, KubeRestClient
from autoscaler_tpu_torch.kube.convert import (
    format_cpu_quantity,
    format_memory_quantity,
    format_timestamp,
    parse_quantity,
    parse_timestamp,
)
from autoscaler_tpu_torch.kube.objects import LabelSelector, LabelSelectorRequirement
from autoscaler_tpu_torch.vpa.api import (
    ContainerResourcePolicy,
    ContainerScalingMode,
    UpdateMode,
    Vpa,
)
from autoscaler_tpu_torch.vpa.feeder import ContainerUsage, MetricsSource
from autoscaler_tpu_torch.vpa.recommender import Checkpoint, Recommendation

VPA_PATH = "/apis/autoscaling.k8s.io/v1/verticalpodautoscalers"
METRICS_PATH = "/apis/metrics.k8s.io/v1beta1/pods"

# An empty LabelSelector matches EVERYTHING, so an unresolved targetRef
# (unknown kind, deleted workload) must use this never-matching sentinel —
# otherwise a dangling VPA would adopt every pod in its namespace.
MATCH_NOTHING = LabelSelector(
    match_expressions=(
        LabelSelectorRequirement(key="", operator="In", values=()),
    )
)

# workload kind → apps/v1 plural, for targetRef selector resolution
_KIND_PLURALS = {
    "Deployment": "deployments",
    "ReplicaSet": "replicasets",
    "StatefulSet": "statefulsets",
    "DaemonSet": "daemonsets",
}


def _selector_from_json(sel: Optional[dict]) -> LabelSelector:
    sel = sel or {}
    exprs = tuple(
        LabelSelectorRequirement(
            key=e.get("key", ""),
            operator=e.get("operator", "In"),
            values=tuple(e.get("values") or ()),
        )
        for e in sel.get("matchExpressions") or ()
    )
    return LabelSelector(
        match_labels=tuple(sorted((sel.get("matchLabels") or {}).items())),
        match_expressions=exprs,
    )


def _policy_from_json(p: dict) -> ContainerResourcePolicy:
    min_a = p.get("minAllowed") or {}
    max_a = p.get("maxAllowed") or {}
    return ContainerResourcePolicy(
        container_name=p.get("containerName", "*"),
        mode=(
            ContainerScalingMode.OFF
            if p.get("mode") == "Off"
            else ContainerScalingMode.AUTO
        ),
        min_cpu=parse_quantity(min_a["cpu"]) if "cpu" in min_a else 0.0,
        max_cpu=parse_quantity(max_a["cpu"]) if "cpu" in max_a else float("inf"),
        min_memory=parse_quantity(min_a["memory"]) if "memory" in min_a else 0.0,
        max_memory=(
            parse_quantity(max_a["memory"]) if "memory" in max_a else float("inf")
        ),
    )


def vpa_from_json(obj: dict, selector: LabelSelector) -> Vpa:
    """VPA CRD JSON → Vpa. The selector comes from targetRef resolution
    (the CRD itself carries no selector in v1)."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    mode_str = (spec.get("updatePolicy") or {}).get("updateMode", "Auto")
    try:
        mode = UpdateMode(mode_str)
    except ValueError:
        # fail CLOSED: an unrecognized mode (newer CRD, e.g.
        # InPlaceOrRecreate) must not become the most disruptive one
        mode = UpdateMode.OFF
    policies = [
        _policy_from_json(p)
        for p in (spec.get("resourcePolicy") or {}).get("containerPolicies") or ()
    ]
    return Vpa(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        target_selector=selector,
        update_mode=mode,
        resource_policies=policies,
    )


def recommendations_from_status(obj: dict) -> Dict[str, Recommendation]:
    """status.recommendation.containerRecommendations → {container: rec}
    (the inverse of write_status; what the reference updater reads)."""
    recs = ((obj.get("status") or {}).get("recommendation") or {}).get(
        "containerRecommendations"
    ) or ()
    out: Dict[str, Recommendation] = {}
    for cr in recs:
        def _pair(section: str, default: dict) -> Tuple[float, float]:
            q = cr.get(section) or default
            return (
                parse_quantity(q.get("cpu", 0)),
                parse_quantity(q.get("memory", 0)),
            )

        target = _pair("target", {})
        lower = _pair("lowerBound", cr.get("target") or {})
        upper = _pair("upperBound", cr.get("target") or {})
        out[cr.get("containerName", "")] = Recommendation(
            target_cpu=target[0], target_memory=target[1],
            lower_cpu=lower[0], lower_memory=lower[1],
            upper_cpu=upper[0], upper_memory=upper[1],
        )
    return out


class VpaKubeBinding:
    """LIST VPAs (resolving each targetRef to a selector) and write their
    status.recommendation, over the REST client."""

    # Selectors of live apps/v1 workloads are immutable, but a workload can
    # be deleted and recreated with a new selector; the TTL bounds how long
    # a stale selector survives (the reference's informer-backed fetcher
    # observes the recreate directly).
    SELECTOR_TTL_S = 600.0

    def __init__(self, client: KubeRestClient):
        self.client = client
        # (ns, kind, name) → (selector, resolved_at)
        self._selector_cache: Dict[
            Tuple[str, str, str], Tuple[LabelSelector, float]
        ] = {}

    def _selector_for(self, namespace: str, target_ref: dict) -> LabelSelector:
        kind = target_ref.get("kind", "")
        name = target_ref.get("name", "")
        plural = _KIND_PLURALS.get(kind)
        if plural is None:
            return MATCH_NOTHING  # unknown kind
        cache_key = (namespace, kind, name)
        hit = self._selector_cache.get(cache_key)
        now = time.monotonic()
        if hit is not None and now - hit[1] < self.SELECTOR_TTL_S:
            return hit[0]
        try:
            obj = self.client.get(
                f"/apis/apps/v1/namespaces/{namespace}/{plural}/{name}"
            )
        except ApiError as e:
            if e.status == 404:
                # target gone: drop any cached selector so a recreate with a
                # different selector is picked up on its next resolution
                self._selector_cache.pop(cache_key, None)
                return MATCH_NOTHING
            raise
        sel = _selector_from_json((obj.get("spec") or {}).get("selector"))
        self._selector_cache[cache_key] = (sel, now)
        return sel

    def list_vpas(self) -> List[Vpa]:
        return [vpa for vpa, _ in self.list_vpas_with_status()]

    def list_vpas_with_status(
        self,
    ) -> List[Tuple[Vpa, Dict[str, Recommendation]]]:
        """→ [(vpa, status recommendations by container)]. The status recs
        let an updater-only process work from what a separate recommender
        wrote, exactly like the reference's updater reads the CRD status."""
        try:
            items = self.client.get(VPA_PATH).get("items") or []
        except ApiError as e:
            if e.status == 404:
                return []  # CRD not installed
            raise
        out = []
        for obj in items:
            meta = obj.get("metadata") or {}
            ns = meta.get("namespace", "default")
            target_ref = (obj.get("spec") or {}).get("targetRef") or {}
            vpa = vpa_from_json(obj, self._selector_for(ns, target_ref))
            out.append((vpa, recommendations_from_status(obj)))
        return out

    def write_status(
        self,
        vpa: Vpa,
        recs: Dict[str, Recommendation],
        now_ts: Optional[float] = None,
    ) -> None:
        """PATCH status.recommendation (UpdateVpaStatusIfNeeded's shape:
        containerRecommendations with target/lowerBound/upperBound)."""
        container_recs = []
        for container, rec in sorted(recs.items()):
            container_recs.append(
                {
                    "containerName": container,
                    "target": {
                        "cpu": format_cpu_quantity(rec.target_cpu),
                        "memory": format_memory_quantity(rec.target_memory),
                    },
                    "lowerBound": {
                        "cpu": format_cpu_quantity(rec.lower_cpu),
                        "memory": format_memory_quantity(rec.lower_memory),
                    },
                    "upperBound": {
                        "cpu": format_cpu_quantity(rec.upper_cpu),
                        "memory": format_memory_quantity(rec.upper_memory),
                    },
                }
            )
        body = {
            "status": {
                "recommendation": {"containerRecommendations": container_recs},
                "conditions": [
                    {
                        "type": "RecommendationProvided",
                        "status": "True",
                        "lastTransitionTime": format_timestamp(
                            now_ts if now_ts is not None else time.time()
                        ),
                    }
                ],
            }
        }
        path = f"/apis/autoscaling.k8s.io/v1/namespaces/{vpa.namespace}/verticalpodautoscalers/{vpa.name}"
        try:
            self.client.merge_patch(path + "/status", body)
        except ApiError as e:
            if e.status == 409:
                # write conflict (another writer raced us): the status is
                # recomputed and rewritten every pass, so losing one write is
                # harmless — the reference logs and moves on
                return
            if e.status not in (404, 405):
                raise
            # CRD without the status subresource enabled: patch the resource
            try:
                self.client.merge_patch(path, body)
            except ApiError as e2:
                if e2.status != 409:
                    raise


CHECKPOINT_PATH = (
    "/apis/autoscaling.k8s.io/v1/verticalpodautoscalercheckpoints"
)


def _histogram_to_json(h: Dict) -> Dict:
    return {
        "referenceTimestamp": format_timestamp(float(h.get("ref_ts", 0.0))),
        "bucketWeights": {str(k): v for k, v in h.get("bucket_weights", {}).items()},
        "totalWeight": float(h.get("total_weight", 0.0)),
    }


def _histogram_from_json(h: Dict) -> Dict:
    return {
        "ref_ts": parse_timestamp(h.get("referenceTimestamp")),
        "bucket_weights": {
            int(k): v for k, v in (h.get("bucketWeights") or {}).items()
        },
        "total_weight": float(h.get("totalWeight", 0.0)),
    }


class VpaCheckpointStore:
    """Histogram checkpoints as VerticalPodAutoscalerCheckpoint API objects,
    one per (vpa, container) — the control-plane persistence the reference's
    recommender uses so a rescheduled pod resumes warm
    (checkpoint/checkpoint_writer.go:36,78; CRD shape from
    apis/autoscaling.k8s.io/v1/types.go VerticalPodAutoscalerCheckpoint).
    A server without the CRD degrades explicitly: load() returns [] and
    save() reports 0, mirroring the binding's CRD-absent behavior."""

    def __init__(self, client: KubeRestClient):
        self.client = client

    @staticmethod
    def _name(ckpt: Checkpoint) -> str:
        return f"{ckpt.vpa}-{ckpt.container}".lower()

    def save(self, checkpoints: List[Checkpoint], now_ts: Optional[float] = None) -> int:
        now_ts = time.time() if now_ts is None else now_ts
        written = 0
        for ckpt in checkpoints:
            body = {
                "metadata": {
                    "name": self._name(ckpt),
                    "namespace": ckpt.namespace,
                },
                "spec": {
                    "vpaObjectName": ckpt.vpa,
                    "containerName": ckpt.container,
                },
                "status": {
                    "lastUpdateTime": format_timestamp(now_ts),
                    "version": "v3",
                    "cpuHistogram": _histogram_to_json(ckpt.cpu),
                    "memoryHistogram": _histogram_to_json(ckpt.memory),
                    "firstSampleStart": format_timestamp(ckpt.first_sample_ts),
                    "totalSamplesCount": int(ckpt.sample_count),
                },
            }
            path = (
                f"/apis/autoscaling.k8s.io/v1/namespaces/{ckpt.namespace}"
                f"/verticalpodautoscalercheckpoints"
            )
            try:
                self.client.put(f"{path}/{self._name(ckpt)}", body)
                written += 1
            except ApiError as e:
                if e.status != 404:
                    raise
                try:
                    self.client.post(path, body)
                    written += 1
                except ApiError as e2:
                    if e2.status == 404:
                        return written  # CRD not installed
                    if e2.status == 409:
                        # create race with an overlapping recommender (rolling
                        # update): the twin just wrote this checkpoint — fine
                        continue
                    raise
        return written

    def load(self) -> List[Checkpoint]:
        out = []
        for obj in self._list_raw():
            meta = obj.get("metadata") or {}
            spec = obj.get("spec") or {}
            status = obj.get("status") or {}
            out.append(
                Checkpoint(
                    vpa=spec.get("vpaObjectName", ""),
                    container=spec.get("containerName", ""),
                    namespace=meta.get("namespace", "default"),
                    cpu=_histogram_from_json(status.get("cpuHistogram") or {}),
                    memory=_histogram_from_json(
                        status.get("memoryHistogram") or {}
                    ),
                    sample_count=int(status.get("totalSamplesCount", 0)),
                    first_sample_ts=parse_timestamp(
                        status.get("firstSampleStart")
                    ),
                )
            )
        return out

    def gc(self, live_vpa_keys) -> int:
        """Delete checkpoint objects whose VPA no longer EXISTS — keyed on
        the live VPA set, never on the in-memory model (a cold-started
        model after a failed restore must not wipe days of persisted
        histograms for VPAs that are still there). Reference:
        MaintainCheckpoints GCs by VPA existence (routines/recommender.go:160)."""
        keep = set(live_vpa_keys)
        deleted = 0
        for obj in self._list_raw():
            meta = obj.get("metadata") or {}
            spec = obj.get("spec") or {}
            ns = meta.get("namespace", "default")
            if (ns, spec.get("vpaObjectName", "")) not in keep:
                try:
                    self.client.delete(
                        f"/apis/autoscaling.k8s.io/v1/namespaces/{ns}"
                        f"/verticalpodautoscalercheckpoints/"
                        f"{meta.get('name', '')}"
                    )
                    deleted += 1
                except ApiError as e:
                    if e.status != 404:
                        raise
        return deleted

    def _list_raw(self) -> List[dict]:
        try:
            return self.client.get(CHECKPOINT_PATH).get("items") or []
        except ApiError as e:
            if e.status == 404:
                return []
            raise


WEBHOOK_PATH = (
    "/apis/admissionregistration.k8s.io/v1/mutatingwebhookconfigurations"
)


def register_webhook(client: KubeRestClient, config: dict) -> None:
    """Create-or-update the MutatingWebhookConfiguration — the reference's
    selfRegistration (admission-controller config.go:67-99). Must run every
    process start: generate_certs mints a fresh CA per process, so a stale
    caBundle from the previous pod would fail TLS against this one."""
    name = (config.get("metadata") or {}).get("name", "")
    try:
        client.put(f"{WEBHOOK_PATH}/{name}", config)
    except ApiError as e:
        if e.status != 404:
            raise
        client.post(WEBHOOK_PATH, config)


class KubeMetricsSource(MetricsSource):
    """metrics.k8s.io scrape → ContainerUsage rows.

    PodMetrics carries no labels, but VPA matching needs them
    (cluster_feeder.go joins through the pod lister the same way), so the
    caller supplies a pod-labels lookup — typically built from
    KubeClusterAPI.list_pods() in the same pass."""

    def __init__(
        self,
        client: KubeRestClient,
        pod_labels_of: Callable[[], Dict[Tuple[str, str], Dict[str, str]]],
    ):
        self.client = client
        self.pod_labels_of = pod_labels_of

    def container_usage(self, now_ts: float) -> List[ContainerUsage]:
        try:
            items = self.client.get(METRICS_PATH).get("items") or []
        except ApiError as e:
            if e.status == 404:
                return []  # metrics-server not installed
            raise
        labels_of = self.pod_labels_of()
        out: List[ContainerUsage] = []
        for pm in items:
            meta = pm.get("metadata") or {}
            ns = meta.get("namespace", "default")
            pod_name = meta.get("name", "")
            labels = labels_of.get((ns, pod_name), {})
            for c in pm.get("containers") or ():
                usage = c.get("usage") or {}
                out.append(
                    ContainerUsage(
                        namespace=ns,
                        pod_name=pod_name,
                        container=c.get("name", ""),
                        pod_labels=labels,
                        # parse_quantity returns base units ("250m" → 0.25)
                        cpu_cores=parse_quantity(usage.get("cpu", 0)),
                        memory_bytes=parse_quantity(usage.get("memory", 0)),
                    )
                )
        return out
