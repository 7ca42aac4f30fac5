"""VPA updater: evict pods whose requests drift from the recommendation.

Reference: vertical-pod-autoscaler/pkg/updater/ — logic/updater.go:109
RunOnce, update_priority_calculator.go:47,81 (evict when any container's
request is off by >10% either way, quick path for recent OOMs, and
long-persisting (12h+) significant changes), eviction rate limiter :235,
PDB-aware eviction via pkg/updater/eviction (here: RemainingPdbTracker).

The port's copy of ``autoscaler_tpu/vpa/updater.py``.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.core.scaledown.tracking import RemainingPdbTracker
from autoscaler_tpu_torch.kube.objects import Pod
from autoscaler_tpu_torch.vpa.recommender import ContainerKey, Recommendation

log = logging.getLogger("vpa.updater")

DEFAULT_DRIFT_THRESHOLD = 0.10         # updatePriorityCalculator 10%
SIGNIFICANT_CHANGE_AFTER_S = 12 * 3600.0
OOM_QUICK_PATH_WINDOW_S = 10 * 60.0


@dataclass
class PodUpdatePriority:
    pod: Pod
    priority: float
    outside_recommended_range: bool
    oom_quick_path: bool


class UpdatePriorityCalculator:
    def __init__(self, drift_threshold: float = DEFAULT_DRIFT_THRESHOLD):
        self.drift_threshold = drift_threshold

    def priority_of(
        self,
        pod: Pod,
        recommendation: Recommendation,
        now_ts: float,
        last_oom_ts: Optional[float] = None,
        recommendation_age_s: float = 0.0,
    ) -> Optional[PodUpdatePriority]:
        """→ update priority, or None when no update is warranted
        (update_priority_calculator.go:47 AddPod / :81 getUpdatePriority)."""
        req_cpu = pod.requests.cpu_m / 1000.0
        req_mem = pod.requests.memory
        drift = 0.0
        outside = False
        if req_cpu > 0:
            drift += abs(recommendation.target_cpu - req_cpu) / req_cpu
            if not (recommendation.lower_cpu <= req_cpu <= recommendation.upper_cpu):
                outside = True
        if req_mem > 0:
            drift += abs(recommendation.target_memory - req_mem) / req_mem
            if not (
                recommendation.lower_memory <= req_mem <= recommendation.upper_memory
            ):
                outside = True

        oom_quick = (
            last_oom_ts is not None and now_ts - last_oom_ts < OOM_QUICK_PATH_WINDOW_S
        )
        significant = drift > self.drift_threshold and (
            outside or recommendation_age_s >= SIGNIFICANT_CHANGE_AFTER_S
        )
        if not (oom_quick or significant):
            return None
        return PodUpdatePriority(
            pod=pod,
            priority=drift + (10.0 if oom_quick else 0.0),
            outside_recommended_range=outside,
            oom_quick_path=oom_quick,
        )


class EvictionRateLimiter:
    """At most a fraction of a workload's replicas may be disrupted per pass
    (updater.go:235 + eviction tolerance)."""

    def __init__(self, eviction_tolerance: float = 0.5, min_replicas: int = 2):
        self.eviction_tolerance = eviction_tolerance
        self.min_replicas = min_replicas

    def budget_for(self, replica_count: int) -> int:
        if replica_count < self.min_replicas:
            return 0
        if self.eviction_tolerance <= 0:
            # tolerance 0 means "never disrupt", not "one per pass"
            return 0
        return max(1, int(replica_count * self.eviction_tolerance))


class Updater:
    def __init__(
        self,
        calculator: Optional[UpdatePriorityCalculator] = None,
        rate_limiter: Optional[EvictionRateLimiter] = None,
    ):
        self.calculator = calculator or UpdatePriorityCalculator()
        self.rate_limiter = rate_limiter or EvictionRateLimiter()

    def run_once(
        self,
        pods_by_workload: Dict[str, List[Pod]],
        recommendations: Dict[ContainerKey, Recommendation],
        vpa_of_workload: Dict[str, str],
        now_ts: float,
        pdb_tracker: Optional[RemainingPdbTracker] = None,
        evict_fn=None,
        oom_ts: Optional[Dict[str, float]] = None,
        recommendation_age_s: float = SIGNIFICANT_CHANGE_AFTER_S,
        vpas: Optional[Dict[str, "object"]] = None,
    ) -> List[Pod]:
        """→ pods evicted, highest priority first, PDB- and rate-limited.

        `vpas` maps VPA name → Vpa; when given, only Recreate/Auto VPAs
        evict (updater.go:109 skips Off/Initial — Initial applies at
        admission only)."""
        from autoscaler_tpu_torch.vpa.api import UpdateMode

        evicted: List[Pod] = []
        oom_ts = oom_ts or {}
        for workload, pods in pods_by_workload.items():
            vpa = vpa_of_workload.get(workload)
            if vpa is None:
                continue
            if vpas is not None:
                # fail CLOSED: an unresolvable VPA (cache lag, rename) or one
                # without a readable mode must not evict — Off mode exists
                # precisely to prevent disruption (updater.go resolves the
                # VPA first and skips when it can't). Lookup tries the
                # workload key first (unique: callers key it by ns/name so
                # same-named VPAs in two namespaces can't collide), then the
                # bare VPA name for callers with a flat map.
                resolved = vpas.get(workload, vpas.get(vpa))
                mode = getattr(resolved, "update_mode", None)
                if mode not in (UpdateMode.RECREATE, UpdateMode.AUTO):
                    continue
            budget = self.rate_limiter.budget_for(len(pods))
            candidates: List[PodUpdatePriority] = []
            for pod in pods:
                key = ContainerKey(vpa, pod.name.rsplit("-", 1)[0], pod.namespace)
                rec = recommendations.get(key) or next(
                    (
                        r
                        for k, r in recommendations.items()
                        if k.vpa == vpa and k.namespace == pod.namespace
                    ),
                    None,
                )
                if rec is None:
                    continue
                p = self.calculator.priority_of(
                    pod,
                    rec,
                    now_ts,
                    last_oom_ts=oom_ts.get(pod.key()),
                    recommendation_age_s=recommendation_age_s,
                )
                if p is not None:
                    candidates.append(p)
            candidates.sort(key=lambda c: -c.priority)
            for cand in candidates[:budget]:
                if pdb_tracker is not None and not pdb_tracker.can_remove_pods([cand.pod]):
                    continue
                if evict_fn is not None:
                    try:
                        evict_fn(cand.pod)
                    except Exception as e:  # noqa: BLE001
                        # eviction races are normal control-plane weather
                        # (429 from a PDB admission check, pod already gone):
                        # skip THIS pod, keep the pass alive, retry next pass
                        # — the reference updater logs and continues
                        # (logic/updater.go:109 eviction loop). The PDB
                        # tracker is only charged after a successful evict.
                        # Logged so persistent non-weather failures (RBAC,
                        # bugs) stay visible.
                        log.warning("evicting %s failed: %s", cand.pod.key(), e)
                        continue
                if pdb_tracker is not None:
                    pdb_tracker.remove_pods([cand.pod])
                evicted.append(cand.pod)
        return evicted


def apply_recommendation(pod: Pod, rec: Recommendation) -> Pod:
    """Admission-controller analog: patch a (new) pod's requests to the
    recommended target (reference pkg/admission-controller/logic/server.go:37
    — the mutating webhook patches at create time; embed this at your pod
    creation path)."""
    import dataclasses

    new_requests = dataclasses.replace(
        pod.requests,
        cpu_m=rec.target_cpu * 1000.0,
        memory=rec.target_memory,
    )
    return dataclasses.replace(pod, requests=new_requests)
