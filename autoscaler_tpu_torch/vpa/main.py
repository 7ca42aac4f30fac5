"""VPA process entry point: recommender + updater (+ admission webhook) as
one runnable binary against a live control plane.

The reference ships three binaries (vertical-pod-autoscaler/pkg/
{recommender,updater,admission-controller}); their control loops are thin —
recommender.RunOnce (routines/recommender.go:160: feed → update VPAs →
checkpoints → GC), updater.RunOnce (logic/updater.go:109), and a webhook
server. Here one process hosts all three on one histogram model (no
CRD-checkpoint round-trip between them), each gated by --components; the
cadence flags keep the reference's defaults (recommender 1m, updater 1m).

Checkpoints persist to the control plane as VerticalPodAutoscalerCheckpoint
API objects by default (kube_io.VpaCheckpointStore; one per (vpa, container),
checkpoint_writer.go:36,78), so a rescheduled recommender pod resumes warm
within one cycle. --checkpoint-file opts into a local JSON file instead
(same serialized histogram payload — histogram.py:138 mirrors
checkpoint_writer.go's normalized buckets) for out-of-cluster runs;
--no-checkpoints runs stateless.

The port's copy of ``autoscaler_tpu/vpa/main.py``. Its one extra flag,
``--device``, puts the histogram banks on a torch device: by default the
first CUDA card (the process exits with an error on a host without one),
``--device=cpu`` on the host.

    python -m autoscaler_tpu_torch.vpa.main --kube-api=http://127.0.0.1:8080 --device=cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Dict, List, Optional

from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.vpa.api import UpdateMode, Vpa
from autoscaler_tpu_torch.vpa.feeder import ClusterStateFeeder, MetricsSource
from autoscaler_tpu_torch.vpa.recommender import (
    Checkpoint,
    CheckpointManager,
    ClusterStateModel,
    ContainerKey,
    PercentileRecommender,
    Recommendation,
)
from autoscaler_tpu_torch.utils.poll import poll_loop
from autoscaler_tpu_torch.vpa.updater import EvictionRateLimiter, Updater

log = logging.getLogger("vpa")


class VpaRunner:
    """One reconcile pass over all three components' responsibilities."""

    def __init__(
        self,
        binding,                      # VpaKubeBinding-shaped: list_vpas/write_status
        cluster_api,                  # ClusterAPI: list_pods/evict_pod
        metrics_source: MetricsSource,
        checkpoint_path: str = "",
        checkpoint_store=None,        # VpaCheckpointStore: CRD persistence
        components: tuple = ("recommender", "updater"),
        half_life_s: float = 24 * 3600.0,
        recommender: "PercentileRecommender" = None,
        updater: Optional[Updater] = None,
        device=None,
    ):
        self.binding = binding
        self.cluster_api = cluster_api
        self.metrics_source = metrics_source
        self.checkpoint_path = checkpoint_path
        self.components = components
        # a supplied recommender brings its model: the feeder must feed the
        # SAME model the recommender reads
        if recommender is not None:
            self.model = recommender.model
            self.recommender = recommender
        else:
            self.model = ClusterStateModel(half_life_s=half_life_s, device=device)
            self.recommender = PercentileRecommender(self.model)
        self.updater = updater or Updater()
        # both containers keep their identity across passes: the admission
        # server holds references to them (test_vpa_e2e.py does the same)
        self.recommendations: Dict[ContainerKey, Recommendation] = {}
        self.vpas: List[Vpa] = []
        # (ns, pod) → labels from this pass's single pod LIST; the metrics
        # source joins against this instead of re-listing
        self.last_pod_labels: Dict = {}
        self.checkpoint_store = checkpoint_store
        self._prev_live_keys = None  # gates per-pass checkpoint GC
        if checkpoint_store is not None:
            try:
                ckpts = checkpoint_store.load()
            except Exception as e:  # noqa: BLE001
                # a transient apiserver blip at startup must not crash-loop
                # the recommender — a cold start works (exactly the CRD-absent
                # behavior); the histograms refill from live samples
                log.warning("checkpoint restore failed, starting cold: %s", e)
                ckpts = []
            CheckpointManager(self.model).load(ckpts)
            if ckpts:
                log.info(
                    "restored %d checkpoints from the control plane", len(ckpts)
                )
        elif checkpoint_path and os.path.exists(checkpoint_path):
            self.load_checkpoints()

    # -- checkpoints: control-plane CRDs (checkpoint_writer.go:36,78) or a
    # local JSON file for out-of-cluster runs --------------------------------
    def load_checkpoints(self) -> int:
        with open(self.checkpoint_path) as f:
            raw = json.load(f)
        ckpts = [Checkpoint(**c) for c in raw]
        CheckpointManager(self.model).load(ckpts)
        log.info("restored %d checkpoints from %s", len(ckpts), self.checkpoint_path)
        return len(ckpts)

    def save_checkpoints(self, live_vpa_keys=None) -> None:
        ckpts = CheckpointManager(self.model).store()
        if live_vpa_keys is not None:
            # GC discipline (routines/recommender.go:160 MaintainCheckpoints):
            # only checkpoints of VPAs that still exist are persisted — a
            # restored-then-deleted VPA's series must not resurrect its own
            # checkpoint forever.
            ckpts = [c for c in ckpts if (c.namespace, c.vpa) in live_vpa_keys]
        if self.checkpoint_store is not None:
            self.checkpoint_store.save(ckpts)
            # GC needs a second cluster-wide LIST, so it runs only when
            # orphans can exist: at the first pass (leftovers from a
            # predecessor) or when the live VPA set shrank — not every
            # cycle (the reference runs GC on a slow timer, not per pass).
            # The keep-set is the LIVE VPA LIST, never the model: a cold
            # start after a failed restore must not wipe persisted state.
            if live_vpa_keys is not None and (
                self._prev_live_keys is None
                or (self._prev_live_keys - set(live_vpa_keys))
            ):
                self.checkpoint_store.gc(live_vpa_keys)
            if live_vpa_keys is not None:
                self._prev_live_keys = set(live_vpa_keys)
            return
        if not self.checkpoint_path:
            return
        raw = [dataclasses.asdict(c) for c in ckpts]
        tmp = self.checkpoint_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(raw, f)
        os.replace(tmp, self.checkpoint_path)  # crash-safe swap

    # -- one pass ----------------------------------------------------------
    def run_once(self, now_ts: Optional[float] = None) -> Dict[str, int]:
        now_ts = time.time() if now_ts is None else now_ts
        with_status = self.binding.list_vpas_with_status()
        self.vpas[:] = [vpa for vpa, _ in with_status]
        vpas = self.vpas
        stats = {"vpas": len(vpas), "samples": 0, "statuses": 0, "evicted": 0}
        if not vpas:
            return stats
        pods = self.cluster_api.list_pods()
        # one LIST feeds everything this pass — the metrics source's label
        # join reads this map instead of re-listing (see main()'s wiring)
        self.last_pod_labels = {(p.namespace, p.name): p.labels for p in pods}

        # The updater must compare against what pods will actually be
        # re-admitted at: the policy-CLAMPED recommendation (raw bounds
        # would evict forever when a resourcePolicy caps the target), with
        # ScalingMode.OFF containers absent entirely.
        clamped: Dict[ContainerKey, Recommendation] = {}

        # recommender.RunOnce: feed → recommend → write status → checkpoint
        if "recommender" in self.components:
            feeder = ClusterStateFeeder(self.model, vpas)
            stats["samples"] = feeder.feed_once(self.metrics_source, now_ts)
            self.recommendations.clear()
            self.recommendations.update(self.recommender.recommend(now_ts))
            for vpa in vpas:
                per_container: Dict[str, Recommendation] = {}
                for key, rec in self.recommendations.items():
                    if key.vpa == vpa.name and key.namespace == vpa.namespace:
                        c = vpa.clamp(key.container, rec)
                        if c is not None:
                            per_container[key.container] = c
                            clamped[key] = c
                if per_container:
                    self.binding.write_status(vpa, per_container, now_ts)
                    stats["statuses"] += 1
            self.save_checkpoints(
                live_vpa_keys={(vpa.namespace, vpa.name) for vpa in vpas}
            )
        else:
            # updater-only process: work from the status a separate
            # recommender wrote, like the reference updater reads the CRD
            for vpa, status_recs in with_status:
                for container, rec in status_recs.items():
                    c = vpa.clamp(container, rec)
                    if c is not None:
                        clamped[
                            ContainerKey(vpa.name, container, vpa.namespace)
                        ] = c

        # updater.RunOnce: evict drifted pods of Auto/Recreate VPAs
        if "updater" in self.components and clamped:
            by_workload: Dict[str, List] = {}
            vpa_of: Dict[str, str] = {}
            vpa_by_workload: Dict[str, Vpa] = {}
            for vpa in vpas:
                wl = f"{vpa.namespace}/{vpa.name}"
                matched = [
                    p
                    for p in pods
                    if p.namespace == vpa.namespace
                    and vpa.target_selector.matches(p.labels)
                ]
                if matched:
                    by_workload[wl] = matched
                    vpa_of[wl] = vpa.name
                    # keyed by workload (ns/name): same-named VPAs in two
                    # namespaces must not collide on the eviction mode gate
                    vpa_by_workload[wl] = vpa
            evicted = self.updater.run_once(
                by_workload,
                clamped,
                vpa_of,
                now_ts,
                evict_fn=self.cluster_api.evict_pod,
                vpas=vpa_by_workload,
            )
            stats["evicted"] = len(evicted)
        return stats


def _fraction(s: str) -> float:
    v = float(s)
    if not (0.0 < v <= 1.0):
        raise argparse.ArgumentTypeError(
            f"expected a fraction in (0, 1], got {s}"
        )
    return v


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("tpu-autoscaler-vpa")
    p.add_argument("--kube-api", required=True,
                   help="API server URL, or 'in-cluster'")
    p.add_argument("--components", default="recommender,updater",
                   help="comma list of recommender,updater,admission")
    p.add_argument("--scrape-interval", type=float, default=60.0,
                   help="pass cadence (reference recommender/updater: 1m)")
    p.add_argument("--checkpoint-file", default="",
                   help="local JSON checkpoint path; overrides the default "
                        "VerticalPodAutoscalerCheckpoint CRD persistence "
                        "(use for out-of-cluster runs without the CRD)")
    p.add_argument("--storage", default="checkpoint",
                   choices=("checkpoint", "prometheus"),
                   help="warm-start source (reference recommender --storage): "
                        "checkpoint CRDs, or a Prometheus history replay at "
                        "startup (then live-only)")
    p.add_argument("--prometheus-address", default="",
                   help="Prometheus base URL for --storage=prometheus")
    p.add_argument("--history-length", default="8d")
    p.add_argument("--history-resolution", default="1h")
    p.add_argument("--prometheus-query-timeout", default="5m")
    p.add_argument("--prometheus-cadvisor-job-name", default="kubernetes-cadvisor")
    p.add_argument("--pod-label-prefix", default="pod_label_")
    p.add_argument("--metric-for-pod-labels",
                   default='up{job="kube-state-metrics"}[8d]')
    p.add_argument("--pod-namespace-label", default="kubernetes_namespace")
    p.add_argument("--pod-name-label", default="kubernetes_pod_name")
    p.add_argument("--container-namespace-label", default="namespace")
    p.add_argument("--container-pod-name-label", default="pod_name")
    p.add_argument("--container-name-label", default="name")
    p.add_argument("--no-checkpoints", action="store_true",
                   help="run stateless: neither CRD nor file checkpoints")
    p.add_argument("--memory-half-life", type=float, default=24 * 3600.0,
                   help="histogram decay half-life seconds (default 24h)")
    p.add_argument("--recommendation-margin-fraction", type=float, default=0.15,
                   help="safety margin added to recommendations")
    p.add_argument("--target-cpu-percentile", type=_fraction, default=0.9,
                   help="in (0, 1]")
    p.add_argument("--pod-recommendation-min-cpu-millicores", type=float,
                   default=25.0)
    p.add_argument("--pod-recommendation-min-memory-mb", type=float,
                   default=250.0)
    p.add_argument("--eviction-tolerance", type=float, default=0.5,
                   help="fraction of a workload's replicas the updater may "
                        "disrupt per pass")
    p.add_argument("--updater-min-replicas", type=int, default=2,
                   help="workloads below this replica count are never "
                        "evicted by the updater")
    p.add_argument("--webhook-timeout-seconds", type=int, default=30)
    p.add_argument("--admission-port", type=int, default=8443)
    p.add_argument("--webhook-service", default="vpa-webhook",
                   help="Service name the webhook registration points at")
    p.add_argument("--webhook-namespace", default="kube-system")
    p.add_argument("--max-iterations", type=int, default=0,
                   help="stop after N passes (0 = forever); for testing")
    # the port's one extra flag
    p.add_argument("--device", default=None,
                   help="torch device of the histogram banks (default: the "
                        "first CUDA card; 'cpu' keeps them on the host)")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    # the card is checked first: without one, nothing starts
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO)
    components = tuple(c.strip() for c in args.components.split(",") if c.strip())

    from autoscaler_tpu_torch.kube.client import KubeClusterAPI, KubeRestClient
    from autoscaler_tpu_torch.vpa.kube_io import (
        KubeMetricsSource,
        VpaCheckpointStore,
        VpaKubeBinding,
    )

    if args.kube_api == "in-cluster":
        client = KubeRestClient.in_cluster(user_agent="tpu-autoscaler-vpa")
    else:
        client = KubeRestClient(args.kube_api, user_agent="tpu-autoscaler-vpa")
    api = KubeClusterAPI(client)
    binding = VpaKubeBinding(client)
    # default persistence is the checkpoint CRD (checkpoint_writer.go:78):
    # a rescheduled recommender pod resumes warm from the control plane. An
    # explicit --checkpoint-file opts into local-file persistence instead.
    store = None
    if args.no_checkpoints or args.storage == "prometheus":
        # prometheus storage replays history at startup instead of resuming
        # from checkpoints (the reference's --storage switch, main.go)
        args.checkpoint_file = ""  # truly stateless: no file either
    elif not args.checkpoint_file:
        store = VpaCheckpointStore(client)

    model = ClusterStateModel(half_life_s=args.memory_half_life, device=device)
    runner = VpaRunner(
        binding,
        api,
        # labels come from run_once's own pod LIST — no second LIST per pass
        KubeMetricsSource(client, lambda: runner.last_pod_labels),
        checkpoint_path=args.checkpoint_file,
        checkpoint_store=store,
        components=components,
        # half-life lives in the model the recommender brings
        recommender=PercentileRecommender(
            model,
            target_cpu_percentile=args.target_cpu_percentile,
            safety_margin=1.0 + args.recommendation_margin_fraction,
            min_cpu_cores=args.pod_recommendation_min_cpu_millicores / 1000.0,
            min_memory_bytes=args.pod_recommendation_min_memory_mb * 1024 * 1024,
        ),
        updater=Updater(
            rate_limiter=EvictionRateLimiter(
                eviction_tolerance=args.eviction_tolerance,
                min_replicas=args.updater_min_replicas,
            )
        ),
    )

    if args.storage == "prometheus" and "recommender" in components:
        # Startup history replay (cluster_feeder.go InitFromHistoryProvider):
        # list VPAs once for key matching, pull the three Prometheus queries,
        # backfill the decaying histograms at original timestamps. A failure
        # is fatal, matching the reference recommender (a silent cold start
        # would hide a misconfigured --prometheus-address).
        from autoscaler_tpu_torch.vpa.prometheus_history import (
            PrometheusHistoryConfig,
            PrometheusHistorySource,
            parse_duration_s,
        )

        if not args.prometheus_address:
            raise SystemExit("--storage=prometheus requires --prometheus-address")
        source = PrometheusHistorySource(PrometheusHistoryConfig(
            address=args.prometheus_address,
            history_length=args.history_length,
            history_resolution=args.history_resolution,
            query_timeout_s=parse_duration_s(args.prometheus_query_timeout),
            pod_label_prefix=args.pod_label_prefix,
            pod_labels_metric_name=args.metric_for_pod_labels,
            pod_namespace_label=args.pod_namespace_label,
            pod_name_label=args.pod_name_label,
            ctr_namespace_label=args.container_namespace_label,
            ctr_pod_name_label=args.container_pod_name_label,
            ctr_name_label=args.container_name_label,
            cadvisor_job_name=args.prometheus_cadvisor_job_name,
        ))
        vpas = [v for v, _ in binding.list_vpas_with_status()]
        replayed = ClusterStateFeeder(runner.model, vpas).replay_history(source)
        logging.getLogger("vpa").info(
            "replayed %d historical samples from %s",
            replayed, args.prometheus_address,
        )

    admission = None
    if "admission" in components:
        from autoscaler_tpu_torch.vpa.admission import AdmissionServer
        from autoscaler_tpu_torch.vpa.certs import generate_certs, webhook_configuration
        from autoscaler_tpu_torch.vpa.kube_io import register_webhook

        bundle = generate_certs(
            service_name=args.webhook_service, namespace=args.webhook_namespace
        )
        admission = AdmissionServer(
            runner.vpas,                 # live references, refreshed per pass
            runner.recommendations,
            host="0.0.0.0",
            port=args.admission_port,
            tls=bundle,
        )
        admission.start()
        # selfRegistration (config.go:67-99): the fresh CA must be pushed
        # into the MutatingWebhookConfiguration every start, else the
        # webhook exists but never fires (failurePolicy Ignore)
        register_webhook(
            client,
            webhook_configuration(
                bundle,
                service_name=args.webhook_service,
                namespace=args.webhook_namespace,
                timeout_seconds=args.webhook_timeout_seconds,
            ),
        )
        print(f"vpa admission webhook on :{args.admission_port} (TLS), "
              f"registered as {args.webhook_service}.{args.webhook_namespace}.svc")

    print(f"tpu-autoscaler-vpa: components={components}, "
          f"interval {args.scrape_interval}s")

    def tick():
        log.info("pass: %s", runner.run_once())

    try:
        return poll_loop(tick, args.scrape_interval, args.max_iterations, logger=log)
    finally:
        if admission is not None:
            admission.stop()


if __name__ == "__main__":
    sys.exit(main())
