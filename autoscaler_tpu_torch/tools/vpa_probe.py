"""The Vertical Pod Autoscaler on the card: chip_smoke's 3z (the
recommender, updater and checkpoints of ``vpa/main.VpaRunner`` over the
snapshot probe's cluster, at a tenth) and 4t (the same on the CPU, every
output equal; K5 against its plain version on the warm start's batch).

    python3 -m autoscaler_tpu_torch.tools.vpa_probe                    # one card
    python3 -m autoscaler_tpu_torch.tools.vpa_probe --tenth            # chip_smoke's 3z
    python3 -m autoscaler_tpu_torch.tools.vpa_probe --device cpu --small

The cluster is ``utils/workload.build_snapshot_world`` (15 000 nodes,
100 000 pods of 300 apps, 5 000 DaemonSet pods), each app in a namespace of
its own with one VPA (Auto) over its pods, one container a pod. Every pod
uses a seeded multiple (0.5-2x) of its requests, so the recommendations
drift from the requests and the updater evicts; an evicted pod comes back
under a new name with the recommendation its VPA's status holds (the
admission webhook's patch). The DaemonSet has no VPA.

The traffic: a warm start from history at the reference recommender's
defaults (8 days at 1 hour, ``--history-length``/``--history-resolution``)
for the first 10 000 app pods, 192 CPU samples and 192 memory peaks a pod
through ``ClusterStateFeeder.replay_history``; then five live passes a
minute apart over every pod, each one ``VpaRunner.run_once`` (scrape,
recommend, status writes, checkpoints, evictions) against an in-memory API.

A pass over 100 000 pods takes ~15 s of host Python (the feed's VPA
match, the runner's grouping of pods by VPA, the updater), so chip_smoke
runs the world at a tenth (``TENTH``: 1 500 nodes, 10 000 pods of the
same 300 apps, all 10 000 in the warm start, which keeps its 1.92 M CPU
samples), as it runs 3r and 3t.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
import time
from typing import Dict, List

import numpy as np

from autoscaler_tpu_torch.device import resolve_device

HISTORY_PODS = 10_000
HISTORY_HOURS = 8 * 24          # --history-length=8d at --history-resolution=1h
PASSES = 5
PASS_S = 60.0
T0 = 1_700_000_000.0            # the warm start's history ends here
CONTAINER = "pod"               # the updater reads a pod's container from its name
TENTH = dict(N=1500, P=10_000, port_nodes=500, apps=300, history_pods=HISTORY_PODS)
SMALL = dict(N=300, P=2000, port_nodes=100, apps=12, history_pods=200)


def vpa_world(N=None, P=None, port_nodes=None, apps=None, history_pods=HISTORY_PODS,
              seed=0) -> dict:
    """The cluster, its VPAs and the seeded usage model (a dict of plain
    objects: the same seed builds the same world in any process)."""
    from autoscaler_tpu_torch.kube.objects import LabelSelector
    from autoscaler_tpu_torch.utils import workload
    from autoscaler_tpu_torch.vpa.api import UpdateMode, Vpa

    N = workload.SNAPSHOT_NODES if N is None else N
    P = workload.SNAPSHOT_PODS if P is None else P
    port_nodes = workload.SNAPSHOT_PORT_NODES if port_nodes is None else port_nodes
    apps = workload.SNAPSHOT_APPS if apps is None else apps
    _, pods = workload.build_snapshot_world(N=N, P=P, port_nodes=port_nodes, apps=apps,
                                            seed=seed)
    pods = [p if p.labels.get("app") == "node-exporter" else
            dataclasses.replace(p, namespace=f"team-{p.labels['app']}") for p in pods]
    vpas = [Vpa(name=f"app-{a}-vpa", namespace=f"team-app-{a}",
                target_selector=LabelSelector.from_dict({"app": f"app-{a}"}),
                update_mode=UpdateMode.AUTO) for a in range(apps)]
    rng = np.random.default_rng(seed + 1)
    scale = rng.uniform(0.5, 2.0, apps)
    usage = {}
    for p in pods:
        app = p.labels["app"]
        s = 1.0 if app == "node-exporter" else float(scale[int(app.split("-")[1])])
        usage[p.name] = (p.requests.cpu_m / 1000.0 * s, p.requests.memory * s)
    history = [p for p in pods if p.labels["app"] != "node-exporter"][:history_pods]
    return {"pods": pods, "vpas": vpas, "usage": usage, "history": history, "seed": seed}


class MemoryBinding:
    """The VPA objects' API in memory: lists the VPAs with the statuses
    written so far, records each status write."""

    def __init__(self, vpas):
        self.vpas = vpas
        self.statuses: Dict[tuple, dict] = {}
        self.writes: List[tuple] = []

    def list_vpas_with_status(self):
        return [(v, dict(self.statuses.get((v.namespace, v.name), {}))) for v in self.vpas]

    def write_status(self, vpa, recs, now_ts):
        self.statuses[(vpa.namespace, vpa.name)] = dict(recs)
        self.writes.append((vpa.namespace, vpa.name, now_ts,
                            sorted((c, _rec(r)) for c, r in recs.items())))


class MemoryClusterAPI:
    """The pods' API in memory: an evicted pod is replaced by a pod of a new
    name whose requests are its VPA's status target (the admission
    webhook's patch, ``updater.apply_recommendation``)."""

    def __init__(self, pods, vpas, binding):
        self.pods = {(p.namespace, p.name): p for p in pods}
        self.vpa_of_ns = {v.namespace: v for v in vpas}
        self.binding = binding
        self.evicted: List[str] = []

    def list_pods(self):
        return list(self.pods.values())

    def evict_pod(self, pod):
        del self.pods[(pod.namespace, pod.name)]
        self.evicted.append(f"{pod.namespace}/{pod.name}")
        vpa = self.vpa_of_ns[pod.namespace]
        rec = self.binding.statuses[(vpa.namespace, vpa.name)][CONTAINER]
        # updater.apply_recommendation's patch, on a shallow copy (a new Pod
        # would run its __post_init__ for each of thousands of evictions)
        new = copy.copy(pod)
        new.name = pod.name + "r"
        new.requests = dataclasses.replace(pod.requests, cpu_m=rec.target_cpu * 1000.0,
                                           memory=rec.target_memory)
        self.pods[(new.namespace, new.name)] = new


class MemoryCheckpointStore:
    """VerticalPodAutoscalerCheckpoint objects in memory: the last save
    (each save holds every live VPA's checkpoints, so GC has nothing to
    remove)."""

    def __init__(self):
        self.saved: list = []

    def load(self):
        return []

    def save(self, ckpts):
        self.saved = [dataclasses.asdict(c) for c in ckpts]

    def gc(self, live):
        pass


class UsageSource:
    """metrics.k8s.io in memory: each listed pod's seeded usage, times a
    pass's seeded noise."""

    def __init__(self, api, usage, seed):
        self.api, self.usage, self.seed = api, usage, seed
        self.passes = 0

    def container_usage(self, now_ts):
        from autoscaler_tpu_torch.vpa.feeder import ContainerUsage

        pods = self.api.list_pods()
        rng = np.random.default_rng((self.seed, self.passes))
        self.passes += 1
        noise = rng.lognormal(0.0, 0.1, (len(pods), 2))
        out = []
        for p, (nc, nm) in zip(pods, noise):
            cpu, mem = self.usage[p.name.rstrip("r")]
            out.append(ContainerUsage(p.namespace, p.name, CONTAINER, p.labels,
                                      cpu_cores=cpu * nc, memory_bytes=mem * nm))
        return out


def history_source(world):
    """The warm start's history: 8 days of hourly CPU samples and memory
    peaks for each history pod, seeded."""
    from autoscaler_tpu_torch.vpa.feeder import InMemoryMetrics

    src = InMemoryMetrics()
    rng = np.random.default_rng(world["seed"] + 2)
    ts = (T0 - HISTORY_HOURS * 3600.0 + 3600.0 * np.arange(1, HISTORY_HOURS + 1)).tolist()
    for p in world["history"]:
        cpu, mem = world["usage"][p.name]
        noise = rng.lognormal(0.0, 0.2, (2, HISTORY_HOURS))
        src.add_history(p.namespace, p.name, CONTAINER, p.labels,
                        cpu=list(zip(ts, (cpu * noise[0]).tolist())),
                        memory=list(zip(ts, (mem * noise[1]).tolist())))
    return src


def _rec(r) -> tuple:
    return tuple(float(getattr(r, f.name)) for f in dataclasses.fields(r))


def _recs(recs) -> list:
    return sorted(((k.namespace, k.vpa, k.container), _rec(r)) for k, r in recs.items())


def run_vpa(world, device=None, passes=PASSES, capture=None) -> dict:
    """The warm start and ``passes`` live passes on ``device`` (the first
    card by default) → {"replay": ..., "passes": [...], "series", "runner"}
    with each part's host seconds. ``capture``, a list, gets a copy of
    every call of K5's wrapper during the warm start: (target before,
    index, values, target after)."""
    from autoscaler_tpu_torch.vpa import histogram
    from autoscaler_tpu_torch.vpa.feeder import ClusterStateFeeder
    from autoscaler_tpu_torch.vpa.main import VpaRunner
    from autoscaler_tpu_torch.vpa.recommender import ClusterStateModel, PercentileRecommender

    device = resolve_device(device)
    binding = MemoryBinding(world["vpas"])
    api = MemoryClusterAPI(world["pods"], world["vpas"], binding)
    store = MemoryCheckpointStore()
    model = ClusterStateModel(device=device)
    runner = VpaRunner(binding, api, UsageSource(api, world["usage"], world["seed"]),
                       checkpoint_store=store, recommender=PercentileRecommender(model))
    source = history_source(world)
    real = histogram.ordered_scatter_add

    def recording(target, index, values):
        before = target.clone()
        out = real(target, index, values)
        capture.append((before, index.clone(), values.clone(), out.clone()))
        return out

    if capture is not None:
        histogram.ordered_scatter_add = recording
    try:
        t0 = time.perf_counter()
        samples = ClusterStateFeeder(model, world["vpas"]).replay_history(source)
        _sync(device)
        replay_s = time.perf_counter() - t0
    finally:
        histogram.ordered_scatter_add = real
    out = {"replay": {"samples": samples, "seconds": replay_s,
                      "recs": _recs(runner.recommender.recommend(T0))}, "passes": []}
    for k in range(passes):
        writes, evicted = len(binding.writes), len(api.evicted)
        t0 = time.perf_counter()
        stats = runner.run_once(now_ts=T0 + PASS_S * (k + 1))
        _sync(device)
        out["passes"].append({
            "seconds": time.perf_counter() - t0, "stats": stats,
            "recs": _recs(runner.recommendations), "statuses": binding.writes[writes:],
            "evicted": api.evicted[evicted:], "checkpoints": store.saved,
        })
    out["series"] = len(model.keys())
    out["runner"] = runner
    return out


def admission_check(runner, https: bool, apps: int = 8) -> dict:
    """The admission webhook (``vpa/admission.AdmissionServer``) over the
    runner's VPAs and recommendations, over HTTP, or over HTTPS with
    certificates from ``vpa/certs.generate_certs`` (which needs the
    ``cryptography`` package): a review of a new pod of each of the first
    ``apps`` apps → {"reviews", "patched", "equal"}: how many came back
    with a patch, and whether every answer equals ``review_pod``'s."""
    import http.client

    from autoscaler_tpu_torch.vpa.admission import AdmissionServer, review_pod

    ctx = bundle = None
    if https:
        from autoscaler_tpu_torch.vpa.certs import generate_certs

        bundle = generate_certs()
        ctx = bundle.client_ssl_context()
    server = AdmissionServer(runner.vpas, runner.recommendations, tls=bundle)
    server.start()
    out = {"reviews": 0, "patched": 0, "equal": True}
    try:
        host, port = server.address
        for vpa in runner.vpas[:apps]:
            app = dict(vpa.target_selector.match_labels)["app"]
            review = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                      "request": {"uid": f"new-{app}", "namespace": vpa.namespace, "object": {
                          "metadata": {"name": f"new-{app}", "labels": {"app": app}},
                          "spec": {"containers": [{"name": CONTAINER, "resources": {
                              "requests": {"cpu": "100m", "memory": "128Mi"}}}]}}}}
            conn = (http.client.HTTPSConnection(host, port, timeout=10, context=ctx) if https
                    else http.client.HTTPConnection(host, port, timeout=10))
            try:
                conn.request("POST", "/mutate", json.dumps(review),
                             {"Content-Type": "application/json"})
                answer = json.loads(conn.getresponse().read())
            finally:
                conn.close()
            out["reviews"] += 1
            out["patched"] += "patch" in answer.get("response", {})
            out["equal"] &= answer == review_pod(review, runner.vpas, runner.recommendations)
    finally:
        server.stop()
    return out


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def comparable(result) -> dict:
    """``run_vpa``'s result without its host seconds."""
    return {"replay": {k: v for k, v in result["replay"].items() if k != "seconds"},
            "passes": [{k: v for k, v in p.items() if k != "seconds"}
                       for p in result["passes"]],
            "series": result["series"]}


def summary(result) -> dict:
    """One line of the run: samples, series, each pass's stats and the
    host seconds of the warm start and of each pass."""
    return {
        "replay_samples": result["replay"]["samples"],
        "replay_s": result["replay"]["seconds"],
        "series": result["series"],
        "passes": [dict(p["stats"], seconds=p["seconds"]) for p in result["passes"]],
    }


def problems(result) -> list:
    """What a run must show: the warm start's samples, a recommendation
    for every series, and in every pass a status for every VPA, a
    checkpoint for every series and at least one eviction in all."""
    bad = []
    n_vpas = result["passes"][0]["stats"]["vpas"] if result["passes"] else 0
    if result["replay"]["samples"] == 0 or not result["replay"]["recs"]:
        bad.append("the warm start fed nothing")
    for k, p in enumerate(result["passes"]):
        if p["stats"]["statuses"] != n_vpas or len(p["recs"]) != result["series"]:
            bad.append(f"pass {k}: {p['stats']} for {result['series']} series")
        if len(p["checkpoints"]) != result["series"]:
            bad.append(f"pass {k}: {len(p['checkpoints'])} checkpoints")
        for _, rec in p["recs"]:
            if not all(np.isfinite(rec)) or min(rec) <= 0:
                bad.append(f"pass {k}: a recommendation {rec}")
                break
    if not sum(len(p["evicted"]) for p in result["passes"]):
        bad.append("no pass evicted a pod")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the first card)")
    ap.add_argument("--tenth", action="store_true",
                    help="the cluster at a tenth, the warm start whole (chip_smoke's 3z)")
    ap.add_argument("--small", action="store_true", help="a small world (seconds on a CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    world = vpa_world(**(SMALL if args.small else TENTH if args.tenth else {}))
    print(f"# world {time.perf_counter() - t0:.3f} s: {len(world['pods'])} pods, "
          f"{len(world['vpas'])} VPAs, {len(world['history'])} history pods", flush=True)
    result = run_vpa(world, device)
    print(json.dumps(summary(result), sort_keys=True), flush=True)
    bad = problems(result)
    if bad:
        print(f"problems: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
