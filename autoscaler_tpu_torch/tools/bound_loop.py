"""The reconcile loop bound to a Kubernetes API and a cloud API over HTTP:
chip_smoke's 3r (three ticks at 3o's size through the kube client's watch
cache and the clusterapi provider, under Lease election), 3s
(``python -m autoscaler_tpu_torch.main --provider=gce`` in a subprocess)
and 4n (3r's sequence and 3s's gce world at 4l's size, on the card and on
the CPU, compared write for write).

    python3 -m autoscaler_tpu_torch.tools.bound_loop                  # one card
    python3 -m autoscaler_tpu_torch.tools.bound_loop --device cpu --tenth

The fake APIs are ``tools/binding_probe``'s, served from a child process.
The world is 3o's (``loop_probe``): every node group is a
MachineDeployment in a namespace of its own named after the group (so
that groups sort as 3o's do), with its size annotations and the
scale-from-zero capacity annotations of its template; each node carries
its Machine's annotation. The autoscaler is ``KubeRestClient`` →
``KubeClusterAPI(watch=True)`` → ``build_clusterapi_provider`` →
``StaticAutoscaler`` at ``BOUND_OPTIONS`` (3o's, whose expander is
``priority,least-waste``, with the live priority ConfigMap), under a
``LeaderElector`` on a ``KubeLease``. Between ticks ``http_churn`` makes
3o's churn (``loop_probe.churn``) on the fake API as watch events: the
filtered pods bound to their hinted nodes, the Machines and Nodes that the
tick's ``/scale`` writes asked for come up from their group's template
with the still-pending pods bound onto them, the pods none holds deleted,
then the arrivals. The next tick starts once both watch caches hold the
last event.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List

from autoscaler_tpu_torch import trace
from autoscaler_tpu_torch.cloudprovider.clusterapi import build_clusterapi_provider
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.core.static_autoscaler import StaticAutoscaler
from autoscaler_tpu_torch.kube.client import KubeClusterAPI, KubeLease, KubeRestClient
from autoscaler_tpu_torch.metrics import metrics as metrics_mod
from autoscaler_tpu_torch.tools import binding_probe as bp
from autoscaler_tpu_torch.tools import loop_probe
from autoscaler_tpu_torch.tools.scaledown_probe import shape_provider
from autoscaler_tpu_torch.tools.tick_probe import TICK_MAX_SIZE, node_from_template
from autoscaler_tpu_torch.utils.leaderelection import LeaderElector

PRIORITY_MAP = "cluster-autoscaler-priority-expander"
# one tier that every group's id matches: the chain's least-waste decides
PRIORITIES = {"10": [".*"]}
# 3o's options with the live priority ConfigMap, and node deletions batched
# into one call a group a wave: the clusterapi provider's delete_nodes
# reads and writes a MachineDeployment's replicas unlocked, so two
# deletions of one group flushed at once lose one decrement (ROADMAP
# queue 3)
BOUND_OPTIONS = {**loop_probe.LOOP_OPTIONS, "priority_config_map": PRIORITY_MAP,
                 "node_deletion_batcher_interval_s": 3600.0}
LEASE = "autoscaler-tpu"
IDENTITY = "bound-loop"
# one renewal period longer than a run, so that the Lease's writes replay
# alike (the elector's renewals are held on the CPU with an injected clock)
RENEW_PERIOD_S = 900.0
RENEW_DEADLINE_S = 3600.0
SYNC_TIMEOUT_S = 600.0   # the first list at 3o's size takes seconds of host time
GCE_PROJECT, GCE_ZONE = "proj", "us-central2-b"
# the gce world's MIGs for the burst: (machine type, zone label), one a
# ct5lp TPU pool (tainted google.com/tpu: no burst pod tolerates it)
GCE_BURST_MIGS = (("n2-standard-8", "zone-a"), ("n2-standard-16", "zone-b"),
                  ("e2-standard-8", "zone-c"), ("n2-standard-16", "zone-a"),
                  ("ct5lp-hightpu-4t", "zone-b"))


def group_name(group_id: str) -> str:
    """A MachineDeployment group's id ("MachineDeployment/ns/name") → the
    3o group it stands for (its name)."""
    return group_id.rsplit("/", 1)[-1]


class Mirror:
    """What the caller knows of the fake API's world, to make 3o's churn:
    the pods by key (the objects as made), each pod's node, the nodes by
    name, each group's template and replicas, and how far the write log was
    read."""

    def __init__(self, nodes, pods, templates: Dict[str, object], replicas: Dict[str, int]):
        self.pods = {p.key(): p for p in pods}
        self.node_of = {p.key(): p.node_name for p in pods}
        self.nodes = {n.name: n for n in nodes}
        self.templates = templates
        self.replicas = dict(replicas)
        self.writes_seen = 0

    def read_writes(self, servers) -> List[tuple]:
        """The autoscaler's writes since the last read, applied to the
        mirror: evictions take pods away, node DELETEs nodes, ``/scale``
        PUTs set replicas. → the (group, delta) of each scale-up PUT, in
        order (3o's ``scale_up_calls``)."""
        writes = servers.writes(self.writes_seen)
        self.writes_seen += len(writes)
        calls = []
        for method, path, body in writes:
            parts = path.split("?")[0].strip("/").split("/")
            if method == "POST" and parts[-1] == "eviction":
                self.node_of.pop(f"{parts[3]}/{parts[5]}", None)
            elif method == "DELETE" and path.startswith("/api/v1/nodes/"):
                self.nodes.pop(parts[-1], None)
            elif method == "PUT" and parts[-1] == "scale":
                gid, replicas = parts[-2], int(body["spec"]["replicas"])
                if replicas > self.replicas[gid]:
                    calls.append((gid, replicas - self.replicas[gid]))
                self.replicas[gid] = replicas
        return calls


def _machine_ops(gid: str, node) -> list:
    """The Machine of a group's node, and the node with its annotation."""
    machine = f"{node.name}-machine"
    return [
        ["put", "machines", bp.machine_json(gid, machine, f"{gid}-ms", gid, node.provider_id)],
        ["put", "nodes", bp.node_json(node, {bp.MACHINE_ANNOTATION: f"{gid}/{machine}"})],
    ]


def serve_capi_world(servers, nodes, pods, groups) -> Mirror:
    """Load 3o's world into the fake API: the shape groups of
    ``scaledown_probe.shape_provider`` owning ``nodes`` and a group per
    burst template (min 0, max ``TICK_MAX_SIZE``, replicas 0), each a
    MachineDeployment with a MachineSet, a Machine per node, the nodes
    annotated, the pods (the burst among them, pending), and the priority
    ConfigMap as JSON."""
    shapes = shape_provider(nodes)
    spec = []   # (gid, min, max, replicas, template), in 3o's group order
    for g in shapes.node_groups():
        spec.append((g.id(), g.min_size(), g.max_size(), g.target_size(),
                     shapes._groups[g.id()]._template))
    for gid, template in sorted(groups.items()):
        spec.append((gid, 0, TICK_MAX_SIZE, 0, template))
    servers.load("machinedeployments", [
        bp.machine_deployment_json(gid, gid, lo, hi, n, template)
        for gid, lo, hi, n, template in spec])
    servers.load("machinesets", [bp.machine_set_json(gid, f"{gid}-ms", gid)
                                 for gid, *_ in spec])
    machines, node_lines = [], []
    for node in nodes:
        gid = shapes.node_group_for_node(node).id()
        machine = f"{node.name}-machine"
        machines.append(bp.machine_json(gid, machine, f"{gid}-ms", gid, node.provider_id))
        node_lines.append((node.name, json.dumps(bp.node_json(
            node, {bp.MACHINE_ANNOTATION: f"{gid}/{machine}"}))))
    servers.load("machines", machines)
    servers.load("nodes", node_lines)
    servers.load("pods", [(p.key(), json.dumps(bp.pod_json(p))) for p in pods])
    servers.load("configmaps", [{
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": PRIORITY_MAP, "namespace": "kube-system"},
        "data": {"priorities": json.dumps(PRIORITIES)}}])
    templates = {gid: template for gid, _, _, _, template in spec}
    return Mirror(nodes, pods, templates, {gid: n for gid, _, _, n, _ in spec})


def http_churn(sa, servers, mirror: Mirror, calls, seed: int, arriving=()) -> dict:
    """``loop_probe.churn`` on the fake API, every change a watch event: →
    the same counts."""
    hints = sa.pod_list_processor.hinting.hints
    pending = sorted(k for k, n in mirror.node_of.items() if not n)
    ops, bound = [], 0
    for key in pending:
        hinted = hints.get(key)
        if hinted is not None and hinted in mirror.nodes:
            ops.append(["bind", key, hinted])
            mirror.node_of[key] = hinted
            bound += 1
    new_nodes = []
    for gid, delta in calls:
        for k in range(delta):
            node = node_from_template(mirror.templates[gid], f"{gid}-t{seed}-{k}")
            ops += _machine_ops(gid, node)
            mirror.nodes[node.name] = node
            new_nodes.append([node, [0.0, 0.0, 0]])
    placed = gone = 0
    for key in pending:
        if mirror.node_of[key]:
            continue
        pod = mirror.pods[key]
        for node, used in new_nodes:
            if loop_probe._fits(pod, node, used):
                used[0] += pod.requests.cpu_m
                used[1] += pod.requests.memory
                used[2] += 1
                ops.append(["bind", key, node.name])
                mirror.node_of[key] = node.name
                placed += 1
                break
        else:
            ops.append(["delete", "pods", key])
            del mirror.node_of[key]
            gone += 1
    for pod in arriving:
        ops.append(["put", "pods", bp.pod_json(pod)])
        mirror.pods[pod.key()] = pod
        mirror.node_of[pod.key()] = pod.node_name
    servers.apply(ops)
    return {"bound": bound, "new_nodes": len(new_nodes), "placed": placed,
            "gone": gone, "arrived": len(arriving)}


def cache_rv(cache) -> int:
    with cache._lock:
        return int(cache._resource_version or 0)


def wait_applied(api: KubeClusterAPI, servers, timeout_s: float = 120.0) -> float:
    """Block until both watch caches hold the fake API's last node and pod
    event. → seconds waited."""
    t0 = time.perf_counter()
    last = servers.last_rv()
    while (cache_rv(api._node_cache) < last["nodes"] or cache_rv(api._pod_cache) < last["pods"]):
        if time.perf_counter() - t0 > timeout_s:
            raise RuntimeError(f"watch caches behind the API: {last}")
        time.sleep(0.001)
    return time.perf_counter() - t0


class ListTimer:
    """Host seconds of the cluster API's lists in each tick (the watch
    cache's copy and ``convert``), by wrapping ``list_nodes`` and
    ``list_pods``."""

    def __init__(self, api):
        self.api, self.times = api, {}
        self._undo = [(name, getattr(api, name)) for name in ("list_nodes", "list_pods")]
        for name, fn in self._undo:
            setattr(api, name, self._timed(name, fn))

    def _timed(self, name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0
        return run

    def take(self) -> dict:
        times, self.times = self.times, {}
        return times


class SeedListSplit:
    """The watch caches' seed LISTs in parts, by wrapping the client's
    ``get`` and ``utils/http``'s ``json.loads`` (each cache lists in a
    thread of its own): for each path, the bytes, the HTTP read (the
    request less the decode) and ``json.loads``. ``convert`` runs later,
    in each ``list_pods``."""

    def __init__(self, client):
        self.client, self.parts = client, {}
        self._local = threading.local()

    def __enter__(self):
        from autoscaler_tpu_torch.utils import http as http_mod

        local, real = self._local, json

        class TimedJson:
            dumps = staticmethod(real.dumps)
            JSONDecodeError = real.JSONDecodeError

            @staticmethod
            def loads(payload):
                t0 = time.perf_counter()
                try:
                    return real.loads(payload)
                finally:
                    local.loads = time.perf_counter() - t0
                    local.size = len(payload)

        self._http = http_mod
        http_mod.json = TimedJson
        real_get = self.client.get

        def get(path):
            local.loads, local.size = 0.0, 0
            t0 = time.perf_counter()
            out = real_get(path)
            total = time.perf_counter() - t0
            self.parts.setdefault(path.split("?", 1)[0], {
                "items": len(out.get("items") or ()), "bytes": local.size,
                "http_read_s": total - local.loads, "json_loads_s": local.loads})
            return out

        self.client.get = get
        return self

    def __exit__(self, *exc):
        self._http.json = json
        del self.client.get
        return False


def build_bound(servers, device=None, metrics=None, clock=None):
    """→ (autoscaler, provider, api, client, seconds to sync, the seed
    LISTs' split by path) bound to ``servers``: the kube client with watch
    caches (waited for until synced), the clusterapi provider and a
    ``StaticAutoscaler`` on ``device`` at ``BOUND_OPTIONS``."""
    client = KubeRestClient(servers.kube_url)
    t0 = time.perf_counter()
    with SeedListSplit(client) as split:
        api = KubeClusterAPI(client, watch=True)
        for cache in (api._node_cache, api._pod_cache):
            if not cache.wait_synced(SYNC_TIMEOUT_S):
                raise RuntimeError(f"the {cache.path} watch cache did not sync")
    synced = time.perf_counter() - t0
    provider = build_clusterapi_provider(client)
    options = AutoscalingOptions(**BOUND_OPTIONS)
    kw = {} if metrics is None else {"metrics": metrics}
    if clock is not None:
        kw.setdefault("metrics", metrics_mod.AutoscalerMetrics())
        kw["tracer"] = trace.Tracer(
            clock=clock, metrics=kw["metrics"],
            recorder=trace.FlightRecorder(capacity=options.trace_ring_size),
            slow_tick_threshold_s=options.trace_slow_tick_threshold_s,
        )
    sa = StaticAutoscaler(provider, api, options, device=device, **kw)
    return sa, provider, api, client, synced, split.parts


def target_sizes(provider) -> Dict[str, int]:
    return {group_name(g.id()): g.target_size() for g in provider.node_groups()}


def write_canon(writes) -> List[str]:
    """The write log as sorted JSON lines (the actuator's workers write in
    the order they finish), with the times the writers stamp from the wall
    clock left out: the Lease's, and the deletion mark's on a Machine."""
    out = []
    for method, path, body in writes:
        body = copy.deepcopy(body)
        if isinstance(body, dict):
            spec = body.get("spec")
            if "/leases" in path and isinstance(spec, dict):
                for k in ("acquireTime", "renewTime"):
                    spec.pop(k, None)
            ann = (body.get("metadata") or {}).get("annotations") or {}
            if ann.get(bp.DELETE_MACHINE) is not None:
                ann[bp.DELETE_MACHINE] = "<time>"
        out.append(json.dumps([method, path, body], sort_keys=True))
    return sorted(out)


def decisions(result) -> dict:
    """A tick's decisions, group names as 3o's: the scale-up by group, the
    nodes deleted, the unneeded count and the unremovable count."""
    up, down = result.scale_up, result.scale_down
    return {
        "scale_up": sorted((group_name(g), int(n)) for g, n in (up.executed if up else ())),
        "deleted": sorted((down.deleted_empty + down.deleted_drain) if down else ()),
        "unneeded": result.unneeded_nodes,
        "errors": list(result.errors),
    }


def write_problems(entry: dict, status_map: str = "cluster-autoscaler-status") -> List[str]:
    """What a tick's writes miss of its decisions: a ``/scale`` PUT for
    each group scaled up, the ToBeDeleted taint and a DELETE for each node
    deleted (and no other node DELETE), an eviction for each pod evicted,
    one status ConfigMap PUT. → the problems (empty when all are there)."""
    from autoscaler_tpu_torch.kube.objects import TO_BE_DELETED_TAINT

    writes, d, r = entry["writes"], entry["decisions"], entry["result"]
    scaled = {g for g, _ in d["scale_up"]}
    put_scale = {path.split("/")[-2] for m, path, _ in writes
                 if m == "PUT" and path.endswith("/scale")}
    deleted = set(d["deleted"])
    tainted = {path.rsplit("/", 1)[1] for m, path, body in writes
               if m == "PATCH" and path.startswith("/api/v1/nodes/")
               and any(t["key"] == TO_BE_DELETED_TAINT
                       for t in (body.get("spec") or {}).get("taints") or ())}
    removed = {path.rsplit("/", 1)[1] for m, path, _ in writes
               if m == "DELETE" and path.startswith("/api/v1/nodes/")}
    evictions = sum(1 for m, path, _ in writes if m == "POST" and path.endswith("/eviction"))
    status = sum(1 for m, path, _ in writes
                 if m == "PUT" and path.endswith(f"/configmaps/{status_map}"))
    problems = []
    if not scaled <= put_scale:
        problems.append(f"no /scale PUT for {sorted(scaled - put_scale)}")
    if not deleted <= tainted:
        problems.append(f"no ToBeDeleted taint on {sorted(deleted - tainted)}")
    if removed != deleted:
        problems.append(f"node DELETEs {sorted(removed)} for deletions {sorted(deleted)}")
    evicted = len(r.scale_down.evicted_pods) if r.scale_down is not None else 0
    if evictions != evicted:
        problems.append(f"{evictions} evictions for {evicted} pods evicted")
    if status != 1:
        problems.append(f"{status} status ConfigMap writes")
    return problems


def lease_holders(writes) -> set:
    """The holders the Lease's creations and updates named."""
    return {(body.get("spec") or {}).get("holderIdentity") for m, path, body in writes
            if "/leases" in path and m in ("POST", "PUT")}


def run_bound_ticks(nodes, pods, burst, groups, device=None, arrive=loop_probe.ARRIVALS,
                    metrics=None, replayable=False, timed=False, servers=None) -> dict:
    """3r: 3o's three ticks through the bindings on ``device``, under the
    elector. ``replayable`` puts the tracer on the ticks' timeline, as
    ``loop_probe.run_loop_ticks`` does. → {"ticks": [{"result", "decisions",
    "unremovable", "targets", "writes", "churn", "apply_s", "lists", "split",
    "probe"}], "first": the pods' seed LIST in parts (HTTP read, json.loads)
    and tick 1's ``list_pods`` (convert), "synced_s", "leases",
    "writes": the whole log, "load_s"}; the servers are stopped unless
    passed in."""
    own = servers is None
    servers = servers or bp.FakeServers.start()
    try:
        t0 = time.perf_counter()
        mirror = serve_capi_world(servers, nodes, list(pods) + list(burst), groups)
        load_s = time.perf_counter() - t0
        timeline = {"now": 0.0}
        clock = (lambda: timeline["now"]) if replayable else None
        sa, provider, api, client, synced_s, seeds = build_bound(servers, device, metrics, clock)
        timer = ListTimer(api)
        probes = []
        probe = sa.journal.probe

        def recording_probe():
            verdict = probe()
            probes.append(verdict)
            return verdict

        sa.journal.probe = recording_probe
        ticks = []
        elector = LeaderElector(KubeLease(client, LEASE, "kube-system"), identity=IDENTITY,
                                renew_period_s=RENEW_PERIOD_S,
                                renew_deadline_s=RENEW_DEADLINE_S)

        def lead(still_leader):
            churned, apply_s = None, 0.0
            for k, now in enumerate(loop_probe.LOOP_TICKS):
                if not still_leader():
                    raise RuntimeError("bound loop: lost the Lease")
                if k:
                    calls = mirror.read_writes(servers)
                    churned = http_churn(sa, servers, mirror, calls, seed=k,
                                         arriving=loop_probe.arrivals(arrive, k) if k == 2
                                         else ())
                    apply_s = wait_applied(api, servers)
                else:
                    mirror.read_writes(servers)
                seen = mirror.writes_seen
                timer.take()
                timeline["now"] = now
                result = sa.run_once(now_ts=now)
                entry = {"result": result, "decisions": decisions(result),
                         "unremovable": len(sa.scale_down_planner.last_unremovable()),
                         "targets": target_sizes(provider),
                         "writes": servers.writes(seen), "churn": churned,
                         "apply_s": apply_s, "lists": timer.take(),
                         "probe": probes[-1] if probes else None}
                if timed:
                    entry["split"] = loop_probe.span_split(sa)
                ticks.append(entry)

        try:
            elector.run(lead)
        finally:
            sa.journal.probe = probe
            api.close()
        first = dict(seeds.get("/api/v1/pods", {}), path="/api/v1/pods")
        first["convert_s"] = ticks[0]["lists"].get("list_pods", 0.0) if ticks else None
        return {"ticks": ticks, "first": first, "synced_s": synced_s, "load_s": load_s,
                "leases": servers.objects("leases"), "writes": servers.writes(),
                "autoscaler": sa, "provider": provider}
    finally:
        if own:
            servers.close()


def bound_line(label: str, entry: dict) -> str:
    d = entry["decisions"]
    parts = [f"# bound tick {label}: scale_up {d['scale_up']}, deleted {len(d['deleted'])}, "
             f"unneeded {d['unneeded']}, unremovable {entry['unremovable']}, "
             f"errors {d['errors']}, writes {len(entry['writes'])}",
             f"watch apply {entry['apply_s']:.3f} s",
             "lists " + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(entry["lists"].items()))]
    if entry["churn"] is not None:
        parts.append(f"churn before {entry['churn']}")
    if "split" in entry:
        parts.append("split " + ", ".join(f"{k} {v:.3f}" for k, v in entry["split"].items()))
    parts.append(f"probe {entry['probe']}")
    return "; ".join(parts)


# -- gce ---------------------------------------------------------------------------------------------
def gce_world(nodes, pods, burst):
    """3s's world: ``nodes`` as instances of one MIG a node shape in
    ``GCE_ZONE`` (their providerID ``gce://project/zone/name``), and the
    burst MIGs of ``GCE_BURST_MIGS`` (target 0) with their instance
    templates. → (nodes, pods, MIGs for ``FakeServers.load_compute``,
    templates, the ``--nodes`` specs)."""
    from autoscaler_tpu_torch.cloudprovider.gce import MACHINE_TYPES

    by_cpu = sorted(MACHINE_TYPES.items(), key=lambda kv: kv[1])
    out_nodes, members = [], {}
    for node in nodes:
        n = copy.deepcopy(node)
        n.provider_id = f"gce://{GCE_PROJECT}/{GCE_ZONE}/{n.name}"
        a = n.allocatable
        mig = f"shape-{int(a.cpu_m) // 1000}c-{int(a.memory) // 2**30}g"
        members.setdefault(mig, []).append(n.name)
        out_nodes.append(n)
    migs, templates, specs = [], {}, []
    for mig, names in sorted(members.items()):
        cpu = int(mig.split("-")[1][:-1]) * 1000
        mtype = next((t for t, v in by_cpu if v[0] >= cpu and v[2] == v[3] == 0), by_cpu[-1][0])
        templates[f"{mig}-tmpl"] = {"properties": {"machineType": f"zones/{GCE_ZONE}/machineTypes/"
                                                                  f"{mtype}", "labels": {}}}
        migs.append({"project": GCE_PROJECT, "zone": GCE_ZONE, "name": mig,
                     "targetSize": len(names), "template": f"{mig}-tmpl",
                     "instances": [{"name": name} for name in names]})
        specs.append(f"0:{len(names)}:projects/{GCE_PROJECT}/zones/{GCE_ZONE}/"
                     f"instanceGroups/{mig}")
    for j, (mtype, zone) in enumerate(GCE_BURST_MIGS):
        mig = f"burst-{j}-{mtype}"
        labels = {"zone": zone}
        if mtype.startswith("ct5lp"):
            labels["cloud.google.com/gke-tpu-topology"] = "2x2"
        templates[f"{mig}-tmpl"] = {"properties": {
            "machineType": f"zones/{GCE_ZONE}/machineTypes/{mtype}", "labels": labels}}
        migs.append({"project": GCE_PROJECT, "zone": GCE_ZONE, "name": mig, "targetSize": 0,
                     "template": f"{mig}-tmpl", "instances": []})
        specs.append(f"0:{TICK_MAX_SIZE}:projects/{GCE_PROJECT}/zones/{GCE_ZONE}/"
                     f"instanceGroups/{mig}")
    return out_nodes, list(pods) + list(burst), migs, templates, specs


def serve_gce_world(servers, nodes, pods, migs, templates) -> None:
    servers.load("nodes", [(n.name, json.dumps(bp.node_json(n))) for n in nodes])
    servers.load("pods", [(p.key(), json.dumps(bp.pod_json(p))) for p in pods])
    servers.load("configmaps", [{
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": PRIORITY_MAP, "namespace": "kube-system"},
        "data": {"priorities": json.dumps(PRIORITIES)}}])
    servers.load_compute(migs, templates)


# the expander chain on the live ConfigMap and the provider's prices, a
# journal probe (K4) every tick, and no client-side rate limit: at the
# default 5 requests a second the soft-taint housekeeping spends its 3 s
# budget waiting, and where that budget cuts in depends on the host
GCE_FLAGS = ("--expander=priority,price", f"--expander-priority-config-map={PRIORITY_MAP}",
             "--journal-probe-interval=1", "--kube-client-qps=0")


def gce_argv(servers, specs, token_file: str, device: str = "", iterations: int = 2) -> list:
    """``main``'s command line for 3s: the gce provider on the fake
    Compute API, the fake kube API, Lease election."""
    argv = ["--provider=gce", f"--gce-api-url={servers.compute_url}",
            f"--gce-token-file={token_file}", f"--gce-project={GCE_PROJECT}",
            f"--kube-api={servers.kube_url}", "--leader-elect=true", *GCE_FLAGS,
            f"--max-iterations={iterations}", "--scan-interval=0", "--address=127.0.0.1:0"]
    for spec in specs:
        argv.append(f"--nodes={spec}")
    if device:
        argv.append(f"--device={device}")
    return argv


# runs ``python -m autoscaler_tpu_torch.main`` (runpy, as -m does); prints
# the package's location first, a line ``TICK <k>`` on standard output as
# each run_once begins (after the start's own lines there), and at exit
# the kernel wrappers' launch counts and the compilers the kernels' build
# started, on standard error
_COUNTED_MAIN = (
    "import atexit, json, runpy, sys\n"
    "import autoscaler_tpu_torch\n"
    "from autoscaler_tpu_torch.core.static_autoscaler import StaticAutoscaler\n"
    "from autoscaler_tpu_torch.ops import _build, ffd_scan, ffd_scan_affinity, fit_reduce\n"
    "print('PACKAGE ' + autoscaler_tpu_torch.__file__, file=sys.stderr, flush=True)\n"
    "_run_once, _ticks = StaticAutoscaler.run_once, []\n"
    "def run_once(self, now_ts):\n"
    "    print(f'TICK {len(_ticks)}', flush=True)\n"
    "    _ticks.append(now_ts)\n"
    "    return _run_once(self, now_ts)\n"
    "StaticAutoscaler.run_once = run_once\n"
    "atexit.register(lambda: print('LAUNCHES ' + json.dumps({**ffd_scan.LAUNCHES, "
    "**ffd_scan_affinity.LAUNCHES, **fit_reduce.LAUNCHES}) + '\\nCOMPILERS '"
    " + str(_build.COMPILERS_STARTED), file=sys.stderr, flush=True))\n"
    "sys.argv = ['autoscaler_tpu_torch.main'] + sys.argv[1:]\n"
    "runpy.run_module('autoscaler_tpu_torch.main', run_name='__main__', alter_sys=True)\n"
)


def run_gce_main(nodes, pods, burst, root: str, device: str = "", timeout_s: float = 600.0,
                 env=None, extra_argv=(), cwd=None) -> dict:
    """3s: ``python -m autoscaler_tpu_torch.main --provider=gce ...`` in a
    subprocess against fresh fake servers, the package imported from
    ``root`` (``PYTHONPATH``; run from ``cwd``, by default ``root``), with
    ``extra_argv`` after 3s's flags. → {"rc", "stdout", "stderr",
    "launches", "compilers", "package", "leases", "kube_writes",
    "compute_writes", "seconds"}."""
    g_nodes, g_pods, migs, templates, specs = gce_world(nodes, pods, burst)
    with bp.FakeServers.start() as servers, tempfile.TemporaryDirectory() as tmp:
        serve_gce_world(servers, g_nodes, g_pods, migs, templates)
        token = os.path.join(tmp, "token")
        with open(token, "w") as f:
            f.write("fake-token\n")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _COUNTED_MAIN, *gce_argv(servers, specs, token, device),
             *extra_argv],
            cwd=cwd or root, env={**(env or os.environ), "PYTHONPATH": str(root)},
            capture_output=True, text=True, timeout=timeout_s)
        secs = time.perf_counter() - t0
        out = {"launches": {}, "compilers": None, "package": None}
        for line in proc.stderr.splitlines():
            if line.startswith("LAUNCHES "):
                out["launches"] = json.loads(line[len("LAUNCHES "):])
            elif line.startswith("COMPILERS "):
                out["compilers"] = int(line[len("COMPILERS "):])
            elif line.startswith("PACKAGE "):
                out["package"] = line[len("PACKAGE "):]
        return {"rc": proc.returncode, "stdout": proc.stdout, "stderr": proc.stderr, **out,
                "leases": servers.objects("leases"), "kube_writes": servers.writes(),
                "compute_writes": servers.compute_state()["writes"], "seconds": secs}


def run_gce_in_process(nodes, pods, burst, device=None, iterations: int = 2) -> dict:
    """3s's gce world in this process: ``main.main`` on ``device``, no
    subprocess. → the compute API's writes and the kube API's."""
    from autoscaler_tpu_torch import main as main_mod

    g_nodes, g_pods, migs, templates, specs = gce_world(nodes, pods, burst)
    with bp.FakeServers.start() as servers, tempfile.TemporaryDirectory() as tmp:
        serve_gce_world(servers, g_nodes, g_pods, migs, templates)
        token = os.path.join(tmp, "token")
        with open(token, "w") as f:
            f.write("fake-token\n")
        argv = gce_argv(servers, specs, token, str(device) if device is not None else "",
                        iterations)
        rc = main_mod.main(argv)
        return {"rc": rc, "kube_writes": servers.writes(),
                "compute_writes": servers.compute_state()["writes"]}


def compute_canon(writes) -> List[str]:
    return [json.dumps(list(w), sort_keys=True) for w in writes]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the first card)")
    ap.add_argument("--tenth", action="store_true", help="4l's size: a tenth of 3o's")
    args = ap.parse_args(argv)
    nodes, pods, burst, groups = loop_probe.loop_world(args.tenth)
    out = run_bound_ticks(nodes, pods, burst, groups, args.device, timed=True,
                          arrive=loop_probe.ARRIVALS // (10 if args.tenth else 1))
    print(f"# bound first list {out['first']}; synced {out['synced_s']:.3f} s", flush=True)
    bad = False
    for k, entry in enumerate(out["ticks"]):
        print(bound_line(str(k + 1), entry), flush=True)
        bad |= bool(entry["decisions"]["errors"])
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
