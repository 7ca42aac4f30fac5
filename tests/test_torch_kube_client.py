"""The kube binding on the port (autoscaler_tpu_torch/kube/client.py,
kube/convert.py, utils/http.py, utils/leaderelection.py) against the JAX
package, each package on a fresh tests/test_kube_client.FakeApiServer:
converted nodes, pods (affinity, spread, volumes, host ports), pdbs and
DaemonSets equal; the write logs (method, path, body) of taints, cordon,
evictions (429 included), node deletes, ConfigMaps and events (with the
dedup window) equal; the watch cache after pushed events; KubeLease and
LeaderElector on an injected clock; the kubeconfig loader (token and
cert); and ``run_once`` over HTTP, a scale-down and a scale-up world.
Tolerance 0: objects compare by ``torch_parity.canon``."""
import base64
import time
import types

import pytest
import yaml
from test_kube_client import FakeApiServer, node_json, pod_json

import autoscaler_tpu.cloudprovider.test_provider as jprov
import autoscaler_tpu.config.options as jopts
import autoscaler_tpu.core.static_autoscaler as jsa
import autoscaler_tpu.kube.api as japi
import autoscaler_tpu.kube.client as jclient
import autoscaler_tpu.kube.convert as jconv
import autoscaler_tpu.utils.http as jhttp
import autoscaler_tpu.utils.leaderelection as jle
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.cloudprovider.test_provider as tprov
import autoscaler_tpu_torch.config.options as topts
import autoscaler_tpu_torch.core.static_autoscaler as tsa
import autoscaler_tpu_torch.kube.api as tapi
import autoscaler_tpu_torch.kube.client as tclient
import autoscaler_tpu_torch.kube.convert as tconv
import autoscaler_tpu_torch.utils.http as thttp
import autoscaler_tpu_torch.utils.leaderelection as tle
import autoscaler_tpu_torch.utils.test_utils as ttu
from torch_parity import canon

JAX = types.SimpleNamespace(name="jax", client=jclient, conv=jconv, api=japi, le=jle, http=jhttp,
                            prov=jprov, opts=jopts, sa=jsa, tu=jtu, kw={})
TORCH = types.SimpleNamespace(name="torch", client=tclient, conv=tconv, api=tapi, le=tle,
                              http=thttp, prov=tprov, opts=topts, sa=tsa, tu=ttu,
                              kw={"device": "cpu"})
GB = jtu.GB


class RecordingServer(FakeApiServer):
    """tests/test_kube_client.FakeApiServer that also records the body of
    every request that sends one, as (method, path, body)."""

    def __init__(self):
        import threading

        self.bodies = []
        # its own lock: the base handler reads a DELETE's body while holding
        # the server's
        self.bodies_lock = threading.Lock()
        super().__init__()

    def _handler(outer_self):
        base = FakeApiServer._handler(outer_self)
        outer = outer_self

        class Handler(base):
            def _body(self):
                body = base._body(self)
                with outer.bodies_lock:
                    outer.bodies.append((self.command, self.path, body))
                return body

        return Handler


@pytest.fixture()
def servers():
    made = {"jax": RecordingServer(), "torch": RecordingServer()}
    yield made
    for s in made.values():
        s.close()


def both(servers, fn):
    """``fn(k, server)`` on each package against its own server → (the
    JAX package's answer and logs, the port's)."""
    out = []
    for k in (JAX, TORCH):
        s = servers[k.name]
        answer = fn(k, s)
        out.append((answer, list(s.writes), list(s.bodies)))
    return out


# -- converters -----------------------------------------------------------------------------------
def rich_pod(i):
    """A pod JSON with every field convert reads."""
    obj = pod_json(f"rich-{i}", ns=f"ns{i % 2}", cpu=f"{250 * (i + 1)}m", mem=f"{i + 1}Gi",
                   node_name="n1" if i % 2 else None, owner_kind=("DaemonSet", "ReplicaSet",
                                                                  "", "Job")[i % 4],
                   labels={"app": f"a{i % 3}"})
    spec = obj["spec"]
    spec["containers"].append({"name": "side", "resources": {"requests": {
        "cpu": "0.1", "memory": "64Mi", "ephemeral-storage": "1Gi", "nvidia.com/gpu": str(i % 2),
        "hugepages-2Mi": "4Mi"}}, "ports": [{"containerPort": 80, "hostPort": 8000 + i}]})
    spec["nodeSelector"] = {"pool": "p"}
    spec["tolerations"] = [{"key": "dedicated", "operator": "Equal", "value": "ml",
                            "effect": "NoSchedule"}, {"operator": "Exists"}]
    spec["priority"] = 100 * i
    spec["affinity"] = {
        "nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {"nodeSelectorTerms": [
            {"matchExpressions": [{"key": "zone", "operator": "In", "values": ["a", "b"]}],
             "matchFields": [{"key": "metadata.name", "operator": "NotIn", "values": ["bad"]}]},
            {}]}},
        "podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"app": "db"}}, "topologyKey": "zone"}]},
        "podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchExpressions": [{"key": "app", "operator": "Exists"}]},
             "topologyKey": "kubernetes.io/hostname", "namespaces": ["ns0", "ns1"]}]},
    }
    spec["topologySpreadConstraints"] = [
        {"maxSkew": 2, "topologyKey": "zone", "whenUnsatisfiable": "DoNotSchedule",
         "labelSelector": {"matchLabels": {"app": f"a{i % 3}"}}, "minDomains": 3,
         "nodeAffinityPolicy": "Ignore", "nodeTaintsPolicy": "Honor",
         "matchLabelKeys": ["pod-template-hash"]},
        {"maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
         "whenUnsatisfiable": "ScheduleAnyway"}]
    spec["volumes"] = [
        {"name": "scratch", "emptyDir": {}},
        {"name": "pd", "gcePersistentDisk": {"pdName": f"disk-{i}", "readOnly": i % 2 == 0}},
        {"name": "ebs", "awsElasticBlockStore": {"volumeID": f"vol-{i}"}},
        {"name": "iscsi", "iscsi": {"iqn": f"iqn.{i}", "readOnly": True}},
        {"name": "rbd", "rbd": {"image": f"img-{i}", "monitors": ["m1", "m2"]}},
        {"name": "inline", "csi": {"driver": "ebs.csi.aws.com"}},
        {"name": "claim", "persistentVolumeClaim": {"claimName": f"claim-{i % 3}"}},
    ]
    obj["metadata"]["annotations"] = {"kubernetes.io/config.mirror": "x"} if i == 3 else {}
    if i == 2:
        obj["metadata"]["deletionTimestamp"] = "2026-07-30T01:02:03Z"
    obj["status"]["phase"] = ("Running", "Pending", "Succeeded", "")[i % 4]
    return obj


PVCS = [{"metadata": {"name": f"claim-{j}", "namespace": f"ns{j % 2}"},
         "spec": {"volumeName": f"pv-{j}" if j < 2 else "", "storageClassName": "zonal",
                  "accessModes": ["ReadWriteOncePod"] if j == 1 else ["ReadWriteOnce"]}}
        for j in range(3)]
PVS = [{"metadata": {"name": "pv-0"}, "spec": {"csi": {"driver": "pd.csi.storage.gke.io",
                                                       "volumeHandle": "h0"},
                                               "nodeAffinity": {"required": {"nodeSelectorTerms": [
                                                   {"matchExpressions": [{"key": "zone",
                                                                          "operator": "In",
                                                                          "values": ["a"]}]}]}}}},
       {"metadata": {"name": "pv-1"}, "spec": {"hostPath": {"path": "/x"}}}]
CLASSES = [{"metadata": {"name": "zonal"}, "allowedTopologies": [{"matchLabelExpressions": [
    {"key": "zone", "values": ["b"]}]}]}]


@pytest.mark.parametrize("i", range(4))
def test_pod_conversion_matches_jax(i):
    obj = rich_pod(i)
    got = []
    for k in (JAX, TORCH):
        index = k.conv.pvc_csi_index(PVCS, PVS, CLASSES)
        got.append((canon(k.conv.pod_from_json(obj, pvc_resolver=lambda ns, c: index.get((ns, c)))),
                    canon(k.conv.pod_from_json(obj)), canon(index)))
    assert got[1] == got[0]


@pytest.mark.parametrize("spec", [
    dict(cpu="4", mem="8Gi"), dict(cpu="3500m", mem="7.5Gi", ready=False),
    dict(cpu="96", mem="1Ti", taints=[{"key": "t", "value": "v", "effect": "NoExecute"},
                                      {"key": "bare"}], labels={"zone": "a"}),
])
def test_node_conversion_matches_jax(spec):
    obj = node_json("n", **spec)
    obj["spec"]["unschedulable"] = True
    obj["status"]["allocatable"].update({"nvidia.com/gpu": "2", "google.com/tpu": "4",
                                         "ephemeral-storage": "100G", "example.com/fpga": "1"})
    obj["metadata"]["annotations"] = {"k": "v"}
    assert canon(tconv.node_from_json(obj)) == canon(jconv.node_from_json(obj))


def test_pdb_daemonset_csinode_and_quantities_match_jax():
    pdb = {"metadata": {"name": "b", "namespace": "ns"},
           "spec": {"selector": {"matchLabels": {"app": "a"}, "matchExpressions": [
               {"key": "tier", "operator": "NotIn", "values": ["x"]}]}},
           "status": {"disruptionsAllowed": 2}}
    ds = {"metadata": {"name": "ds", "namespace": "kube-system"}, "spec": {"template": {"spec": {
        "containers": [{"resources": {"requests": {"cpu": "100m", "memory": "50Mi"}}},
                       {"resources": {"requests": {"cpu": "0.2"}}}],
        "nodeSelector": {"os": "linux"}, "tolerations": [{"operator": "Exists"}],
        "affinity": {"nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{"matchFields": [{"key": "metadata.name", "operator": "In",
                                                    "values": ["n1"]}]}]}}}}}}}
    csinode = {"metadata": {"name": "n1"}, "spec": {"drivers": [
        {"name": "pd.csi", "allocatable": {"count": 15}}, {"name": "no-count"}]}}
    assert canon(tconv.pdb_from_json(pdb)) == canon(jconv.pdb_from_json(pdb))
    assert canon(tconv.daemonset_from_json(ds)) == canon(jconv.daemonset_from_json(ds))
    assert tconv.csinode_limits_from_json(csinode) == jconv.csinode_limits_from_json(csinode)
    for q in ("100m", "1.5", "2Gi", "3k", "1e3", "", 7, 2.5, "0.5Ki", "1M", "4Ei"):
        assert tconv.parse_quantity(q) == jconv.parse_quantity(q)
        assert tconv.parse_cpu_millis(q) == jconv.parse_cpu_millis(q)
    for b in (0, 1.4, 2**30, 1e12):
        assert tconv.format_memory_quantity(b) == jconv.format_memory_quantity(b)
        assert tconv.format_cpu_millis(b) == jconv.format_cpu_millis(b)
        assert tconv.format_cpu_quantity(b / 1000) == jconv.format_cpu_quantity(b / 1000)
    for ts in ("2026-07-29T00:00:00Z", "2026-07-29T00:00:00.123456Z", "", None, "garbage"):
        assert tconv.parse_timestamp(ts) == jconv.parse_timestamp(ts)
    assert tconv.format_timestamp(1.7e9 + 0.25) == jconv.format_timestamp(1.7e9 + 0.25)


# -- writes -----------------------------------------------------------------------------------------
def writes_session(k, s):
    for name in ("n1", "n2"):
        s.nodes[name] = node_json(name)
    s.pods["default/ok"] = pod_json("ok")
    s.pods["default/blocked"] = pod_json("blocked")
    s.reject_evictions.add("default/blocked")
    kube = k.client.KubeClusterAPI(k.client.KubeRestClient(s.url))
    out = []
    taint = k.api.to_be_deleted_taint()
    kube.add_taint("n1", taint)
    kube.add_taint("n1", taint)                # idempotent: one taint
    kube.add_taint("n1", k.api.deletion_candidate_taint())
    kube.remove_taint("n1", taint.key)
    kube.cordon_node("n2")
    kube.uncordon_node("n2")
    kube.evict_pod(k.conv.pod_from_json(pod_json("ok")))
    try:
        kube.evict_pod(k.conv.pod_from_json(pod_json("blocked")))
    except k.api.EvictionError as e:
        out.append(str(e))
    out.append((kube.pod_exists("default/ok"), kube.pod_exists("default/blocked")))
    kube.delete_node_object("n2")
    kube.delete_node_object("n2")              # 404 tolerated
    out.append(kube.read_configmap("kube-system", "absent"))
    kube.write_configmap("kube-system", "st", {"status": "v1", "n": 3})
    kube.write_configmap("kube-system", "st", {"status": "v2"})
    out.append(kube.read_configmap("kube-system", "st"))
    for _ in range(3):
        kube.record_event("Node", "n1", "ScaleDown", "removing n1")
    for i in range(14):
        kube.record_event("Node", "n1", "EvictionFailed", f"retry after {i}s")
    dup = k.client.KubeClusterAPI(k.client.KubeRestClient(s.url), record_duplicated_events=True)
    for _ in range(2):
        dup.record_event("Node", "n2", "ScaleDown", "again")
    out.append(canon(kube.list_nodes()))
    out.append(canon(kube.list_daemonsets()))
    out.append(canon(kube.list_pdbs()))
    return out


def test_write_logs_match_jax(servers):
    ref, out = both(servers, writes_session)
    assert out == ref
    events = [p for m, p in ref[1] if p.endswith("/events")]
    assert len(events) == 1 + tclient.KubeClusterAPI.EVENT_SERIES_CAP + 2


def test_event_windows_on_an_injected_clock_match_jax(servers, monkeypatch):
    def session(k, s):
        now = [0.0]
        monkeypatch.setattr(k.client.time, "monotonic", lambda: now[0])
        kube = k.client.KubeClusterAPI(k.client.KubeRestClient(s.url))
        for w in range(3):
            now[0] = w * (k.client.KubeClusterAPI.EVENT_DEDUP_WINDOW_S + 1)
            for i in range(12):
                kube.record_event("Node", "n1", "EvictionFailed", f"blocked by pod-{i}")
        return None

    ref, out = both(servers, session)
    assert out == ref and len(ref[1]) == 3 * tclient.KubeClusterAPI.EVENT_SERIES_CAP


def test_watch_cache_after_pushed_events_matches_jax(servers):
    def session(k, s):
        s.pods["default/p1"] = pod_json("p1")
        s.nodes["n1"] = node_json("n1")
        kube = k.client.KubeClusterAPI(k.client.KubeRestClient(s.url), watch=True)
        try:
            seen = [canon(kube.list_pods())]
            for rv, (kind, obj) in enumerate([
                    ("ADDED", pod_json("p2", node_name="n1")),
                    ("MODIFIED", pod_json("p1", cpu="2")),
                    ("DELETED", pod_json("p2")),
                    ("ADDED", pod_json("p3", ns="other"))], start=11):
                obj["metadata"]["resourceVersion"] = str(rv)
                s.push_watch_event(kind, obj)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                keys = sorted(p.key() for p in kube.list_pods())
                if keys == ["default/p1", "other/p3"] and kube._pod_cache._resource_version == "14":
                    break
                time.sleep(0.02)
            seen.append(canon(sorted(kube.list_pods(), key=lambda p: p.key())))
            seen.append((kube._node_cache.synced, kube._pod_cache.synced))
            return seen
        finally:
            kube.close()

    ref, out = both(servers, session)
    assert out[0] == ref[0]
    assert [p[1][1] for p in ref[0][1]] == ["p1", "p3"]


# -- Lease and election --------------------------------------------------------------------------------
def lease_session(k, s):
    client = k.client.KubeRestClient(s.url)
    a, b = k.client.KubeLease(client, ttl_s=15.0), k.client.KubeLease(client, ttl_s=15.0)
    out = [a.try_acquire("holder-a", 100.0), b.try_acquire("holder-b", 105.0),
           a.try_acquire("holder-a", 110.0), b.try_acquire("holder-b", 130.0)]
    b.release("holder-b")
    out.append(a.try_acquire("holder-a", 131.0))
    a.release("holder-b")                     # not the holder: nothing happens
    out.append(canon(s.leases))
    ran = []
    clock = iter(float(t) for t in range(200, 400, 7))
    elector = k.le.LeaderElector(k.client.KubeLease(client, "el", ttl_s=15.0), identity="me",
                                 clock=lambda: next(clock), sleep=lambda _: None)
    elector.run(lambda still_leader: ran.append(still_leader()))
    out.append((ran, "el" in s.leases))
    return out


def test_kube_lease_and_elector_match_jax(servers):
    ref, out = both(servers, lease_session)
    assert out == ref
    assert ref[0][:5] == [True, False, True, True, True]


def test_leader_elector_over_a_file_lease_matches_jax(tmp_path):
    """The elector's renewals on injected clocks: the lease lost past the
    renew deadline, in both packages."""
    got = []
    for k in (JAX, TORCH):
        path = tmp_path / f"{k.name}.lease"
        other = k.le.FileLease(str(path), ttl_s=15.0)
        assert other.try_acquire("other", 0.0)
        assert not k.le.FileLease(str(path), ttl_s=15.0).try_acquire("me", 10.0)
        now = [20.0]
        waits = []
        elector = k.le.LeaderElector(k.le.FileLease(str(path), ttl_s=15.0), identity="me",
                                     renew_period_s=0.01, renew_deadline_s=5.0,
                                     clock=lambda: now[0], sleep=waits.append)
        states = []

        def lead(still_leader):
            states.append(still_leader())
            now[0] = 30.0                     # past the deadline, no renewal since
            states.append(still_leader())

        elector.run(lead)
        got.append((states, waits, path.exists()))
    assert got[1] == got[0] and got[0][0] == [True, False]


def test_retry_policy_matches_jax():
    for k in (JAX, TORCH):
        p = k.http.RetryPolicy(attempts=4, base_sleep_s=0.1, max_sleep_s=1.0, rng=lambda: 0.5)
        assert [p.backoff_s(a, None) for a in (1, 2, 3, 6)] == [
            jhttp.RetryPolicy(attempts=4, base_sleep_s=0.1, max_sleep_s=1.0,
                              rng=lambda: 0.5).backoff_s(a, None) for a in (1, 2, 3, 6)]
        assert p.backoff_s(1, 30.0) == 1.0 and p.backoff_s(1, -1.0) == 0.0


# -- kubeconfig ------------------------------------------------------------------------------------------
def write_kubeconfig(tmp_path, name, cluster, user, contexts=None):
    cfg = {"apiVersion": "v1", "kind": "Config", "current-context": "dev",
           "contexts": contexts or [{"name": "dev", "context": {"cluster": "c1", "user": "u1"}}],
           "clusters": [{"name": "c1", "cluster": cluster}],
           "users": [{"name": "u1", "user": user}]}
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


PEM = b"-----BEGIN CERTIFICATE-----\nMIIBfake\n-----END CERTIFICATE-----\n"


@pytest.mark.parametrize("case", ["token", "token-file", "cert-data", "cert-files", "insecure",
                                  "proxy", "exec", "no-credential", "bad-yaml", "no-context"])
def test_kubeconfig_loader_matches_jax(case, tmp_path, servers):
    url = servers["jax"].url
    (tmp_path / "tok").write_text("from-file\n")
    (tmp_path / "client.crt").write_bytes(PEM)
    (tmp_path / "client.key").write_bytes(b"key")
    cases = {
        "token": ({"server": url}, {"token": "tok-abc"}),
        "token-file": ({"server": url}, {"tokenFile": "tok"}),
        "cert-data": ({"server": "https://example.invalid",
                       "certificate-authority-data": base64.b64encode(PEM).decode()},
                      {"client-certificate-data": base64.b64encode(PEM).decode(),
                       "client-key-data": base64.b64encode(b"key").decode()}),
        "cert-files": ({"server": "https://example.invalid"},
                       {"client-certificate": "client.crt", "client-key": "client.key"}),
        "insecure": ({"server": "https://example.invalid", "insecure-skip-tls-verify": True},
                     {"token": "t"}),
        "proxy": ({"server": url}, {}),
        "exec": ({"server": "https://example.invalid"}, {"exec": {"command": "plugin"}}),
        "no-credential": ({"server": "https://example.invalid"}, {}),
    }

    def outcome(k):
        if case == "bad-yaml":
            path = tmp_path / "bad"
            path.write_text("{unclosed: [")
            path = str(path)
        elif case == "no-context":
            path = write_kubeconfig(tmp_path, "kc", {"server": url}, {"token": "t"},
                                    contexts=[{"name": "other", "context": {}}])
        else:
            path = write_kubeconfig(tmp_path, "kc", *cases[case])
        try:
            c = k.client.KubeRestClient.from_kubeconfig(path, qps=3.0, burst=4)
        except (ValueError, OSError) as e:
            return type(e).__name__, str(e).replace(str(tmp_path), "<tmp>")
        return (c.base_url, c.token, c.user_agent, c._ctx is not None,
                getattr(c._ctx, "check_hostname", None), c._limiter.qps, c._limiter.burst)

    assert outcome(TORCH) == outcome(JAX)


# -- run_once over HTTP ------------------------------------------------------------------------------
def scale_down_world(k, s):
    """tests/test_kube_client.TestRunOnceOverHTTP's world and its two
    ticks."""
    provider = k.prov.TestCloudProvider()
    provider.add_node_group("g", 0, 10, 3, k.tu.build_test_node("tmpl", cpu_m=4000, mem=8 * GB))
    for name in ("g-0", "g-1", "g-2"):
        s.nodes[name] = node_json(name, cpu="4", mem="8Gi")
        provider.add_node("g", k.tu.build_test_node(name, cpu_m=4000, mem=8 * GB))
    s.pods["default/w"] = pod_json("w", cpu="500m", mem="1Gi", node_name="g-2")
    s.pods["default/keep"] = pod_json("keep", cpu="3500m", mem="6Gi", node_name="g-0")
    api = k.client.KubeClusterAPI(k.client.KubeRestClient(s.url))
    opts = k.opts.AutoscalingOptions()
    opts.node_group_defaults.scale_down_unneeded_time_s = 60
    opts.scale_down_delay_after_add_s = 0
    sa = k.sa.StaticAutoscaler(provider, api, opts, **k.kw)
    results = [sa.run_once(now_ts=t) for t in (100.0, 200.0)]
    return [canon(r) for r in results], sorted(provider.scale_down_calls)


def scale_up_world(k, s):
    """Pending pods over HTTP on a two-group provider: a scale-up, then
    the nodes listed and the pods bound, then a quiet tick."""
    provider = k.prov.TestCloudProvider()
    provider.add_node_group("small", 0, 5, 1, k.tu.build_test_node("ts", cpu_m=2000, mem=4 * GB))
    provider.add_node_group("big", 0, 5, 0, k.tu.build_test_node("tb", cpu_m=8000, mem=32 * GB))
    s.nodes["small-0"] = node_json("small-0", cpu="2", mem="4Gi")
    provider.add_node("small", k.tu.build_test_node("small-0", cpu_m=2000, mem=4 * GB))
    for i in range(6):
        s.pods[f"default/p{i}"] = pod_json(f"p{i}", cpu=f"{1100 + 100 * i}m", mem="1Gi")
    api = k.client.KubeClusterAPI(k.client.KubeRestClient(s.url))
    sa = k.sa.StaticAutoscaler(provider, api, k.opts.AutoscalingOptions(expander="least-waste"),
                               **k.kw)
    first = sa.run_once(now_ts=0.0)
    return [canon(first), canon(sa.run_once(now_ts=15.0))], list(provider.scale_up_calls)


@pytest.mark.parametrize("world", [scale_down_world, scale_up_world],
                         ids=["scale-down", "scale-up"])
def test_run_once_over_http_matches_jax(world, servers):
    ref, out = both(servers, world)
    canon_writes = [sorted(map(repr, r[1])) for r in (ref, out)]
    canon_bodies = [sorted(map(repr, r[2])) for r in (ref, out)]
    assert out[0] == ref[0]
    assert canon_writes[1] == canon_writes[0] and canon_bodies[1] == canon_bodies[0]
    if world is scale_up_world:
        assert ref[0][1] and ref[0][1][0][0] == "big"
    else:
        assert any(m == "DELETE" for m, _ in ref[1])
