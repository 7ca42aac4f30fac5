"""The clusterapi provider on the port (autoscaler_tpu_torch/cloudprovider/
clusterapi.py) against the JAX package: annotation-driven discovery and
the autodiscovery specs, node → Machine → group resolution, sizes,
scale-from-zero templates, failed machines, scaling over the ``/scale``
subresource (each package's ``RestCapiApi`` on a fresh
tests/test_clusterapi.FakeCapiServer, whose request logs must be equal),
and a reconcile tick through the provider. Tolerance 0: objects compare by
``torch_parity.canon``."""
import copy
import types

import pytest
from test_clusterapi import FakeCapiServer, machine, md, ms

import autoscaler_tpu.cloudprovider.clusterapi as jcapi
import autoscaler_tpu.config.options as jopts
import autoscaler_tpu.core.static_autoscaler as jsa
import autoscaler_tpu.kube.api as japi
import autoscaler_tpu.kube.client as jclient
import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.cloudprovider.clusterapi as tcapi
import autoscaler_tpu_torch.config.options as topts
import autoscaler_tpu_torch.core.static_autoscaler as tsa
import autoscaler_tpu_torch.kube.api as tapi
import autoscaler_tpu_torch.kube.client as tclient
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.utils.test_utils as ttu
from torch_parity import canon

JAX = types.SimpleNamespace(capi=jcapi, opts=jopts, sa=jsa, api=japi, client=jclient, obj=jobj,
                            tu=jtu, kw={})
TORCH = types.SimpleNamespace(capi=tcapi, opts=topts, sa=tsa, api=tapi, client=tclient,
                              obj=tobj, tu=ttu, kw={"device": "cpu"})


def world_objects():
    """tests/test_clusterapi.world()'s objects, a failed machine and a
    scale-from-zero group with every capacity annotation."""
    objs = [md("web", replicas=3), ms("web-abc", owner_md="web", replicas=3),
            ms("solo", annotated=True, replicas=1), ms("plain", replicas=4)]
    for i in range(2):
        objs.append(machine(f"web-abc-{i}", owner_ms="web-abc", labels={"md": "web"},
                            provider_id=f"capi:////web-{i}"))
    failed = machine("web-abc-2", owner_ms="web-abc", labels={"md": "web"}, phase="Failed")
    failed["status"]["failureMessage"] = "quota exhausted"
    objs.append(failed)
    objs.append(machine("solo-0", owner_ms="solo", labels={"ms": "solo"},
                        provider_id="capi:////solo-0"))
    objs.append(machine("web-abc-9", owner_ms="web-abc", labels={"md": "web"},
                        provider_id="capi:////web-9", deleting=True))
    objs.append(md("cold", replicas=0, min_size=0, max_size=5))
    objs.append(md("gpu", replicas=0, min_size=0, max_size=8, ann={
        jcapi.CPU_KEY: "16", jcapi.MEMORY_KEY: "64Gi", jcapi.GPU_COUNT_KEY: "2",
        jcapi.MAX_PODS_KEY: "58", jcapi.DISK_KEY: "100Gi",
        jcapi.LABELS_KEY: "pool=gpu, accel = a100", jcapi.TAINTS_KEY:
            "nvidia.com/gpu=present:NoSchedule,bogus,dedicated=ml:PreferNoSchedule"}))
    objs.append(md("typo", replicas=1, ann={jcapi.max_size_key(): "ten"}))
    return objs


def in_memory(k, objs=None):
    api = k.capi.InMemoryCapiApi()
    for obj in copy.deepcopy(objs if objs is not None else world_objects()):
        api.add(obj)
    return api


def capi_node(k, name, machine_ref, provider_id=""):
    n = k.tu.build_test_node(name, cpu_m=4000)
    if machine_ref:
        n.annotations[k.capi.machine_annotation_key()] = machine_ref
    n.provider_id = provider_id
    return n


def provider_view(k, provider):
    """Every group's id, bounds, target, instances and template (or the
    refusal), and the group of a set of nodes."""
    groups = []
    for g in provider.node_groups():
        try:
            template = canon(g.template_node_info())
        except k.capi.NodeGroupError as e:
            template = str(e)
        groups.append((g.id(), g.min_size(), g.max_size(), g.target_size(), canon(g.nodes()),
                       template, g.exist(), g.autoprovisioned()))
    nodes = [capi_node(k, "n0", "default/web-abc-0"), capi_node(k, "n1", "", "capi:////web-1"),
             capi_node(k, "n2", "default/solo-0"), capi_node(k, "n3", "", "capi://default/web-abc-2"),
             capi_node(k, "stranger", "default/nope", "aws:///x")]
    owners = [getattr(provider.node_group_for_node(n), "id", lambda: None)() for n in nodes]
    return groups, owners


def test_keys_match_jax(monkeypatch):
    for env in (None, "cluster.example.io"):
        if env:
            monkeypatch.setenv("CAPI_GROUP", env)
        assert [f() for f in (tcapi.capi_group, tcapi.min_size_key, tcapi.max_size_key,
                              tcapi.machine_annotation_key, tcapi.delete_machine_key,
                              tcapi.cluster_name_label)] == [
            f() for f in (jcapi.capi_group, jcapi.min_size_key, jcapi.max_size_key,
                          jcapi.machine_annotation_key, jcapi.delete_machine_key,
                          jcapi.cluster_name_label)]
    assert (tcapi.CPU_KEY, tcapi.MEMORY_KEY, tcapi.DISK_KEY, tcapi.GPU_COUNT_KEY,
            tcapi.MAX_PODS_KEY, tcapi.LABELS_KEY, tcapi.TAINTS_KEY) == (
        jcapi.CPU_KEY, jcapi.MEMORY_KEY, jcapi.DISK_KEY, jcapi.GPU_COUNT_KEY,
        jcapi.MAX_PODS_KEY, jcapi.LABELS_KEY, jcapi.TAINTS_KEY)


def test_discovery_groups_and_templates_match_jax():
    ref = provider_view(JAX, jcapi.ClusterAPIProvider(in_memory(JAX)))
    out = provider_view(TORCH, tcapi.ClusterAPIProvider(in_memory(TORCH)))
    assert out == ref
    ids = [g[0] for g in ref[0]]
    assert sorted(ids) == ["MachineDeployment/default/gpu", "MachineDeployment/default/web",
                           "MachineSet/default/solo"]
    assert ref[1] == ["MachineDeployment/default/web", "MachineDeployment/default/web",
                      "MachineSet/default/solo", "MachineDeployment/default/web", None]


def scoped_objects():
    a = md("web-a", ns="team-a")
    a["metadata"]["labels"] = {jcapi.cluster_name_label(): "prod"}
    b = md("web-b", ns="team-b")
    b["spec"]["clusterName"] = "staging"
    c = md("web-c", ns="team-a")
    c["metadata"]["labels"] = {"tier": "gpu"}
    return [a, b, c]


@pytest.mark.parametrize("specs", [
    [], ["clusterapi:namespace=team-a"], ["clusterapi:clusterName=prod"],
    ["clusterapi:clusterName=staging"], ["clusterapi:tier=gpu"],
    ["clusterapi:namespace=team-b", "clusterapi:tier=gpu"], ["clusterapi:namespace=nope"],
    ["aws:namespace=team-a"], ["clusterapi:namespace"],
])
def test_autodiscovery_specs_match_jax(specs):
    def outcome(k):
        try:
            parsed = [k.capi.AutoDiscoverySpec(s) for s in specs]
        except ValueError as e:
            return str(e)
        p = k.capi.ClusterAPIProvider(in_memory(k, scoped_objects()), parsed)
        return sorted(g.id() for g in p.node_groups())

    assert outcome(TORCH) == outcome(JAX)


@pytest.mark.parametrize("spec", ["min:1,taint=a=b:NoSchedule", "k1=v1:NoExecute, k2:NoSchedule",
                                  "", "nokey=:NoSchedule,=v:NoSchedule"])
def test_capacity_taints_parse_as_in_jax(spec):
    assert canon(tcapi.parse_capacity_taints(spec)) == canon(jcapi.parse_capacity_taints(spec))


def rest_scaling(k, server):
    """Scaling over the wire through one package's RestCapiApi: increase,
    the refusals, delete (mark and shrink), the errored machine deleted by
    its capi:// id, decrease and its bounds. → what each step returned or
    raised, and the groups' targets after."""
    rest = k.client.KubeRestClient(f"http://127.0.0.1:{server.port}")
    p = k.capi.build_clusterapi_provider(rest)
    g = {x.id(): x for x in p.node_groups()}
    web, gpu = g["MachineDeployment/default/web"], g["MachineDeployment/default/gpu"]
    out = []

    def step(fn, *args):
        try:
            fn(*args)
            out.append("ok")
        except k.capi.NodeGroupError as e:
            out.append(str(e))

    step(web.increase_size, 2)
    step(web.increase_size, 100)
    step(web.increase_size, 0)
    step(gpu.increase_size, 3)
    step(web.delete_nodes, [capi_node(k, "n0", "default/web-abc-0")])
    step(web.delete_nodes, [capi_node(k, "x", "default/solo-0")])
    (errored,) = [i for i in web.nodes() if i.error_info is not None]
    step(web.delete_nodes, [k.obj.Node(name=errored.id, provider_id=errored.id)])
    step(web.decrease_target_size, 1)
    step(web.decrease_target_size, -1)
    step(web.decrease_target_size, -10)
    out.append([(x.id(), x.target_size()) for x in p.node_groups()])
    return out


def test_rest_scaling_matches_jax():
    """Each package's RestCapiApi against its own FakeCapiServer over a
    fresh in-memory world: the same answers, the same requests, the same
    objects after."""
    runs = []
    for k in (JAX, TORCH):
        backing = in_memory(k)
        server = FakeCapiServer(backing)
        try:
            answers = rest_scaling(k, server)
        finally:
            server.close()
        for obj in backing.objects.values():
            ann = (obj.get("metadata") or {}).get("annotations") or {}
            if k.capi.delete_machine_key() in ann:
                ann[k.capi.delete_machine_key()] = "<time>"
        runs.append((answers, server.requests, canon(backing.objects)))
    assert runs[1] == runs[0]
    assert runs[0][0][0] == "ok" and "too large" in runs[0][0][1]


def test_delete_rolls_back_on_transport_failure():
    """A failed shrink takes the deletion mark back, in both packages."""
    got = []
    for k in (JAX, TORCH):
        api = in_memory(k)

        def broken(*a, **kw):
            raise RuntimeError("transport down")

        p = k.capi.ClusterAPIProvider(api)
        web = {x.id(): x for x in p.node_groups()}["MachineDeployment/default/web"]
        api.set_scale = broken
        with pytest.raises(RuntimeError):
            web.delete_nodes([capi_node(k, "n0", "default/web-abc-0")])
        m = api.objects[("Machine", "default", "web-abc-0")]
        got.append(sorted((m["metadata"].get("annotations") or {}).items()))
    assert got[1] == got[0] == []


def loop_tick(k):
    """tests/test_clusterapi.py's tick through the provider, with a
    running group beside the scale-from-zero one: two ticks of each
    package's StaticAutoscaler. → the results and the scales."""
    api = k.capi.InMemoryCapiApi()
    api.add(md("workers", replicas=0, min_size=0, max_size=5,
               ann={k.capi.CPU_KEY: "8", k.capi.MEMORY_KEY: "32Gi"}))
    api.add(md("small", replicas=1, min_size=0, max_size=3,
               ann={k.capi.CPU_KEY: "2", k.capi.MEMORY_KEY: "4Gi"}))
    api.add(ms("small-x", owner_md="small", replicas=1))
    api.add(machine("small-x-0", owner_ms="small-x", labels={"md": "small"},
                    provider_id="test:///small-0"))
    provider = k.capi.ClusterAPIProvider(api)
    kube = k.api.FakeClusterAPI()
    node = k.tu.build_test_node("small-0", cpu_m=2000, mem=4 * k.tu.GB)
    node.annotations[k.capi.machine_annotation_key()] = "default/small-x-0"
    kube.add_node(node)
    for i in range(6):
        kube.add_pod(k.tu.build_test_pod(f"pending-{i}", cpu_m=1500 + 100 * i))
    sa = k.sa.StaticAutoscaler(provider, kube, k.opts.AutoscalingOptions(expander="least-waste"),
                               **k.kw)
    results = [canon(sa.run_once(now_ts=t)) for t in (1000.0, 1010.0)]
    return results, {key: obj["spec"].get("replicas") for key, obj in sorted(api.objects.items())
                     if key[0] == "MachineDeployment"}


def test_tick_through_the_provider_matches_jax():
    ref, out = loop_tick(JAX), loop_tick(TORCH)
    assert out == ref
    assert ref[1][("MachineDeployment", "default", "workers")] >= 1
