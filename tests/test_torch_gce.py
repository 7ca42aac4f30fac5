"""The gce provider on the port (autoscaler_tpu_torch/cloudprovider/
gce.py, gce_rest.py, utils/cache.py) against the JAX package: MIG groups,
TPU templates, pricing, resize and delete, stockouts and the cleanup of
errored instances, discovery, and the REST transport, each package on a
fresh tests/test_gce_rest.FakeComputeServer, whose recorded requests
(method, path, body) must be equal. Tolerance 0: objects compare by
``torch_parity.canon``."""
import types

import pytest
from test_gce_rest import MIG, PROJECT, ZONE, FakeComputeServer

import autoscaler_tpu.cloudprovider.gce as jgce
import autoscaler_tpu.cloudprovider.gce_rest as jrest
import autoscaler_tpu.cloudprovider.interface as jiface
import autoscaler_tpu.config.options as jopts
import autoscaler_tpu.core.static_autoscaler as jsa
import autoscaler_tpu.kube.api as japi
import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.utils.cache as jcache
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.cloudprovider.gce as tgce
import autoscaler_tpu_torch.cloudprovider.gce_rest as trest
import autoscaler_tpu_torch.cloudprovider.interface as tiface
import autoscaler_tpu_torch.config.options as topts
import autoscaler_tpu_torch.core.static_autoscaler as tsa
import autoscaler_tpu_torch.kube.api as tapi
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.utils.cache as tcache
import autoscaler_tpu_torch.utils.test_utils as ttu
from torch_parity import canon

JAX = types.SimpleNamespace(gce=jgce, rest=jrest, iface=jiface, opts=jopts, sa=jsa, api=japi,
                            obj=jobj, cache=jcache, tu=jtu, kw={})
TORCH = types.SimpleNamespace(gce=tgce, rest=trest, iface=tiface, opts=topts, sa=tsa, api=tapi,
                              obj=tobj, cache=tcache, tu=ttu, kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])
GB = jtu.GB
MIG_URL = "projects/proj/zones/us-central2-b/instanceGroups/tpu-pool"


def make_provider(k, quota=None, machine_type="ct5lp-hightpu-4t", target=1):
    api = k.gce.InMemoryGceApi()
    api.add_mig("proj", "us-central2-b", "tpu-pool",
                k.gce.MigTemplate(machine_type=machine_type, tpu_topology="2x2"),
                target_size=target, quota=quota)
    return api, k.gce.build_gce_provider([f"0:10:{MIG_URL}"], api)


def test_catalogs_and_constants_equal_jax():
    assert tgce.MACHINE_TYPES == jgce.MACHINE_TYPES
    assert tgce.HOURLY_PRICES == jgce.HOURLY_PRICES
    assert (tgce.SPOT_DISCOUNT, tgce.TPU_RESOURCE_LABEL, tgce.TPU_TOPOLOGY_LABEL,
            tgce.TPU_TAINT_KEY, tgce.GPU_LABEL) == (
        jgce.SPOT_DISCOUNT, jgce.TPU_RESOURCE_LABEL, jgce.TPU_TOPOLOGY_LABEL,
        jgce.TPU_TAINT_KEY, jgce.GPU_LABEL)
    assert trest.DEFAULT_BASE_URL == jrest.DEFAULT_BASE_URL


@pytest.mark.parametrize("machine_type", sorted(jgce.MACHINE_TYPES))
@pytest.mark.parametrize("spot", [False, True], ids=["on-demand", "spot"])
def test_template_nodes_and_prices_match_jax(machine_type, spot):
    """Every machine type of the catalog (the TPU families' labels, taint
    and chips too) and its price, node and pod."""
    got = []
    for k in (JAX, TORCH):
        tmpl = k.gce.MigTemplate(machine_type=machine_type, tpu_topology="2x2", spot=spot,
                                 labels={"pool": "p"})
        node = k.gce.build_node_from_template("n", "us-central2-b", tmpl, provider_id="gce://x")
        model = k.gce.GcePriceModel()
        pod = k.tu.build_test_pod("p", cpu_m=1500, mem=3 * GB)
        got.append((canon(node), model.node_price(node, 0, 5400),
                    model.pod_price(pod, 0, 5400)))
    assert got[1] == got[0]


@pytest.mark.parametrize("url", [MIG_URL, "https://www.googleapis.com/compute/v1/" + MIG_URL,
                                 "projects/p/instanceGroups/x"])
def test_parse_mig_url_matches_jax(url):
    def outcome(k):
        try:
            return k.gce.parse_mig_url(url)
        except ValueError as e:
            return str(e)

    assert outcome(TORCH) == outcome(JAX)


def mig_operations(k):
    """tests/test_gce_provider.py's MIG operations on one package: →
    every call the in-memory API saw and every outcome."""
    out = []
    api, provider = make_provider(k)
    (mig,) = provider.node_groups()
    mig.increase_size(2)
    out.append(mig.target_size())
    with pytest.raises(k.iface.NodeGroupError):
        mig.increase_size(100)
    api2, provider2 = make_provider(k, target=2)
    (mig2,) = provider2.node_groups()
    with pytest.raises(k.iface.NodeGroupError):
        mig2.delete_nodes([k.obj.Node(name="other-node")])
    mig2.delete_nodes([k.obj.Node(name="tpu-pool-0")])
    out.append(mig2.target_size())
    api3, provider3 = make_provider(k, target=2)
    (mig3,) = provider3.node_groups()
    with pytest.raises(k.iface.NodeGroupError):
        mig3.decrease_target_size(1)
    mig3.increase_size(1)
    mig3.decrease_target_size(1)
    api3.settle()
    out.append((mig3.target_size(), canon(api3.list_instances("proj", "us-central2-b",
                                                              "tpu-pool"))))
    api4, provider4 = make_provider(k)
    (mig4,) = provider4.node_groups()
    api4.resize("proj", "us-central2-b", "tpu-pool", 5)
    out.append(mig4.target_size())           # hidden by the cache
    mig4.increase_size(1)
    out.append(mig4.target_size())
    node = k.obj.Node(name="tpu-pool-0", provider_id="gce://proj/us-central2-b/tpu-pool-0")
    out.append(provider4.node_group_for_node(node).id())
    return out, api.calls, api2.calls, api3.calls, api4.calls


def test_mig_operations_match_jax():
    assert canon(mig_operations(TORCH)) == canon(mig_operations(JAX))


def test_stockout_errors_match_jax():
    got = []
    for k in (JAX, TORCH):
        api, provider = make_provider(k, quota=1)
        (mig,) = provider.node_groups()
        mig.increase_size(2)
        errored = [i for i in mig.nodes() if i.error_info is not None]
        assert errored and errored[0].error_info.error_class.name == "OUT_OF_RESOURCES"
        got.append(canon(mig.nodes()))
    assert got[1] == got[0]


def errored_cleanup(k):
    """A stockout's errored instances removed by the loop (the reference's
    deleteCreatedNodesWithErrors): two ticks of each package's
    StaticAutoscaler on its in-memory gce API. → the calls and results."""
    api, provider = make_provider(k, quota=1, target=0)
    kube = k.api.FakeClusterAPI()
    pods = []
    for i in range(3):
        pod = k.tu.build_test_pod(f"trainer-{i}", cpu_m=1000, mem=1 * GB)
        pod.requests = k.obj.Resources(cpu_m=1000, memory=1 * GB, tpu=4, pods=1)
        pod.tolerations = [k.obj.Toleration(key=k.gce.TPU_TAINT_KEY, operator="Exists")]
        kube.add_pod(pod)
        pods.append(pod)
    sa = k.sa.StaticAutoscaler(provider, kube, k.opts.AutoscalingOptions(), **k.kw)
    results = [canon(sa.run_once(now_ts=t)) for t in (0.0, 30.0, 60.0)]
    return results, api.calls, [g.target_size() for g in provider.node_groups()]


def test_errored_instances_cleanup_matches_jax():
    ref, out = errored_cleanup(JAX), errored_cleanup(TORCH)
    assert out == ref
    # scaled to 3 past a quota of 1, the two errored instances cleaned up
    # by a resize to 1, then scaled again
    assert ref[1][:2] == [("resize", "tpu-pool", 3), ("resize", "tpu-pool", 1)]


@PKGS
def test_tpu_pod_scales_up_tpu_pool(pkg):
    api, provider = make_provider(pkg, target=0)
    kube = pkg.api.FakeClusterAPI()
    pod = pkg.tu.build_test_pod("trainer", cpu_m=1000, mem=1 * GB)
    pod.requests = pkg.obj.Resources(cpu_m=1000, memory=1 * GB, tpu=4, pods=1)
    pod.tolerations = [pkg.obj.Toleration(key=pkg.gce.TPU_TAINT_KEY, operator="Exists")]
    kube.add_pod(pod)
    result = pkg.sa.StaticAutoscaler(provider, kube, pkg.opts.AutoscalingOptions(),
                                     **pkg.kw).run_once(now_ts=0.0)
    assert result.scale_up is not None and result.scale_up.scaled_up
    assert any(c[0] == "resize" for c in api.calls)


def discovery(k):
    api = k.gce.InMemoryGceApi()
    tmpl = k.gce.MigTemplate(machine_type="ct5lp-hightpu-4t", tpu_topology="2x2")
    for name, target in (("tpu-a", 1), ("tpu-b", 2), ("cpu-pool", 1)):
        api.add_mig("proj", "z", name, tmpl, target_size=target)
    provider = k.gce.build_gce_provider(["0:10:projects/proj/zones/z/instanceGroups/tpu-a"],
                                        api, auto_discovery=["mig:namePrefix=tpu-,min=1,max=7"],
                                        concurrent_refreshes=3)
    specs = []
    for spec in ("mig:namePrefix=tpu-,min=1,max=7", "asg:namePrefix=x", "mig:min=1",
                 "mig:namePrefix=x,bogus=1"):
        try:
            specs.append(k.gce.parse_auto_discovery_spec(spec))
        except ValueError as e:
            specs.append(str(e))
    return ([(g.id(), g.min_size(), g.max_size(), g.target_size())
             for g in provider.node_groups()], specs)


def test_discovery_matches_jax():
    assert discovery(TORCH) == discovery(JAX)


def test_expiring_cache_matches_jax():
    got = []
    for k in (JAX, TORCH):
        now = {"t": 0.0}
        c = k.cache.ExpiringCache(10.0, clock=lambda: now["t"])
        c.put("a", 1)
        seen = [c.get("a")]
        now["t"] = 9.9
        seen.append(c.get("a"))
        now["t"] = 10.1
        seen.append(c.get("a"))
        c.put("b", 2)
        c.invalidate("b")
        seen.append(c.get("b"))
        got.append(seen)
    assert got[1] == got[0] == [1, 1, None, None]


def rest_session(k, server):
    """tests/test_gce_rest.py's REST calls on one package against its own
    fresh FakeComputeServer. → what each call returned (or raised)."""
    api = k.rest.RestGceApi(token_fn=lambda: "tok-123", base_url=server.url, project=PROJECT,
                            op_poll_s=0.01, op_timeout_s=5.0)
    out = [api.get_target_size(PROJECT, ZONE, MIG)]
    api.resize(PROJECT, ZONE, MIG, 7)
    api.delete_instances(PROJECT, ZONE, MIG, [f"{MIG}-1"])
    out.append(canon(api.list_instances(PROJECT, ZONE, MIG)))
    out.append(canon(api.get_template(PROJECT, ZONE, MIG)))
    out.append(api.list_migs())
    server.instances.append({"instance": f"projects/{PROJECT}/zones/{ZONE}/instances/x-stopped",
                             "currentAction": "NONE", "instanceStatus": "STOPPED"})
    server.instances.append({"instance": f"projects/{PROJECT}/zones/{ZONE}/instances/x-new",
                             "currentAction": "CREATING", "lastAttempt": {"errors": {"errors": [
                                 {"code": "ZONE_RESOURCE_POOL_EXHAUSTED", "message": "no"}]}}})
    server.page_size = 2
    out.append(canon(api.list_instances(PROJECT, ZONE, MIG)))
    server.pending_ops = 2
    api.resize(PROJECT, ZONE, MIG, 9)
    server.op_error = {"errors": [{"code": "QUOTA", "message": "over"}]}
    try:
        api.resize(PROJECT, ZONE, MIG, 10)
    except k.iface.NodeGroupError as e:
        out.append(str(e))
    provider = k.gce.build_gce_provider([f"0:20:projects/{PROJECT}/zones/{ZONE}/"
                                         f"instanceGroups/{MIG}"], api)
    (mig,) = provider.node_groups()
    out.append((mig.target_size(), canon(mig.template_node_info()), canon(mig.nodes())))
    return out


def test_rest_transport_matches_jax():
    """Each package's RestGceApi on a fresh recorded compute server: the
    same answers, and the same requests (method, path, body, auth)."""
    runs = []
    for k in (JAX, TORCH):
        server = FakeComputeServer()
        try:
            runs.append((rest_session(k, server), list(server.requests)))
        finally:
            server.close()
    assert runs[1] == runs[0]
    assert any("/resize?size=7" in path for _, path, _, _ in runs[0][1])
    assert any(path.endswith("/deleteInstances") and body == {"instances": [
        f"projects/{PROJECT}/zones/{ZONE}/instances/{MIG}-1"]} for _, path, body, _ in runs[0][1])
