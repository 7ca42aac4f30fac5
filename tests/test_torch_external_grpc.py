"""The out-of-process providers on the port (autoscaler_tpu_torch/
cloudprovider/external_grpc.py, rpc/autoscaler_pb2.py, rpc/refcompat.py)
across packages: the port's client talks to the JAX package's server and
the JAX package's client to the port's, on localhost, and every RPC answer
equals the same session between two JAX package ends (tolerance 0: objects
compare by ``torch_parity.canon``). One case serves the port's provider
from a separate process, as tests/test_external_grpc_full.py does. The
generated module is the JAX package's byte for byte, so both speak one
protocol."""
import subprocess
import sys
import types
from pathlib import Path

import pytest

import autoscaler_tpu.cloudprovider.external_grpc as jext
import autoscaler_tpu.cloudprovider.test_provider as jprov
import autoscaler_tpu.config.options as jopts
import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.processors.nodegroups as jnap
import autoscaler_tpu.rpc.refcompat as jref
import autoscaler_tpu_torch.cloudprovider.external_grpc as text
import autoscaler_tpu_torch.cloudprovider.test_provider as tprov
import autoscaler_tpu_torch.config.options as topts
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.processors.nodegroups as tnap
import autoscaler_tpu_torch.rpc.refcompat as tref
from torch_parity import canon

REPO = Path(__file__).resolve().parent.parent
JAX = types.SimpleNamespace(name="jax", ext=jext, prov=jprov, opts=jopts, obj=jobj, nap=jnap,
                            ref=jref)
TORCH = types.SimpleNamespace(name="torch", ext=text, prov=tprov, opts=topts, obj=tobj,
                              nap=tnap, ref=tref)
GB = 1024**3
PAIRS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]
PKG = {"jax": JAX, "torch": TORCH}


def test_generated_module_is_byte_identical():
    ours = (REPO / "autoscaler_tpu_torch/rpc/autoscaler_pb2.py").read_bytes()
    assert ours == (REPO / "autoscaler_tpu/rpc/autoscaler_pb2.py").read_bytes()
    from autoscaler_tpu.rpc import autoscaler_pb2 as jpb
    from autoscaler_tpu_torch.rpc import autoscaler_pb2 as tpb

    # one descriptor in the default pool: the message classes are shared
    assert tpb.DESCRIPTOR is jpb.DESCRIPTOR and tpb.NodeGroupSpec is jpb.NodeGroupSpec
    assert text.PROVIDER_SERVICE == jext.PROVIDER_SERVICE
    assert tref.PROVIDER_SERVICE == jref.PROVIDER_SERVICE
    assert tref.EXPANDER_SERVICE == jref.EXPANDER_SERVICE


def backing(k):
    """The provider a server serves: a priced group with options and two
    registered nodes, a second group, and the GPU types."""
    provider = k.prov.TestCloudProvider()
    provider.gpu_types = ["nvidia-tesla-t4", "nvidia-l4"]
    tmpl = k.obj.Node(name="tmpl-pool", allocatable=k.obj.Resources(
        cpu_m=4000, memory=16 * GB, gpu=1, pods=110), labels={"pool": "a"},
        taints=[k.obj.Taint(key="dedicated", value="ml", effect="NoSchedule")])
    group = provider.add_node_group("pool", 0, 10, 2, tmpl, price_per_hour=0.5)
    group.options = k.opts.NodeGroupAutoscalingOptions(
        scale_down_utilization_threshold=0.77, scale_down_gpu_utilization_threshold=0.66,
        scale_down_unneeded_time_s=123.0, scale_down_unready_time_s=456.0,
        max_node_provision_time_s=789.0)
    provider.add_node_group("other", 1, 4, 1, k.obj.Node(
        name="tmpl-other", allocatable=k.obj.Resources(cpu_m=2000, memory=4 * GB, pods=58)))
    for i in range(2):
        provider.add_node("pool", k.obj.Node(name=f"pool-{i}", provider_id=f"test:///pool-{i}"))
    return provider


def session(client, k, native: bool) -> list:
    """Every RPC of the provider surface through one client: → the
    answers (objects canonicalised). ``native``: the autoscaler's own
    protocol (NAP create and delete, server-side limits)."""
    client.refresh()
    out = [[(g.id(), g.min_size(), g.max_size(), g.target_size(), g.exist(), g.autoprovisioned())
            for g in client.node_groups()]]
    pool = {g.id(): g for g in client.node_groups()}["pool"]
    out.append(canon(pool.template_node_info()))
    out.append(canon(pool.nodes()))
    out.append(canon(pool.get_options(k.opts.NodeGroupAutoscalingOptions())))
    for name, pid in (("pool-1", "test:///pool-1"), ("stranger", "aws:///x")):
        g = client.node_group_for_node(k.obj.Node(name=name, provider_id=pid))
        out.append(g.id() if g is not None else None)
    pool.increase_size(3)
    client.refresh()
    pool = {g.id(): g for g in client.node_groups()}["pool"]
    out.append(pool.target_size())
    try:
        pool.decrease_target_size(2)
    except Exception as e:  # noqa: BLE001 - compared across packages
        # the reference protocol sends the delta negative, and the bridge
        # hands it on to a backing provider that wants it positive
        out.append(e.details() if hasattr(e, "details") else str(e))
    pool.delete_nodes([k.obj.Node(name="pool-0", provider_id="test:///pool-0")])
    client.refresh()
    out.append([(g.id(), g.target_size()) for g in client.node_groups()])
    model = client.pricing()
    if model is not None:
        pod = k.obj.Pod(name="p", requests=k.obj.Resources(cpu_m=1000, memory=1 * GB))
        out.append((model.node_price(k.obj.Node(name="template-pool-0"), 0.0, 3600.0),
                    model.pod_price(pod, 0.0, 3600.0)))
    out.append((client.gpu_label(), client.get_available_gpu_types()))
    lim = client.get_resource_limiter()
    out.append((lim.get_min("cpu"), lim.has_max("cpu")))
    if native:
        template = k.obj.Node(name="nap-x-template", allocatable=k.obj.Resources(
            cpu_m=8000, memory=32 * GB, pods=110), labels={"workload": "batch"})
        cand = k.nap.CandidateNodeGroup("nap-x", template, 20, client.group_factory,
                                        price_per_hour=0.27)
        created = cand.create()
        created.increase_size(3)
        client.refresh()
        seen = {g.id(): g for g in client.node_groups()}["nap-x"]
        out.append((seen.target_size(), seen.autoprovisioned(), canon(seen.template_node_info())))
        seen.decrease_target_size(3)
        seen.delete()
        client.refresh()
        out.append(sorted(g.id() for g in client.node_groups()))
    return out


def run_pair(kind: str, server_pkg: str, client_pkg: str) -> list:
    s, c = PKG[server_pkg], PKG[client_pkg]
    native = kind == "externalgrpc"
    serve = s.ext.serve_cloud_provider if native else s.ref.serve_ref_provider
    server, port = serve(backing(s))
    try:
        cls = c.ext.ExternalGrpcCloudProvider if native else c.ref.RefProtocolCloudProvider
        client = cls(f"127.0.0.1:{port}")
        try:
            return session(client, c, native)
        finally:
            client.cleanup()
    finally:
        server.stop(None)


@pytest.mark.parametrize("kind", ["externalgrpc", "externalgrpc-ref"])
@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS,
                         ids=[f"{s}-server-{c}-client" for s, c in PAIRS])
def test_rpc_answers_equal_across_packages(kind, server_pkg, client_pkg):
    ref = run_pair(kind, "jax", "jax")
    assert run_pair(kind, server_pkg, client_pkg) == ref
    assert ref[0][0][0] == "pool" and ref[4] == "pool" and ref[5] is None


_PORT_SERVER = """
import sys, time
sys.modules["jax"] = None
from autoscaler_tpu_torch.cloudprovider.external_grpc import serve_cloud_provider
from autoscaler_tpu_torch.cloudprovider.test_provider import TestCloudProvider
from autoscaler_tpu_torch.config.options import NodeGroupAutoscalingOptions
from autoscaler_tpu_torch.kube.objects import Node, Resources, Taint

provider = TestCloudProvider()
provider.gpu_types = ["nvidia-tesla-t4", "nvidia-l4"]
tmpl = Node(name="tmpl-pool", allocatable=Resources(cpu_m=4000, memory=16 * 1024**3, gpu=1,
            pods=110), labels={"pool": "a"},
            taints=[Taint(key="dedicated", value="ml", effect="NoSchedule")])
group = provider.add_node_group("pool", 0, 10, 2, tmpl, price_per_hour=0.5)
group.options = NodeGroupAutoscalingOptions(
    scale_down_utilization_threshold=0.77, scale_down_gpu_utilization_threshold=0.66,
    scale_down_unneeded_time_s=123.0, scale_down_unready_time_s=456.0,
    max_node_provision_time_s=789.0)
provider.add_node_group("other", 1, 4, 1, Node(name="tmpl-other", allocatable=Resources(
    cpu_m=2000, memory=4 * 1024**3, pods=58)))
for i in range(2):
    provider.add_node("pool", Node(name=f"pool-{i}", provider_id=f"test:///pool-{i}"))
loaded = [m for m in sys.modules if m == "autoscaler_tpu" or m.startswith("autoscaler_tpu.")]
assert not loaded, loaded
server, port = serve_cloud_provider(provider)
print(port, flush=True)
time.sleep(600)
"""


@pytest.mark.parametrize("client_pkg", ["jax", "torch"])
def test_port_server_in_a_separate_process(client_pkg):
    """The port's provider served by another interpreter (jax blocked
    there): each package's client gets the answers of the in-process JAX
    pair."""
    proc = subprocess.Popen([sys.executable, "-c", _PORT_SERVER], cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**__import__("os").environ, "PYTHONPATH": str(REPO)})
    try:
        line = proc.stdout.readline().strip()
        assert line.isdigit(), proc.stderr.read() if proc.poll() is not None else line
        c = PKG[client_pkg]
        client = c.ext.ExternalGrpcCloudProvider(f"127.0.0.1:{line}")
        try:
            got = session(client, c, True)
        finally:
            client.cleanup()
    finally:
        proc.kill()
        proc.wait()
    assert got == run_pair("externalgrpc", "jax", "jax")


def test_absent_exist_field_means_exists():
    """A legacy server that never sets ``exist`` reads as existing groups
    in both packages (proto3 presence)."""
    from autoscaler_tpu_torch.rpc import autoscaler_pb2 as pb

    legacy = pb.NodeGroupSpec(id="g", min_size=0, max_size=5, target_size=1)
    explicit = pb.NodeGroupSpec(id="g2", exist=False)
    for k in (JAX, TORCH):
        assert k.ext._RemoteNodeGroup(None, legacy).exist()
        assert not k.ext._RemoteNodeGroup(None, explicit).exist()


@pytest.mark.parametrize("seed", range(3))
def test_v1_codec_round_trips_as_in_jax(seed):
    """The reference protocol's v1 Node and Pod codec: the same bytes from
    both packages, and each decodes the other's."""
    import numpy as np

    rng = np.random.default_rng(seed)
    blobs = {}
    for k in (JAX, TORCH):
        node = k.obj.Node(
            name=f"n{seed}", allocatable=k.obj.Resources(cpu_m=float(rng.integers(1, 64)) * 1000,
                                                         memory=float(rng.integers(1, 256)) * GB,
                                                         gpu=float(rng.integers(0, 4)), pods=110),
            labels={"zone": f"z{seed}", "pool": "p"}, annotations={"a": "b"},
            taints=[k.obj.Taint(key="dedicated", value=str(seed), effect="NoSchedule")],
            provider_id=f"ref://n{seed}")
        pod = k.obj.Pod(name=f"p{seed}", namespace="ns", requests=k.obj.Resources(
            cpu_m=250.0 * (seed + 1), memory=float(seed + 1) * GB), labels={"app": "x"},
            node_selector={"pool": "p"}, node_name=f"n{seed}")
        blobs[k.name] = (k.ref.encode_v1_node(node), k.ref.encode_v1_pod(pod))
        rng = np.random.default_rng(seed)
    assert blobs["torch"] == blobs["jax"]
    for k in (JAX, TORCH):
        other = blobs["jax" if k is TORCH else "torch"]
        assert canon(k.ref.decode_v1_node(other[0])) == canon(jref.decode_v1_node(other[0]))
        assert canon(k.ref.decode_v1_pod(other[1])) == canon(jref.decode_v1_pod(other[1]))
