"""tools/binding_probe and tools/bound_loop, which chip_smoke's 3r, 3s and
4n run, on the CPU at a small size: the port's objects served as the API's
JSON convert back to equal objects; the fake APIs' watch streams, writes
and ``/scale`` semantics; 3r's sequence through the bindings decides as
tools/loop_probe's in-memory sequence does, tick for tick, with the writes
its decisions imply; two runs replay write for write; and the gce world
through ``main`` in process and in a subprocess."""
import dataclasses
import json
import time

import numpy as np
import pytest

from autoscaler_tpu_torch.kube import convert
from autoscaler_tpu_torch.kube.client import KubeClusterAPI, KubeRestClient
from autoscaler_tpu_torch.tools import binding_probe as bp
from autoscaler_tpu_torch.tools import bound_loop, loop_probe
from autoscaler_tpu_torch.utils.test_utils import build_test_node, build_test_pod
from autoscaler_tpu_torch.utils.workload import build_snapshot_world

REPO = str(__import__("pathlib").Path(__file__).resolve().parent.parent)


@pytest.fixture(scope="module")
def small_world():
    nodes, pods = loop_probe.scale_in_listing(*build_snapshot_world(N=120, P=800, port_nodes=40))
    templates, burst = loop_probe.burst_operands()
    return nodes, pods, burst[:200], loop_probe.zoned_templates(templates)


@pytest.fixture(scope="module")
def servers():
    s = bp.FakeServers.start()
    yield s
    s.close()


def f32_cpu(obj):
    """An object with its millicores as the packed float32 requests hold
    them ("1001m" converts to 1000.9999999999999, as in the JAX package)."""
    r = obj.requests if hasattr(obj, "requests") else obj.allocatable
    r = dataclasses.replace(r, cpu_m=float(np.float32(r.cpu_m)))
    return dataclasses.replace(obj, **{"requests" if hasattr(obj, "requests") else
                                       "allocatable": r})


def test_world_round_trips_through_json(small_world):
    """Every node and pod of the small loop world, the burst and the
    arrivals (host ports, DaemonSet owners, hostname anti-affinity, zone
    spread) as the API's JSON and back through ``convert``: equal."""
    nodes, pods, burst, groups = small_world
    for node in list(nodes) + list(groups.values()):
        back = convert.node_from_json(json.loads(json.dumps(bp.node_json(node))))
        assert f32_cpu(back) == f32_cpu(node)
    arrivals = loop_probe.arrivals(40, 2)
    assert any(p.topology_spread for p in arrivals)
    assert any(p.host_ports for p in pods) and any(p.affinity for p in pods)
    for pod in list(pods) + list(burst) + arrivals:
        back = convert.pod_from_json(json.loads(json.dumps(bp.pod_json(pod))))
        assert f32_cpu(back) == f32_cpu(pod), pod.key()


@pytest.mark.parametrize("cpu_m", [0, 1, 250, 999, 1000, 1001, 1500, 32000, 0.5])
def test_cpu_quantities_convert_back(cpu_m):
    back = convert.parse_cpu_millis(bp.cpu_quantity(cpu_m))
    assert np.float32(back) == np.float32(cpu_m)


def test_unserved_fields_are_refused():
    pod = dataclasses.replace(build_test_pod("p"), csi_volumes=(("d", "h"),))
    with pytest.raises(ValueError):
        bp.pod_json(pod)
    with pytest.raises(ValueError):
        bp.pod_json(dataclasses.replace(build_test_pod("q"), owner_ref=None))


def test_fake_api_watch_and_writes(servers):
    """The watch streams carry the writes and the control endpoint's churn;
    a write answers once its watch event is sent; ``/scale`` PUTs reap the
    machines marked for deletion."""
    nodes = [build_test_node(f"w{i}") for i in range(3)]
    servers.load("nodes", [(n.name, json.dumps(bp.node_json(n))) for n in nodes])
    servers.load("pods", [bp.pod_json(build_test_pod(f"wp{i}")) for i in range(3)])
    servers.load("machinedeployments", [bp.machine_deployment_json("ns", "md", 0, 5, 2)])
    servers.load("machines", [bp.machine_json("ns", f"m{i}", "md-ms", "md", f"p{i}")
                              for i in range(2)])
    api = KubeClusterAPI(KubeRestClient(servers.kube_url), watch=True)
    try:
        seen = len(servers.writes())
        api.delete_node_object("w2")
        api.cordon_node("w1")
        api.evict_pod(build_test_pod("wp0"))
        servers.apply([["bind", "default/wp1", "w0"], ["delete", "pods", "default/wp2"]])
        bound_loop.wait_applied(api, servers)
        assert sorted(n.name for n in api.list_nodes()) == ["w0", "w1"]
        assert [n.unschedulable for n in api.list_nodes() if n.name == "w1"] == [True]
        assert {p.key(): p.node_name for p in api.list_pods()} == {"default/wp1": "w0"}
        client = api.client
        client.merge_patch(f"{bp.CAPI}/namespaces/ns/machines/m1", {"metadata": {
            "annotations": {bp.DELETE_MACHINE: "1"}}})
        scale = client.get(f"{bp.CAPI}/namespaces/ns/machinedeployments/md/scale")
        scale["spec"]["replicas"] = 1
        client.put(f"{bp.CAPI}/namespaces/ns/machinedeployments/md/scale", scale)
        assert [m["metadata"]["name"] for m in servers.objects("machines", "ns")] == ["m0"]
        writes = servers.writes(seen)
        assert [(m, p.rsplit("/", 1)[-1]) for m, p, _ in writes] == [
            ("DELETE", "w2"), ("PATCH", "w1"), ("POST", "eviction"), ("PATCH", "m1"),
            ("PUT", "scale")]
    finally:
        api.close()


def test_bound_ticks_decide_as_the_loop(small_world):
    """3r at a small size: every tick's decisions (the scale-up by group,
    the nodes deleted, the unneeded and unremovable counts) equal
    tools/loop_probe's in-memory ticks; the writes are the decisions';
    one Lease holder; and a second run replays write for write."""
    nodes, pods, burst, groups = small_world
    ref = loop_probe.run_loop_ticks(nodes, pods, burst, groups, "cpu", arrive=40,
                                    replayable=True)
    runs = [bound_loop.run_bound_ticks(nodes, pods, burst, groups, "cpu", arrive=40,
                                       replayable=True, timed=k == 0) for k in range(2)]
    for k, (want, got, again) in enumerate(zip(ref["ticks"], *[r["ticks"] for r in runs])):
        assert {**bound_loop.decisions(want["result"]), "unremovable": want["unremovable"]} == {
            **got["decisions"], "unremovable": got["unremovable"]}, k
        assert bound_loop.write_problems(got) == []
        assert got["probe"]["checked"] and not got["probe"]["drift"]
        assert loop_probe.result_canon(got["result"]) == loop_probe.result_canon(again["result"])
        assert bound_loop.write_canon(got["writes"]) == bound_loop.write_canon(again["writes"])
        assert got["targets"] == again["targets"] == {
            bound_loop.group_name(g): t for g, *_, t in want["state"]["groups"]}
    assert bound_loop.lease_holders(runs[0]["writes"]) == {bound_loop.IDENTITY}
    first = runs[0]["first"]
    assert first["items"] == len(pods) + len(burst) and first["bytes"] > 0
    assert "split" in runs[0]["ticks"][0] and runs[0]["ticks"][1]["churn"]["bound"] > 0


def test_gce_world_in_process_replays(small_world):
    """3s's gce world through ``main`` in this process twice on the CPU:
    the same resize and deleteInstances requests, a resize among them."""
    nodes, pods, burst, _ = small_world
    runs = [bound_loop.run_gce_in_process(nodes, pods, burst, "cpu") for _ in range(2)]
    assert runs[0]["rc"] == runs[1]["rc"] == 0
    assert bound_loop.compute_canon(runs[0]["compute_writes"]) == bound_loop.compute_canon(
        runs[1]["compute_writes"])
    assert any("/resize?" in p for _, p, _ in runs[0]["compute_writes"])
    assert bound_loop.lease_holders(runs[0]["kube_writes"])


def test_gce_main_in_a_subprocess(small_world):
    """3s on the CPU: ``python -m autoscaler_tpu_torch.main --provider=gce
    ... --leader-elect`` exits 0, takes the Lease, resizes a MIG, writes
    the status ConfigMap, and reports its kernel wrappers' counts."""
    nodes, pods, burst, _ = small_world
    t0 = time.perf_counter()
    out = bound_loop.run_gce_main(nodes, pods, burst, REPO, device="cpu")
    assert out["rc"] == 0, out["stderr"][-2000:]
    assert len(bound_loop.lease_holders(out["kube_writes"])) == 1
    assert any("/resize?" in p for _, p, _ in out["compute_writes"])
    assert any(p.endswith("/configmaps/cluster-autoscaler-status") for _, p, _ in out["kube_writes"])
    assert set(out["launches"]) == {"ffd_scan_f32", "ffd_scan_swar", "ffd_scan_aff",
                                    "fit_reduce", "fit_reduce_rows"}
    assert time.perf_counter() - t0 < 120
