"""The port's BinpackingNodeEstimator (autoscaler_tpu_torch/estimator/
binpacking.py, on the CPU) and expander against the JAX package's, on the
same pods and templates: each package builds them with its own
build_test_pod/build_test_node from one numpy-seeded spec. Node counts,
scheduled pods and the expander's choice must be equal, on the plain and
runs routes and on every dynamic route (inter-pod affinity, hard spread,
legacy volume conflicts), where each case also checks which of the port's
routes served it."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import autoscaler_tpu.estimator.binpacking as jest
import autoscaler_tpu.estimator.limiter as jlim
import autoscaler_tpu.expander.core as jexp
import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.estimator.binpacking as tes
import autoscaler_tpu_torch.estimator.limiter as tlim
import autoscaler_tpu_torch.expander.core as texp
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.utils.test_utils as ttu
from autoscaler_tpu_torch.ops import ffd_scan, ffd_scan_affinity
from torch_parity import port_world

JAX = SimpleNamespace(obj=jobj, tu=jtu, est=jest, lim=jlim, exp=jexp)
TORCH = SimpleNamespace(obj=tobj, tu=ttu, est=tes, lim=tlim, exp=texp)
MB = 1024 * 1024


def pod_spec(seed, n, decimal_memory=False, replicated=False, extras=False):
    """One numpy-seeded list of plain dicts that both packages turn into
    their own Pod objects."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n):
        mem = int(rng.integers(64, 4096))
        spec = {
            "name": f"p{i}",
            "cpu_m": float(rng.integers(50, 2000)),
            "mem": mem * 10**6 if decimal_memory and i % 3 == 0 else mem * MB,
            "owner": f"rs{i % 7}" if replicated else None,
            "zone": None, "tolerate": False, "port": None, "csi": 0, "ext": 0.0,
        }
        if replicated:  # replicas of one controller share a spec
            r = np.random.default_rng(seed * 100 + i % 7)
            spec["cpu_m"] = float(r.integers(50, 2000))
            spec["mem"] = int(r.integers(64, 4096)) * MB
        if extras:
            spec["zone"] = ["a", "b", None][i % 3]
            spec["tolerate"] = i % 4 == 0
            spec["port"] = 8080 if i % 5 == 0 else (9090 if i % 11 == 0 else None)
            spec["csi"] = int(i % 6 == 0) + int(i % 12 == 0)
            spec["ext"] = float(rng.integers(1, 3)) if i % 4 == 1 else 0.0
        specs.append(spec)
    return specs


def make_pods(pkg, specs):
    pods = []
    for s in specs:
        pod = pkg.tu.build_test_pod(
            s["name"], cpu_m=s["cpu_m"], mem=s["mem"],
            node_selector={"zone": s["zone"]} if s["zone"] else None,
            tolerations=(
                [pkg.obj.Toleration(key="dedicated", value="batch", effect="NoSchedule")]
                if s["tolerate"] else None
            ),
        )
        changes = {}
        if s["owner"]:
            changes["owner_ref"] = pkg.obj.OwnerRef(kind="ReplicaSet", name=s["owner"])
        if s["port"]:
            changes["host_ports"] = (s["port"],)
        if s["csi"]:
            changes["csi_volumes"] = tuple(
                ("ebs.csi", f"{s['name']}-vol{k}") for k in range(s["csi"])
            )
        if s["ext"]:
            changes["requests"] = dataclasses.replace(
                pod.requests, extended=(("example.com/fpga", s["ext"]),)
            )
        pods.append(dataclasses.replace(pod, **changes) if changes else pod)
    return pods


def template_spec(seed, n, extras=False):
    rng = np.random.default_rng(seed + 1)
    out = {}
    for j in range(n):
        out[f"ng-{j}"] = {
            "cpu_m": float(rng.choice([2000, 4000, 8000, 16000])),
            "mem": int(rng.choice([4096, 8192, 16384, 32768])) * MB,
            "zone": ["a", "b"][j % 2] if extras else None,
            "taint": extras and j % 3 == 2,
            "csi_limit": (None if j % 2 else 2) if extras else None,
            "ext": 4.0 if extras and j % 2 == 0 else 0.0,
            "overhead": float(rng.integers(0, 300)) if extras else 0.0,
        }
    return out


def make_templates(pkg, specs):
    out = {}
    for name, s in specs.items():
        node = pkg.tu.build_test_node(
            f"{name}-template", cpu_m=s["cpu_m"], mem=s["mem"],
            labels={"zone": s["zone"]} if s["zone"] else None,
            taints=(
                [pkg.obj.Taint(key="dedicated", value="batch")] if s["taint"] else None
            ),
        )
        changes = {}
        if s["csi_limit"] is not None:
            changes["csi_attach_limits"] = {"ebs.csi": s["csi_limit"]}
        if s["ext"]:
            changes["allocatable"] = dataclasses.replace(
                node.allocatable, extended=(("example.com/fpga", s["ext"]),)
            )
        if s["overhead"]:
            changes["daemon_overhead"] = pkg.obj.Resources(cpu_m=s["overhead"], memory=64 * MB)
        out[name] = dataclasses.replace(node, **changes) if changes else node
    return out


class Group:
    """A node group as the expander sees it: id() and its template."""

    def __init__(self, name, template):
        self.name, self.template = name, template

    def id(self):
        return self.name

    def template_node_info(self):
        return self.template


def estimator(pkg, max_nodes):
    limiter = pkg.lim.ThresholdBasedEstimationLimiter(max_nodes=max_nodes)
    if pkg is TORCH:
        return pkg.est.BinpackingNodeEstimator(limiter=limiter, device="cpu")
    return pkg.est.BinpackingNodeEstimator(limiter=limiter)


def run_both(pspecs, tspecs, max_nodes=64, headrooms=None):
    results = {}
    for label, pkg in (("jax", JAX), ("torch", TORCH)):
        pods = make_pods(pkg, pspecs)
        templates = make_templates(pkg, tspecs)
        res = estimator(pkg, max_nodes).estimate_many(pods, templates, headrooms)
        results[label] = (res, templates)
    return results


def assert_same(results):
    (jres, jt), (tres, tt) = results["jax"], results["torch"]
    assert sorted(jres) == sorted(tres)
    for g in jres:
        assert jres[g][0] == tres[g][0], g
        assert [p.name for p in jres[g][1]] == [p.name for p in tres[g][1]], g
    # the expander picks the same option from equal results
    for names in (["least-waste"], ["most-pods"], ["least-waste", "most-pods"]):
        picks = []
        for pkg, res, templates in ((JAX, jres, jt), (TORCH, tres, tt)):
            options = [
                pkg.exp.Option(node_group=Group(g, templates[g]), node_count=c, pods=pods)
                for g, (c, pods) in sorted(res.items()) if c > 0 and pods
            ]
            strategy = pkg.exp.build_strategy(names, seed=0)
            best = strategy.best_option(options)
            picks.append((best.node_group.id() if best else None, strategy.last_table))
        assert picks[0] == picks[1], names
    return tres


def routed_kernel(pspecs, tspecs, max_nodes=64):
    """Which scan kernel the port's plain route takes on these operands."""
    pods = make_pods(TORCH, pspecs)
    templates = make_templates(TORCH, tspecs)
    names = sorted(templates)
    P = tes.bucket_size(len(pods))
    req, masks, allocs = tes._build_group_arrays(pods, names, templates, pad=P)
    ops = ffd_scan.prepare_scan(
        *ffd_scan.operands_from_numpy(req, masks, allocs, device="cpu")[:3], max_nodes
    )
    return "swar" if ops.plan is not None else "f32"


@pytest.mark.parametrize("seed", [0, 1])
def test_unique_pods_plain_route_swar(seed):
    pspecs, tspecs = pod_spec(seed, 150), template_spec(seed, 6)
    assert routed_kernel(pspecs, tspecs) == "swar"
    tres = assert_same(run_both(pspecs, tspecs))
    assert any(c > 0 for c, _ in tres.values())


@pytest.mark.parametrize("seed", [2, 3])
def test_decimal_memory_plain_route_f32(seed):
    pspecs, tspecs = pod_spec(seed, 150, decimal_memory=True), template_spec(seed, 6)
    assert routed_kernel(pspecs, tspecs) == "f32"
    assert_same(run_both(pspecs, tspecs))


def test_replicated_pods_runs_route():
    pspecs, tspecs = pod_spec(4, 280, replicated=True), template_spec(4, 5)
    pods = make_pods(TORCH, pspecs)
    assert len(tes.build_pod_groups(pods)) * 2 <= len(pods)
    before = dict(ffd_scan.LAUNCHES)
    assert_same(run_both(pspecs, tspecs))
    assert ffd_scan.LAUNCHES == before


def test_headrooms_cap_groups():
    pspecs, tspecs = pod_spec(5, 200), template_spec(5, 5)
    headrooms = {"ng-0": 1, "ng-1": 3, "ng-3": 2}
    tres = assert_same(run_both(pspecs, tspecs, headrooms=headrooms))
    for g, h in headrooms.items():
        assert tres[g][0] <= h


def test_extended_resources_host_ports_and_csi_limits():
    """Named extended resources, host ports and CSI attach limits become
    extra columns and virtual planes; selectors and taints shape the
    masks."""
    pspecs, tspecs = pod_spec(6, 160, extras=True), template_spec(6, 6, extras=True)
    assert_same(run_both(pspecs, tspecs))


def test_extras_with_decimal_memory():
    pspecs = pod_spec(7, 120, decimal_memory=True, extras=True)
    assert_same(run_both(pspecs, template_spec(7, 4, extras=True)))


def test_default_limiter_cap():
    """The reference's default 1000-node cap (a 1024-node carry)."""
    pspecs, tspecs = pod_spec(8, 60), template_spec(8, 3)
    assert_same(run_both(pspecs, tspecs, max_nodes=1000))


@pytest.mark.parametrize("decimal_memory", [False, True])
def test_estimate_single_template(decimal_memory):
    pspecs = pod_spec(9, 90, decimal_memory=decimal_memory, extras=True)
    tspecs = template_spec(9, 2, extras=True)
    got = []
    for pkg in (JAX, TORCH):
        pods = make_pods(pkg, pspecs)
        templates = make_templates(pkg, tspecs)
        est = estimator(pkg, 32)
        got.append([
            (c, [p.name for p in sched])
            for c, sched in (
                est.estimate(pods, templates[g], max_size_headroom=h)
                for g, h in (("ng-0", 0), ("ng-1", 5))
            )
        ])
    assert got[0] == got[1]


def test_empty_inputs():
    est = estimator(TORCH, 16)
    tmpl = make_templates(TORCH, template_spec(0, 1))
    assert est.estimate_many([], tmpl) == {"ng-0": (0, [])}
    assert est.estimate([], tmpl["ng-0"]) == (0, [])


# -- dynamic worlds: inter-pod affinity, hard spread, volume conflicts -------

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def dynamic_spec(seed, n, anti=0.0, aff=0.0, spread=0.0, spread_key=ZONE, volumes=0.0,
                 replicated=False, apps=4, skew=1, min_domains=None):
    """pod_spec plus an app label and, by the given shares, hostname
    anti-affinity or zone affinity on the pod's app, a DoNotSchedule
    spread constraint on it, or a shared legacy GCE PD."""
    rng = np.random.default_rng(seed + 50)
    specs = pod_spec(seed, n, replicated=replicated)
    for i, s in enumerate(specs):
        s["app"] = f"a{i % apps}" if replicated else f"a{int(rng.integers(0, apps))}"
        r = rng.random()
        s["anti"] = r < anti
        s["aff"] = anti <= r < anti + aff
        s["spread"] = (spread_key, skew, min_domains) if rng.random() < spread else None
        s["volume"] = bool(rng.random() < volumes)
        if replicated:  # replicas share the dynamic parts of their spec
            s["owner"] = f"rs-{s['app']}"
            s["anti"] = s["app"] == "a0"
            s["aff"] = False
            s["spread"] = (spread_key, skew, min_domains) if s["app"] == "a1" and spread else None
            s["volume"] = False
    return specs


def make_dynamic_pods(pkg, specs):
    pods = []
    o = pkg.obj
    for pod, s in zip(make_pods(pkg, specs), specs):
        sel = o.LabelSelector.from_dict({"app": s["app"]})
        changes = {"labels": {"app": s["app"]}}
        if s["anti"]:
            changes["affinity"] = pkg.tu.anti_affinity({"app": s["app"]})
        elif s["aff"]:
            changes["affinity"] = pkg.tu.pod_affinity({"app": s["app"]}, topology_key=ZONE)
        if s["spread"]:
            key, skew, min_domains = s["spread"]
            changes["topology_spread"] = (o.TopologySpreadConstraint(
                max_skew=skew, topology_key=key, selector=sel, min_domains=min_domains,
            ),)
        if s["volume"]:
            changes["legacy_volumes"] = (o.LegacyVolume("gce-pd", "shared-disk"),)
        pods.append(dataclasses.replace(pod, **changes))
    return pods


def zoned_templates(pkg, seed, n):
    out = make_templates(pkg, template_spec(seed, n))
    for j, node in enumerate(out.values()):
        if j % 4 != 3:                      # one template in four has no zone
            node.labels[ZONE] = f"zone-{'abc'[j % 3]}"
    return out


def cluster_of(pkg):
    """Two existing nodes: zone-a holds two app-a0 pods, zone-d none."""
    nodes = []
    for name, zone in (("e0", "zone-a"), ("e1", "zone-d")):
        node = pkg.tu.build_test_node(name, cpu_m=8000)
        node.labels[ZONE] = zone
        nodes.append(node)
    pods = [pkg.tu.build_test_pod(f"q{k}", labels={"app": "a0"}) for k in range(2)]
    return nodes, pods, [0, 0]


def run_dynamic(specs, seed=0, n_templates=4, max_nodes=16, cluster=False, headrooms=None):
    """estimate_many on both packages (the port on the CPU) and the route
    the port took."""
    results = {}
    routes_before = dict(tes.ROUTES)
    launches_before = dict(ffd_scan_affinity.LAUNCHES)
    for label, pkg in (("jax", JAX), ("torch", TORCH)):
        pods = make_dynamic_pods(pkg, specs)
        templates = zoned_templates(pkg, seed, n_templates)
        res = estimator(pkg, max_nodes).estimate_many(
            pods, templates, headrooms, cluster=cluster_of(pkg) if cluster else None
        )
        results[label] = (res, templates)
    assert ffd_scan_affinity.LAUNCHES == launches_before  # CPU: no kernel launch
    routed = {k: tes.ROUTES[k] - routes_before[k] for k in tes.ROUTES}
    return results, routed


def per_pod_route(results, routed, route="ffd_scan_aff"):
    assert routed == {k: int(k == route) for k in routed}, routed
    return assert_same(results)


def test_anti_affinity_world_per_pod_route():
    results, routed = run_dynamic(dynamic_spec(10, 60, anti=0.4, aff=0.2))
    tres = per_pod_route(results, routed)
    assert any(c > 0 for c, _ in tres.values())


def test_zone_spread_world_per_pod_route():
    per_pod_route(*run_dynamic(dynamic_spec(11, 60, spread=0.5, anti=0.2, skew=2)))


def test_hostname_spread_world_per_pod_route():
    per_pod_route(*run_dynamic(dynamic_spec(12, 60, spread=0.6, spread_key=HOST, min_domains=2)))


def test_spread_with_a_cluster_context():
    """The static counts come from existing nodes: zone-a already holds two
    matching pods, zone-d none."""
    specs = dynamic_spec(13, 60, spread=0.7, apps=2, min_domains=3)
    per_pod_route(*run_dynamic(specs, cluster=True))


def test_legacy_volume_conflicts_per_pod_route():
    """Pending sharers of one RW disk: synthetic hostname conflict terms
    keep them on separate nodes; conflict worlds never take the runs
    route."""
    specs = dynamic_spec(14, 40, volumes=0.3, replicated=False)
    tres = per_pod_route(*run_dynamic(specs))
    sharers = {s["name"] for s in specs if s["volume"]}
    for count, pods in tres.values():
        assert len([p for p in pods if p.name in sharers]) <= max(count, 0)


def test_replicated_world_runs_affinity_route():
    """Replicas of 7 deployments, one with hostname anti-affinity: dedup
    still halves the runs, so neither K3 nor the torch loop serves."""
    specs = dynamic_spec(15, 140, replicated=True, apps=7)
    pods = make_dynamic_pods(TORCH, specs)
    groups = tes.build_pod_groups(pods)
    assert len(groups) * 2 <= len(pods)
    results, routed = run_dynamic(specs)
    assert routed == {k: 0 for k in tes.ROUTES}
    assert_same(results)


def test_replicated_world_with_spread_runs_affinity_route():
    specs = dynamic_spec(16, 140, replicated=True, apps=7, spread=1.0, spread_key=HOST)
    results, routed = run_dynamic(specs)
    assert routed == {k: 0 for k in tes.ROUTES}
    assert_same(results)


def test_more_than_32_spread_terms_take_the_torch_loop():
    """More than 32 apps with distinct spread terms: S buckets to 64,
    wider than K3's bitset, so the gate sends the estimate to the torch
    loop."""
    specs = dynamic_spec(17, 100, spread=1.0, apps=50, skew=2)
    assert len({s["app"] for s in specs}) > 32
    per_pod_route(*run_dynamic(specs), route="affinity_loop")


def test_headrooms_cap_dynamic_groups():
    specs = dynamic_spec(18, 60, anti=0.5)
    tres = per_pod_route(*run_dynamic(specs, headrooms={"ng-0": 1, "ng-2": 2}))
    assert tres["ng-0"][0] <= 1 and tres["ng-2"][0] <= 2


def test_kernel_route_gate(monkeypatch):
    """The gate reads K3's shared memory from the kernel library on a card
    (stubbed here), and only the spread width on the CPU."""
    import torch

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    seen = []

    def smem(R, TP, S, max_nodes):
        seen.append((R, TP, S, max_nodes))
        return 4 * (R + 2 * TP + S) * max_nodes

    monkeypatch.setattr(ffd_scan_affinity, "affinity_smem_bytes", smem)
    assert tes.kernel_route(cuda, 6, 64, 32, 1024) == "ffd_scan_aff"
    assert seen == [(6, 2, 32, 1024)]
    assert tes.kernel_route(cuda, 6, 64, 32, 2048) == "affinity_loop"
    assert tes.kernel_route(cuda, 6, 4, 64, 16) == "affinity_loop"
    assert tes.kernel_route(cpu, 6, 64, 32, 2048) == "ffd_scan_aff"
    assert tes.kernel_route(cpu, 6, 4, 33, 16) == "affinity_loop"


def scan_smem(planes, max_nodes):
    """csrc/ffd_scan.cu's smem_bytes: the carry [NP, M], the block
    summaries [NP, ceil(M/32)], two staged request blocks [2, 32, NP], the
    guards [NP] and two rounds' hit slots [2, 8], in 4-byte words."""
    return 4 * (planes * max_nodes + planes * -(-max_nodes // 32) + 64 * planes + planes + 16)


@pytest.mark.parametrize("max_nodes,widest", [(1024, 51), (2048, 26), (4096, 13), (8192, 6)])
def test_scan_route_gate(monkeypatch, max_nodes, widest):
    """The plain route's gate reads K1/K2's shared memory from the kernel
    library on a card (the C formula here): the widest carry that fits a
    block launches the kernel, one plane more takes the torch loop. The
    CPU never asks, and runs the plain versions."""
    import torch

    seen = []

    def smem(planes, m):
        seen.append((planes, m))
        return scan_smem(planes, m)

    monkeypatch.setattr(ffd_scan, "smem_bytes", smem)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert scan_smem(widest, max_nodes) <= ffd_scan.SMEM_PER_BLOCK < scan_smem(widest + 1, max_nodes)
    assert tes.scan_route(cuda, widest, max_nodes) == "ffd_scan"
    assert tes.scan_route(cuda, widest + 1, max_nodes) == "binpack_loop"
    assert seen == [(widest, max_nodes), (widest + 1, max_nodes)]
    assert tes.scan_route(cpu, widest + 1, max_nodes) == "ffd_scan"
    assert len(seen) == 2


def test_plain_route_gate_counts_routes(monkeypatch):
    """A world with 7 f32 planes at a scan cap of 8192: on the CPU the gate
    keeps the plain versions ("ffd_scan"); where a card's gate refuses the
    kernel ("binpack_loop") the torch loop answers the same, and ROUTES
    counts each. No kernel launches on the CPU, and the loop route builds
    no request stream for the kernels."""
    pods, templates = port_world(ttu, 150, ports=4)
    est = tes.BinpackingNodeEstimator(tlim.ThresholdBasedEstimationLimiter(max_nodes=5000),
                                      device="cpu")
    req, _, _ = tes._build_group_arrays(pods, sorted(templates), templates, pad=256)
    assert req.shape[1] == 6 + 4
    launches = dict(ffd_scan.LAUNCHES)
    routes = dict(tes.ROUTES)
    on_kernel_route = est.estimate_many(pods, templates)
    assert {k: tes.ROUTES[k] - routes[k] for k in tes.ROUTES} == {
        k: int(k == "ffd_scan") for k in tes.ROUTES
    }
    decided = []

    def card_gate(device, planes, max_nodes):
        decided.append((planes, max_nodes))
        return "binpack_loop"

    def no_stream(*args, **kwargs):
        raise AssertionError("the loop route built the kernels' request stream")

    monkeypatch.setattr(tes, "scan_route", card_gate)
    monkeypatch.setattr(ffd_scan, "prepare_scan", no_stream)
    routes = dict(tes.ROUTES)
    on_loop = est.estimate_many(pods, templates)
    assert decided == [(7, 8192)]
    assert {k: tes.ROUTES[k] - routes[k] for k in tes.ROUTES} == {
        k: int(k == "binpack_loop") for k in tes.ROUTES
    }
    assert ffd_scan.LAUNCHES == launches
    assert any(n > 0 for n, _ in on_loop.values())
    for g in templates:
        assert on_loop[g][0] == on_kernel_route[g][0]
        assert [p.name for p in on_loop[g][1]] == [p.name for p in on_kernel_route[g][1]]


@pytest.mark.parametrize("cluster", [False, True])
def test_estimate_single_template_dynamic(cluster):
    """estimate() on a dynamic world runs the torch loop with one group."""
    specs = dynamic_spec(19, 50, anti=0.3, spread=0.4, apps=3)
    got = []
    for pkg in (JAX, TORCH):
        pods = make_dynamic_pods(pkg, specs)
        templates = zoned_templates(pkg, 19, 2)
        est = estimator(pkg, 16)
        got.append([
            (c, [p.name for p in sched])
            for c, sched in (
                est.estimate(pods, templates[g], max_size_headroom=h,
                             cluster=cluster_of(pkg) if cluster else None)
                for g, h in (("ng-0", 0), ("ng-1", 3))
            )
        ])
    assert got[0] == got[1]


def test_unported_expanders_raise():
    with pytest.raises(NotImplementedError):
        texp.build_strategy(["price"])
    with pytest.raises(ValueError):
        texp.build_strategy(["nope"])
