"""The port's BinpackingNodeEstimator (autoscaler_tpu_torch/estimator/
binpacking.py, on the CPU) and expander against the JAX package's, on the
same pods and templates: each package builds them with its own
build_test_pod/build_test_node from one numpy-seeded spec. Node counts,
scheduled pods and the expander's choice must be equal."""
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
from autoscaler_tpu_torch.ops import ffd_scan

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


def test_affinity_world_raises():
    pods = make_pods(TORCH, pod_spec(10, 20))
    pods[3] = dataclasses.replace(pods[3], affinity=tobj.Affinity(
        pod_anti_affinity=(tobj.PodAffinityTerm(
            selector=tobj.LabelSelector.from_dict({"app": "x"}),
            topology_key="kubernetes.io/hostname",
        ),)
    ))
    templates = make_templates(TORCH, template_spec(10, 2))
    est = estimator(TORCH, 16)
    with pytest.raises(NotImplementedError, match="affinity"):
        est.estimate_many(pods, templates)
    with pytest.raises(NotImplementedError, match="affinity"):
        est.estimate(pods, templates["ng-0"])


def test_hard_spread_world_raises():
    pods = make_pods(TORCH, pod_spec(11, 12))
    pods[0] = dataclasses.replace(pods[0], topology_spread=(tobj.TopologySpreadConstraint(
        max_skew=1, topology_key="zone", selector=tobj.LabelSelector.from_dict({"a": "b"}),
    ),))
    with pytest.raises(NotImplementedError):
        estimator(TORCH, 16).estimate_many(pods, make_templates(TORCH, template_spec(11, 2)))


def test_unported_expanders_raise():
    with pytest.raises(NotImplementedError):
        texp.build_strategy(["price"])
    with pytest.raises(ValueError):
        texp.build_strategy(["nope"])
