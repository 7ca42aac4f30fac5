"""The port's term and spread factorizations (autoscaler_tpu_torch/snapshot/
affinity.py) and the hard topology-spread rows of its mask engine
(snapshot/packer.py) against the JAX package's, on the same worlds: each
package builds its own objects from one numpy-seeded generator, and every
output field must be equal."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.snapshot.affinity as jaff
import autoscaler_tpu.snapshot.packer as jpack
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.snapshot.affinity as taff
import autoscaler_tpu_torch.snapshot.packer as tpack
import autoscaler_tpu_torch.utils.test_utils as ttu
from torch_parity import canon

JAX = SimpleNamespace(obj=jobj, tu=jtu, aff=jaff, pack=jpack)
TORCH = SimpleNamespace(obj=tobj, tu=ttu, aff=taff, pack=tpack)
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def affinity_world(pkg, seed, n=30, G=3):
    """Pods of three apps in two namespaces with hostname and zone
    (anti-)affinity terms, some duplicated across pods, and legacy volumes
    shared by a few; templates with and without the zone label."""
    rng = np.random.default_rng(seed)
    o = pkg.obj
    pods = []
    for i in range(n):
        app = str(rng.choice(["web", "db", "cache"]))
        ns = str(rng.choice(["default", "team"]))
        p = pkg.tu.build_test_pod(f"p{i}", namespace=ns, labels={"app": app, "tier": str(i % 2)})
        r = rng.random()
        key = HOST if rng.random() < 0.5 else ZONE
        sel = o.LabelSelector.from_dict({"app": str(rng.choice(["web", "db"]))})
        if r < 0.3:
            p.affinity = o.Affinity(pod_anti_affinity=(o.PodAffinityTerm(sel, key),))
        elif r < 0.45:
            p.affinity = o.Affinity(pod_affinity=(o.PodAffinityTerm(sel, key),))
        elif r < 0.55:
            p.affinity = o.Affinity(
                pod_affinity=(o.PodAffinityTerm(sel, ZONE, namespaces=("team", "default")),),
                pod_anti_affinity=(o.PodAffinityTerm(
                    o.LabelSelector(match_expressions=(
                        o.LabelSelectorRequirement("tier", "In", ("0",)),
                    )), HOST),),
            )
        if rng.random() < 0.25:
            kind = str(rng.choice(["gce-pd", "aws-ebs", "rbd"]))
            p.legacy_volumes = (o.LegacyVolume(
                kind, "vol-1", read_only=bool(rng.random() < 0.4),
                monitors=("m1",) if kind == "rbd" else (),
            ),)
        pods.append(p)
    templates = []
    for g in range(G):
        node = pkg.tu.build_test_node(f"t{g}", cpu_m=4000)
        if g % 3:
            node.labels[ZONE] = f"zone-{g}"
        templates.append(node)
    return pods, templates


def spread_world(pkg, seed, n=24, with_cluster=False):
    """The knobs of tests/test_topology_spread.py's random worlds:
    minDomains, node inclusion policies, matchLabelKeys, hostname and zone
    keys, terminating cluster pods."""
    rng = np.random.default_rng(seed)
    o = pkg.obj
    pods = []
    for i in range(n):
        app = str(rng.choice(["web", "db"]))
        p = pkg.tu.build_test_pod(f"p{i}", labels={"app": app, "rev": str(rng.choice(["v1", "v2"]))})
        if rng.random() < 0.3:
            p.node_selector = {"disk": "ssd"}
        if rng.random() < 0.3:
            p.tolerations = [o.Toleration(key="dedicated", value="x", effect="NoSchedule")]
        if rng.random() < 0.7:
            p.topology_spread = (o.TopologySpreadConstraint(
                max_skew=int(rng.integers(1, 3)),
                topology_key=str(rng.choice([ZONE, HOST])),
                selector=o.LabelSelector.from_dict({"app": app}),
                when_unsatisfiable=str(rng.choice(["DoNotSchedule", "DoNotSchedule", "ScheduleAnyway"])),
                min_domains=int(rng.integers(1, 5)) if rng.random() < 0.4 else None,
                node_affinity_policy=str(rng.choice(["Honor", "Ignore"])),
                node_taints_policy=str(rng.choice(["Honor", "Ignore"])),
                match_label_keys=("rev",) if rng.random() < 0.4 else (),
            ),)
        pods.append(p)
    templates = []
    for g in range(3):
        node = pkg.tu.build_test_node(f"t{g}", cpu_m=4000)
        if g < 2:
            node.labels[ZONE] = f"zone-{'ab'[g]}"
        templates.append(node)
    cluster = None
    if with_cluster:
        nodes, cl_pods, node_of = [], [], []
        for j in range(int(rng.integers(3, 7))):
            node = pkg.tu.build_test_node(f"e{j}", cpu_m=8000)
            if rng.random() < 0.85:
                node.labels[ZONE] = f"zone-{rng.choice(list('abc'))}"
            if rng.random() < 0.4:
                node.labels["disk"] = "ssd"
            if rng.random() < 0.25:
                node.taints.append(o.Taint("dedicated", "x", "NoSchedule"))
            nodes.append(node)
            for k in range(int(rng.integers(0, 4))):
                q = pkg.tu.build_test_pod(
                    f"q{j}-{k}", labels={"app": str(rng.choice(["web", "db"])), "rev": "v1"}
                )
                if rng.random() < 0.15:
                    q.deletion_ts = 1.0
                cl_pods.append(q)
                node_of.append(j)
        cluster = (nodes, cl_pods, node_of)
    return pods, templates, cluster


def fields(x):
    return {f.name: canon(getattr(x, f.name)) for f in dataclasses.fields(x)}


def test_profile_key():
    for seed in range(2):
        jp, _ = affinity_world(JAX, seed)
        tp, _ = affinity_world(TORCH, seed)
        assert [p.profile_key() for p in jp] == [p.profile_key() for p in tp]
        assert tp[0].profile_key() is tp[0].profile_key()  # memoized


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_build_affinity_terms(seed, bucket):
    out = []
    for pkg in (JAX, TORCH):
        pods, templates = affinity_world(pkg, seed)
        assert pkg.aff.has_interpod_affinity(pods)
        terms = pkg.aff.build_affinity_terms(
            pods, templates, pad_pods=32 if bucket else None, bucket_terms=bucket
        )
        out.append((fields(terms), terms.num_terms, canon(pkg.aff.volume_conflict_components(pods))))
    assert out[0] == out[1]


def test_volume_conflict_terms_reach_the_rows():
    pods, templates = affinity_world(TORCH, 3, n=40)
    comps = taff.volume_conflict_components(pods)
    assert comps, "the world has no conflict component"
    terms = taff.build_affinity_terms(pods, templates, volume_components=comps)
    assert terms.node_level[-len(comps):].all()
    assert terms.has_label[:, -len(comps):].all()
    # an explicitly empty component list adds no synthetic terms
    assert taff.build_affinity_terms(pods, templates, volume_components=()).num_terms == (
        terms.num_terms - len(comps)
    )


@pytest.mark.parametrize("with_cluster", [False, True])
@pytest.mark.parametrize("seed", range(5))
def test_build_spread_terms(seed, with_cluster):
    out = []
    for pkg in (JAX, TORCH):
        pods, templates, cluster = spread_world(pkg, seed, with_cluster=with_cluster)
        sp = pkg.aff.build_spread_terms(pods, templates, pad_pods=32, bucket_terms=True, cluster=cluster)
        plain = pkg.aff.build_spread_terms(pods, templates, cluster=cluster)
        out.append((fields(sp), fields(plain), pkg.aff.has_hard_spread(pods)))
    assert out[0] == out[1]


def test_spread_min_domains_and_match_label_keys_reach_the_tensors():
    pods, templates, cluster = spread_world(TORCH, 1, n=40, with_cluster=True)
    sp = taff.build_spread_terms(pods, templates, cluster=cluster)
    assert (sp.min_domains > 1).any() and sp.static_count.any()
    keyed = [p for p in pods if any(c.match_label_keys for c in p.topology_spread)]
    sel = taff._spread_effective_selector(keyed[0].topology_spread[0], keyed[0])
    assert ("rev", keyed[0].labels["rev"]) in sel.match_labels


def mask_world(pkg, seed):
    """tests/test_topology_spread.py's random worlds with all knobs: placed
    and pending pods over labelled, tainted nodes."""
    rng = np.random.default_rng(1000 + seed)
    o = pkg.obj
    zones = [f"zone-{z}" for z in "abcd"[: rng.integers(2, 5)]]
    nodes = []
    for j in range(int(rng.integers(4, 10))):
        n = pkg.tu.build_test_node(f"n{j}", cpu_m=100_000)
        if rng.random() < 0.85:
            n.labels[ZONE] = str(rng.choice(zones))
        if rng.random() < 0.3:
            n.labels["disk"] = str(rng.choice(["ssd", "hdd"]))
        if rng.random() < 0.25:
            n.taints.append(o.Taint("dedicated", "x", "NoSchedule"))
        nodes.append(n)
    pods, node_of = [], []
    for i in range(int(rng.integers(8, 20))):
        app = str(rng.choice(["web", "db"]))
        p = pkg.tu.build_test_pod(f"p{i}", cpu_m=10, labels={"app": app, "rev": str(rng.choice(["v1", "v2"]))})
        if rng.random() < 0.3:
            p.node_selector = {"disk": "ssd"}
        if rng.random() < 0.2:
            p.deletion_ts = 1.0
        if rng.random() < 0.6:
            p.topology_spread = (o.TopologySpreadConstraint(
                max_skew=int(rng.integers(1, 3)),
                topology_key=str(rng.choice([ZONE, HOST])),
                selector=o.LabelSelector.from_dict({"app": app}),
                min_domains=int(rng.integers(1, 5)) if rng.random() < 0.5 else None,
                node_affinity_policy=str(rng.choice(["Honor", "Ignore"])),
                node_taints_policy=str(rng.choice(["Honor", "Ignore"])),
                match_label_keys=("rev",) if rng.random() < 0.5 else (),
            ),)
        if rng.random() < 0.2:
            p.affinity = o.Affinity(pod_anti_affinity=(
                o.PodAffinityTerm(o.LabelSelector.from_dict({"app": app}), HOST),
            ))
        pods.append(p)
        node_of.append(int(rng.integers(0, len(nodes))) if rng.random() < 0.6 else -1)
    return nodes, pods, node_of


@pytest.mark.parametrize("interpod", [True, False])
@pytest.mark.parametrize("seed", range(6))
def test_sched_mask_with_hard_spread_rows(seed, interpod):
    masks = []
    for pkg in (JAX, TORCH):
        nodes, pods, node_of = mask_world(pkg, seed)
        masks.append(pkg.pack.compute_sched_mask(nodes, pods, node_of, interpod=interpod))
    np.testing.assert_array_equal(masks[0], masks[1])


def test_spread_rows_apply_without_interpod():
    """The skew gate bites on a pending pod whatever ``interpod`` is."""
    nodes, pods, node_of = [], [], []
    for z, count in zip("abc", (1, 1, 0)):
        node = ttu.build_test_node(f"n-{z}", cpu_m=10_000)
        node.labels[ZONE] = f"zone-{z}"
        nodes.append(node)
        for k in range(count):
            pods.append(ttu.build_test_pod(f"placed-{z}-{k}", labels={"app": "web"}))
            node_of.append(len(nodes) - 1)
    new = ttu.build_test_pod("new", labels={"app": "web"})
    new.topology_spread = (tobj.TopologySpreadConstraint(
        max_skew=1, topology_key=ZONE, selector=tobj.LabelSelector.from_dict({"app": "web"}),
    ),)
    pods.append(new)
    node_of.append(-1)
    for interpod in (True, False):
        mask = tpack.compute_sched_mask(nodes, pods, node_of, interpod=interpod)
        assert mask[-1].tolist() == [False, False, True]
