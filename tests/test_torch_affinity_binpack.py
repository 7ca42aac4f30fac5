"""The port's torch loops for the dynamic scans (autoscaler_tpu_torch/ops/
binpack.py: ``ffd_binpack_groups_affinity`` and
``ffd_binpack_groups_runs_affinity``) against the JAX package's XLA scans
of the same names, on the CPU, bit for bit. The worlds are those of
tests/test_affinity_binpack.py and tests/test_spread_binpack.py: hostname
anti-affinity, zone affinity with self-seeding, group-level terms on
label-less templates, hard spread with and without affinity, and the
runs route on a mixed world."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autoscaler_tpu.estimator.binpacking as jest
import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.snapshot.affinity as jaff
import autoscaler_tpu.utils.test_utils as jtu
from autoscaler_tpu.ops import binpack as jbp
from autoscaler_tpu_torch.ops import binpack as tbp
from torch_parity import CPU, MEMORY, PODS, assert_results_equal, hostname_skew_pods, rand_world

P = 40
M = 16
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
SPREAD_TYPES = (
    torch.bool, torch.bool, torch.bool, torch.int32, torch.int32, torch.bool,
    torch.int32, torch.int32, torch.int32, torch.int32, torch.bool,
)


def t(a, dtype=None):
    a = np.asarray(a)
    out = torch.tensor(a)
    return out if dtype is None else out.to(dtype)


def t_spread(spread):
    return None if spread is None else tuple(
        t(a, dt) for a, dt in zip(spread, SPREAD_TYPES)
    )


def j_spread(spread):
    return None if spread is None else tuple(jnp.asarray(a) for a in spread)


def loop_both(req, masks, allocs, max_nodes, match, aff, anti, nl, hl, caps=None, spread=None):
    ref = jbp.ffd_binpack_groups_affinity(
        jnp.asarray(req), jnp.asarray(masks), jnp.asarray(allocs), max_nodes=max_nodes,
        match=jnp.asarray(match), aff_of=jnp.asarray(aff), anti_of=jnp.asarray(anti),
        node_level=jnp.asarray(nl), has_label=jnp.asarray(hl),
        node_caps=None if caps is None else jnp.asarray(caps), spread=j_spread(spread),
    )
    out = tbp.ffd_binpack_groups_affinity(
        t(req), t(masks), t(allocs), max_nodes, t(match), t(aff), t(anti), t(nl), t(hl),
        node_caps=None if caps is None else t(caps), spread=t_spread(spread),
    )
    assert_results_equal(ref, out)
    return out


def simple_workload(n, cpu=1000, cap_cpu=4000, G=1):
    """n identical pods (the rest of the P rows masked off)."""
    req = np.zeros((P, 6), np.float32)
    req[:, CPU] = cpu
    req[:, MEMORY] = 1024
    req[:, PODS] = 1
    allocs = np.zeros((G, 6), np.float32)
    allocs[:, CPU] = cap_cpu
    allocs[:, MEMORY] = 8192
    allocs[:, PODS] = 110
    masks = np.zeros((G, P), bool)
    masks[:, :n] = True
    return req, masks, allocs


@pytest.mark.parametrize("seed", range(4))
def test_random_worlds(seed):
    w = rand_world(seed, P=P, max_nodes=M)
    loop_both(*w[:3], M, *w[3:])


def test_hostname_anti_affinity_one_pod_a_node():
    req, masks, allocs = simple_workload(6)
    one = np.ones((1, P), bool)
    out = loop_both(req, masks, allocs, M, one, ~one, one, np.array([True]), np.ones((1, 1), bool))
    assert int(out.node_count[0]) == 6


def test_symmetric_rule_blocks_non_declaring_pods():
    """Pods that only MATCH a placed pod's anti term stay off its node."""
    req, masks, allocs = simple_workload(5)
    match = np.ones((1, P), bool)
    anti = np.zeros((1, P), bool)
    anti[0, 0] = True
    loop_both(req, masks, allocs, M, match, ~match, anti, np.array([True]), np.ones((1, 1), bool))


def test_zone_affinity_with_self_seeding():
    req, masks, allocs = simple_workload(10, cap_cpu=4000, G=2)
    match = np.ones((1, P), bool)
    out = loop_both(req, masks, allocs, M, match, match, ~match, np.array([False]),
                    np.ones((2, 1), bool))
    assert out.scheduled[:, :10].all()


def test_group_level_terms_on_label_less_templates():
    w = list(rand_world(3, P=P, max_nodes=M))
    w[7] = np.zeros_like(w[7])
    loop_both(*w[:3], M, *w[3:])


# -- hard topology spread -----------------------------------------------------


def web_pods(constraint, every=1, cpu=100):
    pods = []
    for i in range(P):
        p = jtu.build_test_pod(f"p{i}", cpu_m=cpu, labels={"app": "web"})
        if i % every == 0:
            p.topology_spread = (constraint,)
        pods.append(p)
    return pods


def zone_templates(G):
    out = []
    for g in range(G):
        node = jtu.build_test_node(f"t{g}", cpu_m=4000)
        node.labels[ZONE] = f"zone-{g % 3}"
        out.append(node)
    return out


def spread_args(pods, templates, cluster=None, pods_capacity=110, T=3, rng=None):
    G = len(templates)
    req = np.zeros((P, 6), np.float32)
    req[:, CPU] = [p.requests.cpu_m for p in pods]
    req[:, PODS] = 1.0
    allocs = np.zeros((G, 6), np.float32)
    allocs[:, CPU] = 4000.0
    allocs[:, PODS] = pods_capacity
    if rng is None:
        match = aff = anti = np.zeros((T, P), bool)
        nl, hl = np.zeros(T, bool), np.zeros((G, T), bool)
    else:
        match = rng.random((T, P)) < 0.4
        aff = (rng.random((T, P)) < 0.2) & match
        anti = (rng.random((T, P)) < 0.2) & ~aff
        nl, hl = rng.random(T) < 0.5, np.ones((G, T), bool)
    sp = jaff.build_spread_terms(pods, templates, pad_pods=P, bucket_terms=True, cluster=cluster)
    spread = tuple(np.asarray(a) for a in jest._spread_tuple(sp))
    return (req, np.ones((G, P), bool), allocs, M, match, aff, anti, nl, hl,
            np.full(G, M, np.int32), spread)


def constraint(key=ZONE, skew=1, min_domains=None):
    return jobj.TopologySpreadConstraint(
        max_skew=skew, topology_key=key,
        selector=jobj.LabelSelector.from_dict({"app": "web"}), min_domains=min_domains,
    )


def other_zone_cluster():
    other = jtu.build_test_node("existing-other", cpu_m=4000)
    other.labels[ZONE] = "zone-other"
    return ([other], [], [])


def test_zone_spread_with_empty_other_domain():
    out = loop_both(*spread_args(web_pods(constraint(), every=2), zone_templates(4),
                                 other_zone_cluster()))
    assert not bool(out.scheduled.all())


def test_hostname_spread():
    loop_both(*spread_args(web_pods(constraint(HOST)), zone_templates(2), pods_capacity=3))


def test_hostname_spread_redirects_off_fuller_nodes():
    out = loop_both(*spread_args(hostname_skew_pods(jtu, jobj), zone_templates(2)))
    used = out.node_used[0, :4, CPU].tolist()
    assert max(used) - min(used) <= 100


def test_spread_with_affinity():
    loop_both(*spread_args(web_pods(constraint(), every=2), zone_templates(2),
                           other_zone_cluster(), rng=np.random.default_rng(5)))


def test_min_domains_fold():
    out = loop_both(*spread_args(web_pods(constraint(min_domains=3)), zone_templates(2)))
    assert int(out.scheduled.sum()) == 2


# -- the runs route -----------------------------------------------------------


def runs_world(seed, U_plain=6, n_aff=4, G=3, T=3):
    """tests/test_affinity_binpack.py's mixed world: U_plain plain runs
    (distinct scores, counts 1..9) plus n_aff involved singleton runs with
    random terms."""
    rng = np.random.default_rng(seed)
    U = U_plain + n_aff
    run_req = np.zeros((U, 6), np.float32)
    run_req[:, CPU] = rng.choice(np.arange(100, 3100, 100), U, replace=False)
    run_req[:, MEMORY] = rng.integers(64, 4096, U)
    run_req[:, PODS] = 1
    run_counts = np.ones(U, np.int32)
    run_counts[:U_plain] = rng.integers(1, 10, U_plain)
    match = np.zeros((T, U), bool)
    aff = np.zeros((T, U), bool)
    anti = np.zeros((T, U), bool)
    match[:, U_plain:] = rng.random((T, n_aff)) < 0.5
    aff[:, U_plain:] = rng.random((T, n_aff)) < 0.3
    anti[:, U_plain:] = (rng.random((T, n_aff)) < 0.3) & ~aff[:, U_plain:]
    involved = (match | aff | anti).any(axis=0)
    nl = rng.random(T) < 0.5
    hl = rng.random((G, T)) < 0.8
    allocs = np.zeros((G, 6), np.float32)
    allocs[:, CPU] = rng.integers(4000, 12000, G)
    allocs[:, MEMORY] = rng.integers(8192, 16384, G)
    allocs[:, PODS] = 32
    run_masks = rng.random((G, U)) > 0.1
    caps = rng.integers(3, 16, G).astype(np.int32)
    return run_req, run_counts, run_masks, allocs, involved, match, aff, anti, nl, hl, caps


def runs_both(run_req, run_counts, run_masks, allocs, involved, match, aff, anti, nl, hl,
              caps, spread=None):
    ref = jbp.ffd_binpack_groups_runs_affinity(
        jnp.asarray(run_req), jnp.asarray(run_counts), jnp.asarray(run_masks),
        jnp.asarray(allocs), max_nodes=M, involved=jnp.asarray(involved),
        match=jnp.asarray(match), aff_of=jnp.asarray(aff), anti_of=jnp.asarray(anti),
        node_level=jnp.asarray(nl), has_label=jnp.asarray(hl),
        node_caps=jnp.asarray(caps), spread=j_spread(spread),
    )
    out = tbp.ffd_binpack_groups_runs_affinity(
        t(run_req), t(run_counts), t(run_masks), t(allocs), M, t(involved),
        t(match), t(aff), t(anti), t(nl), t(hl), node_caps=t(caps), spread=t_spread(spread),
    )
    assert_results_equal(ref, out)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_runs_mixed_world(seed):
    runs_both(*runs_world(seed))


def test_runs_with_spread():
    """Spread-constrained runs are singletons and involved; the plain runs
    fill around them."""
    w = list(runs_world(7))
    U, G = len(w[0]), len(w[3])
    S = 4
    involved = w[4]
    sp_of = np.zeros((U, S), bool)
    sp_of[involved, 0] = True
    sp_match = sp_of.copy()
    spread = (
        sp_of, sp_match, np.array([True, False, False, False]), np.ones(S, np.int32),
        np.ones(S, np.int32), np.ones((G, S), bool), np.zeros((G, S), np.int32),
        np.full((G, S), 2**30, np.int32), np.full((G, S), 2**30, np.int32),
        np.zeros((G, S), np.int32), np.zeros((G, S), bool),
    )
    runs_both(*w, spread=spread)
