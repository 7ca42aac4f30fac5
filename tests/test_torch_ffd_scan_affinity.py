"""The port's affinity scan entry ``ffd_binpack_groups_affinity_cuda``
(autoscaler_tpu_torch/ops/ffd_scan_affinity.py) on CPU tensors, its glue
plus the plain version of the kernel K3, against the JAX package's
``ffd_binpack_groups_affinity_pallas`` run in interpret mode, bit for bit:
the worlds of tests/test_pallas_affinity.py.

Interpret mode compiles the Pallas kernel once for each shape, and that
compile is nearly all of these tests' time, so the reference sees one
shape: 40 pods in 16-pod chunks (two of the port's 32-step blocks), at
most 8 groups, a 16-node carry, 6 resource axes, two term planes and four
spread terms. A world with fewer terms reaches the reference padded with
inert ones (all-False rows: they never gate, seed or count, as the JAX
package's ``bucket_terms`` padding relies on), and the port runs both the
world as it is (one term plane, no spread) and the padded world, so each
of its paths is held to the same reference. The world with 32 spread
terms, whose interpret-mode compile alone takes most of a minute, runs
against the XLA scan twin."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autoscaler_tpu.estimator.binpacking as jest
import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.snapshot.affinity as jaff
import autoscaler_tpu.utils.test_utils as jtu
from autoscaler_tpu.ops import binpack as jbp
from autoscaler_tpu.ops import pallas_binpack_affinity as jpa
from autoscaler_tpu_torch.ops import ffd_scan_affinity as fa
from torch_parity import (
    AFF_SEARCH_WORLDS,
    CPU,
    PODS,
    aff_search_world,
    assert_bits_equal,
    assert_results_equal,
    hostname_skew_pods,
    key_max_f32,
    rand_world,
)

P = 40
M = 16
CHUNK = 16
T_REF = 33       # the reference's term axis: two planes
S_REF = 1        # and its spread axis
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def reference_terms(match, aff_of, anti_of, node_level, has_label, spread):
    """The same world at the reference's one shape: all-False term rows
    appended up to T_REF terms, and S_REF spread terms: the inert term that
    build_spread_terms gives a world that declares none, or the world's
    own terms with the inert bucket padding cut off."""
    T, G = match.shape[0], has_label.shape[0]
    extra = max(T_REF - T, 0)

    def rows(a):
        return np.concatenate([a, np.zeros((extra,) + a.shape[1:], bool)])

    if spread is None:
        spread = tuple(np.asarray(a) for a in jest._spread_tuple(
            jaff.build_spread_terms([], [None] * G, pad_pods=P)
        ))
    else:
        assert not (spread[0][:, S_REF:].any() or spread[1][:, S_REF:].any())
        spread = tuple(a[..., :S_REF] for a in spread)
    return (rows(match), rows(aff_of), rows(anti_of), rows(node_level),
            rows(has_label.T).T, spread)


def run_both(req, masks, allocs, max_nodes, match, aff_of, anti_of, node_level,
             has_label, caps=None, spread=None, reference="pallas"):
    """JAX's Pallas twin in interpret mode on the world at its one shape
    (or, with reference="xla", its XLA scan twin, which the JAX package's
    own tests hold equal to it, on the world as it is), and the port on CPU
    tensors on the world as it is and at the reference's shape; every
    result must be equal bit for bit."""
    worlds = [(match, aff_of, anti_of, node_level, has_label, spread)]
    if reference == "pallas":
        padded = reference_terms(*worlds[0])
        pm, pa, px, pnl, phl, psp = padded
        ref = jpa.ffd_binpack_groups_affinity_pallas(
            req, masks, allocs, max_nodes=max_nodes, match=pm, aff_of=pa,
            anti_of=px, node_level=pnl, has_label=phl, node_caps=caps,
            spread=psp, interpret=True, chunk=CHUNK,
        )
        worlds.append(padded)
    else:
        j = jnp.asarray
        ref = jbp.ffd_binpack_groups_affinity(
            j(req), j(masks), j(allocs), max_nodes=max_nodes, match=j(match),
            aff_of=j(aff_of), anti_of=j(anti_of), node_level=j(node_level),
            has_label=j(has_label), node_caps=None if caps is None else j(caps),
            spread=None if spread is None else tuple(j(a) for a in spread),
        )
    for m, a, x, nl, hl, sp in worlds:
        ops = fa.affinity_operands_from_numpy(
            req, masks, allocs, m, a, x, nl, hl, caps, sp, device="cpu",
        )
        before = dict(fa.LAUNCHES)
        out = fa.ffd_binpack_groups_affinity_cuda(**ops, max_nodes=max_nodes)
        assert fa.LAUNCHES == before  # CPU tensors never launch a kernel
        assert_results_equal(ref, out)
    return out


def world(seed, T=5):
    w = rand_world(seed, P=P, T=T, max_nodes=M)
    return w[:3] + (M,) + w[3:]


# -- the glue -----------------------------------------------------------------


@pytest.mark.parametrize("T", [5, 32, 33, 37])
def test_pack_term_bits_layout(T):
    """Term t is bit t % 32 of plane t // 32, term 31 the sign bit, as the
    JAX package packs through uint32 and bitcasts."""
    rng = np.random.default_rng(T)
    rows = rng.random((T, 11)) < 0.5
    rows[T - 1] = True
    TP = (T + 31) // 32
    out = fa._pack_term_bits(torch.tensor(rows), TP)
    assert out.dtype == torch.int32
    assert_bits_equal(np.asarray(jpa._pack_term_bits(jnp.asarray(rows), TP)), out)
    planes = out.numpy().view(np.uint32)
    for t in range(T):
        np.testing.assert_array_equal((planes[t // 32] >> (t % 32)) & 1, rows[t])
    if T >= 32:
        assert (out[0] < 0).tolist() == rows[31].tolist()


def test_operands_are_copies_of_the_contract_dtypes():
    req, masks, allocs, _, match, aff, anti, nl, hl, caps = world(0)
    sp = tuple(np.array(a) for a in jest._spread_tuple(spread_terms(*hostname_world())))
    ops = fa.affinity_operands_from_numpy(
        req, masks, allocs, match, aff, anti, nl, hl, caps, sp, device="cpu"
    )
    want = {
        "pod_req": torch.float32, "pod_masks": torch.bool, "template_allocs": torch.float32,
        "match": torch.bool, "aff_of": torch.bool, "anti_of": torch.bool,
        "node_level": torch.bool, "has_label": torch.bool, "node_caps": torch.int32,
    }
    for name, dtype in want.items():
        assert ops[name].dtype == dtype, name
    assert [t.dtype for t in ops["spread"]] == [
        torch.bool, torch.bool, torch.bool, torch.int32, torch.int32, torch.bool,
        torch.int32, torch.int32, torch.int32, torch.int32, torch.bool,
    ]
    req[0, CPU] += 1.0
    masks[0, 0] = not masks[0, 0]
    sp[6][0, 0] += 1
    assert float(ops["pod_req"][0, CPU]) == req[0, CPU] - 1.0
    assert bool(ops["pod_masks"][0, 0]) != masks[0, 0]
    assert int(ops["spread"][6][0, 0]) == sp[6][0, 0] - 1


def test_more_than_32_spread_terms_raise():
    req, masks, allocs, _, match, aff, anti, nl, hl, caps = world(1)
    G = masks.shape[0]
    S = 33
    spread = (
        np.zeros((P, S), bool), np.zeros((P, S), bool), np.zeros(S, bool),
        np.ones(S, np.int32), np.ones(S, np.int32), np.ones((G, S), bool),
        np.zeros((G, S), np.int32), np.zeros((G, S), np.int32),
        np.zeros((G, S), np.int32), np.zeros((G, S), np.int32), np.zeros((G, S), bool),
    )
    ops = fa.affinity_operands_from_numpy(
        req, masks, allocs, match, aff, anti, nl, hl, caps, spread, device="cpu"
    )
    with pytest.raises(ValueError, match="at most 32"):
        fa.ffd_binpack_groups_affinity_cuda(**ops, max_nodes=M)


def test_empty_inputs():
    ops = fa.affinity_operands_from_numpy(
        np.zeros((0, 6), np.float32), np.zeros((2, 0), bool), np.ones((2, 6), np.float32),
        np.zeros((3, 0), bool), np.zeros((3, 0), bool), np.zeros((3, 0), bool),
        np.zeros(3, bool), np.ones((2, 3), bool), device="cpu",
    )
    out = fa.ffd_binpack_groups_affinity_cuda(**ops, max_nodes=M)
    assert out.node_count.tolist() == [0, 0]
    assert tuple(out.node_used.shape) == (2, M, 6)


def test_work_count_of_plain_scan():
    """The plain version counts the work the data needs: node fit tests
    up to the first hit (or every open node plus one closed node), and a
    term-gate test for each tested open node that fits, a term plane with
    a bit set apiece; none for a pod that carries no term bit. And the
    kernel's search: one block, one summary test, one round a step."""
    req, masks, allocs = _uniform_world(4, cpu=100, cap_cpu=1000)
    match = np.zeros((1, P), bool)
    match[0, :3] = True                 # pods 0-2: hostname anti on themselves
    ops = fa.prepare_scan_aff(
        *(torch.tensor(a) for a in (req, masks, allocs)), M,
        torch.tensor(match), torch.zeros((1, P), dtype=torch.bool), torch.tensor(match),
        torch.tensor([True]), torch.ones((1, 1), dtype=torch.bool),
    )
    stats = {}
    free, opened, placed = fa._scan_plain_aff(
        ops.stream, ops.bits, ops.allocs, ops.caps, ops.nl, ops.hl, ops.spstat,
        ops.num_planes, ops.num_spread, M, stats=stats,
    )
    assert int(opened[0]) == 3 and int(placed.sum()) == 4
    # pods 0-2 test 1, 2 and 3 nodes (open nodes fit but fail the anti
    # gate: 0, 1 and 2 gate tests); pod 3 fits node 0 (1 test, no gate)
    search = {"summary_tests": 4, "candidate_blocks": 4, "rounds": 4, "placements": 4}
    assert stats == {"node_tests": 7, "gate_plane_tests": 3,
                     "host_gate_tests": 0, "open_min_nodes": 0, **search,
                     **{f"max_group_{k}": n for k, n in search.items() if k != "summary_tests"}}


# -- affinity worlds ----------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_random_worlds(seed):
    run_both(*world(seed))


@pytest.mark.parametrize("T", [32, 33, 40])
def test_term_plane_boundaries(T):
    """T = 32 fills one plane (term 31 is its sign bit); 33 and 40 spill
    into a second plane."""
    w = list(world(11, T=T))
    w[5][31] |= w[4][31]        # term 31 is held and matched by many pods
    w[6][31] = True
    run_both(*w)


def _uniform_world(n_real, cpu=500, cap_cpu=4000, G=1):
    """n_real identical pods (the rest of the P rows masked off) and G
    templates with room for 8 of them."""
    req = np.zeros((P, 6), np.float32)
    req[:, CPU] = cpu
    req[:, PODS] = 1
    allocs = np.zeros((G, 6), np.float32)
    allocs[:, CPU] = cap_cpu
    allocs[:, PODS] = 110
    masks = np.zeros((G, P), bool)
    masks[:, :n_real] = True
    return req, masks, allocs


def test_anti_affinity_one_per_node():
    req, masks, allocs = _uniform_world(4)
    one = np.ones((1, P), bool)
    out = run_both(req, masks, allocs, M, one, ~one, one, np.array([True]),
                   np.ones((1, 1), bool))
    assert int(out.node_count[0]) == 4


def test_affinity_colocation_with_self_seeding():
    req, masks, allocs = _uniform_world(3)
    one = np.ones((1, P), bool)
    out = run_both(req, masks, allocs, M, one, one, ~one, np.array([True]),
                   np.ones((1, 1), bool))
    assert int(out.node_count[0]) == 1 and bool(out.scheduled[0, :3].all())


def test_group_level_terms_on_label_less_templates():
    w = list(world(3))
    w[8] = np.zeros_like(w[8])  # no template carries a topology label
    run_both(*w)


def test_masked_pods_carry_unmasked_bits():
    """A masked pod's term bits ride the stream (only its requests are
    +inf); it never places, so it never changes the term state."""
    w = list(world(4))
    w[1][:, ::3] = False
    w[4][:, ::3] = True         # the masked pods match and hold every term
    w[6][:, ::3] = True
    run_both(*w)


def test_zero_terms_equal_the_plain_ffd():
    req, masks, allocs = world(9)[:3]
    G = masks.shape[0]
    z = np.zeros((0, P), bool)
    out = run_both(req, masks, allocs, M, z, z, z, np.zeros(0, bool), np.zeros((G, 0), bool))
    plain = jbp.ffd_binpack_groups(
        jnp.asarray(req), jnp.asarray(masks), jnp.asarray(allocs), max_nodes=M
    )
    assert_results_equal(plain, out)


def test_inf_alloc_clamps():
    """An unlimited CSI-attach plane (+inf alloc) keeps node_used finite
    and exact."""
    w = list(world(23))
    w[2] = w[2].copy()
    w[2][:, 4] = np.inf
    w[0] = w[0].copy()
    w[0][:, 4] = 1.0
    out = run_both(*w)
    assert bool(torch.isfinite(out.node_used).all())


def test_multi_chunk_carry():
    """Terms and capacity carry across the JAX kernel's 16-pod chunks and
    the port's 32-step blocks."""
    run_both(*world(17, T=40))


# -- hard topology spread -----------------------------------------------------


def spread_terms(pods, templates, cluster=None):
    return jaff.build_spread_terms(
        pods, templates, pad_pods=P, bucket_terms=True, cluster=cluster
    )


def web_pods(constraint, every=1, n=P, cpu=100):
    pods = []
    for i in range(n):
        p = jtu.build_test_pod(f"p{i}", cpu_m=cpu, labels={"app": "web"})
        if i % every == 0:
            p.topology_spread = (constraint,)
        pods.append(p)
    return pods


def zone_templates(G):
    out = []
    for g in range(G):
        t = jtu.build_test_node(f"t{g}", cpu_m=4000)
        t.labels[ZONE] = f"zone-{g % 3}"
        out.append(t)
    return out


def hostname_world():
    """40 web pods with a hostname constraint (maxSkew 1) on 2 templates
    of pods-capacity 3: several nodes open, and the minimum over the open
    nodes' counts redirects placements."""
    c = jobj.TopologySpreadConstraint(
        max_skew=1, topology_key=HOST, selector=jobj.LabelSelector.from_dict({"app": "web"}),
    )
    return web_pods(c), zone_templates(2)


def spread_kernel_args(pods, templates, cluster=None, pods_capacity=110, T=4, rng=None):
    """Kernel operands for an object-built spread world: requests from the
    pods, the spread tuple from the JAX package's build_spread_terms, and (with ``rng``) random
    affinity terms beside it."""
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
    spread = tuple(np.asarray(a) for a in jest._spread_tuple(spread_terms(pods, templates, cluster)))
    return (req, np.ones((G, P), bool), allocs, M, match, aff, anti, nl, hl,
            np.full(G, M, np.int32), spread)


def zone_world_with_empty_other_domain(G=4):
    """Every other pod carries a zone constraint (maxSkew 1) and the
    cluster holds an EMPTY zone-other domain, so each group's wave budget
    is maxSkew + 0 and the gate bites."""
    c = jobj.TopologySpreadConstraint(
        max_skew=1, topology_key=ZONE, selector=jobj.LabelSelector.from_dict({"app": "web"}),
    )
    other = jtu.build_test_node("existing-other", cpu_m=4000)
    other.labels[ZONE] = "zone-other"
    return web_pods(c, every=2), zone_templates(G), ([other], [], [])


def test_zone_spread_world():
    out = run_both(*spread_kernel_args(*zone_world_with_empty_other_domain()))
    assert not bool(out.scheduled.all())


def test_hostname_spread_world():
    out = run_both(*spread_kernel_args(*hostname_world(), pods_capacity=3))
    assert int(out.node_count[0]) == 14  # 40 pods, 3 a node, spread-balanced


def test_hostname_spread_redirects_off_fuller_nodes():
    """The hostname gate binds: first fit would put every small pod on
    node 0, the skew gate spreads them over the open nodes."""
    out = run_both(*spread_kernel_args(hostname_skew_pods(jtu, jobj), zone_templates(2)))
    used = out.node_used[0, :4, CPU].tolist()
    assert out.node_count.tolist() == [4, 4] and max(used) - min(used) <= 100


def test_spread_with_affinity():
    pods, templates, cluster = zone_world_with_empty_other_domain(G=2)
    run_both(*spread_kernel_args(pods, templates, cluster, rng=np.random.default_rng(5)))


def test_min_domains_fold():
    """minDomains 3 over single-zone groups: the effective minimum is 0,
    so only maxSkew pods place a group. The Pallas form folds force_zero
    into min_others_eff = 0."""
    c = jobj.TopologySpreadConstraint(
        max_skew=1, topology_key=ZONE, selector=jobj.LabelSelector.from_dict({"app": "web"}),
        min_domains=3,
    )
    out = run_both(*spread_kernel_args(web_pods(c), zone_templates(2)))
    assert out.node_count.tolist() == [1, 1]
    assert int(out.scheduled.sum()) == 2


def test_32_spread_terms():
    """S = 32 fills the spread bitset: term 31 is its sign bit. Pods of
    32 apps, zone and hostname constraints of several skews."""
    rng = np.random.default_rng(32)
    pods = []
    for i in range(P):
        app = i % 32
        p = jtu.build_test_pod(f"p{i}", cpu_m=int(rng.integers(100, 1500)),
                               labels={"app": f"a{app}"})
        p.topology_spread = (jobj.TopologySpreadConstraint(
            max_skew=1 + app % 2, topology_key=HOST if app % 3 == 0 else ZONE,
            selector=jobj.LabelSelector.from_dict({"app": f"a{app}"}),
        ),)
        pods.append(p)
    args = spread_kernel_args(pods, zone_templates(3), pods_capacity=4)
    assert args[-1][0].shape == (P, 32) and args[-1][0][:, 31].any()
    run_both(*args, reference="xla")


# -- a step-level model of K3's search ----------------------------------------
#
# K3 searches each step as K1/K2 do: the blocks 0..lim/32 (lim = min(opened,
# min(cap, M) - 1)) are tested against their capacity summaries (the max
# free capacity of the block's nodes below the cap, per resource) in passes
# of 32, and the blocks that pass are searched in rounds of GROUP_WARPS ×
# WARP_BLOCKS in node order, the round's hit being the lowest of its
# blocks' hits; a node passes if it fits and passes the gates. Masked
# steps, and steps that a group-level spread term blocks, search nothing.
# The model below runs that search in numpy, checks its `first` against the
# lowest node 0..lim that passes at every step, and counts the work the way
# `_scan_plain_aff`'s stats do.

NO_NODE = 2**31 - 1


def model_scan_aff(stream, bits, allocs, caps, nl, hl, spstat, TP, S, M,
                   W=fa.GROUP_WARPS * fa.WARP_BLOCKS):
    """K3's search on numpy operands → (free [G, R, M], opened [G], placed
    [G, P_pad], counts, the counts of each group), searching ``W``
    candidate blocks a round. Besides the plain
    version's search counts, ``counts`` holds ``blocked_steps`` (steps a
    group-level term blocked) and ``gated_blocks`` (searched blocks where
    some node fits on capacity and none passes the gates). Raises
    AssertionError on any step whose search misses the lowest passing
    node."""
    G, P_pad, R = stream.shape
    NB = -(-M // 32)
    u32 = np.uint32
    nl = nl.view(u32)
    keys = ("summary_tests", "candidate_blocks", "rounds", "placements",
            "blocked_steps", "gated_blocks")
    counts = dict.fromkeys(keys, 0)
    per_group = []
    free_out = np.empty((G, R, M), np.float32)
    opened_out = np.zeros(G, np.int32)
    placed = np.zeros((G, P_pad), bool)
    for g in range(G):
        mine = dict.fromkeys(keys, 0)
        free = np.repeat(allocs[g][:, None], M, axis=1)
        summ = np.repeat(allocs[g][:, None], NB, axis=1)
        pm = np.zeros((TP, M), u32)
        ha = np.zeros((TP, M), u32)
        pmt = np.zeros(TP, u32)
        hat = np.zeros(TP, u32)
        spc = np.zeros((S, M), np.int64)
        spct = np.zeros(S, np.int64)
        st = spstat[g].astype(np.int64) if S else None      # [8, S]
        h = hl[g].view(u32)
        span = min(M, max(int(caps[g]), 0))
        opened = 0
        for s in range(P_pad):
            req = stream[g, s]
            if np.isinf(req[0]):
                continue
            b = bits[g, s].view(u32)
            mp, ap, xp = b[:TP], b[TP:2 * TP], b[2 * TP:3 * TP]
            spof = int(b[3 * TP]) if S else 0
            spmt = int(b[3 * TP + 1]) if S else 0
            group_ok, minh = True, {}
            for i in range(S):
                if not spof >> i & 1:
                    continue
                self_i = spmt >> i & 1
                if st[0, i] == 0:
                    if st[1, i] != 0:
                        cnt = st[4, i] + spct[i]
                        if cnt + self_i - min(st[5, i], cnt) > st[2, i]:
                            group_ok = False
                else:
                    v = spc[i, :opened].min() if opened else NO_NODE
                    minh[i] = 0 if st[3, i] > st[7, i] + opened else min(st[6, i], v)
            if not group_ok:
                mine["blocked_steps"] += 1
                continue
            seed = mp & ~pmt
            new_ok = not (
                (ap & ~((nl & seed) | (~nl & h & (pmt | seed))))
                | (xp & ~nl & pmt & h) | (mp & ~nl & hat & h)
            ).any()

            def fits(nodes):
                return (req[:, None] <= free[:, nodes]).all(axis=0)

            def gates(nodes):
                c = lambda v: v[:, None]  # noqa: E731
                dom_pm = (pm[:, nodes] & c(nl)) | c(pmt & ~nl)
                dom_ha = (ha[:, nodes] & c(nl)) | c(hat & ~nl)
                viol = ((c(ap) & (~c(h) | ~(dom_pm | c(seed))))
                        | (c(xp) & dom_pm & c(h)) | (c(mp) & dom_ha & c(h)))
                ok = (viol == 0).all(axis=0)
                for i, mh in minh.items():
                    ok &= ~(spc[i, nodes] + (spmt >> i & 1) - mh > st[2, i])
                return np.where(nodes < opened, ok, new_ok)

            lim = min(opened, span - 1)
            nblk = lim // 32 + 1 if lim >= 0 else 0
            mine["summary_tests"] += nblk
            first = NO_NODE
            for q0 in range(0, nblk, 32):
                blocks = np.arange(q0, min(q0 + 32, nblk))
                cand = list(blocks[(req[:, None] <= summ[:, blocks]).all(axis=0)])
                while cand and first == NO_NODE:
                    slots = []
                    for blk in cand[:W]:
                        nodes = np.minimum(blk * 32 + np.arange(32), lim)
                        live = blk * 32 + np.arange(32) <= lim
                        fit = live & fits(nodes)
                        ok = fit & gates(nodes)
                        mine["gated_blocks"] += int(fit.any() and not ok.any())
                        slots.append(blk * 32 + int(np.argmax(ok)) if ok.any() else NO_NODE)
                    mine["rounds"] += 1
                    mine["candidate_blocks"] += len(slots)
                    first = min(slots)
                    cand = cand[W:]
                if first != NO_NODE:
                    break
            every = np.arange(lim + 1)
            hits = np.nonzero(fits(every) & gates(every))[0]
            assert first == (int(hits[0]) if len(hits) else NO_NODE), (g, s, first)
            if first == NO_NODE:
                continue
            free[:, first] = free[:, first] - req
            pm[:, first] |= mp
            ha[:, first] |= xp
            pmt |= mp
            hat |= xp
            for i in range(S):
                if spmt >> i & 1 and st[1, i] != 0:
                    spc[i, first] += 1
                    spct[i] += 1
            opened = max(opened, first + 1)
            placed[g, s] = True
            mine["placements"] += 1
            nodes = first // 32 * 32 + np.arange(32)
            summ[:, first // 32] = key_max_f32(free[:, np.minimum(nodes, M - 1)],
                                               (nodes < span)[None, :])
        free_out[g], opened_out[g] = free, opened
        per_group.append(mine)
        for key in keys:
            counts[key] += mine[key]
    return free_out, opened_out, placed, counts, per_group


def _search_operands(name):
    (req, masks, allocs, match, aff, anti, nl, hl, caps, spread,
     M) = aff_search_world(name)
    ops = fa.affinity_operands_from_numpy(
        req, masks, allocs, match, aff, anti, nl, hl, caps, spread, device="cpu"
    )
    return fa.prepare_scan_aff(**ops, max_nodes=M)


def _plain_aff(ops, stats=None):
    return fa._scan_plain_aff(
        ops.stream, ops.bits, ops.allocs, ops.caps, ops.nl, ops.hl, ops.spstat,
        ops.num_planes, ops.num_spread, ops.max_nodes, stats=stats,
    )


def _model_aff(ops, **kw):
    spstat = None if ops.spstat is None else ops.spstat.numpy()
    return model_scan_aff(
        ops.stream.numpy(), ops.bits.numpy(), ops.allocs.numpy(), ops.caps.numpy(),
        ops.nl.numpy(), ops.hl.numpy(), spstat, ops.num_planes, ops.num_spread,
        ops.max_nodes, **kw,
    )


@pytest.mark.parametrize("world", ["m1000", "gates-reject", "zone-blocked"])
def test_aff_work_counts_do_not_depend_on_the_chunk(world, monkeypatch):
    """K3's plain version counts its work SEARCH_CHUNK active steps at a
    time, in whole-chunk operations; every count (the search, node tests,
    gate and hostname work) is the same at one step a chunk, a few, and
    all the steps in one."""
    ops = _search_operands(world)
    counts = []
    for chunk in (1, 7, ops.stream.shape[1]):
        monkeypatch.setattr(fa, "SEARCH_CHUNK", chunk)
        stats = {}
        _plain_aff(ops, stats)
        counts.append(stats)
    assert counts[0] == counts[1] == counts[2]
    assert counts[0]["node_tests"] > 0
    if world != "m1000":   # the only world without term planes
        assert counts[0]["gate_plane_tests"] > 0


@pytest.mark.parametrize("world", AFF_SEARCH_WORLDS)
def test_aff_search_model_matches_plain_version(world):
    """K3's search (rounds of candidate blocks in node order, exact capacity
    summaries refreshed on every placement, the gates on the node tests,
    the search stopped at min(opened, min(cap, M) - 1)) finds the lowest
    passing node at every step and ends with the plain version's free,
    opened and placed, bit for bit; the plain version's search counts are
    the model's."""
    ops = _search_operands(world)
    stats = {}
    want = _plain_aff(ops, stats)
    free, opened, placed, counts, per_group = _model_aff(ops)
    assert_bits_equal(want[0], free)
    assert_bits_equal(want[1], opened)
    assert_bits_equal(want[2], placed)
    for key in ("summary_tests", "candidate_blocks", "rounds", "placements"):
        assert stats[key] == counts[key], key
    for key in ("candidate_blocks", "rounds", "placements"):
        assert stats[f"max_group_{key}"] == max(c[key] for c in per_group), key
    assert stats["candidate_blocks"] <= stats["summary_tests"]
    # the worlds reach the edges they are named for
    M, caps = ops.max_nodes, ops.caps.tolist()
    if world == "m1000":
        assert M == 1000 and opened.tolist() == [1000, 700] and not placed[:, -100:].any()
    elif world == "cap-in-block":
        assert opened.tolist() == caps == [40, 70, 3]
    elif world == "caps-0-1":
        assert opened.tolist() == [0, 1, 0, 1]
    elif world == "last-node-of-block":
        assert int(opened[0]) == 32 and placed[0, :33].all() and free[0, CPU, 31] == 0.0
    elif world == "gates-reject":
        assert counts["gated_blocks"] > 0 and counts["rounds"] > stats["placements"]
        assert max(c["rounds"] for c in per_group) > ops.stream.shape[1]  # several a step
    elif world == "zone-blocked":
        assert counts["blocked_steps"] > 0
    elif world == "masked":
        assert int(opened[1]) == 0 and not placed[1].any()


@pytest.mark.parametrize("W", [1, 3, 16])
@pytest.mark.parametrize("world", ["rand", "cap-in-block", "caps-0-1"])
def test_aff_search_model_exact_for_any_round_width(world, W):
    """However many candidate blocks a round searches, the lowest passing
    node of the round is `first`: the search is exact for every width,
    and wider rounds take fewer of them."""
    ops = _search_operands(world)
    want = _plain_aff(ops)
    free, opened, placed, counts, _ = _model_aff(ops, W=W)
    for a, b in zip(want, (free, opened, placed)):
        assert_bits_equal(a, b)
    assert counts["rounds"] >= _model_aff(ops, W=W + 1)[3]["rounds"]


def test_aff_search_counts_follow_the_kernel_constants():
    """The plain version counts rounds of GROUP_WARPS × WARP_BLOCKS blocks,
    the kernel's kWarps × kWarpBlocks: the constants are read from the
    source."""
    import re

    from autoscaler_tpu_torch.ops import _build

    text = _build.source("ffd_scan_affinity").read_text()
    for name, want in (("kWarps", fa.GROUP_WARPS), ("kWarpBlocks", fa.WARP_BLOCKS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) == want
