"""Shared helpers of the tests/test_torch_*.py parity tests: seeded numpy
worlds fed to both the JAX package and its PyTorch port, and a bit-exact
comparison (tolerance 0: every operation on both sides is an IEEE f32
mul, add, sub or compare in a fixed order, or integer arithmetic)."""

import numpy as np
import torch

CPU, MEMORY, GPU, PODS = 0, 1, 3, 5


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_bits_equal(ref, out) -> None:
    """Equal shapes, dtypes' kinds and bit patterns (so -0.0 != +0.0 and
    NaN payloads count)."""
    a, b = to_np(ref), to_np(out)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        assert a.dtype == b.dtype == np.float32, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def assert_results_equal(ref, out) -> None:
    assert len(ref) == len(out)
    for name, a, b in zip(ref._fields, ref, out):
        try:
            assert_bits_equal(a, b)
        except AssertionError as e:
            raise AssertionError(f"field {name}: {e}") from None


def rand_case(seed, P=200, G=5, R=6, fractional=False):
    """The world of tests/test_pallas_binpack.py::rand_case; fractional=True
    gives decimal memory (bytes in 10^6 units, stored in MiB)."""
    rng = np.random.default_rng(seed)
    req = np.zeros((P, R), np.float32)
    req[:, CPU] = rng.integers(50, 2000, P)
    req[:, MEMORY] = rng.integers(64, 4096, P)
    if fractional:
        req[:, MEMORY] = req[:, MEMORY] * np.float32(1e6 / 2**20)
    req[:, PODS] = 1.0
    masks = rng.random((G, P)) > 0.1
    allocs = np.zeros((G, R), np.float32)
    allocs[:, CPU] = rng.integers(2000, 16000, G)
    allocs[:, MEMORY] = rng.integers(4096, 32768, G)
    allocs[:, PODS] = 32.0
    return req, masks, allocs


def canon(x):
    """A structure of dataclasses, enums, dicts and sequences → plain
    nested tuples, so the two packages' objects (distinct classes with the
    same names and fields) compare by value."""
    import dataclasses
    import enum

    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, canon(getattr(x, f.name))) for f in dataclasses.fields(x)
        )
    if isinstance(x, dict):
        return ("dict",) + tuple(sorted((k, canon(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    return x


def rand_world(seed, P=40, G=3, T=5, max_nodes=16):
    """The world of tests/test_pallas_affinity.py::rand_world: requests,
    masks, allocs, random affinity term rows (affinity terms self-match)
    and caps."""
    rng = np.random.default_rng(seed)
    pod_req = np.zeros((P, 6), np.float32)
    pod_req[:, CPU] = rng.integers(200, 2500, P)
    pod_req[:, MEMORY] = rng.integers(128, 4096, P)
    pod_req[:, PODS] = 1
    allocs = np.zeros((G, 6), np.float32)
    allocs[:, CPU] = rng.integers(3000, 9000, G)
    allocs[:, MEMORY] = rng.integers(6000, 16000, G)
    allocs[:, PODS] = 32
    masks = rng.random((G, P)) > 0.1
    match = rng.random((T, P)) < 0.4
    aff_of = (rng.random((T, P)) < 0.15) & match
    anti_of = (rng.random((T, P)) < 0.15) & ~aff_of
    node_level = rng.random(T) < 0.5
    has_label = rng.random((G, T)) < 0.8
    caps = rng.integers(2, max_nodes, G).astype(np.int32)
    return pod_req, masks, allocs, match, aff_of, anti_of, node_level, has_label, caps


def hostname_skew_pods(tu, obj, P=40, big=4):
    """``big`` large pods (no constraint) open a node each; the other pods
    are small "web" pods with a hostname spread constraint (maxSkew 1).
    First fit would pile the small pods onto node 0; the minimum over the
    open nodes' counts makes the gate send them round the open nodes.
    ``tu``/``obj`` are either package's test_utils and objects modules."""
    c = obj.TopologySpreadConstraint(
        max_skew=1, topology_key="kubernetes.io/hostname",
        selector=obj.LabelSelector.from_dict({"app": "web"}),
    )
    pods = []
    for i in range(P):
        if i < big:
            pods.append(tu.build_test_pod(f"big{i}", cpu_m=3000, labels={"app": "batch"}))
        else:
            p = tu.build_test_pod(f"web{i}", cpu_m=100, labels={"app": "web"})
            p.topology_spread = (c,)
            pods.append(p)
    return pods


def mask_world(tu, obj, seed, P=40, N=12, place=True):
    """The world of tests/test_factored_mask.py::world built with either
    package's ``tu`` (test_utils) and ``obj`` (kube.objects): taints,
    selectors, an unschedulable node, host ports, placed and pending
    (anti-)affinity. → (nodes, pods, node_of_pod); with ``place`` the
    placed pods also carry their node's name, as the packer reads it."""
    rng = np.random.default_rng(seed)
    nodes = []
    for j in range(N):
        labels = {"zone": f"z{j % 3}", "pool": f"p{j % 2}"}
        taints = [obj.Taint("dedicated", "a", "NoSchedule")] if j % 4 == 0 else []
        n = tu.build_test_node(f"n{j}", cpu_m=4000, labels=labels, taints=taints)
        n.unschedulable = j % 7 == 6
        nodes.append(n)
    pods = []
    node_of_pod = []
    for i in range(P):
        kw = {}
        if i % 5 == 0:
            kw["node_selector"] = {"pool": f"p{i % 2}"}
        if i % 4 == 0:
            kw["tolerations"] = [obj.Toleration(key="dedicated", value="a")]
        if i % 6 == 3:
            kw["affinity"] = tu.anti_affinity({"app": f"a{i % 3}"})
        if i % 6 == 5:
            kw["affinity"] = tu.pod_affinity({"app": f"a{i % 3}"}, topology_key="zone")
        pod = tu.build_test_pod(f"pod{i}", cpu_m=100, labels={"app": f"a{i % 3}"}, **kw)
        if i % 9 == 1:
            pod.host_ports = (8080,)
        placed = rng.random() < 0.5
        node_of_pod.append(int(rng.integers(0, N)) if placed else -1)
        pods.append(pod)
    if place:
        for i, pod in enumerate(pods):
            pod.node_name = nodes[node_of_pod[i]].name if node_of_pod[i] >= 0 else ""
    return nodes, pods, node_of_pod


def rand_spread(rng, P, G, S):
    """A random 11-array spread tuple (the order of the port's
    ``SPREAD_DTYPES``): zone and hostname terms, skews 1-2, some static
    context and minDomains."""
    nl = np.arange(S) % 2 == 0
    return (
        rng.random((P, S)) < 0.3, rng.random((P, S)) < 0.5, nl,
        rng.integers(1, 3, S).astype(np.int32), rng.integers(1, 3, S).astype(np.int32),
        rng.random((G, S)) < 0.9, rng.integers(0, 3, (G, S)).astype(np.int32),
        rng.integers(0, 2, (G, S)).astype(np.int32),
        np.where(rng.random((G, S)) < 0.5, 2**30, 0).astype(np.int32),
        rng.integers(0, 3, (G, S)).astype(np.int32), rng.random((G, S)) < 0.2,
    )


def key_max_f32(vals, valid):
    """The max of f32 values over the last axis as the scan kernels take
    it: on keys that order the bit patterns as the values order; NaN and
    invalid lanes at key 0, which decodes to a NaN."""
    b = vals.astype(np.float32).view(np.uint32).astype(np.uint64)
    key = np.where(b >= 2**31, b ^ 0xFFFFFFFF, b | 2**31)
    key = np.where(valid & ~np.isnan(vals), key, 0).max(axis=-1)
    out = np.where(key >= 2**31, key & 0x7FFFFFFF, key ^ 0xFFFFFFFF)
    return out.astype(np.uint32).view(np.float32)


def _terms(P, T, G, node_level=True):
    z = np.zeros((T, P), bool)
    return z, z.copy(), z.copy(), np.full(T, node_level), np.ones((G, T), bool)


def _one_spread(P, G, S, node_level, min_others=0):
    """S spread terms that no pod declares or matches yet: maxSkew 1,
    minDomains 1, no static context (a static minimum of 2^30, so the
    minimum over the open nodes is the one that binds)."""
    return [
        np.zeros((P, S), bool), np.zeros((P, S), bool), np.asarray(node_level, bool),
        np.ones(S, np.int32), np.ones(S, np.int32), np.ones((G, S), bool),
        np.zeros((G, S), np.int32), np.broadcast_to(np.asarray(min_others, np.int32), (G, S)).copy(),
        np.full((G, S), 2**30, np.int32), np.zeros((G, S), np.int32), np.zeros((G, S), bool),
    ]


# The edge worlds of K3's search, for its numpy model on the CPU and for
# the kernel on the card: (req, masks, allocs, match, aff_of, anti_of,
# node_level, has_label, caps, spread, max_nodes).
AFF_SEARCH_WORLDS = ["rand", "masked", "caps-0-1", "s32", "cap-in-block", "m1000",
                     "last-node-of-block", "gates-reject", "zone-blocked", "many-chunks"]


def aff_search_world(name):
    rng = np.random.default_rng(len(name))
    if name in ("rand", "masked", "caps-0-1", "s32", "many-chunks"):
        # random requests and terms (two term planes) beside random spread
        # terms, 300 pods (3000 small ones in ~94 staged blocks of 32)
        P, G, M = (3000, 3, 256) if name == "many-chunks" else (300, 4, 64)
        req, masks, allocs, match, aff, anti, nl, hl, caps = rand_world(
            len(name), P=P, G=G, T=40, max_nodes=M
        )
        if name == "many-chunks":
            req[:, CPU] //= 8
        if name == "masked":
            masks[1, :] = False
            masks[2, ::2] = False
        if name == "caps-0-1":
            caps = np.array([0, 1, 0, 1], np.int32)
        spread = rand_spread(rng, P, G, 32 if name == "s32" else 4)
        return req, masks, allocs, match, aff, anti, nl, hl, caps, spread, M
    if name in ("m1000", "cap-in-block"):
        # half-node to whole-node pods: the groups reach their caps, 1000
        # (nodes 992..999 make a partial last block) and 700, or 40, 70
        # and 3 inside a block of 100 nodes; one pod in ten with hostname
        # anti-affinity on itself, one in twenty with a hostname spread
        P, G, M, caps = (
            (1500, 2, 1000, [1000, 700]) if name == "m1000" else (400, 3, 100, [40, 70, 3])
        )
        req = np.zeros((P, 6), np.float32)
        req[:, CPU] = rng.integers(500, 1001, P)
        req[:, MEMORY] = rng.integers(64, 2048, P)
        req[:, PODS] = 1.0
        allocs = np.zeros((G, 6), np.float32)
        allocs[:, CPU] = 1000.0
        allocs[:, MEMORY] = 4096.0
        allocs[:, PODS] = 110.0
        match, aff, anti, nl, hl = _terms(P, 1, G)
        match[0, ::10] = anti[0, ::10] = True
        spread = _one_spread(P, G, 1, [True])
        spread[0][::20, 0] = True
        spread[1][:, 0] = True
        return (req, np.ones((G, P), bool), allocs, match, aff, anti, nl, hl,
                np.array(caps, np.int32), tuple(spread), M)
    if name == "last-node-of-block":
        # 31 whole-node pods fill nodes 0..30; a 600 pod opens node 31, the
        # last of block 0; the 400 pod after it lands on node 31 as well
        P, G, M = 33, 1, 64
        req = np.zeros((P, 6), np.float32)
        req[:, CPU] = [1000.0] * 31 + [600.0, 400.0]
        req[:, MEMORY] = req[:, CPU]
        req[:, PODS] = 1.0
        allocs = np.zeros((G, 6), np.float32)
        allocs[:, CPU] = allocs[:, MEMORY] = 1000.0
        allocs[:, PODS] = 110.0
        return (req, np.ones((G, P), bool), allocs, *_terms(P, 1, G),
                np.array([M], np.int32), None, M)
    if name == "gates-reject":
        # tiny pods that fit every node: two in three hold hostname
        # anti-affinity on themselves (a node each), the others a hostname
        # spread of maxSkew 1 that every pod matches; the open nodes' blocks
        # pass their summaries and fail the gates, over more than 32 blocks
        # (two passes, a round each)
        P, G, M = 1800, 2, 1500
        req = np.zeros((P, 6), np.float32)
        req[:, CPU] = rng.integers(5, 20, P)
        req[:, PODS] = 1.0
        allocs = np.zeros((G, 6), np.float32)
        allocs[:, CPU] = 4000.0
        allocs[:, PODS] = 110.0
        match, aff, anti, nl, hl = _terms(P, 1, G)
        match[0] = anti[0] = np.arange(P) % 3 != 0
        spread = _one_spread(P, G, 1, [True])
        spread[0][::3, 0] = True
        spread[1][:, 0] = True
        return (req, np.ones((G, P), bool), allocs, match, aff, anti, nl, hl,
                np.array([M, 1100], np.int32), tuple(spread), M)
    # "zone-blocked": a zone spread term (group-level) whose budget runs
    # out after 1, 6 or 101 matching pods, blocking every later step that
    # declares it, and a hostname spread term
    P, G, M = 300, 3, 64
    req, masks, allocs, match, aff, anti, nl, hl, caps = rand_world(5, P=P, G=G, T=5, max_nodes=M)
    spread = _one_spread(P, G, 2, [False, True], min_others=np.array([[0], [5], [100]]))
    spread[0][:, 0] = rng.random(P) < 0.5
    spread[0][:, 1] = rng.random(P) < 0.2
    spread[1][:] = True
    return req, masks, allocs, match, aff, anti, nl, hl, caps, tuple(spread), M


def fit_case(seed, P, N, R=6, CP=4, CN=3):
    """K4's operands: tests/test_pallas_fit.py::build_case widened to R
    axes, with classless pods, -1 node classes and invalid nodes."""
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 60, (P, R)).astype(np.float32)
    free = rng.integers(0, 200, (N, R)).astype(np.float32)
    pod_class = rng.integers(-1, CP, P).astype(np.int32)
    node_class = rng.integers(-1, CN, N).astype(np.int32)
    class_mask = rng.random((CP, CN)) > 0.3
    node_valid = rng.random(N) > 0.05
    free[~node_valid] = 0
    return req, free, pod_class, node_class, class_mask, node_valid


def rows_case(seed, S, N, R=6, padding=0.0):
    """The rows entry's operands: requests, free capacity, [S, N] rows
    (about a third false) and the slots (each row's index; -1 for a
    ``padding`` share of them)."""
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 60, (S, R)).astype(np.float32)
    free = rng.integers(0, 200, (N, R)).astype(np.float32)
    rows = rng.random((S, N)) > 0.3
    slots = np.where(rng.random(S) < padding, -1, np.arange(S)).astype(np.int32)
    return req, free, rows, slots


def port_world(tu, n_pods, ports, seed=21):
    """Unique pending pods built with ``tu`` (a package's test_utils), with
    fractional memory (the f32 route) and ``ports`` distinct host ports
    (one virtual plane each), and three templates: cpu, memory, pods and
    the ports make 3 + ports kernel planes."""
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(n_pods):
        pod = tu.build_test_pod(
            f"w{i}", cpu_m=float(rng.integers(50, 2000)),
            mem=(float(rng.integers(64, 2048)) + 0.5) * 2**20,
        )
        if ports and i % 3 == 0:
            pod.host_ports = (9000 + i % ports,)
        pods.append(pod)
    templates = {
        f"ng-{j}": tu.build_test_node(f"t{j}", cpu_m=4000.0 * (1 + j), mem=8 * 2**30)
        for j in range(3)
    }
    return pods, templates


def tick_world(tu, obj, prov, cs, spread, **snap_kw):
    """The scale-up half of a tick at a small size, built with either
    package's test_utils, objects, test_provider and cluster_snapshot
    modules: a 12-node cluster (mask_world's nodes, seed 7) with placed
    pods and 40 pending pods of 300-3300 m cpu, more than it holds; one
    pending pod in four selects a "tier" label that only the templates
    carry, and with ``spread`` one in five has a zone DoNotSchedule spread
    on its app. Six node groups of three shapes over three zones, min 0,
    max 10, target 0. → (snapshot, pending, provider)."""
    GiB, MiB = 1024**3, 1024**2
    nodes, pods, _ = mask_world(tu, obj, 7, P=30, N=12)
    pending = []
    for i in range(40):
        kw = {"node_selector": {"tier": f"t{i % 2}"}} if i % 4 == 1 else {}
        p = tu.build_test_pod(f"pend{i}", cpu_m=300.0 + 100 * (i * 7 % 31),
                              mem=(256 + 64 * (i % 9)) * MiB, labels={"app": f"a{i % 3}"},
                              priority=i % 2, **kw)
        if spread and i % 5 == 0:
            p.topology_spread = (obj.TopologySpreadConstraint(
                max_skew=1, topology_key="zone",
                selector=obj.LabelSelector.from_dict({"app": f"a{i % 3}"}),
            ),)
        pending.append(p)
    provider = prov.TestCloudProvider()
    for g in range(6):
        provider.add_node_group(f"ng-{g}", 0, 10, 0, tu.build_test_node(
            f"ng-{g}-tmpl", cpu_m=[2000, 4000, 8000][g % 3], mem=[4, 8, 16][g % 3] * GiB,
            labels={"zone": f"z{g % 3}", "tier": f"t{g % 2}"},
        ))
    snap = cs.ClusterSnapshot(**snap_kw)
    for n in nodes:
        snap.add_node(n)
    for p in pods + pending:
        snap.add_pod(p)
    return snap, pending, provider


def twin(x, obj):
    """A copy of the port's object ``x`` (a kube object, or a list, tuple
    or dict of them) built from the other package's ``obj`` (kube.objects):
    the same class names and field values, so both packages can run on
    identical listings."""
    import dataclasses

    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = getattr(obj, type(x).__name__)
        return cls(**{f.name: twin(getattr(x, f.name), obj) for f in dataclasses.fields(x)})
    if isinstance(x, list):
        return [twin(v, obj) for v in x]
    if isinstance(x, tuple):
        return tuple(twin(v, obj) for v in x)
    if isinstance(x, dict):
        return {k: twin(v, obj) for k, v in x.items()}
    return x


def removal_arrays(seed, N=20, P=60, pad_n=4, pad_p=4, factored=False):
    """A packed world in the shape of sharded_worlds.scaledown_world with
    fractional requests (so the order of the carry's subtractions shows in
    the bits), padding rows, and node 0 large enough to take many pods (so
    one lane places repeatedly on one node); the last node holds no pod."""
    rng = np.random.default_rng(seed)
    M, Q = N + pad_n, P + pad_p
    alloc = np.zeros((M, 6), np.float32)
    alloc[:N, CPU] = 4000
    alloc[:N, MEMORY] = 8192
    alloc[:N, PODS] = 110
    alloc[0, CPU] = 40000
    alloc[0, MEMORY] = 81920
    req = np.zeros((Q, 6), np.float32)
    req[:P, CPU] = rng.integers(200, 1500, P)
    req[:P, MEMORY] = (rng.integers(64, 3000, P) * np.float32(1e6 / 2**20)).astype(np.float32)
    req[:P, PODS] = 1
    pod_node = np.full(Q, -1, np.int32)
    pod_node[:P] = rng.integers(1, N - 1, P)              # node N - 1 holds none
    pod_node[:P:9] = -1                                   # a few pending pods
    used = np.zeros((M, 6), np.float32)
    for i in range(P):
        if pod_node[i] >= 0:
            used[pod_node[i]] += req[i]
    out = {
        "node_alloc": alloc, "node_used": used, "node_valid": np.arange(M) < N,
        "node_group": np.zeros(M, np.int32), "pod_req": req,
        "pod_valid": np.arange(Q) < P, "pod_node": pod_node,
    }
    if not factored:
        out["sched_mask"] = rng.random((Q, M)) > 0.1
        return out
    CP, CN, E, K = 5, 4, 3, 6
    pod_class = rng.integers(0, CP, Q).astype(np.int32)
    pod_class[P:] = -1
    node_class = rng.integers(0, CN, M).astype(np.int32)
    node_class[N:] = -1
    pod_exc = np.full(Q, -1, np.int32)
    pod_exc[rng.choice(P, E, replace=False)] = np.arange(E)
    cell_pod = np.full(K + 2, -1, np.int32)
    cell_pod[:K] = rng.choice(P, K, replace=False)
    out.update(
        pod_class=pod_class, node_class=node_class,
        class_mask=rng.random((CP, CN)) > 0.15,
        exc_rows=rng.random((E, M)) > 0.2, pod_exc=pod_exc,
        cell_pod=cell_pod, cell_node=rng.integers(0, N, K + 2).astype(np.int32),
        cell_val=rng.random(K + 2) > 0.5,
    )
    return out


def lanes_of(arrays, C=10, S=6, seed=0):
    """C candidate nodes (never node 0) with their pods in left-filled
    slots; lane 2 blocked, lane 3 a node with no pods, and a -1 hole in the
    middle of the first row that holds two pods."""
    rng = np.random.default_rng(seed)
    N = int(arrays["node_valid"].sum())
    pod_node = arrays["pod_node"]
    cand = rng.choice(np.arange(1, N - 1), C, replace=False).astype(np.int32)
    cand[3] = N - 1                                        # holds no pod
    slots = np.full((C, S), -1, np.int32)
    for ci, j in enumerate(cand):
        on = np.flatnonzero(pod_node == j)[:S]
        slots[ci, : len(on)] = on
    holed = next(ci for ci in range(C) if (slots[ci] >= 0).sum() >= 2 and ci != 2)
    n_on = int((slots[holed] >= 0).sum())
    if n_on < S:
        slots[holed, 1:n_on + 1] = slots[holed, :n_on].copy()
        slots[holed, 0] = -1
    blocked = np.zeros(C, bool)
    blocked[2] = True
    excluded = np.zeros(arrays["node_valid"].shape[0], bool)
    excluded[cand] = True
    return cand, slots, blocked, excluded


def removal_spread_context(arrays, C, seed, S=3, D=4):
    """A random spread context of S terms over D domains for the world of
    ``removal_arrays`` (its nine arrays in the context's order, as numpy),
    and a random [C, S] count of each candidate's movable matching pods."""
    rng = np.random.default_rng(seed)
    Q, M = arrays["pod_valid"].shape[0], arrays["node_valid"].shape[0]
    ctx = [
        rng.random((Q, S)) < 0.5, rng.random((Q, S)) < 0.6,
        rng.integers(-1, D, (S, M)).astype(np.int32),
        rng.random((S, M)) < 0.9, rng.random((S, D)) < 0.9,
        rng.integers(0, 4, (S, D)).astype(np.int32),
        rng.integers(1, 3, S).astype(np.int32), rng.integers(1, 6, S).astype(np.int32),
        np.full(S, D - 1, np.int32),
    ]
    return ctx, rng.integers(0, 2, (C, S)).astype(np.int32)


# -- the kernel ladder's labels ------------------------------------------------
# The one table that maps the JAX package's rung, route and reason labels to
# the port's: they name what serves on each package's device. Every other
# label value is the same in both packages.
NAME_MAP = {
    "rung": {"pallas": "cuda", "xla": "torch"},
    "route": {"pallas": "cuda", "pallas_affinity": "cuda_affinity",
              "xla_scan": "torch_scan", "xla_runs": "torch_runs",
              "xla_single": "torch_single", "xla_preempt": "torch_preempt",
              "pallas_preempt": "cuda_preempt"},
    "reason": {"not_tpu": "not_cuda", "vmem": "smem"},
}


def port_label(key: str, value: str) -> str:
    """A JAX package label value under the name map."""
    return NAME_MAP.get(key, {}).get(value, value)


def port_series(counter) -> dict:
    """A JAX package metric's series {labels: value} under the name map."""
    return {
        tuple((k, port_label(k, v)) for k, v in labels): value
        for labels, value in counter.values.items()
    }


def port_exposition_line(line: str) -> str:
    """One exposition line of the JAX package under the name map:
    ``rung="pallas"`` → ``rung="cuda"`` and so on."""
    for key, table in NAME_MAP.items():
        for jax_value, port_value in table.items():
            line = line.replace(f'{key}="{jax_value}"', f'{key}="{port_value}"')
    return line


def series(counter) -> dict:
    """A metric's series {labels: value}, for comparing with port_series."""
    return {tuple(labels): value for labels, value in counter.values.items()}


def scan_smem(planes, max_nodes):
    """csrc/ffd_scan.cu's smem_bytes: the carry [NP, M], the block
    summaries [NP, ceil(M/32)], two staged request blocks [2, 32, NP], the
    guards [NP] and two rounds' hit slots [2, 8], in 4-byte words."""
    return 4 * (planes * max_nodes + planes * -(-max_nodes // 32) + 64 * planes + planes + 16)


def aff_smem(R, TP, S, max_nodes):
    """A stand-in for K3's shared memory: its carry grows with R, the term
    planes and the spread terms over the nodes."""
    return 4 * (R + 2 * TP + S) * max_nodes


# -- the JAX package's own test cases, run on the port ----------------------------

_JAX_PKG, _PORT_PKG = "autoscaler_tpu", "autoscaler_tpu_torch"
# label values of the JAX package that the port names for its card
PORT_CONSTS = {"xla": "torch", "pallas": "cuda", "not_tpu": "not_cuda", "vmem": "smem"}


def _port_name(name):
    if name == _JAX_PKG or name.startswith(_JAX_PKG + "."):
        return _PORT_PKG + name[len(_JAX_PKG):]
    return name


def _port_code(code):
    """A code object with the JAX package's label constants renamed
    (``PORT_CONSTS``) and its ``autoscaler_tpu.*`` imports pointed at the
    port, nested code (lambdas, comprehensions) included."""
    import types

    consts = tuple(
        _port_code(c) if isinstance(c, types.CodeType)
        else PORT_CONSTS.get(c, c) if isinstance(c, str) else c
        for c in code.co_consts
    )
    names = tuple(_port_name(n) if "." in n or n == _JAX_PKG else n for n in code.co_names)
    return code.replace(co_consts=consts, co_names=names)


class _Unported:
    def __init__(self, name):
        self.name = name

    def __call__(self, *args, **kwargs):
        raise NotImplementedError(f"the port has no namesake of {self.name}")


class Rebound:
    """A JAX package test module whose functions run on the port: every
    global that names a JAX package module, class or function is the
    port's namesake, the module's own functions and classes are rebuilt on
    those globals, and each function's code has its label constants and
    local imports ported (``_port_code``). ``case(name)`` → a callable of the test
    ``name`` ("test_x" or "TestClass.test_x") taking the test's fixtures.
    A global named in ``unported`` (a JAX package function the port has no
    namesake of) becomes a stand-in that raises when a case calls it."""

    def __init__(self, module, unported=()):
        self.module = module
        self.globals = dict(module.__dict__)
        for key, value in list(self.globals.items()):
            self.globals[key] = _Unported(key) if key in unported else self._port(value)

    def _port(self, value):
        import enum
        import importlib
        import types

        if isinstance(value, enum.Enum):
            ported = self._port(type(value))
            return value if ported is type(value) else ported[value.name]
        if isinstance(value, types.ModuleType):
            name = _port_name(value.__name__)
            return importlib.import_module(name) if name != value.__name__ else value
        if isinstance(value, types.FunctionType) and value.__module__ == self.module.__name__:
            return self.function(value)
        if isinstance(value, type) and value.__module__ == self.module.__name__:
            return self.cls(value)
        mod = getattr(value, "__module__", None)
        if isinstance(mod, str) and _port_name(mod) != mod and hasattr(value, "__qualname__"):
            target = importlib.import_module(_port_name(mod))
            for part in value.__qualname__.split("."):
                target = getattr(target, part)
            return target
        return value

    def _port_default(self, value):
        """A default argument's value, ported when it is a JAX package
        module, class, function or enum member (an instance stays as it
        is)."""
        import enum
        import types

        kinds = (enum.Enum, type, types.FunctionType, types.ModuleType)
        return self._port(value) if isinstance(value, kinds) else value

    def function(self, fn):
        import types

        defaults = fn.__defaults__ and tuple(self._port_default(d) for d in fn.__defaults__)
        new = types.FunctionType(_port_code(fn.__code__), self.globals, fn.__name__,
                                 defaults, fn.__closure__)
        new.__kwdefaults__ = fn.__kwdefaults__ and {
            k: self._port_default(v) for k, v in fn.__kwdefaults__.items()}
        return new

    def cls(self, cls):
        """The module's class ``cls`` with every method rebuilt."""
        import types

        body = {k: self.function(v) if isinstance(v, types.FunctionType) else v
                for k, v in cls.__dict__.items() if k not in ("__dict__", "__weakref__")}
        return type(cls.__name__, cls.__bases__, body)

    def case(self, name):
        if "." in name:
            cls_name, meth = name.split(".")
            cls = self.globals[cls_name]
            return lambda **fixtures: getattr(cls(), meth)(**fixtures)
        return self.globals[name]

    def run(self, name, request):
        """Run the case ``name`` with its fixtures from pytest's
        ``request``."""
        import inspect

        target = getattr(self.module, name.split(".")[0])
        if "." in name:
            target = getattr(target, name.split(".")[1])
        params = [p for p in inspect.signature(target).parameters if p != "self"]
        self.case(name)(**{p: request.getfixturevalue(p) for p in params})

    def class_cases(self, *classes, leave_out=()) -> list:
        """"Class.test_x" for each test method of ``classes`` whose name
        holds none of ``leave_out``."""
        return [f"{c}.{m}" for c in classes for m in vars(getattr(self.module, c))
                if m.startswith("test_") and not any(s in m for s in leave_out)]
