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
    """A structure of dataclasses, dicts and sequences → plain nested
    tuples, so the two packages' objects (distinct classes with the same
    names and fields) compare by value."""
    import dataclasses

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
