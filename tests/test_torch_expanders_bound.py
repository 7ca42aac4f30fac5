"""The expanders that need a binding, on the port (autoscaler_tpu_torch/
expander/{price,priority,grpc_}.py) against the JAX package: on seeded
option sets both packages' filters keep the same options and score them
alike (tolerance 0); priority from a static map, from a hot-reloaded file
and from a live ConfigMap (a malformed payload keeps the last good tiers,
a deleted ConfigMap disables them or falls back); and grpc-ref, whose
client in each package talks to the other package's reference-protocol
expander server on localhost."""
import json
import types

import numpy as np
import pytest

import autoscaler_tpu.cloudprovider.test_provider as jprov
import autoscaler_tpu.expander.core as jexp
import autoscaler_tpu.expander.grpc_ as jgrpc
import autoscaler_tpu.expander.price as jprice
import autoscaler_tpu.expander.priority as jprio
import autoscaler_tpu.kube.api as japi
import autoscaler_tpu.rpc.refcompat as jref
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.cloudprovider.test_provider as tprov
import autoscaler_tpu_torch.expander.core as texp
import autoscaler_tpu_torch.expander.grpc_ as tgrpc
import autoscaler_tpu_torch.expander.price as tprice
import autoscaler_tpu_torch.expander.priority as tprio
import autoscaler_tpu_torch.kube.api as tapi
import autoscaler_tpu_torch.rpc.refcompat as tref
import autoscaler_tpu_torch.utils.test_utils as ttu

JAX = types.SimpleNamespace(prov=jprov, exp=jexp, price=jprice, prio=jprio, api=japi,
                            grpc=jgrpc, ref=jref, tu=jtu)
TORCH = types.SimpleNamespace(prov=tprov, exp=texp, price=tprice, prio=tprio, api=tapi,
                              grpc=tgrpc, ref=tref, tu=ttu)
PKGS = (JAX, TORCH)
GB, MB = jtu.GB, jtu.MB
CM_NS, CM_NAME = "kube-system", "cluster-autoscaler-priority-expander"


def option_set(k, seed, groups=6, pods=12):
    """A provider of ``groups`` priced groups and one option a group, each
    with a seeded node count and a seeded slice of ``pods`` pods."""
    rng = np.random.default_rng(seed)
    provider = k.prov.TestCloudProvider()
    for g in range(groups):
        provider.add_node_group(
            f"pool-{g}", 0, 50, 0,
            k.tu.build_test_node(f"t{g}", cpu_m=float(rng.choice([2000, 4000, 8000, 16000])),
                                 mem=float(rng.choice([4, 8, 16, 32])) * GB),
            price_per_hour=float(rng.choice([0.1, 0.25, 0.5, 1.0, 2.0, 4.0])))
    all_pods = [k.tu.build_test_pod(f"p{i}", cpu_m=float(rng.integers(100, 3000)),
                                    mem=float(rng.integers(64, 4096)) * MB)
                for i in range(pods)]
    options = []
    for g in provider.node_groups():
        take = int(rng.integers(1, pods + 1))
        options.append(k.exp.Option(g, int(rng.integers(1, 8)), all_pods[:take]))
    return provider, options


def ids(options):
    return [o.node_group.id() for o in options]


@pytest.mark.parametrize("seed", range(8))
def test_price_filter_matches_jax(seed):
    got = []
    for k in PKGS:
        provider, options = option_set(k, seed)
        f = k.price.PriceFilter(provider.pricing())
        got.append((ids(f.best_options(options)), [float(s) for s in f.scores(options)]))
    assert got[1] == got[0]


def random_tiers(seed, groups=6):
    rng = np.random.default_rng(100 + seed)
    tiers = {}
    for g in range(groups):
        if rng.random() < 0.8:
            tiers.setdefault(int(rng.choice([1, 10, 50])), []).append(f"pool-{g}")
    return tiers


@pytest.mark.parametrize("seed", range(8))
def test_priority_filter_matches_jax(seed):
    got = []
    for k in PKGS:
        _, options = option_set(k, seed)
        got.append(ids(k.prio.PriorityFilter(random_tiers(seed)).best_options(options)))
    assert got[1] == got[0]


@pytest.mark.parametrize("chain", [["priority", "price"], ["priority", "least-waste"],
                                   ["price", "most-pods"], ["least-waste", "priority"]])
@pytest.mark.parametrize("seed", range(4))
def test_chains_choose_as_in_jax(chain, seed):
    got = []
    for k in PKGS:
        provider, options = option_set(k, seed)
        strategy = k.exp.build_strategy(chain, seed=seed, priorities=random_tiers(seed),
                                        pricing=provider.pricing())
        best = strategy.best_option(options)
        got.append((best.node_group.id(), strategy.last_table, strategy.last_score))
    assert got[1] == got[0]


def test_file_priority_hot_reload_matches_jax(tmp_path):
    """A priority file read per decision: a change applies, a broken edit
    keeps the last good tiers, a missing file serves the fallback."""
    got = []
    for name, k in (("jax", JAX), ("torch", TORCH)):
        path = tmp_path / f"{name}.yaml"
        path.write_text(json.dumps({"10": ["pool-1"]}))
        _, options = option_set(k, 3)
        f = k.prio.FileWatchingPriorityFilter(str(path), fallback={5: ["pool-4"]})
        seen = [ids(f.best_options(options))]
        path.write_text(json.dumps({"10": ["pool-2", "pool-3"]}))
        import os

        os.utime(path, (1e9, 2e9))   # a later mtime, whatever the clock's grain
        seen.append(ids(f.best_options(options)))
        path.write_text("{not: [valid")
        os.utime(path, (1e9, 3e9))
        seen.append(ids(f.best_options(options)))
        path.unlink()
        seen.append(ids(f.best_options(options)))
        got.append(seen)
    assert got[1] == got[0]
    assert got[0][0] == ["pool-1"] and got[0][1] == ["pool-2", "pool-3"]
    assert got[0][2] == got[0][1]


def configmap_sequence(k, fallback):
    """A live ConfigMap through each package's FakeClusterAPI: JSON tiers,
    an update, a malformed payload, a bad regex, the ConfigMap deleted,
    then restored. → the options kept at each step and the last error."""
    api = k.api.FakeClusterAPI()
    _, options = option_set(k, 5)

    def write(payload):
        api.write_configmap(CM_NS, CM_NAME, {"priorities": payload})

    write(json.dumps({"10": ["pool-0"], "50": ["pool-5"]}))
    f = k.prio.ConfigMapPriorityFilter(lambda: api.read_configmap(CM_NS, CM_NAME),
                                       fallback=fallback)
    out = [ids(f.best_options(options))]
    for payload in (json.dumps({"10": ["pool-1", "pool-2"]}), "{broken", '{"10": ["("]}'):
        write(payload)
        out.append((ids(f.best_options(options)), f.last_error is None))
    api.configmaps.pop((CM_NS, CM_NAME), None)
    out.append((ids(f.best_options(options)), f.last_error))
    write(json.dumps({"7": ["pool-3"]}))
    out.append((ids(f.best_options(options)), f.last_error))
    return out


@pytest.mark.parametrize("fallback", [None, {3: ["pool-4"]}], ids=["no-fallback", "fallback"])
def test_configmap_priority_matches_jax(fallback):
    ref, out = configmap_sequence(JAX, fallback), configmap_sequence(TORCH, fallback)
    assert out == ref
    assert ref[0] == ["pool-5"] and ref[1][0] == ["pool-1", "pool-2"]
    assert ref[2][0] == ref[1][0] and not ref[2][1]     # malformed: the last good tiers


def test_configmap_store_is_keyed_as_in_jax():
    for k in PKGS:
        api = k.api.FakeClusterAPI()
        api.write_configmap(CM_NS, CM_NAME, {"priorities": "{}"})
        assert (CM_NS, CM_NAME) in api.configmaps


def chooser(options, node_map):
    """The operator's expander: the fewest nodes, ties by group id; it also
    notes what it was sent."""
    chooser.seen.append(sorted((o.group_id, o.node_count, tuple(sorted(p.key() for p in o.pods)),
                                tuple(sorted(node_map)))
                               for o in options))
    best = min(options, key=lambda o: (o.node_count, o.group_id))
    return [best]


chooser.seen = []


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
@pytest.mark.parametrize("seed", range(3))
def test_grpc_ref_across_packages(server_pkg, seed):
    """Each package's RefGRPCFilter against the other's (and its own)
    reference expander server: the same options on the wire, the same
    choice back."""
    ref = JAX.ref if server_pkg == "jax" else TORCH.ref
    server, port = ref.serve_ref_expander(chooser)
    try:
        chooser.seen.clear()
        got = []
        for k in PKGS:
            _, options = option_set(k, seed)
            f = k.grpc.RefGRPCFilter(f"127.0.0.1:{port}")
            got.append(ids(f.best_options(options)))
        assert got[1] == got[0] and len(got[0]) == 1
        assert len(chooser.seen) == 2 and chooser.seen[1] == chooser.seen[0]
    finally:
        server.stop(None)


def test_grpc_ref_builds_from_the_chain_and_fails_open():
    """build_strategy's grpc-ref entry, as the JAX package builds it; an
    unreachable server keeps every option (fail open) in both."""
    got = []
    for k in PKGS:
        _, options = option_set(k, 1)
        strategy = k.exp.build_strategy(["grpc-ref"], seed=0, grpc_target="127.0.0.1:1")
        f = strategy.filters[0]
        f.client.timeout_s = 0.5
        got.append((type(f).__name__, ids(f.best_options(options))))
    assert got[1] == got[0] and got[0][0] == "RefGRPCFilter" and len(got[0][1]) == 6
