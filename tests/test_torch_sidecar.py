"""The gRPC sidecar and the native ``grpc`` expander across packages, on the
CPU: the port's client against the JAX package's sidecar and the JAX
package's client against the port's (and the port against itself), on
every RPC — ``Estimate`` (with an extended resource column and a schema
mismatch), ``BatchEstimate`` (the fleet's wire surface, what-if prices),
``TrySchedule`` (with and without a spread context), ``FindNodesToRemove``
and ``BestOptions`` — each answer byte-equal to the JAX package's own
client and sidecar on the same request; drain and the health surface;
the client's failover, hedging and Retry-After (the JAX suites' client
cases run on the port, ``torch_parity.Rebound``); ``python -m
autoscaler_tpu_torch.rpc`` in a subprocess; and ``GRPCFilter``'s choice
against a live sidecar of either package.
"""
import inspect
import os
import select
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

import autoscaler_tpu.cloudprovider.test_provider as jprov  # noqa: E402
import autoscaler_tpu.expander.core as jcore  # noqa: E402
import autoscaler_tpu.fleet as jfleet  # noqa: E402
import autoscaler_tpu.rpc.autoscaler_pb2 as jpb  # noqa: E402
import autoscaler_tpu.rpc.service as jsvc  # noqa: E402
import autoscaler_tpu.utils.sharded_worlds as jworlds  # noqa: E402
import autoscaler_tpu.utils.test_utils as jtu  # noqa: E402
import autoscaler_tpu_torch.cloudprovider.test_provider as tprov  # noqa: E402
import autoscaler_tpu_torch.expander.core as tcore  # noqa: E402
import autoscaler_tpu_torch.fleet as tfleet  # noqa: E402
import autoscaler_tpu_torch.fleet.coalescer as tcoalescer  # noqa: E402
import autoscaler_tpu_torch.parallel.mesh as tmesh  # noqa: E402
import autoscaler_tpu_torch.perf as tperf  # noqa: E402
import autoscaler_tpu_torch.rpc.autoscaler_pb2 as tpb  # noqa: E402
import autoscaler_tpu_torch.rpc.service as tsvc  # noqa: E402
import autoscaler_tpu_torch.utils.test_utils as ttu  # noqa: E402
import test_fleet  # noqa: E402
import test_fleet_ha  # noqa: E402
import test_fleet_overload  # noqa: E402
import test_overpack_bound  # noqa: E402
from torch_parity import Rebound  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SVC = {"jax": jsvc, "torch": tsvc}
FLEET = {"jax": jfleet, "torch": tfleet}
PAIRS = [("torch", "jax"), ("jax", "torch"), ("torch", "torch")]
PAIR_IDS = [f"{c}-client-{s}-sidecar" for c, s in PAIRS]


def _cpu(pkg):
    return {} if pkg == "jax" else {"device": "cpu"}


class Sidecar:
    """One package's sidecar on a free port, with its coalescer."""

    def __init__(self, pkg, drain=None, residency=None, **co_kw):
        co_kw = {"buckets": "16x4x8,64x8x8", "window_s": 0.002, "batch_scenarios": 4, **co_kw}
        self.co = FLEET[pkg].FleetCoalescer(**co_kw, **_cpu(pkg))
        self.server, self.port = SVC[pkg].serve(fleet=self.co, drain=drain, residency=residency,
                                                **_cpu(pkg))
        self.target = f"127.0.0.1:{self.port}"

    def stop(self):
        self.server.stop(0)
        self.co.stop()


def _client(pkg, target, **kw):
    return SVC[pkg].TpuSimulationClient(target, **kw)


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def pair(request):
    """(client package, a sidecar of the server package, the JAX package's
    own sidecar for the reference answers)."""
    client_pkg, server_pkg = request.param
    side, ref = Sidecar(server_pkg), Sidecar("jax")
    client = _client(client_pkg, side.target, default_timeout_s=30.0)
    ref_client = _client("jax", ref.target, default_timeout_s=30.0)
    yield client, ref_client, client_pkg
    client.close()
    ref_client.close()
    side.stop()
    ref.stop()


def both(pair, method, *args, **kw):
    client, ref_client, _ = pair
    return getattr(client, method)(*args, **kw), getattr(ref_client, method)(*args, **kw)


def assert_same(got, want):
    if isinstance(want, dict):
        assert got == want
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_same(a, b)
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def estimate_world(seed, P=64, G=3, R=6):
    rng = np.random.default_rng(seed)
    req = np.zeros((P, R), np.float32)
    req[:, 0] = rng.integers(100, 1500, P)
    req[:, 1] = rng.integers(64, 2048, P)
    req[:, 5] = 1
    masks = rng.random((G, P)) > 0.1
    allocs = np.tile(np.array([4000, 8192, 0, 0, 0, 110] + [0] * (R - 6), np.float32), (G, 1))
    allocs[:, 0] *= rng.integers(1, 4, G)
    caps = rng.integers(4, 33, G).astype(np.int32)
    return req, masks, allocs, [f"g{i}" for i in range(G)], caps


@pytest.mark.parametrize("seed", [1, 2])
def test_estimate_across_packages(pair, seed):
    req, masks, allocs, gids, caps = estimate_world(seed)
    got, want = both(pair, "estimate", req, masks, allocs, gids, caps, max_nodes=32)
    assert_same(got, want)
    assert int(np.asarray(got[0]).sum()) > 0


def test_estimate_extended_resource_across_packages(pair):
    widget = widget_world()
    got, want = both(pair, "estimate", *widget, max_nodes=64,
                     extended_resources=("example.com/widget",))
    assert_same(got, want)
    assert list(got[0]) == [16, 16]


def widget_world():
    """tests/test_processors_rpc_native.py's widget world: only the named
    extended resource gates the fit (2 pods a node)."""
    P, G = 32, 2
    req = np.zeros((P, 7), np.float32)
    req[:, 0], req[:, 1], req[:, 5], req[:, 6] = 100, 128, 1, 1
    allocs = np.tile(np.array([4000, 8192, 0, 0, 0, 110, 2], np.float32), (G, 1))
    return req, np.ones((G, P), bool), allocs, ["a", "b"], np.full(G, 64, np.int32)


def test_estimate_schema_mismatch_aborts_on_both_sidecars(pair):
    client, ref_client, client_pkg = pair
    req, masks, allocs, gids, caps = widget_world()
    pb = jpb if client_pkg == "jax" else tpb
    bad = pb.EstimateRequest(
        pods=pb.PackedPods(requests=np.ascontiguousarray(req, "<f4").tobytes(),
                           num_pods=req.shape[0], num_resources=7,
                           extended_resources=["a.example/x", "b.example/y"]),
        pod_masks=np.ascontiguousarray(masks, np.uint8).tobytes(),
        template_allocs=np.ascontiguousarray(allocs, "<f4").tobytes(),
        group_ids=gids, node_caps=np.ascontiguousarray(caps, "<i4").tobytes(), max_nodes=64)
    details = []
    for c in (client, ref_client):
        with pytest.raises(grpc.RpcError) as exc:
            c._call("Estimate", bad)
        assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        details.append(exc.value.details())
    assert details[0] == details[1]


@pytest.mark.parametrize("priced", [False, True])
def test_batch_estimate_across_packages(pair, priced):
    req, masks, allocs, gids, caps = estimate_world(3, P=12, G=3)
    prices = np.random.default_rng(4).random(3).astype(np.float32) if priced else None
    got, want = both(pair, "batch_estimate", req, masks, allocs, gids, caps, max_nodes=16,
                     tenant_id="alpha", prices=prices)
    assert_same(got, want)
    assert got[2]["route"] == "fleet_batched" and got[2]["bucket"] == "16x4x8"
    assert (got[2]["best_group"] >= 0) == priced


def _spread_call_operands(spread_ctx):
    import jax.numpy as jnp  # noqa: F401 — the JAX package's pack builds them

    from autoscaler_tpu.snapshot.affinity import build_spread_schedule_context
    from autoscaler_tpu.snapshot.packer import pack

    K = test_overpack_bound.K
    pending = [test_overpack_bound.spread_pod(f"p{i}") for i in range(K)]
    nodes, pods, _ = test_overpack_bound.two_zone_world(pending)
    tensors, meta = pack(nodes, pods, {})
    slots = np.asarray([meta.pod_index[p.key()] for p in pending], np.int32)
    spread = None
    if spread_ctx:
        spread = tuple(np.asarray(a) for a in build_spread_schedule_context(
            pending, nodes, [], [], meta.pod_index, int(tensors.pod_req.shape[0]),
            num_node_cols=int(tensors.node_valid.shape[0])))
    return (np.asarray(tensors.pod_req, np.float32), np.asarray(tensors.free(), np.float32),
            np.asarray(tensors.sched_mask, np.uint8), slots, np.full((K,), -1, np.int32)), spread


@pytest.mark.parametrize("spread_ctx", [False, True])
def test_try_schedule_across_packages(pair, spread_ctx):
    args, spread = _spread_call_operands(spread_ctx)
    got, want = both(pair, "try_schedule", *args, spread=spread)
    assert_same(got, want)
    placed, dest = got
    assert placed.all()
    skew = int(np.ptp(np.bincount(dest, minlength=2)))
    assert skew <= 1 if spread_ctx else skew == test_overpack_bound.K


def test_find_nodes_to_remove_across_packages(pair):
    client, ref_client, client_pkg = pair
    snap, cand, pod_slots, blocked, _ = jworlds.scaledown_world(24, 64, 8, 6)
    pb = jpb if client_pkg == "jax" else tpb
    f32 = lambda a: np.ascontiguousarray(np.asarray(a), "<f4").tobytes()  # noqa: E731
    req = pb.FindNodesToRemoveRequest(
        pods=pb.PackedPods(requests=f32(snap.pod_req), num_pods=int(snap.pod_req.shape[0]),
                           num_resources=6),
        node_alloc=f32(snap.node_alloc), node_used=f32(snap.node_used),
        sched_mask=np.ascontiguousarray(np.asarray(snap.sched_mask), np.uint8).tobytes(),
        candidate_nodes=np.ascontiguousarray(cand, "<i4").tobytes(),
        pod_slots=np.ascontiguousarray(pod_slots, "<i4").tobytes(),
        blocked=np.ascontiguousarray(blocked, np.uint8).tobytes(),
        num_nodes=int(snap.node_alloc.shape[0]), slots_per_node=int(pod_slots.shape[1]))
    got, want = client._call("FindNodesToRemove", req), ref_client._call("FindNodesToRemove", req)
    assert got.SerializeToString() == want.SerializeToString()
    assert np.frombuffer(got.feasible, np.uint8).any()


def test_best_options_across_packages(pair):
    client, ref_client, client_pkg = pair
    pb = jpb if client_pkg == "jax" else tpb
    opts = [pb.Option(group_id="few", node_count=1, pod_keys=["a"]),
            pb.Option(group_id="many", node_count=2, pod_keys=["a", "b", "c"]),
            pb.Option(group_id="hinted", node_count=3, pod_keys=["a"], score_hint=-9.0)]
    got, want = both(pair, "best_options", opts)
    assert [o.SerializeToString() for o in got] == [o.SerializeToString() for o in want]
    assert [o.group_id for o in got] == ["hinted"]


def test_wire_names_are_the_jax_packages():
    for name in ("SERVICE_NAME", "TRACE_METADATA_KEY", "RETRY_AFTER_METADATA_KEY",
                 "DRAIN_DETAIL"):
        assert getattr(tsvc, name) == getattr(jsvc, name)
    assert set(tsvc._METHODS) == set(jsvc._METHODS)
    import autoscaler_tpu.rpc.fleet_pb2 as jfpb
    import autoscaler_tpu_torch.rpc.fleet_pb2 as tfpb

    assert tfpb.MESSAGE_LAYOUT == jfpb.MESSAGE_LAYOUT
    assert tfpb.BatchEstimateRequest.DESCRIPTOR.full_name == \
        jfpb.BatchEstimateRequest.DESCRIPTOR.full_name


def test_sidecar_accounts_scenario_batches():
    """The servicer's ``_account`` seats each RPC's unpacked tensors in the
    ``scenario_batches`` pool for the call and drops them after."""
    ledger = tperf.ResidencyLedger()
    seen = []
    real_set = ledger.set

    def recording_set(pool, key, nbytes):
        seen.append((pool, key, nbytes))
        real_set(pool, key, nbytes)

    ledger.set = recording_set
    side = Sidecar("torch", residency=ledger)
    client = _client("torch", side.target, default_timeout_s=30.0)
    try:
        req, masks, allocs, gids, caps = estimate_world(5)
        client.estimate(req, masks, allocs, gids, caps, max_nodes=32)
        client.batch_estimate(req[:12], masks[:, :12], allocs, gids, caps, max_nodes=16)
    finally:
        client.close()
        side.stop()
    want = req.nbytes + masks.nbytes + allocs.nbytes + caps.nbytes
    assert seen[0] == (tperf.POOL_SCENARIO_BATCHES, "Estimate", want)
    assert [k for _, k, _ in seen] == ["Estimate", "BatchEstimate"]
    assert all(pool == tperf.POOL_SCENARIO_BATCHES for pool, _, _ in seen)


# -- drain, health, overload ----------------------------------------------------


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS, ids=PAIR_IDS)
def test_drain_refuses_unavailable_with_detail(client_pkg, server_pkg):
    drain = SVC[server_pkg].DrainState()
    side = Sidecar(server_pkg, drain=drain, buckets="16x4x8")
    client = _client(client_pkg, side.target, default_timeout_s=5.0,
                     failover_base_sleep_s=0.001)
    try:
        req, masks, allocs, gids, caps = estimate_world(13, P=9)
        client.estimate(req, masks, allocs, gids, caps, max_nodes=16)
        drain.begin_drain()
        with pytest.raises(grpc.RpcError) as exc:
            client.estimate(req, masks, allocs, gids, caps, max_nodes=16)
        assert exc.value.code() == grpc.StatusCode.UNAVAILABLE
        assert tsvc.DRAIN_DETAIL in exc.value.details()
    finally:
        client.close()
        side.stop()


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS, ids=PAIR_IDS)
def test_overload_retry_after_across_packages(client_pkg, server_pkg):
    side = Sidecar(server_pkg, buckets="16x4x8", tenant_qps=0.001, tenant_burst=1.0)
    client = _client(client_pkg, side.target, default_timeout_s=10.0)
    try:
        req, masks, allocs, gids, caps = estimate_world(12, P=9)
        client.batch_estimate(req, masks, allocs, gids, caps, max_nodes=16, tenant_id="q")
        with pytest.raises(grpc.RpcError) as exc:
            client.batch_estimate(req, masks, allocs, gids, caps, max_nodes=16, tenant_id="q")
        assert exc.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert "fleet overload" in exc.value.details()
        trailing = dict(exc.value.trailing_metadata() or ())
        assert float(trailing[tsvc.RETRY_AFTER_METADATA_KEY]) > 1.0
    finally:
        client.close()
        side.stop()


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS, ids=PAIR_IDS)
def test_failover_to_a_live_sidecar(client_pkg, server_pkg):
    """The first endpoint is dead: the client fails over to the live one."""
    side = Sidecar(server_pkg)
    client = _client(client_pkg, ["127.0.0.1:1", side.target], default_timeout_s=10.0,
                     failover_base_sleep_s=0.001, failover_max_sleep_s=0.002)
    try:
        req, masks, allocs, gids, caps = estimate_world(7)
        counts, _ = client.estimate(req, masks, allocs, gids, caps, max_nodes=32)
        assert int(counts.sum()) > 0
    finally:
        client.close()
        side.stop()


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS, ids=PAIR_IDS)
def test_hedged_batch_estimate_across_packages(client_pkg, server_pkg):
    sides = [Sidecar(server_pkg), Sidecar(server_pkg)]
    client = _client(client_pkg, [s.target for s in sides], default_timeout_s=10.0, hedge=True)
    ref = Sidecar("jax")
    ref_client = _client("jax", ref.target, default_timeout_s=10.0)
    try:
        req, masks, allocs, gids, caps = estimate_world(8, P=12)
        for _ in range(3):
            got = client.batch_estimate(req, masks, allocs, gids, caps, max_nodes=16)
            want = ref_client.batch_estimate(req, masks, allocs, gids, caps, max_nodes=16)
            assert_same(got[:2], want[:2])
    finally:
        client.close()
        ref_client.close()
        for s in sides + [ref]:
            s.stop()


def test_drain_server_flushes_and_health_flips():
    drain = tsvc.DrainState()
    httpd, hport = tsvc.start_health_server(drain, port=0)
    side = Sidecar("torch", drain=drain)
    import urllib.error
    import urllib.request

    try:
        assert urllib.request.urlopen(f"http://127.0.0.1:{hport}/healthz").read() == b"ok\n"
        tsvc.drain_server(side.server, fleet=side.co, drain=drain, grace_s=1.0)
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{hport}/healthz")
        assert exc.value.code == 503 and side.co.draining()
    finally:
        httpd.shutdown()


# -- the JAX suites' RPC and client cases on the port -------------------------------

REBOUND = {m.__name__: Rebound(m) for m in (test_fleet, test_fleet_overload, test_fleet_ha)}
RPC_CASES = [
    ("test_fleet", "test_rpc_batch_estimate_matches_estimate"),
    ("test_fleet", "test_rpc_axis_mismatch_consistent_on_both_routes"),
    ("test_fleet", "test_serve_builds_coalescer_from_options"),
    ("test_fleet", "test_fleet_pb2_matches_declared_layout"),
    ("test_fleet_overload", "test_rpc_overload_surfaces_resource_exhausted_with_retry_after"),
    ("test_fleet_overload", "test_rpc_drain_refuses_unavailable_with_detail"),
    ("test_fleet_overload", "test_health_server_readiness_flips_on_drain"),
] + [
    (mod, f"{cls}.{name}")
    for mod, cls in (("test_fleet_overload", "TestClientResendMatrix"),
                     ("test_fleet_overload", "TestClientFailover"),
                     ("test_fleet_overload", "TestClientHedging"),
                     ("test_fleet_ha", "TestHedgeHealthGating"))
    for name in vars(getattr(REBOUND[mod].module, cls)) if name.startswith("test_")
] + [
    ("test_fleet_ha", name) for name in (
        "test_duplicate_endpoints_are_deduped_not_a_crash",
        "test_call_does_not_double_record_hedged_failures",
        "test_send_rides_the_attempts_target_channel",
        "test_non_outage_response_resolves_a_half_open_probe",
        "test_released_probe_slot_can_probe_again",
        "test_client_resource_exhausted_probe_does_not_wedge")
]


@pytest.fixture()
def rpc_server(on_cpu):
    side = Sidecar("torch")
    client = tsvc.TpuSimulationClient(side.target, default_timeout_s=30.0)
    yield client
    client.close()
    side.stop()


@pytest.fixture()
def quota_server(on_cpu):
    side = Sidecar("torch", buckets="16x4x8", tenant_qps=0.001, tenant_burst=1.0)
    client = tsvc.TpuSimulationClient(side.target, default_timeout_s=10.0)
    yield client
    client.close()
    side.stop()


@pytest.fixture()
def on_cpu(monkeypatch):
    cpu = lambda d=None: __import__("torch").device("cpu" if d is None else d)  # noqa: E731
    for mod in (tcoalescer, tmesh, tsvc):
        monkeypatch.setattr(mod, "resolve_device", cpu)


@pytest.mark.parametrize("module,name", RPC_CASES, ids=[f"{m}::{n}" for m, n in RPC_CASES])
def test_jax_rpc_case_on_the_port(module, name, request, on_cpu):
    rb = REBOUND[module]
    target = getattr(rb.module, name.split(".")[0])
    if "." in name:
        target = getattr(target, name.split(".")[1])
    params = [p for p in inspect.signature(target).parameters if p != "self"]
    rb.case(name)(**{p: request.getfixturevalue(p) for p in params})


# -- the launcher and the grpc expander ---------------------------------------------


def test_rpc_main_serves_on_the_cpu_and_drains_on_sigterm():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "autoscaler_tpu_torch.rpc", "--address", "127.0.0.1:0",
         "--device", "cpu", "--health-port", "0", "--fleet-shape-buckets", "16x4x8",
         "--fleet-drain-grace-s", "1"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line, t_end = "", time.monotonic() + 120
        while time.monotonic() < t_end and "serving on port" not in line:
            ready, _, _ = select.select([proc.stdout], [], [], 1.0)
            if ready:
                line = proc.stdout.readline()
                if not line:
                    break
        assert "serving on port" in line, proc.stderr.read() if proc.poll() is not None else line
        port = int(line.split("serving on port ")[1].split()[0])
        client = _client("jax", f"127.0.0.1:{port}", default_timeout_s=30.0)
        try:
            req, masks, allocs, gids, caps = estimate_world(9, P=12)
            got = client.batch_estimate(req, masks, allocs, gids, caps, max_nodes=16)
            assert got[2]["route"] == "fleet_batched" and got[2]["bucket"] == "16x4x8"
        finally:
            client.close()
        proc.send_signal(subprocess.signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-2000:]
        assert "drained cleanly" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def expander_options(prov, core, tu):
    p = prov.TestCloudProvider()
    p.add_node_group("few", 0, 10, 0, tu.build_test_node("t1"))
    p.add_node_group("many", 0, 10, 0, tu.build_test_node("t2"))
    p.add_node_group("some", 0, 10, 0, tu.build_test_node("t3"))
    gs = {g.id(): g for g in p.node_groups()}
    return [core.Option(gs["few"], 1, [tu.build_test_pod("a")]),
            core.Option(gs["many"], 2, [tu.build_test_pod(f"x{i}") for i in range(3)]),
            core.Option(gs["some"], 1, [tu.build_test_pod(f"y{i}") for i in range(2)])]


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_grpc_expander_chooses_as_the_jax_package(server_pkg):
    side = Sidecar(server_pkg)
    try:
        picks = {}
        for pkg, (prov, core, tu) in {"jax": (jprov, jcore, jtu),
                                      "torch": (tprov, tcore, ttu)}.items():
            strategy = core.build_strategy(["grpc"], grpc_target=side.target, seed=0)
            options = expander_options(prov, core, tu)
            best = strategy.best_option(options)
            picks[pkg] = (best.node_group.id(), [
                o.node_group.id() for o in strategy.filters[0].best_options(options)])
        assert picks["torch"] == picks["jax"] == ("many", ["many"])
    finally:
        side.stop()


def test_grpc_expander_fails_open_in_both_packages():
    for prov, core, tu in ((jprov, jcore, jtu), (tprov, tcore, ttu)):
        p = prov.TestCloudProvider()
        p.add_node_group("g", 0, 10, 0, tu.build_test_node("t"))
        options = [core.Option(p.node_groups()[0], 1, [tu.build_test_pod("a")])]
        from importlib import import_module

        f = import_module(core.__name__.replace("core", "grpc_")).GRPCFilter("127.0.0.1:1")
        assert f.best_options(options) == options
