"""Scenario batching on the CPU against the JAX package, exactly (tolerance
0: both sides compute the same IEEE f32 products, sums and compares in the
same order, or integer arithmetic):

- ``ops/binpack.ffd_binpack_scenarios`` (the torch loop over S·G groups)
  and ``ops/ffd_scan.ffd_binpack_scenarios_cuda`` (the batched stream of
  K1/K2, on the CPU their plain versions) against the JAX package's vmapped
  XLA scan and ``scenario_binpack_reference``, on seeded worlds with
  padded zero slots, cap-0 groups, decimal memory and a fractional tenant;
- every case of tests/test_parallel.py on a port ``Mesh`` whose shape
  equals the JAX package's 8-device mesh (one CPU device in every slot):
  ``whatif_best_options`` (default and K1/K2 kernels), the multihost
  layout, ``sharded_affinity_estimate`` (torch loop and K3, its gate,
  inert and declared spread), ``sharded_scaledown_step``;
- ``ScenarioStrategy``'s choice on the TestScenarioStrategy cases of
  tests/test_expanders.py and on a wider option set.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autoscaler_tpu.cloudprovider.test_provider as jprov
import autoscaler_tpu.estimator.reference_impl as jref
import autoscaler_tpu.expander.core as jcore
import autoscaler_tpu.expander.scenario as jscen
import autoscaler_tpu.ops.binpack as jbp
import autoscaler_tpu.parallel.mesh as jmesh
import autoscaler_tpu.utils.sharded_worlds as jworlds
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.cloudprovider.test_provider as tprov
import autoscaler_tpu_torch.estimator.binpacking as tbinpacking
import autoscaler_tpu_torch.estimator.reference_impl as tref
import autoscaler_tpu_torch.expander.core as tcore
import autoscaler_tpu_torch.expander.scenario as tscen
import autoscaler_tpu_torch.ops.binpack as tbp
import autoscaler_tpu_torch.ops.ffd_scan as tscan
import autoscaler_tpu_torch.ops.ffd_scan_affinity as taff
import autoscaler_tpu_torch.parallel.mesh as tmesh
import autoscaler_tpu_torch.utils.test_utils as ttu
from autoscaler_tpu.kube.objects import CPU, MEMORY, PODS
from autoscaler_tpu_torch.snapshot.tensors import tensors_from_numpy
from torch_parity import aff_smem

T = torch.tensor


def np_of(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def assert_equal(a, b, what=""):
    a, b = np_of(a), np_of(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


# -- the batched entry ----------------------------------------------------------

S_, P_, G_, R_, M_ = 4, 24, 5, 6, 8   # one shape for every world: one XLA compile


def scen_world(seed, pad_slots=0, zero_caps=0, decimal=False, fractional=False):
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 100, (S_, P_, R_)).astype(np.float32)
    masks = rng.random((S_, G_, P_)) > 0.3
    allocs = rng.integers(50, 400, (S_, G_, R_)).astype(np.float32)
    caps = rng.integers(0, 9, (S_, G_)).astype(np.int32)
    if decimal:   # memory as decimal-M requests against Gi allocatable, in MiB
        req[:, :, MEMORY] = rng.integers(1, 60, (S_, P_)) * 1000**2 / 1024**2
        allocs[:, :, MEMORY] = rng.integers(1, 4, (S_, G_)) * 1024.0
    if fractional:
        req[0, :, CPU] += 0.5
    for s in range(S_ - pad_slots, S_):   # padded zero worlds
        req[s], masks[s], allocs[s], caps[s] = 0, False, 0, 0
    for k in range(zero_caps):             # padded groups: alloc 0, cap 0
        s, g = k % S_, (2 * k + 1) % G_
        allocs[s, g], caps[s, g] = 0, 0
    return req, masks, allocs, caps


SCEN_WORLDS = [
    dict(seed=0), dict(seed=1), dict(seed=2, pad_slots=2), dict(seed=3, zero_caps=3),
    dict(seed=4, decimal=True), dict(seed=5, fractional=True),
    dict(seed=6, pad_slots=1, zero_caps=2, decimal=True),
]


@pytest.mark.parametrize("world", SCEN_WORLDS,
                         ids=lambda w: "-".join(f"{k}{v}" for k, v in w.items()))
def test_scenarios_match_jax_and_oracle(world):
    req, masks, allocs, caps = scen_world(**world)
    want = jbp.ffd_binpack_scenarios(jnp.asarray(req), jnp.asarray(masks),
                                      jnp.asarray(allocs), max_nodes=M_,
                                      scen_caps=jnp.asarray(caps))
    oc, os_ = jref.scenario_binpack_reference(req, masks, allocs, M_, caps)
    assert_equal(want.node_count, oc, "JAX scan vs its oracle")
    assert_equal(want.scheduled, os_, "JAX scan vs its oracle")
    pc, ps = tref.scenario_binpack_reference(req, masks, allocs, M_, caps)
    assert_equal(pc, oc) and assert_equal(ps, os_)
    got = tbp.ffd_binpack_scenarios(T(req), T(masks), T(allocs), max_nodes=M_,
                                    scen_caps=T(caps))
    batched = tscan.ffd_binpack_scenarios_cuda(T(req), T(masks), T(allocs), M_, T(caps))
    for res in (got, batched):
        for field in ("node_count", "scheduled"):
            assert_equal(getattr(res, field), getattr(want, field), field)
        assert res.node_count.dtype == torch.int32 and res.scheduled.dtype == torch.bool
    # the torch loop and the batched launch's glue (from the node each pod
    # took) sum the usage as the XLA scan does, on every world; a solo
    # launch reads it back as alloc - free, as its Pallas twin does, which
    # equals the sum where the requests are integers
    assert_equal(got.node_used, want.node_used, "node_used")
    assert_equal(batched.node_used, want.node_used, "node_used")
    integral = not (world.get("decimal") or world.get("fractional"))
    for s in range(S_):
        solo = tscan.ffd_binpack_groups_cuda(T(req[s]), T(masks[s]), T(allocs[s]), M_, T(caps[s]))
        assert_equal(batched.node_count[s], solo.node_count, "node_count")
        assert_equal(batched.scheduled[s], solo.scheduled, "scheduled")
        if integral:
            assert_equal(batched.node_used[s], solo.node_used, "node_used")
    assert int(np_of(got.node_count).sum()) > 0


def test_scenarios_default_caps_and_solo_equality():
    req, masks, allocs, _ = scen_world(7)
    want = jbp.ffd_binpack_scenarios(jnp.asarray(req), jnp.asarray(masks),
                                      jnp.asarray(allocs), max_nodes=M_)
    got = tbp.ffd_binpack_scenarios(T(req), T(masks), T(allocs), max_nodes=M_)
    assert_equal(got.node_count, want.node_count)
    assert_equal(got.scheduled, want.scheduled)
    for s in range(S_):
        solo = tbp.ffd_binpack_groups(T(req[s]), T(masks[s]), T(allocs[s]), max_nodes=M_)
        assert_equal(solo.node_count, got.node_count[s])
        assert_equal(solo.scheduled, got.scheduled[s])


def test_batched_stream_flattens_scenarios():
    """One plan for the batch: a fractional scenario routes it to K1, an
    integral batch to K2; padded slots stream only inactive rows."""
    for fractional, swar in ((False, True), (True, False)):
        req, masks, allocs, caps = scen_world(8, pad_slots=1, fractional=fractional)
        ops = tscan.prepare_scenarios(T(req), T(masks), T(allocs), M_, T(caps))
        assert (ops.plan is not None) == swar
        assert ops.stream.shape[:2] == (S_ * G_, 32)
        inactive = ops.guards if swar else torch.full((ops.stream.shape[2],), float("inf"))
        assert (ops.stream[(S_ - 1) * G_:] == inactive).all()
        assert ops.caps.tolist() == np.minimum(caps, M_).reshape(-1).tolist()


def test_kernel_contracts_are_the_jax_packages():
    assert tbp.KERNEL_CONTRACTS == jbp.KERNEL_CONTRACTS
    assert "ffd_binpack_scenarios" in tbp.KERNEL_CONTRACTS


def test_scenarios_entry_is_observed_once():
    from autoscaler_tpu_torch.ops.telemetry import kernel_observer

    seen = []
    req, masks, allocs, caps = scen_world(9)
    with kernel_observer(lambda fn, a, k: seen.append(fn.__name__)):
        tbp.ffd_binpack_scenarios(T(req), T(masks), T(allocs), max_nodes=M_, scen_caps=T(caps))
    assert seen == ["ffd_binpack_scenarios"]


# -- the mesh: tests/test_parallel.py's cases ------------------------------------


def port_mesh(n=8):
    return tmesh.make_mesh(["cpu"] * n)


def test_factor_mesh_and_mesh_shape():
    for n in (1, 4, 6, 7, 8, 9, 12):
        assert tmesh.factor_mesh(n) == jmesh.factor_mesh(n)
    jm, tm = jmesh.make_mesh(), port_mesh()
    assert dict(tm.shape) == dict(jm.shape) and tm.size == jm.size == 8
    one = tmesh.make_mesh(["cpu"])
    assert one.shape == {"scenario": 1, "group": 1} and one.size == 1


def build_whatif(S, G, P_n, seed=0):
    rng = np.random.default_rng(seed)
    pod_req = np.zeros((P_n, 6), np.float32)
    pod_req[:, CPU] = rng.integers(100, 900, P_n)
    pod_req[:, MEMORY] = rng.integers(128, 1024, P_n)
    pod_req[:, PODS] = 1
    masks = np.ones((G, P_n), bool)
    allocs = np.zeros((S, G, 6), np.float32)
    allocs[:, :, CPU] = rng.integers(2000, 8000, (S, G))
    allocs[:, :, MEMORY] = rng.integers(4096, 16384, (S, G))
    allocs[:, :, PODS] = 110
    prices = rng.uniform(0.5, 3.0, (S, G)).astype(np.float32)
    caps = np.full(G, 32, np.int32)
    return pod_req, masks, allocs, prices, caps


def assert_whatif_equal(got, want):
    for field in ("node_counts", "total_costs", "best_group", "best_cost"):
        assert_equal(getattr(got, field), getattr(want, field), field)


WHATIF_CASES = [
    # (S, G, P, max_nodes, seed, mesh devices): the JAX tests' shapes
    (8, 4, 64, 32, 0, 8), (2, 3, 32, 16, 5, 1), (8, 4, 16, 8, 5, 8),
]


@pytest.mark.parametrize("S,G,P_n,M,seed,n", WHATIF_CASES)
def test_whatif_matches_jax(S, G, P_n, M, seed, n):
    w = build_whatif(S, G, P_n, seed)
    want = jmesh.whatif_best_options(
        jmesh.make_mesh(jax.devices()[:n]), *(jnp.asarray(a) for a in w), max_nodes=M)
    got = tmesh.whatif_best_options(port_mesh(n), *(T(a) for a in w), max_nodes=M)
    assert_whatif_equal(got, want)
    assert got.node_counts.dtype == torch.int32 and got.best_group.dtype == torch.int32
    # the serial oracle per scenario, as the JAX test checks it
    for s in range(S):
        ref_counts, ref_scheds = jref.ffd_binpack_reference_groups(w[0], w[1], w[2][s],
                                                                   max_nodes=M)
        assert_equal(got.node_counts[s], np.minimum(ref_counts, M))


def test_whatif_block_layout_joins_groups_in_mesh_order():
    """A world whose best group sits in the second group block: the port's
    joined costs and first argmin are the JAX all_gather's."""
    S, G, P_n, M = 4, 4, 16, 8
    w = list(build_whatif(S, G, P_n, seed=2))
    w[3][:, :] = 5.0
    w[3][:, 3] = 0.25      # group 3: second block of a 2-wide group axis
    w[3][1, 2] = 0.25      # a tie in scenario 1: the first minimum wins
    want = jmesh.whatif_best_options(jmesh.make_mesh(), *(jnp.asarray(a) for a in w),
                                     max_nodes=M)
    got = tmesh.whatif_best_options(port_mesh(), *(T(a) for a in w), max_nodes=M)
    assert_whatif_equal(got, want)
    assert (np_of(got.best_group) >= 2).all()   # every winner in the second block


def test_kernel_whatif_matches_jax_pallas():
    """test_pallas_whatif_matches_reference: K1/K2 (their plain versions on
    the CPU) through scenario_loop against the Pallas twin."""
    from autoscaler_tpu.ops.pallas_binpack import ffd_binpack_groups_pallas

    S, G, P_n, M = 4, 4, 96, 16
    w = list(build_whatif(S, G, P_n, seed=11))
    w[4] = np.full(G, M, np.int32)
    want = jmesh.whatif_best_options(
        jmesh.make_mesh(), *(jnp.asarray(a) for a in w), max_nodes=M,
        binpack_fn=ffd_binpack_groups_pallas, scenario_loop=True)
    got = tmesh.whatif_best_options(
        port_mesh(), *(T(a) for a in w), max_nodes=M,
        binpack_fn=tscan.ffd_binpack_groups_cuda, scenario_loop=True)
    assert_whatif_equal(got, want)


class _StubDevice:
    def __init__(self, pid, did):
        self.process_index = pid
        self.id = did

    def __repr__(self):
        return f"d{self.process_index}.{self.id}"


@pytest.mark.parametrize("n_hosts,per_host", [(1, 8), (2, 4), (4, 8), (3, 4)])
def test_multihost_layout_matches_jax(n_hosts, per_host):
    devs = [_StubDevice(h, h * per_host + i) for h in range(n_hosts) for i in range(per_host)]
    want = jmesh.arrange_devices_for_hosts(devs)
    got = tmesh.arrange_devices_for_hosts(devs)
    assert got.shape == want.shape
    assert [[d.id for d in row] for row in got] == [[d.id for d in row] for row in want]
    if n_hosts > 1:
        for row in got:
            assert len({d.process_index for d in row}) == 1
    mesh = tmesh.make_multihost_mesh(devs)
    assert mesh.shape == dict(zip(("scenario", "group"), want.shape))


def test_heterogeneous_fleet_rejected_in_both():
    devs = [_StubDevice(0, 0), _StubDevice(0, 1), _StubDevice(1, 2)]
    for mod in (jmesh, tmesh):
        with pytest.raises(ValueError, match="heterogeneous"):
            mod.arrange_devices_for_hosts(devs)


def test_multihost_mesh_runs_whatif():
    """test_multihost_mesh_runs_whatif_on_virtual_devices: one host's eight
    CPU slots through make_multihost_mesh, against the JAX package's."""
    import types

    cpu = torch.device("cpu")
    devs = [types.SimpleNamespace(process_index=0, id=i) for i in range(8)]
    layout = tmesh.arrange_devices_for_hosts(devs)
    mesh = tmesh.Mesh(np.vectorize(lambda d: cpu, otypes=[object])(layout),
                      ("scenario", "group"))
    jm = jmesh.make_multihost_mesh(jax.devices()[:8])
    assert mesh.shape == dict(jm.shape)
    rng = np.random.default_rng(5)
    s_dim, g_dim = mesh.shape["scenario"], mesh.shape["group"]
    S, G, P_n, M = 2 * s_dim, 2 * g_dim, 16, 8
    pod_req = np.zeros((P_n, 6), np.float32)
    pod_req[:, CPU] = rng.integers(100, 1500, P_n)
    pod_req[:, PODS] = 1
    allocs = np.zeros((S, G, 6), np.float32)
    allocs[:, :, CPU] = rng.integers(2000, 8000, (S, G))
    allocs[:, :, PODS] = 110
    prices = rng.uniform(0.5, 3.0, (S, G)).astype(np.float32)
    args = (pod_req, np.ones((G, P_n), bool), allocs, prices, np.full(G, M, np.int32))
    want = jmesh.whatif_best_options(jm, *(jnp.asarray(a) for a in args), max_nodes=M)
    got = tmesh.whatif_best_options(mesh, *(T(a) for a in args), max_nodes=M)
    assert_whatif_equal(got, want)
    assert (np_of(got.node_counts) >= 1).all()


def group_meshes(n=8):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), ("group",)), tmesh.Mesh(["cpu"] * n, ("group",))


AFF_KEYS = ("pod_req", "pod_masks", "template_allocs", "node_caps")
TERM_KEYS = ("match", "aff_of", "anti_of", "node_level", "has_label")


def affinity_args(w, M, conv):
    return [conv(w[k]) for k in AFF_KEYS[:3]] + [conv(w["node_caps"]), M] + [
        conv(w[k]) for k in TERM_KEYS]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_sharded_affinity_matches_jax_and_oracle(seed, use_pallas):
    jm, tm = group_meshes()
    G, P_n, T_, M = 8, 96, 4, 24
    w = jworlds.affinity_world(G, P_n, T_, M, seed=seed)
    want = jmesh.sharded_affinity_estimate(jm, *affinity_args(w, M, jnp.asarray))
    before = taff.LAUNCHES["ffd_scan_aff"]
    got = tmesh.sharded_affinity_estimate(tm, *affinity_args(w, M, T), use_pallas=use_pallas)
    assert taff.LAUNCHES["ffd_scan_aff"] == before       # the CPU runs K3's plain version
    for field in ("node_count", "scheduled"):
        assert_equal(getattr(got, field), getattr(want, field), field)
    for g in range(G):
        c, s = jref.ffd_binpack_reference_affinity(
            w["pod_req"], w["pod_masks"][g], w["template_allocs"][g], M, w["match"],
            w["aff_of"], w["anti_of"], w["node_level"], w["has_label"][g])
        assert int(got.node_count[g]) == c
        assert_equal(got.scheduled[g], s)


@pytest.fixture()
def k3_gate_as_on_a_card(monkeypatch):
    """K3's gate decided as on a card (the shared memory from torch_parity's
    stand-in), so the CPU meets the same refusals."""
    real = tbinpacking.affinity_gate
    monkeypatch.setattr(taff, "affinity_smem_bytes", aff_smem)
    monkeypatch.setattr(tbinpacking, "affinity_gate",
                        lambda device, *a: real(torch.device("cuda"), *a))


def test_sharded_affinity_gate_rejects_oversize(k3_gate_as_on_a_card):
    jm, tm = group_meshes()
    G, P_n, T_, M = 8, 96, 4, 24
    w = jworlds.affinity_world(G, P_n, T_, M, seed=0)
    with pytest.raises(ValueError, match="VMEM gate"):
        jmesh.sharded_affinity_estimate(jm, *affinity_args(w, 65536, jnp.asarray),
                                        use_pallas=True)
    with pytest.raises(ValueError, match="K3's gate \\(smem"):
        tmesh.sharded_affinity_estimate(tm, *affinity_args(w, 65536, T), use_pallas=True)


def test_sharded_affinity_spread_matches_unsharded():
    jm, tm = group_meshes()
    G, M = 8, 12
    spw, spread = jworlds.spread_world(G, 24, M)
    want = jmesh.sharded_affinity_estimate(jm, *affinity_args(spw, M, jnp.asarray),
                                           spread=tuple(jnp.asarray(a) for a in spread))
    unsharded = tbp.ffd_binpack_groups_affinity(
        *(T(spw[k]) for k in AFF_KEYS[:3]), max_nodes=M,
        **{k: T(spw[k]) for k in TERM_KEYS}, node_caps=T(spw["node_caps"]),
        spread=tuple(T(np.asarray(a)) for a in spread))
    for use_pallas in (False, True):
        got = tmesh.sharded_affinity_estimate(
            tm, *affinity_args(spw, M, T), spread=tuple(T(np.asarray(a)) for a in spread),
            use_pallas=use_pallas)
        for field in ("node_count", "scheduled"):
            assert_equal(getattr(got, field), getattr(want, field), field)
            assert_equal(getattr(got, field), getattr(unsharded, field), field)
    assert not np_of(unsharded.scheduled).all()   # the spread terms bit


def inert_spread(P_n, G, S, declared=False):
    sp = [np.zeros((P_n, S), bool), np.zeros((P_n, S), bool), np.zeros((S,), bool),
          np.zeros((S,), np.int32), np.zeros((S,), np.int32), np.zeros((G, S), bool),
          np.zeros((G, S), np.int32), np.zeros((G, S), np.int32), np.zeros((G, S), np.int32),
          np.zeros((G, S), np.int32), np.zeros((G, S), bool)]
    if declared:
        sp[0][0, 0] = True
    return sp


def test_inert_spread_rides_the_k3_gate(k3_gate_as_on_a_card):
    jm, tm = group_meshes()
    G, P_n, T_, M = 8, 96, 4, 24
    w = jworlds.affinity_world(G, P_n, T_, M, seed=1)
    sp = inert_spread(P_n, G, 40)
    for use_pallas in (False, True):
        want = jmesh.sharded_affinity_estimate(
            jm, *affinity_args(w, M, jnp.asarray), spread=tuple(jnp.asarray(a) for a in sp),
            use_pallas=use_pallas)
        base = tmesh.sharded_affinity_estimate(tm, *affinity_args(w, M, T),
                                               use_pallas=use_pallas)
        got = tmesh.sharded_affinity_estimate(
            tm, *affinity_args(w, M, T), spread=tuple(T(a) for a in sp), use_pallas=use_pallas)
        for field in ("node_count", "scheduled"):
            assert_equal(getattr(got, field), getattr(base, field), field)
            assert_equal(getattr(got, field), getattr(want, field), field)


def test_declared_wide_spread_still_rejected():
    """Off a card K3's glue runs its plain version, but a declared spread
    past its 32-term bitset is refused there too, as the JAX package does."""
    jm, tm = group_meshes()
    G, P_n, T_, M = 8, 96, 4, 24
    w = jworlds.affinity_world(G, P_n, T_, M, seed=1)
    sp = inert_spread(P_n, G, 40, declared=True)
    with pytest.raises(ValueError, match="VMEM gate"):
        jmesh.sharded_affinity_estimate(
            jm, *affinity_args(w, M, jnp.asarray), spread=tuple(jnp.asarray(a) for a in sp),
            use_pallas=True)
    with pytest.raises(ValueError, match="spread_width"):
        tmesh.sharded_affinity_estimate(
            tm, *affinity_args(w, M, T), spread=tuple(T(a) for a in sp), use_pallas=True)


def port_snap(jsnap):
    import dataclasses

    return tensors_from_numpy({
        f.name: np.asarray(getattr(jsnap, f.name)) for f in dataclasses.fields(jsnap)
        if getattr(jsnap, f.name) is not None}, device="cpu")


def candidate_meshes(n=8):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), ("candidate",)), tmesh.Mesh(["cpu"] * n,
                                                                          ("candidate",))


def assert_feasibility_equal(got, want):
    for field in want._fields:
        assert_equal(getattr(got, field), getattr(want, field), field)


def test_sharded_scaledown_step_matches_jax_and_unsharded():
    import autoscaler_tpu_torch.ops.scaledown as tsd

    jm, tm = candidate_meshes()
    snap, cand, pod_slots, blocked, excluded = jworlds.scaledown_world(24, 64, 8, 6)
    j_per, j_joint = jmesh.sharded_scaledown_step(
        jm, snap, jnp.asarray(cand), jnp.asarray(pod_slots), jnp.asarray(blocked),
        jnp.asarray(excluded))
    ps = port_snap(snap)
    args = (T(cand), T(pod_slots), T(blocked))
    per, joint = tmesh.sharded_scaledown_step(tm, ps, *args, T(excluded))
    assert_feasibility_equal(per, j_per)
    assert_feasibility_equal(joint, j_joint)
    assert_feasibility_equal(per, tsd.removal_feasibility(ps, *args))
    assert_feasibility_equal(joint, tsd.joint_removal_feasibility(ps, T(cand), T(pod_slots),
                                                                  T(excluded)))
    assert np_of(per.feasible).any()


def test_sharded_scaledown_spread_matches_jax():
    jm, tm = candidate_meshes()
    (snap, cand, pod_slots, blocked, excluded,
     spread8, static_counts, cand_sub) = jworlds.scaledown_spread_world()
    j_per, j_joint = jmesh.sharded_scaledown_step(
        jm, snap, jnp.asarray(cand), jnp.asarray(pod_slots), jnp.asarray(blocked),
        jnp.asarray(excluded), spread=spread8, static_counts=static_counts,
        cand_sub=jnp.asarray(cand_sub))
    per, joint = tmesh.sharded_scaledown_step(
        tm, port_snap(snap), T(cand), T(pod_slots), T(blocked), T(excluded),
        spread=tuple(T(np.asarray(a)) for a in spread8), static_counts=T(np.asarray(static_counts)),
        cand_sub=T(np.asarray(cand_sub)))
    assert_feasibility_equal(per, j_per)
    assert_feasibility_equal(joint, j_joint)
    assert np_of(per.feasible).any()


def test_sharded_scaledown_partial_spread_args_rejected():
    _, tm = candidate_meshes()
    snap, cand, pod_slots, blocked, excluded = jworlds.scaledown_world(24, 64, 8, 6)
    with pytest.raises(AssertionError, match="all-or-none"):
        tmesh.sharded_scaledown_step(tm, port_snap(snap), T(cand), T(pod_slots), T(blocked),
                                     T(excluded), spread=((),) * 8)


# -- the scenario expander: tests/test_expanders.py's TestScenarioStrategy -------


def provider_with_groups(prov, tu):
    p = prov.TestCloudProvider()
    p.add_node_group("cheap-pool", 0, 10, 0, tu.build_test_node("c", cpu_m=4000, mem=8 * tu.GB),
                     price_per_hour=0.5)
    p.add_node_group("pricey-pool", 0, 10, 0, tu.build_test_node("e", cpu_m=4000, mem=8 * tu.GB),
                     price_per_hour=5.0)
    return p


def options_for(p, core, tu, case):
    gs = {g.id(): g for g in p.node_groups()}
    if case == "unequal":
        pods_a = [tu.build_test_pod(f"a{i}", cpu_m=500, mem=512 * tu.MB) for i in range(6)]
        return [core.Option(gs["cheap-pool"], 1, pods_a),
                core.Option(gs["pricey-pool"], 1, pods_a[:2])]
    pods = [tu.build_test_pod(f"p{i}", cpu_m=1000, mem=1 * tu.GB) for i in range(4)]
    opts = [core.Option(gs["cheap-pool"], 2, pods), core.Option(gs["pricey-pool"], 2, pods)]
    return opts[:1] if case == "single" else opts


SCENARIO_CASES = [
    ("cheap", dict(base_prices={"cheap-pool": 0.5, "pricey-pool": 5.0}, num_scenarios=8, seed=3)),
    ("single", dict(base_prices={})),
    ("unequal", dict(base_prices={"cheap-pool": 1.0, "pricey-pool": 1.0}, num_scenarios=4,
                     seed=0)),
    ("even", dict(base_prices={"cheap-pool": 1.0, "pricey-pool": 1.0}, num_scenarios=8, seed=7,
                  preemption_prob=0.5)),
]


@pytest.mark.parametrize("case,kw", SCENARIO_CASES, ids=[c for c, _ in SCENARIO_CASES])
@pytest.mark.parametrize("mesh_slots", [None, 8])
def test_scenario_strategy_matches_jax(case, kw, mesh_slots):
    jp = provider_with_groups(jprov, jtu)
    tp = provider_with_groups(tprov, ttu)
    jopts = options_for(jp, jcore, jtu, case)
    topts = options_for(tp, tcore, ttu, case)
    jmesh_ = None if mesh_slots is None else jmesh.make_mesh()
    tmesh_ = tmesh.make_mesh(["cpu"] * (mesh_slots or 1))
    want = jscen.ScenarioStrategy(**kw, mesh=jmesh_).best_option(jopts)
    strat = tscen.ScenarioStrategy(**kw, mesh=tmesh_)
    got = strat.best_option(topts)
    assert got.node_group.id() == want.node_group.id()
    assert topts.index(got) == jopts.index(want)
    if len(topts) > 1:
        assert strat.last_route == "torch_scan"     # no card: the torch loop serves
    if case == "cheap":
        assert got.node_group.id() == "cheap-pool"
    if case == "single":
        assert got is topts[0]


def test_scenario_strategy_wide_options_match_jax():
    """Twelve groups of mixed templates, caps from max - target, extended
    resources, a mesh that pads G: every scenario's winner and the modal
    choice equal the JAX package's."""
    rng = np.random.default_rng(4)
    made = {}
    for pkg, (prov, core, tu) in {"jax": (jprov, jcore, jtu), "torch": (tprov, tcore, ttu)}.items():
        r = np.random.default_rng(4)
        p = prov.TestCloudProvider()
        pods = [tu.build_test_pod(f"p{i}", cpu_m=float(r.integers(100, 3000)),
                                  mem=float(r.integers(64, 4096)) * tu.MB) for i in range(40)]
        opts = []
        for g in range(11):
            p.add_node_group(f"g{g}", 0, int(r.integers(2, 20)), int(r.integers(0, 2)),
                             tu.build_test_node(f"t{g}", cpu_m=float(r.choice([2000, 4000, 8000])),
                                                mem=float(r.choice([4, 8, 16])) * tu.GB))
        gs = {g.id(): g for g in p.node_groups()}
        for g in range(11):
            sel = r.random(40) < 0.6
            opts.append(core.Option(gs[f"g{g}"], 1, [q for q, s in zip(pods, sel) if s]))
        made[pkg] = opts
    prices = {f"g{g}": float(rng.uniform(0.5, 3.0)) for g in range(11)}
    kw = dict(base_prices=prices, num_scenarios=8, seed=2, max_nodes=16)
    want = jscen.ScenarioStrategy(**kw, mesh=jmesh.make_mesh()).best_option(made["jax"])
    strat = tscen.ScenarioStrategy(**kw, mesh=port_mesh())
    got = strat.best_option(made["torch"])
    assert made["torch"].index(got) == made["jax"].index(want)
    res = jmesh.whatif_best_options(
        jmesh.make_mesh(), *(jnp.asarray(a) for a in strat.operands(made["torch"], 8, 2)),
        max_nodes=16)
    assert_whatif_equal(strat.last_whatif, res)
