"""Device meshes for multi-scenario what-if evaluation — the port of
``autoscaler_tpu/parallel/mesh.py``.

The two embarrassingly parallel axes of the decision problem are mesh
axes:

- ``scenario`` — independent what-if worlds (spot-pricing scenarios,
  candidate futures, the tenants of one coalesced fleet batch);
- ``group`` — node groups whose expansion options are independent until
  the expander's cross-group argmin (the reference's BestOption,
  expander/expander.go:52), the one reduction across blocks.

``Mesh`` is the port's own: an object array of ``torch.device``s with axis
names, exposing ``.shape[axis]`` and ``.size`` as ``jax.sharding.Mesh``
does. Each function runs every block of its operands on the block's
device in turn and joins the blocks in mesh order, which is what the JAX
package's ``shard_map`` and its ``all_gather`` over the group axis
compute. One device may fill several slots (the CPU parity tests hold the
block layout against the JAX package's 8-device mesh that way); on one
card ``make_mesh()`` is 1×1. Results land on the mesh's first device.

The kernels are the port's: ``whatif_best_options`` takes any
``binpack_fn`` with ``ffd_binpack_groups``'s signature (``ops/ffd_scan.
ffd_binpack_groups_cuda`` is K1/K2), ``sharded_affinity_estimate
(use_pallas=True)`` launches K3 (``ops/ffd_scan_affinity``), and
``fleet_batch_estimate`` serves a whole coalesced batch in one K1/K2
launch on a card (``ops/ffd_scan.ffd_binpack_scenarios_cuda``), counting
the route it took in ``FLEET_ROUTES``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.kube.objects import PODS
from autoscaler_tpu_torch.ops.binpack import (
    BinpackResult,
    ffd_binpack_groups,
    ffd_binpack_scenarios,
)

UNSCHEDULED_PENALTY = 1.0e6  # cost per pod left pending, dominates node price

# Routes of fleet_batch_estimate on a card: "cuda" is one K1/K2 launch for
# the batch, "torch_scan" the torch loop past the kernels' shared-memory
# gate (plain_gate's "smem"). Off a card the torch loop serves uncounted.
FLEET_ROUTES = {"cuda": 0, "torch_scan": 0}


class Mesh:
    """A grid of devices with named axes: ``devices`` is an object ndarray
    of ``torch.device``s (a device name given is made one), ``shape`` maps
    each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.vectorize(
            lambda d: torch.device(d) if isinstance(d, str) else d, otypes=[object]
        )(np.asarray(devices, dtype=object))
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"a {grid.ndim}-d device grid needs {grid.ndim} axis names, "
                f"got {tuple(axis_names)}"
            )
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.ravel().tolist()})"


def _device_grid(devices: Sequence, shape) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = list(devices)
    return grid.reshape(shape)


def factor_mesh(n: int) -> tuple[int, int]:
    """Split n devices into (scenario, group) dims, group dim = largest
    divisor <= sqrt(n) so both axes get parallelism when possible."""
    g = 1
    for d in range(int(n**0.5), 0, -1):
        if n % d == 0:
            g = d
            break
    return n // g, g


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A (scenario, group) mesh over ``devices`` (torch devices or their
    names); None is one slot on the default device (the first card)."""
    devices = [resolve_device(None)] if devices is None else [
        resolve_device(d) for d in devices
    ]
    s, g = factor_mesh(len(devices))
    return Mesh(_device_grid(devices, (s, g)), ("scenario", "group"))


def arrange_devices_for_hosts(devices: Sequence) -> np.ndarray:
    """[scenario, group] device grid for a (possibly multi-host) fleet.

    The ``group`` axis carries the only reduction across blocks (the
    expander's cross-group argmin), so it stays inside a host; the
    ``scenario`` axis is embarrassingly parallel and spans hosts. Falls
    back to the flat single-host factorization when every device shares a
    process. Duck-typed on ``.process_index``; requires a homogeneous
    fleet (same device count per host)."""
    by_host: dict = {}
    for d in devices:
        by_host.setdefault(d.process_index, []).append(d)
    hosts = [by_host[k] for k in sorted(by_host)]
    n_hosts = len(hosts)
    per_host = len(hosts[0])
    if any(len(h) != per_host for h in hosts):
        raise ValueError(
            f"heterogeneous fleet: {[len(h) for h in hosts]} devices per host"
        )
    if n_hosts == 1:
        s, g = factor_mesh(per_host)
        return _device_grid(hosts[0], (s, g))
    # groups get a host's whole set of devices: with n_hosts > 1 the
    # scenario axis already has host-level parallelism
    s_local, g = 1, per_host
    grid = np.empty((n_hosts * s_local, g), dtype=object)
    for hi, host_devs in enumerate(hosts):
        grid[hi * s_local : (hi + 1) * s_local, :] = _device_grid(
            host_devs, (s_local, g)
        )
    return grid


def make_multihost_mesh(devices: Sequence) -> Mesh:
    """Mesh for a multi-host fleet from the device objects given (each
    with ``.process_index``): scenario axis across hosts, group axis within
    each host. On one host this equals make_mesh's layout."""
    return Mesh(arrange_devices_for_hosts(list(devices)), ("scenario", "group"))


def _to(x, dev: torch.device):
    """Move a tensor, a tuple of them or a dataclass of them (a
    SnapshotTensors) to ``dev``; None stays None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        return tuple(_to(v, dev) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), dev) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), (torch.Tensor, tuple))
        })
    return x


def _blocks(n: int, parts: int):
    step = n // parts
    return [slice(i * step, (i + 1) * step) for i in range(parts)]


class WhatIfResult(NamedTuple):
    node_counts: torch.Tensor  # [S, G] i32 — nodes needed per scenario × group
    total_costs: torch.Tensor  # [S, G] f32 — price·count + penalty·unscheduled
    best_group: torch.Tensor   # [S] i32 — expander argmin per scenario
    best_cost: torch.Tensor    # [S] f32


def _whatif_local(pod_req, pod_masks, allocs, prices, caps, *, max_nodes,
                  binpack_fn=None, scenario_loop=False):
    """One (scenario, group) block: FFD for each scenario, then each
    group's cost. The cost is two f32 products and a sum, each a separate
    eager kernel (no fused multiply-add), as the scores are computed.
    ``binpack_fn`` (``ffd_binpack_groups``'s signature) runs once a
    scenario; without one and without ``scenario_loop`` the block's
    scenarios go through ``ffd_binpack_scenarios`` in one loop."""
    S_loc, G_loc = allocs.shape[0], allocs.shape[1]
    P = pod_req.shape[0]
    valid = pod_req[:, PODS] > 0  # real pods carry a pods-count of 1
    if binpack_fn is None and not scenario_loop:
        # graftlint: disable=GL003 — the what-if block's default kernel (the JAX twin's vmapped ffd_binpack_groups, reached there through a variable): what-if serving runs the torch scan on the block directly, as the JAX package does
        res = ffd_binpack_scenarios(
            pod_req.expand(S_loc, P, pod_req.shape[1]),
            pod_masks.expand(S_loc, G_loc, P),
            allocs,
            max_nodes=max_nodes,
            scen_caps=caps.expand(S_loc, G_loc),
        )
        counts, scheduled = res.node_count, res.scheduled            # [S, G(, P)]
    else:
        kern = binpack_fn if binpack_fn is not None else ffd_binpack_groups
        outs = [
            kern(pod_req, pod_masks, allocs[s], max_nodes=max_nodes, node_caps=caps)
            for s in range(S_loc)
        ]
        counts = torch.stack([o.node_count for o in outs])
        scheduled = torch.stack([o.scheduled for o in outs])
    pending = valid.sum() - (scheduled & valid[None, None, :]).sum(dim=2)
    cost = prices * counts.to(torch.float32)
    cost = cost + UNSCHEDULED_PENALTY * pending.to(torch.float32)
    return counts, cost


def whatif_best_options(
    mesh: Mesh,
    pod_req: torch.Tensor,    # [P, R] shared pending pods
    pod_masks: torch.Tensor,  # [G, P] per-group predicate masks (shared across scenarios)
    allocs: torch.Tensor,     # [S, G, R] per-scenario template capacities
    prices: torch.Tensor,     # [S, G] per-scenario per-group node price
    caps: torch.Tensor,       # [G] i32 per-group node caps
    max_nodes: int,
    binpack_fn=None,
    scenario_loop: bool = False,
) -> WhatIfResult:
    """Full multi-scenario scale-up evaluation over the mesh's blocks.

    S must divide by mesh['scenario'], G by mesh['group'] (pad upstream).
    ``binpack_fn``/``scenario_loop``: see _whatif_local — K1/K2 run with
    ``binpack_fn=ffd_binpack_groups_cuda, scenario_loop=True``. Each
    scenario's best group is the first argmin over the costs of all its
    group blocks, joined in mesh order."""
    s_dim = mesh.shape["scenario"]
    g_dim = mesh.shape["group"]
    S, G = allocs.shape[0], allocs.shape[1]
    assert S % s_dim == 0, f"S={S} not divisible by scenario dim {s_dim}"
    assert G % g_dim == 0, f"G={G} not divisible by group dim {g_dim}"
    home = mesh.devices.flat[0]
    count_rows, cost_rows = [], []
    for i, ss in enumerate(_blocks(S, s_dim)):
        row_counts, row_costs = [], []
        for j, gs in enumerate(_blocks(G, g_dim)):
            dev = mesh.devices[i, j]
            c, k = _whatif_local(
                pod_req.to(dev), pod_masks[gs].to(dev), allocs[ss, gs].to(dev),
                prices[ss, gs].to(dev), caps[gs].to(dev), max_nodes=max_nodes,
                binpack_fn=binpack_fn, scenario_loop=scenario_loop,
            )
            row_counts.append(c.to(home))
            row_costs.append(k.to(home))
        count_rows.append(torch.cat(row_counts, dim=1))
        cost_rows.append(torch.cat(row_costs, dim=1))
    counts = torch.cat(count_rows).to(torch.int32)
    costs = torch.cat(cost_rows)
    best_cost, best = torch.min(costs, dim=1)  # the first minimum
    return WhatIfResult(counts, costs, best.to(torch.int32), best_cost)


def _affinity_gate_or_raise(device, R, T, S, max_nodes):
    """K3's shape gate for ``use_pallas``: a shape K3 cannot carry (over
    its spread bitset or a block's shared memory) fails loudly at the
    call, naming the knob that routes around it. Off a card the K3 glue
    runs its plain version, so only the spread width is checked there."""
    from autoscaler_tpu_torch.estimator.binpacking import affinity_gate
    from autoscaler_tpu_torch.ops.ffd_scan_affinity import MAX_SPREAD

    gate = affinity_gate(device, R, T, S, max_nodes)
    if gate is not None and gate[0] == "not_cuda":
        gate = ("spread_width", gate[1]) if S > MAX_SPREAD else None
    if gate is not None:
        raise ValueError(
            f"shape exceeds K3's gate ({gate[0]}: {gate[1]}); pass "
            "use_pallas=False to ride the torch loop like the estimator's "
            "fallback route"
        )


def sharded_affinity_estimate(
    mesh: Mesh,
    pod_req: torch.Tensor,     # [P, R]
    pod_masks: torch.Tensor,   # [G, P]
    allocs: torch.Tensor,      # [G, R]
    caps: Optional[torch.Tensor],  # [G] i32 (None: max_nodes)
    max_nodes: int,
    match: torch.Tensor,       # [T, P]
    aff_of: torch.Tensor,      # [T, P]
    anti_of: torch.Tensor,     # [T, P]
    node_level: torch.Tensor,  # [T]
    has_label: torch.Tensor,   # [G, T]
    spread: tuple | None = None,  # SpreadTermTensors 11-tuple (G-axis at 5..10)
    use_pallas: bool = False,     # route K3 (ops/ffd_scan_affinity)
) -> BinpackResult:
    """Dynamic inter-pod-affinity (+hard-spread) FFD estimation over a 1-D
    ``group`` mesh: each device runs the whole scan for its block of
    groups (per-group affinity and spread state is independent across
    groups, so the group axis needs no reduction). Term tensors and the
    shared pod matrix go to every block; [G, ·] tensors (masks, allocs,
    caps, has_label, and the spread tuple's slots 5-10) split.
    ``use_pallas`` runs each block through K3
    (``ffd_binpack_groups_affinity_cuda``) behind its shape gate."""
    from autoscaler_tpu_torch.ops.binpack import ffd_binpack_groups_affinity
    from autoscaler_tpu_torch.ops.ffd_scan_affinity import (
        ffd_binpack_groups_affinity_cuda,
    )

    # inert spread tuples gate as S=0, like the estimator route's
    # sp_of.any() check: undeclared terms cannot affect placement
    if spread is not None and not bool(torch.as_tensor(spread[0]).any()):
        spread = None
    g_dim = mesh.shape["group"]
    G = pod_masks.shape[0]
    assert G % g_dim == 0, f"G={G} not divisible by group dim {g_dim}"
    if use_pallas:
        S = int(spread[2].shape[0]) if spread is not None else 0
        for dev in mesh.devices.ravel():
            _affinity_gate_or_raise(
                dev, int(pod_req.shape[1]), int(match.shape[0]), S, max_nodes
            )
    kern = ffd_binpack_groups_affinity_cuda if use_pallas else ffd_binpack_groups_affinity
    if caps is None:
        caps = torch.full((G,), max_nodes, dtype=torch.int32, device=pod_req.device)
    home = mesh.devices.flat[0]
    outs = []
    for dev, gs in zip(mesh.devices.ravel(), _blocks(G, g_dim)):
        sp = None
        if spread is not None:
            sp = tuple(_to(a, dev) for a in spread[:5]) + tuple(
                _to(a[gs], dev) for a in spread[5:]
            )
        res = kern(
            pod_req.to(dev), pod_masks[gs].to(dev), allocs[gs].to(dev),
            max_nodes=max_nodes, match=match.to(dev), aff_of=aff_of.to(dev),
            anti_of=anti_of.to(dev), node_level=node_level.to(dev),
            has_label=has_label[gs].to(dev), node_caps=caps[gs].to(dev),
            spread=sp,
        )
        outs.append(_to(tuple(res), home))
    return BinpackResult(*(torch.cat(parts) for parts in zip(*outs)))


def fleet_batch_estimate(
    mesh: Optional[Mesh],
    scen_req,     # [S, P, R] f32 — per-tenant pod matrices, bucket-padded
    scen_masks,   # [S, G, P] bool
    scen_allocs,  # [S, G, R] f32
    scen_caps,    # [S, G] i32 — per-tenant caps (already min'd w/ tenant max)
    max_nodes: int,
    device=None,
):
    """One coalesced multi-tenant batch → (counts [S, G] i32, scheduled
    [S, G, P] bool), as numpy: the fleet serving dispatch. The scenario
    axis carries independent tenants and the group axis each tenant's node
    groups; no data flows between tenants, so each verdict equals a solo
    dispatch of the same operands.

    A block on a card is ONE K1/K2 launch over its S·G groups
    (``ffd_binpack_scenarios_cuda``) when the kernels' carry fits a
    block's shared memory (``plain_gate``), else the torch loop
    ``ffd_binpack_scenarios``; ``FLEET_ROUTES`` counts which. Off a card
    the torch loop serves. ``mesh=None`` (or a 1-slot mesh) dispatches the
    batch whole on ``device`` (None: the mesh's device, else the first
    card). A batch that does not tile the mesh is served whole on the
    mesh's first device. Dispatch rides the fleet coalescer's ladder
    (fleet/coalescer.py)."""
    scen_req = np.asarray(scen_req, np.float32)
    scen_masks = np.asarray(scen_masks, bool)
    scen_allocs = np.asarray(scen_allocs, np.float32)
    scen_caps = np.asarray(scen_caps, np.int32)
    S, G = scen_masks.shape[0], scen_masks.shape[1]
    if mesh is None:
        blocks = [(resolve_device(device), slice(None), slice(None))]
    elif mesh.size == 1 or S % mesh.shape["scenario"] or G % mesh.shape["group"]:
        blocks = [(mesh.devices.flat[0], slice(None), slice(None))]
    else:
        blocks = [
            (mesh.devices[i, j], ss, gs)
            for i, ss in enumerate(_blocks(S, mesh.shape["scenario"]))
            for j, gs in enumerate(_blocks(G, mesh.shape["group"]))
        ]
    counts = np.zeros((S, G), np.int32)
    scheduled = np.zeros(scen_masks.shape, bool)
    for dev, ss, gs in blocks:
        c, s = _fleet_block(
            dev, scen_req[ss], scen_masks[ss, gs], scen_allocs[ss, gs],
            scen_caps[ss, gs], max_nodes,
        )
        counts[ss, gs] = c
        scheduled[ss, gs] = s
    return counts, scheduled


def _fleet_block(dev, scen_req, scen_masks, scen_allocs, scen_caps, max_nodes):
    from autoscaler_tpu_torch.estimator.binpacking import plain_gate
    from autoscaler_tpu_torch.ops import ffd_scan

    req = torch.tensor(scen_req, device=dev)
    masks = torch.tensor(scen_masks, device=dev)
    allocs = torch.tensor(scen_allocs, device=dev)
    caps = torch.tensor(scen_caps, device=dev)
    res = None
    if dev.type == "cuda" and req.shape[1] > 0 and masks.shape[1] > 0:
        S, P, R = req.shape
        G = masks.shape[1]
        plan = ffd_scan.plan_scan(req.reshape(S * P, R), allocs.reshape(S * G, R))
        if plain_gate(dev, plan.planes, max_nodes) is None:
            # graftlint: disable=GL003 — fleet batched dispatch entry: the fleet ladder (fleet/coalescer._dispatch_batch) wraps THIS call as its strict cuda rung; a kernel fault raises there, on the card, by design
            res = ffd_scan.ffd_binpack_scenarios_cuda(
                req, masks, allocs, max_nodes, caps, scan_plan=plan
            )
            FLEET_ROUTES["cuda"] += 1
        else:
            FLEET_ROUTES["torch_scan"] += 1
    if res is None:
        # graftlint: disable=GL003 — same fleet dispatch entry as the cuda branch above (its torch rung); the fleet ladder wraps the call
        res = ffd_binpack_scenarios(req, masks, allocs, max_nodes=max_nodes, scen_caps=caps)
    return res.node_count.cpu().numpy(), res.scheduled.cpu().numpy()


def fleet_solo_estimate(
    pod_req,          # [P, R] f32 — one tenant's exact (unpadded) operands
    pod_masks,        # [G, P] bool
    template_allocs,  # [G, R] f32
    node_caps,        # [G] i32
    max_nodes: int,
    device=None,
):
    """One tenant's request dispatched alone — the baseline side of the
    fleet fairness certificate: what the tenant would get paying its own
    dispatch. On a card that is K1/K2 (``ffd_binpack_groups_cuda``) when
    the carry fits a block's shared memory, else (and off a card) the
    torch loop ``ffd_binpack_groups``. → (counts [G] i32, scheduled
    [G, P] bool) numpy."""
    from autoscaler_tpu_torch.estimator.binpacking import plain_gate
    from autoscaler_tpu_torch.ops import ffd_scan

    dev = resolve_device(device)
    args = ffd_scan.operands_from_numpy(
        pod_req, pod_masks, template_allocs, node_caps, device=dev
    )
    res = None
    if dev.type == "cuda" and args[0].shape[0] > 0 and args[1].shape[0] > 0:
        plan = ffd_scan.plan_scan(args[0], args[2])
        if plain_gate(dev, plan.planes, max_nodes) is None:
            # graftlint: disable=GL003 — the solo certification/bench baseline: deliberately ladder-free so the comparison isolates batching, not resilience
            res = ffd_scan.ffd_binpack_groups_cuda(
                *args[:3], max_nodes, args[3], scan_plan=plan
            )
    if res is None:
        # graftlint: disable=GL003 — the solo certification/bench baseline: deliberately ladder-free so the comparison isolates batching, not resilience
        res = ffd_binpack_groups(*args[:3], max_nodes=max_nodes, node_caps=args[3])
    return res.node_count.cpu().numpy(), res.scheduled.cpu().numpy()


def sharded_scaledown_step(
    mesh: Mesh,
    snap,                            # SnapshotTensors (every block gets it)
    candidate_nodes: torch.Tensor,   # [C] i32 — C divisible by the mesh size
    pod_slots: torch.Tensor,         # [C, S]
    blocked: torch.Tensor,           # [C] bool
    excluded: torch.Tensor,          # [N] bool — nodes leaving in the joint plan
    spread: tuple | None = None,     # 8-tensor schedule context
    static_counts: torch.Tensor | None = None,  # [S, D]
    cand_sub: torch.Tensor | None = None,       # [C, S]
):
    """The scale-down decision step on a 1-D ``candidate`` mesh:

    1. per-candidate categorization over the candidate blocks (each lane
       refits one drained node's movable pods — reference planner.go:252
       categorizeNodes);
    2. the blocks' candidates and slots joined in mesh order;
    3. the sequential joint re-validation (reference actuator.go:371) on
       the joined set, once (it shares one capacity carry).

    Returns (per_candidate: RemovalFeasibility over [C], joint:
    RemovalFeasibility over [C]) on the mesh's first device."""
    from autoscaler_tpu_torch.ops.scaledown import (
        RemovalFeasibility,
        joint_removal_feasibility,
        joint_removal_feasibility_spread,
        removal_feasibility,
        removal_feasibility_spread,
    )

    n_dev = mesh.shape["candidate"]
    C = candidate_nodes.shape[0]
    assert C % n_dev == 0, f"C={C} not divisible by mesh size {n_dev}"
    # the spread trio travels together
    opts = (spread is None, static_counts is None, cand_sub is None)
    assert all(opts) or not any(opts), (
        "spread, static_counts and cand_sub must be passed all-or-none"
    )
    home = mesh.devices.flat[0]
    pers = []
    for dev, cs in zip(mesh.devices.ravel(), _blocks(C, n_dev)):
        s_dev = _to(snap, dev)
        if spread is not None:
            per = removal_feasibility_spread(
                s_dev, candidate_nodes[cs].to(dev), pod_slots[cs].to(dev),
                blocked[cs].to(dev), _to(spread, dev), static_counts.to(dev),
                cand_sub[cs].to(dev),
            )
        else:
            per = removal_feasibility(
                s_dev, candidate_nodes[cs].to(dev), pod_slots[cs].to(dev),
                blocked[cs].to(dev),
            )
        pers.append(_to(tuple(per), home))
    per = RemovalFeasibility(*(torch.cat(parts) for parts in zip(*pers)))
    s_home = _to(snap, home)
    if spread is not None:
        joint = joint_removal_feasibility_spread(
            s_home, candidate_nodes.to(home), pod_slots.to(home), excluded.to(home),
            _to(spread, home), static_counts.to(home), cand_sub.to(home),
        )
    else:
        joint = joint_removal_feasibility(
            s_home, candidate_nodes.to(home), pod_slots.to(home), excluded.to(home)
        )
    return per, joint
