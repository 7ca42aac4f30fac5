"""The scale-down half of a reconcile tick on the card, alone: chip_smoke's
two scale-down runs (3m, 3n), their split, the removal dispatch's profile,
and the same runs on the CPU, compared field for field.

    python3 -m autoscaler_tpu_torch.tools.scaledown_probe             # one card
    python3 -m autoscaler_tpu_torch.tools.scaledown_probe --device cpu

The world is the snapshot probe's (``utils/workload.build_snapshot_world``:
15k nodes, 100k pods of 300 apps, one in seven pending, a host-port
DaemonSet on 5k nodes) after a scale-in: every placed pod of apps
``app-0`` … ``app-99`` is gone (``scale_in_listing``), a third of the
deployments scaled in after a peak. For 3n the placed pods of the next 24
apps also carry a zone DoNotSchedule spread (maxSkew 1). The provider has
one node group per node shape (``shape_provider``: cores × memory, min 0)
owning the world's nodes; a ``FakeClusterAPI`` holds the same listing.

``run_scale_down`` runs the scale-down branch of two reconcile loops
(static_autoscaler.py:788-880): at ``DOWN_TICKS[0]`` the planner's
``update_cluster_state`` over every node (sorted by the candidates-sorting
processor) and ``nodes_to_delete``, whose plan is empty (no node has been
unneeded long enough); at ``DOWN_TICKS[1]`` the same again and then
``ScaleDownActuator.start_deletion``. 3m runs ``AutoscalingOptions()`` as it
stands; 3n (``WIDE_REFIT``) simulates every eligible non-empty node in one
``removal_feasibility_spread`` dispatch and validates ten drains jointly.

chip_smoke.py runs 3m and 3n through ``run_scale_down`` and reports them
through ``split_line`` and ``scaledown_differences``, so both print the
same figures. On a card this tool also repeats 3m whole on the CPU and a
seeded subset of 3n's lanes (and its joint pass whole) there, and exits
non-zero when anything differs.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import numpy as np
import torch

from autoscaler_tpu_torch.cloudprovider.test_provider import TestCloudProvider
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.core.scaledown import eligibility
from autoscaler_tpu_torch.core.scaledown.actuator import ScaleDownActuator
from autoscaler_tpu_torch.core.scaledown.planner import ScaleDownPlanner
from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.kube.api import FakeClusterAPI
from autoscaler_tpu_torch.kube.objects import LabelSelector, TopologySpreadConstraint
from autoscaler_tpu_torch.ops import scaledown
from autoscaler_tpu_torch.processors.pipeline import (
    ScaleDownCandidatesSortingProcessor,
    ScaleDownNodeProcessor,
)
from autoscaler_tpu_torch.simulator import removal
from autoscaler_tpu_torch.tools.tick_probe import listing_snapshot
from autoscaler_tpu_torch.utils.test_utils import MB, build_test_node
from autoscaler_tpu_torch.utils.workload import ZONE, build_snapshot_world

SCALE_IN_APPS = 100      # apps app-0 … app-99 lose every placed pod
SPREAD_IN_APPS = 24      # 3n: the placed pods of the next 24 apps spread by zone
DOWN_TICKS = (0.0, 601.0)  # the two loops' clock (s): 601 s > the 600 s unneeded time
# 3n: every eligible non-empty node in one dispatch, ten drains validated
# jointly (the reference's own flags, main.go:119-134)
WIDE_REFIT = dict(
    scale_down_candidates_pool_ratio=1.0,
    scale_down_non_empty_candidates_count=0,
    max_drain_parallelism=10,
    max_scale_down_parallelism=20,
)
CPU_LANES = 256          # 3n's lanes repeated on the CPU (lanes are independent)


def app_index(pod) -> int:
    """The number of a world pod's ``app-<k>`` label, -1 for others."""
    app = pod.labels.get("app", "")
    return int(app[4:]) if app.startswith("app-") else -1


def scale_in_listing(nodes, pods, removed_apps=SCALE_IN_APPS, spread_apps=0):
    """The listing after a scale-in: the placed pods of apps 0 …
    ``removed_apps`` - 1 are gone; with ``spread_apps``, each placed pod of
    the next ``spread_apps`` apps is a new object carrying a zone
    DoNotSchedule spread (maxSkew 1) on its own app. Every other object
    stays the same Python object. → (nodes, pods)."""
    out = []
    for pod in pods:
        k = app_index(pod)
        if pod.node_name and 0 <= k < removed_apps:
            continue
        if pod.node_name and removed_apps <= k < removed_apps + spread_apps:
            app = pod.labels["app"]
            pod = dataclasses.replace(pod, topology_spread=(
                TopologySpreadConstraint(max_skew=1, topology_key=ZONE,
                                         selector=LabelSelector.from_dict({"app": app})),
            ))
        out.append(pod)
    return list(nodes), out


def shape_provider(nodes) -> TestCloudProvider:
    """A TestCloudProvider with one node group a node shape (cores ×
    memory), min 0, max and target the nodes of that shape, owning them."""
    provider = TestCloudProvider()
    shapes = {}
    for node in nodes:
        a = node.allocatable
        shapes.setdefault((a.cpu_m, a.memory), []).append(node)
    for (cpu_m, mem), members in sorted(shapes.items()):
        gid = f"shape-{int(cpu_m) // 1000}c-{int(mem / MB) // 1024}g"
        provider.add_node_group(gid, 0, len(members), len(members),
                                build_test_node(f"{gid}-template", cpu_m=cpu_m, mem=mem))
        for node in members:
            provider.add_node(gid, node)
    return provider


def fake_api(nodes, pods) -> FakeClusterAPI:
    api = FakeClusterAPI()
    for node in nodes:
        api.add_node(node)
    for pod in pods:
        api.add_pod(pod)
    return api


def _plan_summary(plan) -> dict:
    def removal_of(r):
        return (r.node.name, [p.key() for p in r.pods_to_reschedule],
                sorted(r.destinations.items()), [p.key() for p in r.daemonset_pods])

    return {
        "empty": [removal_of(r) for r in plan.empty],
        "drain": [removal_of(r) for r in plan.drain],
        "unremovable": [
            (u.node.name, u.reason.value,
             None if u.blocking_pod is None
             else (u.blocking_pod.pod.key(), u.blocking_pod.reason.value))
            for u in plan.unremovable
        ],
    }


def reasons_of(summary) -> dict:
    """The plan's unremovable nodes counted by reason."""
    out = {}
    for _name, reason, _block in summary["unremovable"]:
        out[reason] = out.get(reason, 0) + 1
    return dict(sorted(out.items()))


def run_scale_down(nodes, pods, device=None, options_kw=None, timed=False) -> dict:
    """The scale-down branch of two reconcile loops over the listing
    (``nodes``, ``pods``) on ``device`` (None = the first card): planner and actuator on a
    ``shape_provider`` and a ``fake_api`` of the listing, options
    ``AutoscalingOptions(**options_kw)``. → a record: ``out``, what came out
    of each loop (the eligible names, the utilization of each node as a hex
    float, the empty names, the pool and the candidates simulated, the
    unneeded names, the plan) and of the actuation (its result with sorted
    lists, the groups' target sizes, the cloud's delete calls); and, when
    ``timed``, each loop's host clock by part, the spans on the card
    (utilization, removal dispatch, joint dispatch) and the dispatches'
    operands."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    options = AutoscalingOptions(**(options_kw or {}))
    provider = shape_provider(nodes)
    api = fake_api(nodes, pods)
    snapshot = listing_snapshot(nodes, pods, dev)
    planner = ScaleDownPlanner(provider, options)
    actuator = ScaleDownActuator(provider, options, api, planner.deletion_tracker)
    sorting = ScaleDownCandidatesSortingProcessor()
    rec = {"loops": []}
    loop = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed_call(key, fn, out_key=None):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            loop[key] = loop.get(key, 0.0) + time.perf_counter() - t0
            if out_key is not None:
                loop[out_key] = (args, kwargs, out)
            return out
        return call

    def on_card_span(key, fn, ops_key=None):
        """``fn`` with its span on the card by CUDA events (its operands
        kept under ``ops_key``)."""
        def call(*args, **kwargs):
            if ops_key is not None:
                loop[ops_key] = (fn, args)
            if not (timed and on_card):
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            torch.cuda.synchronize()
            loop[key] = start.elapsed_time(stop)
            return out
        return call

    planner.eligibility.filter_out_unremovable = timed_call(
        "eligibility_s", planner.eligibility.filter_out_unremovable, "eligibility")
    planner.simulator.find_empty_nodes = timed_call(
        "empty_s", planner.simulator.find_empty_nodes, "empty")
    planner.simulator.find_nodes_to_remove = timed_call(
        "removal_s", planner.simulator.find_nodes_to_remove, "removal")
    planner.simulator.validate_removal_set = timed_call(
        "joint_s", planner.simulator.validate_removal_set)
    # module functions the planner reaches, wrapped for the run and restored
    patches = {
        (eligibility, "node_utilization"): ("util_span_ms", None),
        (removal, "removal_feasibility"): ("dispatch_span_ms", "dispatch_ops"),
        (removal, "removal_feasibility_spread"): ("dispatch_span_ms", "dispatch_ops"),
        (removal, "joint_removal_feasibility"): ("joint_span_ms", "joint_ops"),
        (removal, "joint_removal_feasibility_spread"): ("joint_span_ms", "joint_ops"),
    }
    saved = [(mod, name, getattr(mod, name)) for mod, name in patches]
    for (mod, name), (key, ops_key) in patches.items():
        setattr(mod, name, on_card_span(key, getattr(mod, name), ops_key))
    if timed:
        for name, key in (("get_pods_to_move", "rules_s"),
                          ("_spread_refit_context", "spread_ctx_s"),
                          ("_cand_sub_matrix", "cand_sub_s")):
            saved.append((removal, name, getattr(removal, name)))
            setattr(removal, name, timed_call(key, getattr(removal, name)))
    try:
        for k, now in enumerate(DOWN_TICKS):
            loop = {}
            t0 = time.perf_counter()
            candidates = sorting.sort(ScaleDownNodeProcessor().get_scale_down_candidates(
                snapshot.nodes(), snapshot.nodes()))
            snapshot.tensors()
            sync()
            loop["pack_s"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            planner.update_cluster_state(snapshot, candidates, api.list_pdbs(), now)
            loop["update_s"] = time.perf_counter() - t1
            sorting.update(planner.unneeded_names())
            t2 = time.perf_counter()
            plan = planner.nodes_to_delete(snapshot, now)
            loop["plan_s"] = time.perf_counter() - t2
            if k == len(DOWN_TICKS) - 1:
                t3 = time.perf_counter()
                result = actuator.start_deletion(plan, now)
                loop["actuate_s"] = time.perf_counter() - t3
            # the loop's clock stops here: what follows only records it
            loop["loop_s"] = time.perf_counter() - t0
            eligible, utilization, _ = loop["eligibility"][2]
            empty = sorted(loop["empty"][2])
            empty_set = set(empty)
            loop["out"] = {
                "eligible": list(eligible),
                "utilization": {n: float(u).hex() for n, u in utilization.items()},
                "empty": empty,
                "pool": len(planner._bound_candidates(
                    [n for n in eligible if n not in empty_set])),
                "simulated": list(loop["removal"][0][1]),
                "unneeded": planner.unneeded_names(),
                "plan": _plan_summary(plan),
            }
            if k == len(DOWN_TICKS) - 1:
                rec["actuation"] = {
                    "deleted_empty": sorted(result.deleted_empty),
                    "deleted_drain": sorted(result.deleted_drain),
                    "failed": dict(sorted(result.failed.items())),
                    "evicted_pods": sorted(result.evicted_pods),
                    "sizes": [(g.id(), g.target_size()) for g in provider.node_groups()],
                    "delete_calls": sorted(provider.scale_down_calls),
                }
            del loop["eligibility"], loop["empty"], loop["removal"]
            rec["loops"].append(loop)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    rec["out"] = {"loops": [lp["out"] for lp in rec["loops"]],
                  "actuation": rec["actuation"]}
    return rec


def scaledown_differences(a: dict, b: dict) -> list:
    """Where two runs' ``out`` records differ: (loop, field) pairs, or
    ("actuation", field)."""
    diff = [(k, key) for k, (x, y) in enumerate(zip(a["loops"], b["loops"]))
            for key in x if x[key] != y[key]]
    diff += [("actuation", key) for key in a["actuation"]
             if a["actuation"][key] != b["actuation"][key]]
    if len(a["loops"]) != len(b["loops"]):
        diff.append(("loops", len(a["loops"]), len(b["loops"])))
    return diff


def dispatch_shape(ops) -> dict:
    """The lanes C, the slots the loop steps, the lane chunk and the spread
    terms of a captured removal dispatch."""
    fn, args = ops
    tensors, cand, slots = args[0], args[1], args[2]
    terms = int(args[5].shape[0]) if len(args) > 4 else 0
    chunk = scaledown.lane_chunk(tensors, terms)
    C = int(cand.shape[0])
    return {"lanes": C, "slots": int(slots.shape[1]), "steps": scaledown.filled_slots(slots),
            "chunk": chunk, "chunks": -(-C // chunk), "terms": terms}


def dispatch_profile(ops) -> dict:
    """The dispatch's launches, kernels and device time a slot step, from
    torch.profiler over one whole call (after a warm one), divided by the
    steps every chunk takes, and the kernels that took the most device
    time; device keys None where the profiler records no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn, args = ops
    shape = dispatch_shape(ops)
    steps = max(1, shape["steps"] * shape["chunks"])
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    events = list(prof.events())
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    launches = sum(1 for e in events
                   if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    seen = len(device) > 0
    kernels = sum(1 for e in device if not e.name.startswith(("Memcpy", "Memset")))
    device_us = sum(e.time_range.elapsed_us() for e in device)
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"steps": steps, "launches": launches / steps,
            "kernels": kernels / steps if seen else None,
            "device_us": device_us if seen else None,
            "top": [(name[:60], us / 1e3) for name, us in top]}


def split_line(label: str, rec: dict, prof=None) -> str:
    """Each loop's host clock by part, the utilization's span on the card,
    and the removal dispatch's shape, span, launches a step and idle share
    (``prof``: ``dispatch_profile`` of the last loop's dispatch)."""
    parts = []
    for k, lp in enumerate(rec["loops"]):
        rest = (lp["update_s"] - lp["eligibility_s"] - lp["empty_s"] - lp["removal_s"])
        text = (
            f"loop {k + 1} {lp['loop_s']:.3f} s = pack {lp['pack_s']:.3f} s + "
            f"update_cluster_state {lp['update_s']:.3f} s (eligibility "
            f"{lp['eligibility_s']:.3f} s, utilization span "
            f"{lp.get('util_span_ms', float('nan')):.3f} ms on the card; empty detection "
            f"{lp['empty_s']:.3f} s; find_nodes_to_remove {lp['removal_s']:.3f} s = drain "
            f"rules {lp.get('rules_s', float('nan')):.3f} s + spread context "
            f"{lp.get('spread_ctx_s', 0.0):.3f} s (with the joint pass's) + candidates' "
            f"matching pods "
            f"{lp.get('cand_sub_s', 0.0):.3f} s + dispatch span "
            f"{lp.get('dispatch_span_ms', float('nan')):.3f} ms + the rest; the planner's "
            f"own {rest:.3f} s) + nodes_to_delete {lp['plan_s']:.3f} s (joint validation "
            f"{lp.get('joint_s', 0.0):.3f} s, joint span "
            f"{lp.get('joint_span_ms', float('nan')):.3f} ms)"
        )
        if "actuate_s" in lp:
            text += f" + actuation {lp['actuate_s']:.3f} s"
        parts.append(text)
    line = f"# scale-down {label} split (host clock): " + "; ".join(parts)
    ops = rec["loops"][-1].get("dispatch_ops")
    if ops is not None:
        shape = dispatch_shape(ops)
        span = rec["loops"][-1].get("dispatch_span_ms")
        line += (f"; dispatch C = {shape['lanes']} lanes, {shape['steps']} of "
                 f"{shape['slots']} slots stepped, lane chunk {shape['chunk']} "
                 f"({shape['chunks']} chunks), {shape['terms']} spread terms")
        if prof is not None:
            line += f", {prof['launches']:.2f} kernel launches a step by the runtime"
            if prof["device_us"] is None or not span:
                line += ", device time and idle share not measured"
            else:
                top = "; ".join(f"{name} {ms:.3f} ms" for name, ms in prof["top"])
                line += (f", {prof['kernels']:.2f} kernels a step, {prof['device_us'] / 1e3:.3f}"
                         f" ms of device time in the call, idle share "
                         f"{1.0 - prof['device_us'] / 1e3 / span:.4f} of its span; the "
                         f"kernels that took most: {top}")
    return line


def summary_line(label: str, rec: dict) -> str:
    """What the two loops decided: counts of eligible, empty, pool,
    simulated and unneeded nodes, the plans, the unremovable reasons, the
    deletions and the target sizes after them."""
    parts = []
    for k, out in enumerate(rec["out"]["loops"]):
        plan = out["plan"]
        parts.append(
            f"loop {k + 1}: {len(out['eligible'])} eligible, {len(out['empty'])} empty, pool "
            f"{out['pool']}, {len(out['simulated'])} simulated, {len(out['unneeded'])} "
            f"unneeded; plan {len(plan['empty'])} empty + {len(plan['drain'])} drain, "
            f"unremovable {reasons_of(plan)}")
    act = rec["out"]["actuation"]
    shrunk = {g: n for g, n in act["sizes"]}
    return (f"# scale-down {label}: " + "; ".join(parts) + f"; deleted "
            f"{len(act['deleted_empty'])} empty + {len(act['deleted_drain'])} drained, "
            f"{len(act['evicted_pods'])} pods evicted, failed {act['failed']}; target sizes "
            f"after: {shrunk}")


def cpu_lanes_check(ops, lanes: int = CPU_LANES, seed: int = 0):
    """A seeded subset of ``lanes`` lanes of a captured removal dispatch,
    run again on the CPU from the same operands, against the card's
    outputs: → (lanes compared, fields compared, first difference or
    None)."""
    fn, args = ops
    card = fn(*args)
    C = int(args[1].shape[0])
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(C, min(lanes, C), replace=False))
    idx = torch.tensor(pick, dtype=torch.int64)
    cpu_args = _to_cpu(args)
    sub = list(cpu_args)
    sub[1], sub[2], sub[3] = (cpu_args[1][idx], cpu_args[2][idx], cpu_args[3][idx])
    if len(sub) > 4:
        sub[6] = cpu_args[6][idx]
    cpu = fn(*sub)
    return (len(pick), len(card), _first_difference(card, cpu, idx))


def cpu_joint_check(ops):
    """A captured joint dispatch run again whole on the CPU: → (candidates,
    fields compared, first difference or None)."""
    fn, args = ops
    card = fn(*args)
    cpu = fn(*_to_cpu(args))
    return int(args[1].shape[0]), len(card), _first_difference(card, cpu, None)


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        return tuple(_to_cpu(v) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to_cpu(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def _first_difference(card, cpu, idx):
    for name, a, b in zip(card._fields, card, cpu):
        a = a.cpu() if idx is None else a.cpu()[idx]
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[0].tolist()
            return (name, bad, a[tuple(bad)].item(), b[tuple(bad)].item())
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host alone (default: the first card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        print(smi.stdout.strip().splitlines()[0], flush=True)
    world_nodes, world_pods = build_snapshot_world()
    bad = 0
    for label, spread_apps, options_kw in (("3m", 0, {}), ("3n", SPREAD_IN_APPS, WIDE_REFIT)):
        nodes, pods = scale_in_listing(world_nodes, world_pods, spread_apps=spread_apps)
        rec = run_scale_down(nodes, pods, dev, options_kw, timed=on_card)
        print(summary_line(label, rec), flush=True)
        if not on_card:
            continue
        ops = rec["loops"][-1].get("dispatch_ops")
        print(split_line(label, rec, dispatch_profile(ops) if ops else None), flush=True)
        t0 = time.perf_counter()
        if label == "3m":
            cpu = run_scale_down(nodes, pods, "cpu", options_kw)
            diff = scaledown_differences(rec["out"], cpu["out"])
        else:
            n, fields, first = cpu_lanes_check(ops)
            diff = [] if first is None else [("lanes", first)]
            print(f"# scale-down 3n: {n} lanes x {fields} fields on the CPU, first "
                  f"difference {first}", flush=True)
            joint = rec["loops"][-1].get("joint_ops")
            if joint is not None:
                n, fields, first = cpu_joint_check(joint)
                diff += [] if first is None else [("joint", first)]
                print(f"# scale-down 3n: joint pass of {n} drains x {fields} fields on "
                      f"the CPU, first difference {first}", flush=True)
        bad += len(diff)
        print(f"# scale-down {label} on the CPU: {time.perf_counter() - t0:.3f} s host "
              f"clock; differs from the card in {diff or 'nothing'}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
