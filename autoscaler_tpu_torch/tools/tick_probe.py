"""The scale-up half of a reconcile tick on the card, alone: the two
ticks of ``chip_smoke.py`` (3j, 3k), their split, the greedy loop's
profile and the same ticks on the CPU, compared whole; or the tick
sequence over one incremental packer.

    python3 -m autoscaler_tpu_torch.tools.tick_probe                 # one card
    python3 -m autoscaler_tpu_torch.tools.tick_probe --sequence      # one card
    python3 -m autoscaler_tpu_torch.tools.tick_probe --sequence --device cpu

The world is ``utils/workload.build_snapshot_world`` (15k nodes, 105k
pods) plus chip_smoke's 30k-pod burst, regenerated here from the same
seed; ``spread_burst`` gives one burst pod in twenty (of those with no
selector and no toleration) a zone DoNotSchedule spread on one of the
world's first 24 apps. The provider's 100 groups are the burst's
templates with the world's zone key beside "zone" (``zoned_templates``).

``--sequence`` runs three ticks over one cluster whose listing changes
between them as a watch cache delivers it (``CHURNS``, ``churn``), every
tick packed through one ``IncrementalPacker``: tick 1 on the 3j listing
(a full build), ticks 2 and 3 on the churned listings (deltas only). It
prints each tick's pack seconds, the packer's counters and, on a card,
its split; holds tick 2's tensors against a full pack of the same
objects, and on a card replays the sequence on the CPU through a packer
of its own, each tick compared whole.

chip_smoke.py runs its ticks through ``run_tick`` and ``run_sequence``
and reports them through ``split_line``, ``sequence_line`` and
``tick_differences``, so both print the same figures. Exits non-zero
when the card and the CPU (or the full pack) disagree.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import enum
import subprocess
import sys
import time

import numpy as np
import torch

from autoscaler_tpu_torch.cloudprovider.test_provider import TestCloudProvider
from autoscaler_tpu_torch.clusterstate.registry import ClusterStateRegistry
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.core.podlistprocessor import FilterOutSchedulablePodListProcessor
from autoscaler_tpu_torch.core.scaleup.orchestrator import ScaleUpOrchestrator
from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.kube.objects import (
    LabelSelector,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)
from autoscaler_tpu_torch.ops import ffd_scan, ffd_scan_affinity, schedule
from autoscaler_tpu_torch.simulator import hinting
from autoscaler_tpu_torch.snapshot.affinity import _intern_spread_terms
from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot
from autoscaler_tpu_torch.snapshot.incremental import IncrementalPacker
from autoscaler_tpu_torch.utils.test_utils import GB, MB, build_test_node, build_test_pod
from autoscaler_tpu_torch.utils.workload import SPREAD_APPS, ZONE, build_snapshot_world

TICK_MAX_SIZE = 1000     # each node group of the ticks: min 0, max 1000, target 0
TICK_NOW = 100.0         # the ticks' clock (seconds)
SPREAD_SLOT = 1          # burst pods i with i % 20 == 1 spread in 3k: no selector, no toleration
PROFILE_STEPS = 100      # greedy steps under torch.profiler (eager: under one chunk)
OUT_KEYS = ("filtered", "assigned", "still", "sizes", "calls", "reverted")


ZONES = ["zone-a", "zone-b", "zone-c"]
BATCH = [Toleration(key="dedicated", value="batch", effect="NoSchedule")]


def burst_pods(rng, n: int, prefix: str = "burst"):
    """``n`` pending pods of the burst's distribution, drawn from ``rng``:
    50-2000 m cpu, 64-8192 MiB, a zone selector on one in ten, the batch
    toleration on one in twenty."""
    return [
        build_test_pod(
            f"{prefix}-{i}",
            cpu_m=float(rng.integers(50, 2000)),
            mem=float(rng.integers(64, 8192)) * MB,
            node_selector={"zone": ZONES[i % 3]} if i % 10 == 0 else None,
            tolerations=BATCH if i % 20 == 0 else None,
        )
        for i in range(n)
    ]


def burst_operands(seed: int = 0):
    """chip_smoke's 3b operands: 100 node-group templates and the 30k-pod
    pending burst, drawn in the same order from the same seed."""

    rng = np.random.default_rng(seed)
    zones = ZONES
    templates = {}
    for j in range(100):
        templates[f"ng-{j:03d}"] = build_test_node(
            f"ng-{j:03d}-template",
            cpu_m=float(rng.choice([4000, 8000, 16000, 32000])),
            mem=float(rng.choice([8, 16, 32, 64])) * GB,
            labels={"zone": zones[j % 3]},
            taints=[Taint(key="dedicated", value="batch")] if j % 10 == 9 else None,
        )
    return templates, burst_pods(rng, 30_000)


def zoned_templates(templates):
    """The templates, each copied with the world's zone key beside "zone"."""

    out = {}
    for g, tmpl in templates.items():
        tmpl = copy.deepcopy(tmpl)
        tmpl.labels[ZONE] = tmpl.labels["zone"]
        out[g] = tmpl
    return out


def spread_burst(burst):
    """The burst with pod i, for i % 20 == SPREAD_SLOT (no selector, no
    toleration), given a zone DoNotSchedule spread (maxSkew 1) on the app
    app-(i // 20 % 24): the world's placed pods of that app count."""

    out = []
    for i, pod in enumerate(burst):
        if i % 20 == SPREAD_SLOT:
            app = f"app-{(i // 20) % SPREAD_APPS}"
            pod = dataclasses.replace(pod, labels={"app": app}, topology_spread=(
                TopologySpreadConstraint(max_skew=1, topology_key=ZONE,
                                         selector=LabelSelector.from_dict({"app": app})),
            ))
        out.append(pod)
    return out


def canon(x):
    """A structure of dataclasses, enums, dicts and sequences → plain
    nested tuples that compare by value."""

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
    return x


def greedy_profile(greedy, tensors, slots, hints, spread) -> dict:
    """The greedy loop's launches and device time a step, from
    torch.profiler on ``len(slots)`` steps and on their first step alone
    (after one warm run): the difference, over the steps between, leaves
    out what a call costs once (its buffers, the chunk's gather). Counts
    the CUDA runtime's kernel launches, the kernels and other device
    activities (copies, fills) the card ran, and their summed time; the
    device keys are None where the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def measure(n):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            greedy(tensors, slots[:n], hints[:n], spread=spread)
            torch.cuda.synchronize()
        events = list(prof.events())
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        return (
            sum(1 for e in events if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))),
            sum(1 for e in device if not e.name.startswith(("Memcpy", "Memset"))),
            len(device),
            sum(e.time_range.elapsed_us() for e in device),
        )

    steps = int(slots.shape[0])
    greedy(tensors, slots, hints, spread=spread)
    torch.cuda.synchronize()
    many, one = measure(steps), measure(1)
    api, kernels, activities, device_us = ((a - b) / (steps - 1) for a, b in zip(many, one))
    seen = many[2] > 0
    return {
        "steps": steps,
        "launches": api,
        "kernels": kernels if seen else None,
        "activities": activities if seen else None,
        "device_us": device_us if seen else None,
    }


def tick_state(snap):
    return snap.fork_depth, [(p.key(), snap.assignment(p.key())) for p in snap.pods()]


def listing_snapshot(nodes, pods, device, packer=None) -> ClusterSnapshot:
    """A ClusterSnapshot of a listing, holding the listed objects
    themselves (the packer diffs them by identity), packed through
    ``packer`` when one is given."""
    snap = ClusterSnapshot(device=device, packer=packer)
    for node in nodes:
        snap.add_node(node)
    for pod in pods:
        snap.add_pod(pod)
    return snap


def run_tick(world_nodes, world_pods, extra, templates, device, timed=False,
             packer=None, operand_arena=None, metrics=None):
    """One scale-up tick (static_autoscaler.py:629-631, :712: fork,
    filter-out-schedulable, revert, scale_up on a TestCloudProvider whose
    groups are ``templates``, min 0, max TICK_MAX_SIZE, target 0,
    least-waste with seeded ties) over the world plus ``extra`` pending
    pods, on ``device``, packed through ``packer`` (an IncrementalPacker
    carried across ticks; None = a full pack) and estimated from
    ``operand_arena`` when given, its orchestrator and estimator counting
    on ``metrics`` (an AutoscalerMetrics; None = no recording): → a
    record of what came out (``out``), the tick's tensors and meta, the
    packer's counters after its update and, when ``timed``, the host clock
    of its parts, the greedy loop's operands, span on the card and output
    devices, and the operands the estimate handed its kernel."""
    snap = listing_snapshot(world_nodes, list(world_pods) + list(extra), device, packer)
    pending = snap.pending_pods()
    before = tick_state(snap)
    provider = TestCloudProvider()
    for g in sorted(templates):
        provider.add_node_group(g, 0, TICK_MAX_SIZE, 0, templates[g])
    opts = AutoscalingOptions(expander="least-waste", expander_random_seed=0)
    orch = ScaleUpOrchestrator(provider, opts, ClusterStateRegistry(provider, opts),
                               device=device, operand_arena=operand_arena, metrics=metrics)
    rec = {"pending": len(pending)}
    real_greedy, real_ctx = schedule.greedy_schedule, hinting.build_spread_context_from_meta
    real_estimate, real_best = orch.estimator.estimate_many, orch.expander.best_option
    real_kernels = (ffd_scan.ffd_scan_swar, ffd_scan.ffd_scan_f32,
                    ffd_scan_affinity.ffd_scan_aff)

    def timed_call(key, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if dev_is_card:
                torch.cuda.synchronize()
            rec[key] = time.perf_counter() - t0
            return out
        return call

    def greedy(tensors, slots, hints, spread=None):
        start = torch.cuda.Event(enable_timing=True) if dev_is_card else None
        stop = torch.cuda.Event(enable_timing=True) if dev_is_card else None
        t0 = time.perf_counter()
        if dev_is_card:
            start.record()
        out = real_greedy(tensors, slots, hints, spread=spread)
        if dev_is_card:
            stop.record()
            torch.cuda.synchronize()
            rec["greedy_span_ms"] = start.elapsed_time(stop)
        rec["greedy_s"] = time.perf_counter() - t0
        rec["greedy_ops"] = (tensors, slots, hints, spread)
        rec["greedy_devices"] = (out.placed.device.type, out.dest.device.type)
        return out

    def capture(name, fn):
        def call(*args):
            rec["kernel"] = (name, fn, args)
            return fn(*args)
        return call

    dev_is_card = torch.device(device).type == "cuda"
    if timed:
        schedule.greedy_schedule = greedy
        hinting.build_spread_context_from_meta = timed_call("context_s", real_ctx)
        orch.estimator.estimate_many = timed_call("estimate_s", real_estimate)
        orch.expander.best_option = timed_call("expander_s", real_best)
        ffd_scan.ffd_scan_swar = capture("ffd_scan_swar", real_kernels[0])
        ffd_scan.ffd_scan_f32 = capture("ffd_scan_f32", real_kernels[1])
        ffd_scan_affinity.ffd_scan_aff = capture("ffd_scan_aff", real_kernels[2])
    try:
        t0 = time.perf_counter()
        snap.fork()
        # the pack, timed alone; filter-out reuses it
        rec["tensors"], rec["meta"] = snap.tensors()
        if dev_is_card:
            torch.cuda.synchronize()
        rec["pack_s"] = time.perf_counter() - t0
        if packer is not None:
            rec["packer"] = packer_counts(packer)
        t1 = time.perf_counter()
        still, filtered = FilterOutSchedulablePodListProcessor().process(snap, pending)
        rec["filter_s"] = time.perf_counter() - t1
        assigned = [(p.key(), snap.assignment(p.key())) for p in filtered]
        snap.revert()
        rec["reverted"] = tick_state(snap) == before
        t2 = time.perf_counter()
        result = orch.scale_up(still, snap.nodes(), TICK_NOW, pods_of_node=snap.pods_on_node)
        rec["scale_up_s"] = time.perf_counter() - t2
    finally:
        schedule.greedy_schedule = real_greedy
        hinting.build_spread_context_from_meta = real_ctx
        ffd_scan.ffd_scan_swar, ffd_scan.ffd_scan_f32 = real_kernels[:2]
        ffd_scan_affinity.ffd_scan_aff = real_kernels[2]
    rec["tick_s"] = time.perf_counter() - t0
    rec["spread_terms"] = len(_intern_spread_terms(still, with_sig=True)[0])
    kernel = rec.get("kernel")
    rec["k3_spread"] = kernel[2][0].num_spread if kernel and kernel[0] == "ffd_scan_aff" else 0
    rec["out"] = {
        "filtered": [p.key() for p in filtered], "assigned": assigned,
        "still": [p.key() for p in still], "result": result,
        "sizes": [(g.id(), g.target_size()) for g in provider.node_groups()],
        "calls": list(provider.scale_up_calls), "reverted": rec["reverted"],
    }
    return rec


def tick_summary(rec) -> dict:
    """What a tick run in another process sends back: its ``out`` record
    with the result in ``canon`` form (which ``tick_differences`` reads
    alike), the chosen group and new nodes, its host clock and its
    packer's counts."""
    out, res = rec["out"], rec["out"]["result"]
    return {"out": {**{k: out[k] for k in OUT_KEYS}, "result": canon(res)},
            "chosen_group": res.chosen_group, "new_nodes": res.new_nodes,
            **{k: rec[k] for k in ("pack_s", "filter_s", "scale_up_s")},
            "packer": rec.get("packer")}


def packer_counts(packer) -> dict:
    """An IncrementalPacker's counters after its last update: full and
    incremental updates so far, and the last update's dirty rows."""
    return {"full_packs": packer.full_packs,
            "incremental_updates": packer.incremental_updates, **packer.last_dirty}


# The tick sequence over one cluster: the 3j listing (tick 1), then two
# churns as a watch cache delivers them. Churn 1 is the world one scan
# interval after a burst was absorbed: the pods tick 1 filtered bound to
# their nodes, the nodes its IncreaseSize asked for come up, 1% of the
# running pods finish, 1000 new pending pods arrive. Churn 2 is the steady
# state: the pods tick 2 filtered bound, 200 running pods gone, 200 new.
CHURNS = (
    {"seed": 1, "remove_share": 0.01, "arrive": 1000, "grow": True},
    {"seed": 2, "remove": 200, "arrive": 200, "grow": False},
)


def node_from_template(template, name: str):
    """A node of a group as it comes up: its template under its own name
    (and hostname label)."""
    node = copy.deepcopy(template)
    node.name = name
    node.labels = {**node.labels, "kubernetes.io/hostname": name}
    return node


def churn(nodes, pods, out, templates, seed, arrive, remove=None,
          remove_share=None, grow=True):
    """The listing one scan interval after a tick whose ``out`` record is
    given: → (nodes, pods, counts). Every pod that the tick filtered is
    bound to the node filter-out chose (a new object with ``node_name``
    set); with ``grow``, the nodes the tick's IncreaseSize calls asked for
    come up from their group's template; ``remove`` running pods (or
    ``remove_share`` of them) chosen with ``seed`` finish and are gone;
    ``arrive`` new pending pods of the burst's distribution, drawn from
    ``seed``, are listed last. Objects that did not change stay the same
    Python objects, as a watch cache keeps them."""
    rng = np.random.default_rng(seed)
    running = [i for i, p in enumerate(pods) if p.node_name]
    n_remove = remove if remove is not None else int(round(remove_share * len(running)))
    gone = {running[k] for k in rng.choice(len(running), n_remove, replace=False)}
    bind = dict(out["assigned"])
    next_pods = []
    for i, pod in enumerate(pods):
        if i in gone:
            continue
        node_name = bind.get(pod.key())
        if node_name is not None:
            pod = copy.copy(pod)
            pod.node_name = node_name
        next_pods.append(pod)
    next_nodes = list(nodes)
    if grow:
        for group, delta in out["calls"]:
            next_nodes += [node_from_template(templates[group], f"{group}-s{seed}-{k}")
                           for k in range(delta)]
    next_pods += burst_pods(rng, arrive, prefix=f"arrive-s{seed}")
    counts = {"bound": len(bind), "removed": n_remove, "arrived": arrive,
              "new_nodes": len(next_nodes) - len(nodes)}
    return next_nodes, next_pods, counts


def run_sequence(nodes, pods, templates, device, packer, timed=False, report=None,
                 churns=CHURNS, metrics=None):
    """The tick sequence on ``device``, every tick packed through
    ``packer``: a tick on the listing (``nodes``, ``pods``), then for each
    of ``churns`` the next listing and its tick. → one (nodes, pods, churn
    counts, record) entry a tick (the first tick's counts are None);
    ``report`` is called with each entry as its tick ends; every tick
    counts on ``metrics``."""
    seq, counts = [], None
    for i in range(len(churns) + 1):
        rec = run_tick(nodes, pods, (), templates, device, timed=timed, packer=packer,
                       metrics=metrics)
        seq.append((nodes, pods, counts, rec))
        if report is not None:
            report(seq[-1])
        if i < len(churns):
            nodes, pods, counts = churn(nodes, pods, rec["out"], templates, **churns[i])
    return seq


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def tensors_differences(a, meta_a, b, meta_b, chunk: int = 8192) -> list:
    """The fields in which two packs of the same objects disagree, compared
    by pod key and node name (row orders may differ): the mask verdicts
    (in either form, ``chunk`` pod rows at a time), requests, validity,
    allocatables, used, groups by name and assignments by node name. Bit
    for bit; "keys" when the two hold different pods or nodes."""
    if set(meta_a.pod_index) != set(meta_b.pod_index) or \
            set(meta_a.node_index) != set(meta_b.node_index):
        return ["keys"]
    dev = a.device
    keys, names = list(meta_b.pod_index), list(meta_b.node_index)

    def rows(index, order):
        return torch.tensor([index[k] for k in order], dtype=torch.int64, device=dev)

    pa, pb = rows(meta_a.pod_index, keys), rows(meta_b.pod_index, keys)
    na, nb = rows(meta_a.node_index, names), rows(meta_b.node_index, names)
    diff = []
    for field, ra, rb in (("node_alloc", na, nb), ("node_used", na, nb), ("node_valid", na, nb),
                          ("pod_req", pa, pb), ("pod_valid", pa, pb),
                          ("pod_priority", pa, pb), ("pod_preempt", pa, pb)):
        if not torch.equal(_bits(getattr(a, field)[ra]), _bits(getattr(b, field)[rb])):
            diff.append(field)
    if int(a.node_valid.sum()) != len(names) or int(a.pod_valid.sum()) != len(keys):
        diff.append("padding")

    def assignment(t, pods, nodes):
        """Each pod's node as a position in ``names`` (-1 pending)."""
        pos = torch.full((t.num_nodes,), -1, dtype=torch.int64, device=dev)
        pos[nodes] = torch.arange(len(names), device=dev)
        pn = t.pod_node[pods].long()
        return torch.where(pn >= 0, pos[pn.clamp(min=0)], -1)

    if not torch.equal(assignment(a, pa, na), assignment(b, pb, nb)):
        diff.append("pod_node")

    def groups(t, meta, nodes):
        return [meta.group_names[g] if g >= 0 else None for g in t.node_group[nodes].tolist()]

    if groups(a, meta_a, na) != groups(b, meta_b, nb):
        diff.append("node_group")
    for c in range(0, len(keys), chunk):
        if not torch.equal(a.sched_rows(pa[c:c + chunk])[:, na],
                           b.sched_rows(pb[c:c + chunk])[:, nb]):
            diff.append("mask")
            break
    return diff


def fields_differing(a, b) -> list:
    """The fields of two SnapshotTensors that are not equal bit for bit
    (shape, dtype and values; None only where the other is None too)."""
    out = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            if x is not y:
                out.append(f.name)
        elif x.dtype != y.dtype or x.shape != y.shape or not torch.equal(_bits(x), _bits(y)):
            out.append(f.name)
    return out


def tick_differences(on_card: dict, on_cpu: dict) -> list:
    """The fields of two ticks' ``out`` records that differ."""
    diff = [key for key in OUT_KEYS if on_card[key] != on_cpu[key]]
    if canon(on_card["result"]) != canon(on_cpu["result"]):
        diff.append("result")
    return diff


def split_line(label: str, rec: dict, prof: dict, kernel_ms: float) -> str:
    """One timed tick's split: the host clock of its parts, the greedy
    loop's span on the card (CUDA events around the whole loop), its
    launches and device time a step (``prof``, torch.profiler), the
    card-busy time for K steps and the idle share derived from the two."""
    K = int(rec["greedy_ops"][1].shape[0])
    span = rec["greedy_span_ms"]
    if prof["device_us"] is None:
        busy = "card-busy time and idle share not measured (no device activity profiled)"
    else:
        busy_ms = prof["device_us"] * K / 1e3
        busy = (f"{prof['kernels']:.2f} kernels and {prof['activities']:.2f} device "
                f"activities a step, {prof['device_us']:.2f} us of device time a step: "
                f"card-busy {busy_ms:.3f} ms for K steps, idle share "
                f"{1.0 - busy_ms / span:.4f}")
    commit_s = rec["filter_s"] - rec.get("context_s", 0.0) - rec["greedy_s"]
    return (
        f"# tick {label} split ({rec['tick_s']:.3f} s host clock in all): pack "
        f"{rec['pack_s']:.3f} s; filter-out {rec['filter_s']:.3f} s = spread context "
        f"{rec.get('context_s', 0.0):.3f} s + greedy_schedule {rec['greedy_s']:.3f} s "
        f"(K = {K} steps, {rec['greedy_s'] * 1e6 / K:.2f} us a step; span on the card "
        f"{span:.3f} ms by events; profiler on {prof['steps']} steps less one: "
        f"{prof['launches']:.2f} kernel launches a step by the runtime, {busy}) + commit "
        f"loop and host {commit_s:.3f} s; scale_up {rec['scale_up_s']:.3f} s = estimate "
        f"{rec['estimate_s']:.3f} s (route {rec['route']}, {rec['kernel'][0]} "
        f"{kernel_ms:.3f} ms on the card) + expander {rec['expander_s']:.4f} s + the rest"
    )


def profile_tick(rec: dict) -> dict:
    """``greedy_profile`` on the first PROFILE_STEPS steps of a timed
    tick's loop operands."""

    tensors, slots, hints, spread = rec["greedy_ops"]
    return greedy_profile(schedule.greedy_schedule, tensors, slots[:PROFILE_STEPS],
                          hints[:PROFILE_STEPS], spread)


def kernel_ms(rec: dict, reps: int = 3) -> float:
    """Mean card time of the estimate's kernel on the operands the tick
    handed it, by CUDA events, queued behind ~10 ms of a spinning card."""
    _name, fn, args = rec["kernel"]
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sequence_line(label: str, entry) -> str:
    """One tick of the sequence: the churn that led to it, its pack's host
    seconds and the packer's counters after it, and what the tick did."""
    nodes, pods, counts, rec = entry
    out, res = rec["out"], rec["out"]["result"]
    return (f"# sequence tick {label}: {len(pods)} pods on {len(nodes)} nodes after churn "
            f"{counts}; pack {rec['pack_s']:.3f} s host clock, packer {rec['packer']}; "
            f"{rec['pending']} pending in, {len(out['filtered'])} filtered, "
            f"{len(out['still'])} still pending; chosen {res.chosen_group} +{res.new_nodes}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sequence", action="store_true",
                    help="the three-tick sequence over one incremental packer "
                         "instead of the two ticks")
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
    templates, burst = burst_operands()
    groups = zoned_templates(templates)
    world_nodes, world_pods = build_snapshot_world()
    if args.sequence:
        return sequence_main(world_nodes, list(world_pods) + burst, groups, dev)
    bad = 0
    for label, extra in (("3j", burst), ("3k", spread_burst(burst))):
        rec = run_tick(world_nodes, world_pods, extra, groups, dev, timed=on_card)
        res = rec["out"]["result"]
        print(f"# tick {label}: {rec['pending']} pending in, {len(rec['out']['filtered'])} "
              f"filtered, {len(rec['out']['still'])} still pending; {rec['spread_terms']} "
              f"spread terms interned; chosen {res.chosen_group} +{res.new_nodes}", flush=True)
        if not on_card:
            continue
        rec["route"] = rec["kernel"][0]
        print(split_line(label, rec, profile_tick(rec), kernel_ms(rec)), flush=True)
        t0 = time.perf_counter()
        cpu = run_tick(world_nodes, world_pods, extra, groups, "cpu")
        diff = tick_differences(rec["out"], cpu["out"])
        bad += len(diff)
        print(f"# tick {label} on the CPU: {time.perf_counter() - t0:.3f} s host clock; "
              f"differs from the card in {diff or 'nothing'}", flush=True)
    return 1 if bad else 0


def sequence_main(nodes, pods, groups, dev) -> int:
    """The tick sequence on ``dev`` through one IncrementalPacker; tick 2's
    tensors against a full pack of its listing; on a card, the sequence
    replayed on the CPU through a packer of its own, each tick compared
    whole. → 1 when anything differs, else 0."""
    on_card = dev.type == "cuda"

    def report(entry):
        print(sequence_line(str(len(seq_done) + 1), entry), flush=True)
        rec = entry[3]
        if on_card and "kernel" in rec:
            rec["route"] = rec["kernel"][0]
            print(split_line(str(len(seq_done) + 1), rec, profile_tick(rec), kernel_ms(rec)),
                  flush=True)
        seq_done.append(entry)

    seq_done = []
    seq = run_sequence(nodes, pods, groups, dev, IncrementalPacker(device=dev),
                       timed=on_card, report=report)
    nodes2, pods2, _counts, rec2 = seq[1]
    full, full_meta = listing_snapshot(nodes2, pods2, dev).tensors()
    bad = tensors_differences(rec2["tensors"], rec2["meta"], full, full_meta)
    print(f"# sequence tick 2: tensors differ from a full pack in {bad or 'nothing'}", flush=True)
    if on_card:
        cpu_packer = IncrementalPacker(device="cpu")
        for i, (nodes_i, pods_i, _c, rec) in enumerate(seq):
            t0 = time.perf_counter()
            if i == 0:
                listing_snapshot(nodes_i, pods_i, "cpu", cpu_packer).tensors()
                continue
            cpu = run_tick(nodes_i, pods_i, (), groups, "cpu", packer=cpu_packer)
            diff = tick_differences(rec["out"], cpu["out"])
            bad += diff
            print(f"# sequence tick {i + 1} on the CPU: {time.perf_counter() - t0:.3f} s host "
                  f"clock, packer {cpu['packer']}; differs from the card in "
                  f"{diff or 'nothing'}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
