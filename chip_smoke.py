#!/usr/bin/env python3
"""Runs the PyTorch port's main paths, the scale-up estimate with and
without dynamic inter-pod affinity and hard topology spread, and the
cluster snapshot's predicate fit, on one CUDA card through its
hand-written kernels, and holds every kernel against its plain PyTorch
version.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases (any failure raises and exits non-zero):

1. device: the card's name and power limit (nvidia-smi) and PyTorch's name;
2. build: each CUDA source compiled with nvcc, all at once; each ptxas
   report (registers, static shared memory, spills);
3. the main paths, each with every launch and route count set to 0 just
   before it and read just after:
   a. the repo's headline estimate (bench.py's workload: 100k pending pods
      × 500 node groups, 1000-node cap, 6 resource axes) through
      ``ffd_binpack_groups_cuda`` with integral requests (SWAR kernel K2)
      and with fractional memory (f32 kernel K1);
   b. the object-level estimator on a 30k-pod pending burst × 100 node-group
      templates and the least-waste expander's choice (K2);
   c. a replicated-pods burst (the run-compressed route, no kernel);
   d. the affinity workload (benchmarks/affinity_bench.py's default: 20k
      pods × 100 groups × 50 terms, 1000-node cap) through
      ``ffd_binpack_groups_affinity_cuda`` (K3);
   e. the object-level spread world (benchmarks/spread_bench.py's default:
      20k unique pods × 16 zoned templates, 10% hostname anti-affinity, 5%
      zone DoNotSchedule spread) through ``estimate_many`` and least-waste
      (K3), and the same world with the spread over the hostname key;
   f. a replicated affinity world (30k pods of 300 deployments, one in ten
      with hostname anti-affinity on its own app; the runs-affinity route,
      no kernel);
   g. the tiled fit (benchmarks/fit_bench.py's operands: 100k pods × 15k
      nodes × 6 resources, 40 × 24 classes, 1.5 G pairs) through
      ``fit_reduce_cuda`` (K4);
   h. the snapshot probe: a ``ClusterSnapshot`` on the card holding a
      15k-node, 105k-pod world (one pod in seven pending, hostname
      anti-affinity on 1% of them, a host-port DaemonSet on 5k nodes) is
      packed into factored ``SnapshotTensors`` and probed by
      ``DebuggingSnapshotter.capture`` (``fits_any_node``) and
      ``first_fit_node``, each through ``fit_reduce_exact`` (K4 plus the
      exact patch of the exception-row and single-cell pods).
   Every kernel of the paths must have launched;
4. each kernel at its headline shape against its plain version on the same
   card tensors (K1/K2 on all 500 groups, K3 on all 100 groups), exactly;
   the main paths' results against the plain versions' results, K3's
   launches on the two spread worlds included (all 16 groups); the
   estimator's results and choices against the same calls on the CPU (the
   CPU takes a stride sample of the templates for the dynamic worlds:
   each group's result depends on its own template only); K4 on all 100k
   pods of the tiled fit and on the probe's two launches (4e); the probe's
   ``fit_reduce_exact`` on all 131 072 pod rows against a reduction of
   ``dense_sched()`` rows chunked by pods (4f);
5. timings with CUDA events: each kernel alone, its whole entry call, and
   the plain version; K3 on the zone and hostname spread worlds; K4 on the
   probe's operands and the whole ``fit_reduce_exact`` there.

The last two lines of standard output are the kernels line (one JSON
object) and ``{"ok": true, "device": {...}}``. Without a CUDA card, or
outside a checkout of the repo, it exits non-zero and prints nothing on
standard output.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

# The card's peak rates (NVIDIA H100 SXM data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12   # non-tensor f32; also used for the int32 ops, a lower bound

BURST_PODS = 30_000      # BASELINE.md's 30k-pod burst (scalability_tests.md:30-34)
BURST_TEMPLATES = 100
REPLICATED_PODS = 30_000
REPLICATED_CONTROLLERS = 300
REPS = 3
CPU_TEMPLATE_STRIDE = 2      # spread worlds: every other template on the CPU
CPU_RUNS_TEMPLATE_STRIDE = 20  # replicated affinity world: 5 of 100 templates
HOSTNAME_KEY = "kubernetes.io/hostname"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# K3's operations for each unit of work its plain version counts: a node
# fit test is R compares; a term gate on an open node that fits is ~16 int
# ops a term plane with a bit set (two domain blends, three violation
# terms); a hostname spread gate is an add, a subtract and a compare; a
# hostname-minimum read is one min. The per-step group scalars (new_ok,
# group-level spread) are left out, which keeps the bound a lower bound.
K3_OPS = {"gate_plane_tests": 16, "host_gate_tests": 3, "open_min_nodes": 1}


def k3_operations(stats: dict, R: int) -> int:
    return stats["node_tests"] * R + sum(stats[k] * w for k, w in K3_OPS.items())


def k3_work(stats: dict, R: int) -> str:
    return " + ".join(
        [f"{stats['node_tests']} node tests x {R}"]
        + [f"{stats[k]} {k} x {w}" for k, w in K3_OPS.items()]
    )


def main() -> int:
    try:
        import torch
    except ImportError:
        log("chip_smoke: PyTorch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "autoscaler_tpu_torch")):
        log("chip_smoke: autoscaler_tpu_torch/ is missing: run it from a checkout")
        return 2
    sys.path.insert(0, root)
    import numpy as np

    from autoscaler_tpu_torch.estimator import binpacking
    from autoscaler_tpu_torch.estimator.binpacking import (
        BinpackingNodeEstimator,
        _build_group_arrays,
    )
    from autoscaler_tpu_torch.estimator.limiter import ThresholdBasedEstimationLimiter
    from autoscaler_tpu_torch.expander.core import Option, build_strategy
    from autoscaler_tpu_torch.kube.objects import MEMORY, OwnerRef, Taint, Toleration
    from autoscaler_tpu_torch.debugging import DebuggingSnapshotter
    from autoscaler_tpu_torch.ops import _build, ffd_scan, ffd_scan_affinity, fit, fit_reduce
    from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot
    from autoscaler_tpu_torch.snapshot.tensors import bucket_size
    from autoscaler_tpu_torch.utils.test_utils import (
        GB,
        MB,
        anti_affinity,
        build_test_node,
        build_test_pod,
    )
    from autoscaler_tpu_torch.utils.workload import (
        AFFINITY_GROUPS,
        AFFINITY_MAX_NODES,
        AFFINITY_PODS,
        AFFINITY_TERMS,
        HEADLINE_MAX_NODES,
        SPREAD_APPS,
        SPREAD_GROUPS,
        SPREAD_MAX_NODES,
        SPREAD_PODS,
        build_affinity_workload,
        build_fit_workload,
        build_snapshot_world,
        build_spread_world,
        build_workload,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

    def phase(label, t0):
        print(f"# phase {label}: {time.perf_counter() - t0:.3f} s host clock", flush=True)

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} device {kind!r}", flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    print(f"# kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    # registers and static shared memory ("Used ..."), stack and spills
    # (the line after each function's properties); the carries' dynamic
    # shared memory is printed with each kernel below
    for name, report in sorted(_build.BUILD_LOGS.items()):
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                print(f"# {name}.cu: {line.strip()}", flush=True)

    # -- operands of the main paths (set-up: not part of the paths) --------
    t0 = time.perf_counter()
    req, masks, allocs, caps = build_workload()
    req_frac = req.copy()
    req_frac[:, MEMORY] += 0.5            # fractional memory refuses the SWAR plan
    P = req.shape[0]
    G = masks.shape[0]
    headline = ffd_scan.operands_from_numpy(req, masks, allocs, caps, dev)
    headline_frac = ffd_scan.operands_from_numpy(req_frac, masks, allocs, caps, dev)
    aff_np = build_affinity_workload(AFFINITY_PODS, AFFINITY_GROUPS, AFFINITY_TERMS)
    aff_ops = ffd_scan_affinity.affinity_operands_from_numpy(*aff_np, device=dev)

    rng = np.random.default_rng(0)
    zones = ["zone-a", "zone-b", "zone-c"]
    templates = {}
    for j in range(BURST_TEMPLATES):
        templates[f"ng-{j:03d}"] = build_test_node(
            f"ng-{j:03d}-template",
            cpu_m=float(rng.choice([4000, 8000, 16000, 32000])),
            mem=float(rng.choice([8, 16, 32, 64])) * GB,
            labels={"zone": zones[j % 3]},
            taints=[Taint(key="dedicated", value="batch")] if j % 10 == 9 else None,
        )
    batch = [Toleration(key="dedicated", value="batch", effect="NoSchedule")]
    burst = [
        build_test_pod(
            f"burst-{i}",
            cpu_m=float(rng.integers(50, 2000)),
            mem=float(rng.integers(64, 8192)) * MB,
            node_selector={"zone": zones[i % 3]} if i % 10 == 0 else None,
            tolerations=batch if i % 20 == 0 else None,
        )
        for i in range(BURST_PODS)
    ]
    shapes = [
        (float(rng.integers(50, 2000)), float(rng.integers(64, 8192)) * MB)
        for _ in range(REPLICATED_CONTROLLERS)
    ]
    replicated = []
    for i in range(REPLICATED_PODS):
        c = i % REPLICATED_CONTROLLERS
        pod = build_test_pod(f"rep-{i}", cpu_m=shapes[c][0], mem=shapes[c][1])
        pod.owner_ref = OwnerRef(kind="ReplicaSet", name=f"deploy-{c}")
        replicated.append(pod)
    # the replicated affinity world: the same shapes, an app label per
    # deployment, and hostname anti-affinity on its own app for one
    # deployment in ten
    replicated_aff = []
    for i in range(REPLICATED_PODS):
        c = i % REPLICATED_CONTROLLERS
        pod = build_test_pod(
            f"repaff-{i}", cpu_m=shapes[c][0], mem=shapes[c][1], labels={"app": f"app-{c}"},
            affinity=anti_affinity({"app": f"app-{c}"}) if c % 10 == 0 else None,
        )
        pod.owner_ref = OwnerRef(kind="ReplicaSet", name=f"deploy-{c}")
        replicated_aff.append(pod)
    spread_worlds = {
        "zone": build_spread_world(SPREAD_PODS, SPREAD_GROUPS, SPREAD_APPS),
        "hostname": build_spread_world(
            SPREAD_PODS, SPREAD_GROUPS, SPREAD_APPS, topology_key=HOSTNAME_KEY
        ),
    }
    fit_np = build_fit_workload()
    fit_ops = tuple(torch.tensor(a, device=dev) for a in fit_np)   # copies
    world_nodes, world_pods = build_snapshot_world()
    snapshot = ClusterSnapshot()                   # device=None: the card
    for node in world_nodes:
        snapshot.add_node(node)
    for pod in world_pods:
        snapshot.add_pod(pod)
    world_pending = snapshot.pending_pods()
    phase("operand set-up", t0)

    class Group:
        def __init__(self, name, template):
            self.name, self.template = name, template

        def id(self):
            return self.name

        def template_node_info(self):
            return self.template

    def event_ms(fn, reps=REPS):
        """Mean device time of ``reps`` calls, by CUDA events."""
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def choose(results, tmpls):
        strategy = build_strategy(["least-waste"], seed=0)
        options = [
            Option(node_group=Group(g, tmpls[g]), node_count=n, pods=pods)
            for g, (n, pods) in sorted(results.items()) if n > 0 and pods
        ]
        best = strategy.best_option(options)
        return (best.node_group.id() if best else None), strategy.last_table

    counters = (ffd_scan.LAUNCHES, ffd_scan_affinity.LAUNCHES, fit_reduce.LAUNCHES,
                binpacking.ROUTES)
    launches = {name: 0 for d in counters[:3] for name in d}

    def run_path(label, fn):
        """Drive one main path with every count set to 0 just before it;
        → (its result, its counts read just after, host seconds)."""
        for d in counters:
            for k in d:
                d[k] = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {**ffd_scan.LAUNCHES, **ffd_scan_affinity.LAUNCHES, **fit_reduce.LAUNCHES,
                  **{f"route:{k}": v for k, v in binpacking.ROUTES.items()}}
        for name in launches:
            launches[name] += counts[name]
        print(f"# path {label}: {secs:.3f} s host clock, counts {counts}", flush=True)
        return out, counts, secs

    # -- 3. the main paths ----------------------------------------------------
    t3 = time.perf_counter()
    (res_swar, res_f32), counts, t_headline = run_path("headline K2+K1", lambda: (
        ffd_scan.ffd_binpack_groups_cuda(
            *headline[:3], max_nodes=HEADLINE_MAX_NODES, node_caps=headline[3]
        ),
        ffd_scan.ffd_binpack_groups_cuda(
            *headline_frac[:3], max_nodes=HEADLINE_MAX_NODES, node_caps=headline_frac[3]
        ),
    ))
    check(counts["ffd_scan_swar"] == 1 and counts["ffd_scan_f32"] == 1,
          "the headline did not run K2 and K1 once each")
    estimator = BinpackingNodeEstimator()          # device=None: the card

    def burst_path():
        out = estimator.estimate_many(burst, templates)
        return out, choose(out, templates)

    (burst_card, choice_card), counts, t_burst = run_path("30k burst + expander", burst_path)
    check(counts["ffd_scan_swar"] == 1, "the burst estimate did not run the SWAR kernel")
    replicated_card, counts, t_replicated = run_path(
        "replicated burst", lambda: estimator.estimate_many(replicated, templates)
    )
    check(not any(counts.values()), "the replicated burst did not take the runs route")
    res_aff, counts, t_aff = run_path(
        "affinity workload K3",
        lambda: ffd_scan_affinity.ffd_binpack_groups_affinity_cuda(
            **aff_ops, max_nodes=AFFINITY_MAX_NODES
        ),
    )
    check(counts["ffd_scan_aff"] == 1, "the affinity workload did not run K3")

    # the spread worlds: capture the operands K3 is handed and what it
    # returns, to hold it against its plain version and time it below (the
    # capture calls the wrapper itself, which counts)
    spread_estimator = BinpackingNodeEstimator(
        ThresholdBasedEstimationLimiter(max_nodes=SPREAD_MAX_NODES)
    )
    captured = {}
    real_scan = ffd_scan_affinity.ffd_scan_aff
    spread_card = {}
    for variant, (pods_sw, tmpl_sw) in spread_worlds.items():
        def spread_path():
            out = spread_estimator.estimate_many(pods_sw, tmpl_sw)
            return out, choose(out, tmpl_sw)

        def capture(ops, variant=variant):
            out = real_scan(ops)
            captured[variant] = (ops, out)
            return out

        ffd_scan_affinity.ffd_scan_aff = capture
        try:
            spread_card[variant] = run_path(f"spread world ({variant})", spread_path)
        finally:
            ffd_scan_affinity.ffd_scan_aff = real_scan
        counts = spread_card[variant][1]
        check(counts["ffd_scan_aff"] == 1 and counts["route:ffd_scan_aff"] == 1
              and counts["route:affinity_loop"] == 0,
              f"the {variant} spread world did not take the ffd_scan_aff route")
        check(captured[variant][0].num_spread == 32, f"{variant}: expected 32 spread terms")
    replicated_aff_card, counts, t_replicated_aff = run_path(
        "replicated affinity world",
        lambda: estimator.estimate_many(replicated_aff, templates),
    )
    check(not any(counts.values()),
          "the replicated affinity world did not take the runs-affinity route")

    res_fit, counts, t_fit = run_path(
        "fit-K4", lambda: fit_reduce.fit_reduce_cuda(*fit_ops)
    )
    check(counts["fit_reduce"] == 1, "the tiled fit did not run K4 once")

    # the snapshot probe: capture the operands K4 is handed and what it
    # returns, to hold it against its plain version and time it below
    debugger = DebuggingSnapshotter()
    stand_in = SimpleNamespace(provider=SimpleNamespace(node_groups=lambda: [
        Group(f"pool-{k}", world_nodes[k]) for k in range(3)
    ]))
    last_result = SimpleNamespace(
        scale_up=None, pending_pods=len(world_pending), unneeded_nodes=[]
    )
    probe_launches = []
    real_fit = fit_reduce.fit_reduce_cuda

    def capture_fit(*operands):
        out = real_fit(*operands)
        probe_launches.append((operands, out))
        return out

    def probe_path():
        t0 = time.perf_counter()
        tensors, meta = snapshot.tensors()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        debugger.request()
        debugger.capture(stand_in, snapshot, world_pending, last_result, now=0.0)
        first = fit.first_fit_node(tensors)
        torch.cuda.synchronize()
        return tensors, meta, first, t1 - t0, time.perf_counter() - t1

    fit_reduce.fit_reduce_cuda = capture_fit
    try:
        (probe_t, probe_meta, probe_first, t_pack, t_probe), counts, _ = run_path(
            "snapshot probe", probe_path
        )
    finally:
        fit_reduce.fit_reduce_cuda = real_fit
    check(counts["fit_reduce"] == 2, "the snapshot probe did not run K4 twice")
    check(probe_t.sched_mask is None, "the snapshot world did not pack factored")
    n_exc = int((probe_t.pod_exc >= 0).sum())
    n_cells = int((probe_t.cell_pod >= 0).sum())
    check(n_exc > 0 and n_cells > 0, "the factored pack has no exception rows or no cells")
    payload = json.loads(debugger.get())
    n_fitting = len(payload["pending_pods_fitting_free_capacity"])
    check(n_fitting > 0, "the probe found no pending pod fitting free capacity")
    print(
        f"# snapshot probe: {probe_meta.num_nodes} nodes, {probe_meta.num_pods} pods "
        f"({len(world_pending)} pending), padded {probe_t.num_pods} x {probe_t.num_nodes}, "
        f"factored: class mask {list(probe_t.class_mask.shape)}, exception rows "
        f"{n_exc} of {probe_t.exc_rows.shape[0]}, cells {n_cells} of "
        f"{probe_t.cell_pod.shape[0]}; pack {t_pack:.3f} s host clock, probe "
        f"(capture + first_fit_node) {t_probe:.3f} s host clock; {n_fitting} pending "
        f"pods fit free capacity, {int((probe_first >= 0).sum())} pods have a first fit",
        flush=True,
    )
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main paths")
    check(
        sum(len(p) for _, p in burst_card.values()) > 0 and choice_card[0] is not None,
        "the burst estimate scheduled nothing",
    )
    for variant, ((out, choice), _, _) in spread_card.items():
        check(sum(len(p) for _, p in out.values()) > 0 and choice[0] is not None,
              f"the {variant} spread world scheduled nothing")
    print(f"# main paths: launches {launches}", flush=True)
    phase("3 main paths", t3)

    # -- 4. kernels against their plain versions, results against the CPU ----
    t4 = time.perf_counter()
    kernels = []
    for name, args, res, replaces in (
        ("ffd_scan_swar", headline, res_swar, "autoscaler_tpu/ops/pallas_binpack.py:305"),
        ("ffd_scan_f32", headline_frac, res_f32, "autoscaler_tpu/ops/pallas_binpack.py:141"),
    ):
        ops = ffd_scan.prepare_scan(*args[:3], HEADLINE_MAX_NODES, args[3])
        check((ops.plan is not None) == (name == "ffd_scan_swar"), f"{name}: wrong route")
        NP = ops.stream.shape[2]
        plain_args = (ops.stream, ops.allocs, ops.caps) + (
            (ops.guards,) if ops.plan is not None else ()
        ) + (HEADLINE_MAX_NODES,)
        plain_fn = (
            ffd_scan._scan_plain_swar if ops.plan is not None else ffd_scan._scan_plain_f32
        )
        kernel_fn = ffd_scan.ffd_scan_swar if ops.plan is not None else ffd_scan.ffd_scan_f32

        got = kernel_fn(*plain_args)
        torch.cuda.synchronize()
        stats = {}
        t0 = time.perf_counter()
        want = plain_fn(*plain_args, stats=stats)
        torch.cuda.synchronize()
        log(f"{name}: plain version with work count {time.perf_counter() - t0:.1f} s")
        max_err = 0.0
        for field, a, b in zip(("free", "opened", "placed"), want, got):
            check(a.dtype == b.dtype and a.shape == b.shape, f"{name}: {field} layout")
            check(torch.equal(a, b), f"{name}: {field} differs from the plain version")
            max_err = max(max_err, float((a.double() - b.double()).abs().max()))
        plain_res = ffd_scan.finish_scan(ops, *want)
        for field, a, b in zip(plain_res._fields, plain_res, res):
            check(torch.equal(a, b), f"{name}: main-path {field} differs from the plain version")

        # timings: the kernel alone, the whole entry call, the plain version,
        # and the kernel on an all-zero stream (every pod fits node 0: one
        # 32-node block a step), the floor of its chain of dependent steps
        ms = event_ms(lambda: kernel_fn(*plain_args))
        call_ms = event_ms(
            lambda: ffd_scan.ffd_binpack_groups_cuda(*args[:3], HEADLINE_MAX_NODES, args[3])
        )
        plain_ms = event_ms(lambda: plain_fn(*plain_args), reps=1)
        zeros = torch.zeros_like(ops.stream)
        floor_ms = event_ms(lambda: kernel_fn(zeros, *plain_args[1:]))
        del zeros

        P_pad = ops.stream.shape[1]
        bytes_moved = (
            ops.stream.numel() * 4 + ops.allocs.numel() * 4 + ops.caps.numel() * 4
            + (NP * 4 if ops.plan is not None else 0)
            + G * NP * HEADLINE_MAX_NODES * 4 + G * 4 + G * P_pad
        )
        ops_per_plane = 4 if ops.plan is not None else 1   # or, sub, and, cmp | cmp
        operations = stats["node_tests"] * NP * ops_per_plane
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = operations / FP32_OPS_PER_S * 1e3
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "autoscaler_tpu_torch/csrc/ffd_scan.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max_err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "parity": "exact",
            "call_ms": call_ms,
            "chain_floor_ms": floor_ms,
        })
        print(
            f"# {name}: {ms:.3f} ms kernel ({ms * 1e3 / P_pad:.3f} us a step), "
            f"{call_ms:.3f} ms whole call, {plain_ms:.1f} ms plain, chain floor "
            f"{floor_ms:.3f} ms, parity exact", flush=True,
        )
        # the bound's inputs, computed from this run's shapes and data, and
        # the dynamic shared memory the launch requests (from the kernel
        # library itself)
        print(
            f"# {name} bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({kernels[-1]['bound_by']}): G={G} P={P} P_pad={P_pad} planes={NP} "
            f"max_nodes={HEADLINE_MAX_NODES}, {bytes_moved} B moved ({bytes_ms:.4f} ms), "
            f"{stats['node_tests']} node tests, {operations} operations "
            f"({ops_ms:.4f} ms); {ffd_scan.smem_bytes(NP, HEADLINE_MAX_NODES)} B "
            f"dynamic shared memory a block", flush=True,
        )
        del ops, got, want, plain_res
    phase("4a K1/K2 against their plain versions", t4)

    # K3 at the affinity workload: all 100 groups and all 20k pods
    t0 = time.perf_counter()
    M_aff = AFFINITY_MAX_NODES
    aff_prep = ffd_scan_affinity.prepare_scan_aff(**aff_ops, max_nodes=M_aff)
    plain_args = (aff_prep.stream, aff_prep.bits, aff_prep.allocs, aff_prep.caps,
                  aff_prep.nl, aff_prep.hl, aff_prep.spstat, aff_prep.num_planes,
                  aff_prep.num_spread, M_aff)
    got = ffd_scan_affinity.ffd_scan_aff(aff_prep)
    torch.cuda.synchronize()
    stats = {}
    t1 = time.perf_counter()
    want = ffd_scan_affinity._scan_plain_aff(*plain_args, stats=stats)
    torch.cuda.synchronize()
    log(f"ffd_scan_aff: plain version with work count {time.perf_counter() - t1:.1f} s")
    max_err = 0.0
    for field, a, b in zip(("free", "opened", "placed"), want, got):
        check(a.dtype == b.dtype and a.shape == b.shape, f"ffd_scan_aff: {field} layout")
        check(torch.equal(a, b), f"ffd_scan_aff: {field} differs from the plain version")
        max_err = max(max_err, float((a.double() - b.double()).abs().max()))
    plain_res = ffd_scan_affinity.finish_scan_aff(aff_prep, *want)
    for field, a, b in zip(plain_res._fields, plain_res, res_aff):
        check(torch.equal(a, b), f"ffd_scan_aff: main-path {field} differs from the plain version")
    ms = event_ms(lambda: ffd_scan_affinity.ffd_scan_aff(aff_prep))
    call_ms = event_ms(lambda: ffd_scan_affinity.ffd_binpack_groups_affinity_cuda(
        **aff_ops, max_nodes=M_aff
    ))
    plain_ms = event_ms(lambda: ffd_scan_affinity._scan_plain_aff(*plain_args), reps=1)
    G_aff, P_pad_aff, R_aff = aff_prep.stream.shape
    TP_aff = aff_prep.num_planes
    NB_aff = aff_prep.bits.shape[2]
    bytes_moved = (
        aff_prep.stream.numel() * 4 + aff_prep.bits.numel() * 4 + aff_prep.allocs.numel() * 4
        + aff_prep.caps.numel() * 4 + aff_prep.nl.numel() * 4 + aff_prep.hl.numel() * 4
        + G_aff * R_aff * M_aff * 4 + G_aff * 4 + G_aff * P_pad_aff
    )
    operations = k3_operations(stats, R_aff)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = operations / FP32_OPS_PER_S * 1e3
    kernels.append({
        "name": "ffd_scan_aff",
        "route": "cuda",
        "source": "autoscaler_tpu_torch/csrc/ffd_scan_affinity.cu",
        "replaces": "autoscaler_tpu/ops/pallas_binpack_affinity.py:150",
        "launches": launches["ffd_scan_aff"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "parity": "exact",
        "call_ms": call_ms,
    })
    print(
        f"# ffd_scan_aff: {ms:.3f} ms kernel ({ms * 1e3 / P_pad_aff:.3f} us a step), "
        f"{call_ms:.3f} ms whole call, {plain_ms:.1f} ms plain, parity exact on all "
        f"{G_aff} groups", flush=True,
    )
    print(
        f"# ffd_scan_aff bound {max(bytes_ms, ops_ms):.4f} ms ({kernels[-1]['bound_by']}): "
        f"G={G_aff} P={AFFINITY_PODS} P_pad={P_pad_aff} R={R_aff} T={AFFINITY_TERMS} "
        f"planes={TP_aff} bit_planes={NB_aff} max_nodes={M_aff}, {bytes_moved} B moved "
        f"({bytes_ms:.4f} ms), {k3_work(stats, R_aff)} = {operations} operations "
        f"({ops_ms:.4f} ms); "
        f"{ffd_scan_affinity.affinity_smem_bytes(R_aff, TP_aff, 0, M_aff)} B dynamic "
        f"shared memory a block", flush=True,
    )
    del got, want, plain_res
    phase("4b K3 against its plain version", t0)

    # K3 on the two spread worlds (S = 32: the only launches where the
    # spread gates and count planes run): the main path's own launch
    # against the plain version on the operands it was handed, all 16
    # groups; then K3 timed on them
    for variant in spread_worlds:
        t0 = time.perf_counter()
        ops, got = captured[variant]
        G_s, P_pad_s, R_s = ops.stream.shape
        stats = {}
        want = ffd_scan_affinity._scan_plain_aff(
            ops.stream, ops.bits, ops.allocs, ops.caps, ops.nl, ops.hl, ops.spstat,
            ops.num_planes, ops.num_spread, ops.max_nodes, stats=stats,
        )
        for field, a, b in zip(("free", "opened", "placed"), want, got):
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"ffd_scan_aff ({variant} spread): {field} layout")
            check(torch.equal(a, b),
                  f"ffd_scan_aff ({variant} spread): {field} differs from the plain version")
        sp_ms = event_ms(lambda: ffd_scan_affinity.ffd_scan_aff(ops))
        print(
            f"# ffd_scan_aff on the {variant} spread world: {sp_ms:.3f} ms kernel "
            f"({sp_ms * 1e3 / P_pad_s:.3f} us a step), parity exact on all {G_s} groups, "
            f"G={G_s} P_pad={P_pad_s} R={R_s} "
            f"planes={ops.num_planes} S={ops.num_spread} max_nodes={ops.max_nodes}, "
            f"{ffd_scan_affinity.affinity_smem_bytes(R_s, ops.num_planes, ops.num_spread, ops.max_nodes)} "
            f"B dynamic shared memory a block; work {k3_work(stats, R_s)} = "
            f"{k3_operations(stats, R_s)} operations "
            f"({k3_operations(stats, R_s) / FP32_OPS_PER_S * 1e3:.4f} ms at the peak rate); "
            f"estimate_many + least-waste {spread_card[variant][2]:.3f} s host clock",
            flush=True,
        )
        del want
        phase(f"4b K3 on the {variant} spread world against its plain version", t0)

    # the estimator's results and choices against the same calls on the CPU
    t0 = time.perf_counter()
    cpu_estimator = BinpackingNodeEstimator(device="cpu")
    burst_cpu = cpu_estimator.estimate_many(burst, templates)
    choice_cpu = choose(burst_cpu, templates)
    replicated_cpu = cpu_estimator.estimate_many(replicated, templates)
    log(f"estimator on the CPU: {time.perf_counter() - t0:.1f} s")
    for label, on_card, on_cpu in (
        ("burst", burst_card, burst_cpu), ("replicated", replicated_card, replicated_cpu)
    ):
        for g in templates:
            check(on_card[g][0] == on_cpu[g][0], f"{label} {g}: node count differs")
            check(
                [p.name for p in on_card[g][1]] == [p.name for p in on_cpu[g][1]],
                f"{label} {g}: scheduled pods differ",
            )
    check(choice_card == choice_cpu, "the expander chose differently on the card")
    print(
        f"# estimator: card equals CPU on {len(templates)} groups (burst and "
        f"replicated), least-waste picks {choice_card[0]}", flush=True,
    )
    phase("4c plain-route estimates on the CPU", t0)

    def compare_sampled(label, est_cpu, pods_w, tmpl_w, on_card, stride):
        """The CPU's estimate on every ``stride``-th template against the
        card's results for those templates, and the least-waste choice
        among them."""
        t0 = time.perf_counter()
        sample = {g: tmpl_w[g] for g in sorted(tmpl_w)[::stride]}
        on_cpu = est_cpu.estimate_many(pods_w, sample)
        for g in sample:
            check(on_card[g][0] == on_cpu[g][0], f"{label} {g}: node count differs")
            check(
                [p.name for p in on_card[g][1]] == [p.name for p in on_cpu[g][1]],
                f"{label} {g}: scheduled pods differ",
            )
        card_sample = {g: on_card[g] for g in sample}
        check(choose(card_sample, sample) == choose(on_cpu, sample),
              f"{label}: the expander chose differently on the card")
        print(
            f"# {label}: card equals CPU on {len(sample)} of {len(tmpl_w)} templates, "
            f"{sum(c for c, _ in on_card.values())} nodes on the card in all, "
            f"least-waste picks {choose(on_card, tmpl_w)[0]} (all) and "
            f"{choose(card_sample, sample)[0]} (sample)", flush=True,
        )
        phase(f"4d {label} on the CPU", t0)

    spread_cpu = BinpackingNodeEstimator(
        ThresholdBasedEstimationLimiter(max_nodes=SPREAD_MAX_NODES), device="cpu"
    )
    for variant, (pods_sw, tmpl_sw) in spread_worlds.items():
        (out, _choice), _, _ = spread_card[variant]
        compare_sampled(f"{variant} spread world", spread_cpu, pods_sw, tmpl_sw, out,
                        CPU_TEMPLATE_STRIDE)
    compare_sampled("replicated affinity world", cpu_estimator, replicated_aff, templates,
                    replicated_aff_card, CPU_RUNS_TEMPLATE_STRIDE)

    # K4 against its plain version on the card: the tiled fit's main-path
    # launch on all 100k pods, and the probe's two launches on the operands
    # they were handed
    t0 = time.perf_counter()

    def hold(label, want, got):
        """Every field equal, dtype and all; → the largest difference (0)."""
        err = 0.0
        for field, a, b in zip(want._fields, want, got):
            check(a.dtype == b.dtype and a.shape == b.shape, f"{label}: {field} layout")
            check(torch.equal(a, b), f"{label}: {field} differs from the plain version")
            err = max(err, float((a.double() - b.double()).abs().max()))
        return err

    fit_stats, probe_stats = {}, {}
    max_err = hold("fit_reduce (fit-K4)", fit_reduce._fit_reduce_plain(*fit_ops, stats=fit_stats),
                   res_fit)
    for k, (operands, got) in enumerate(probe_launches):
        max_err = max(max_err, hold(
            f"fit_reduce (probe launch {k})",
            fit_reduce._fit_reduce_plain(*operands, stats=probe_stats if k == 0 else None), got,
        ))
    ms = event_ms(lambda: fit_reduce.fit_reduce_cuda(*fit_ops))
    plain_ms = event_ms(lambda: fit_reduce._fit_reduce_plain(*fit_ops), reps=1)
    probe_ops = probe_launches[0][0]
    probe_k4_ms = event_ms(lambda: fit_reduce.fit_reduce_cuda(*probe_ops))
    call_ms = event_ms(lambda: fit_reduce.fit_reduce_exact(probe_t))
    P_f, R_f = fit_ops[0].shape
    N_f = fit_ops[1].shape[0]
    CP_f, CN_f = fit_ops[4].shape
    # operands read once (f32 rows, i32 classes, bool mask and validity),
    # outputs written once (bool, i32, i32)
    bytes_moved = (P_f * R_f * 4 + N_f * R_f * 4 + P_f * 4 + N_f * 4 + CP_f * CN_f + N_f
                   + P_f * (1 + 4 + 4))
    operations = fit_stats["class_tests"] + fit_stats["compares"]
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = operations / FP32_OPS_PER_S * 1e3
    kernels.append({
        "name": "fit_reduce",
        "route": "cuda",
        "source": "autoscaler_tpu_torch/csrc/fit_reduce.cu",
        "replaces": "autoscaler_tpu/ops/pallas_fit.py:78",
        "launches": launches["fit_reduce"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "parity": "exact",
        "call_ms": call_ms,
    })
    probe_ops_count = probe_stats["class_tests"] + probe_stats["compares"]
    print(
        f"# fit_reduce: {ms:.3f} ms kernel at fit-K4 ({P_f} pods x {N_f} nodes, "
        f"{ms * 1e9 / (P_f * N_f):.4f} ps a pair), {plain_ms:.1f} ms plain, parity exact on "
        f"all {P_f} pods; probe: {probe_k4_ms:.3f} ms kernel, {call_ms:.3f} ms whole "
        f"fit_reduce_exact (exact patch {call_ms - probe_k4_ms:.3f} ms), parity exact on "
        f"both launches ({len(probe_launches)})", flush=True,
    )
    print(
        f"# fit_reduce bound {max(bytes_ms, ops_ms):.4f} ms ({kernels[-1]['bound_by']}): "
        f"P={P_f} N={N_f} R={R_f} CP={CP_f} CN={CN_f}, {bytes_moved} B moved "
        f"({bytes_ms:.4f} ms), {fit_stats['class_tests']} class tests + "
        f"{fit_stats['compares']} compares = {operations} operations ({ops_ms:.4f} ms); "
        f"{fit_reduce.smem_bytes(R_f, CP_f, CN_f)} B dynamic shared memory a block; probe "
        f"launch: {probe_stats['class_tests']} class tests + {probe_stats['compares']} "
        f"compares = {probe_ops_count} operations "
        f"({probe_ops_count / FP32_OPS_PER_S * 1e3:.4f} ms at the peak rate)", flush=True,
    )
    phase("4e K4 against its plain version", t0)

    # the probe's exact reduction on every pod row against an independent
    # dense path: dense_sched() expands classes, exception rows and cells
    # itself, and the reduction runs over it chunked by pods
    t0 = time.perf_counter()
    exact = fit_reduce.fit_reduce_exact(probe_t)
    dense = probe_t.dense_sched()
    free_d = probe_t.free()
    ref_parts = []
    for s0 in range(0, probe_t.num_pods, 2048):
        rows = slice(s0, s0 + 2048)
        fits = (probe_t.pod_req[rows, None, :] <= free_d[None, :, :]).all(dim=2)
        fits &= dense[rows] & probe_t.pod_valid[rows, None] & probe_t.node_valid[None, :]
        cnt = fits.sum(dim=1, dtype=torch.int32)
        first = fits.to(torch.uint8).argmax(dim=1).to(torch.int32)   # the first max
        ref_parts.append((cnt > 0, cnt, torch.where(cnt > 0, first, -1)))
    ref = fit_reduce.FitReduction(*(torch.cat(x) for x in zip(*ref_parts)))
    del dense, ref_parts
    for field, a, b in zip(ref._fields, ref, exact):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"probe: fit_reduce_exact {field} differs from the dense path")
    check(torch.equal(probe_first, ref.first_fit), "probe: first_fit_node differs from the dense path")
    ref_any = ref.any_fit.cpu().numpy()
    fitting = sorted(p.key() for p in world_pending if ref_any[probe_meta.pod_index[p.key()]])
    check(sorted(payload["pending_pods_fitting_free_capacity"]) == fitting,
          "probe: the capture's fitting pods differ from the dense path")
    print(
        f"# probe: fit_reduce_exact equals the dense path on all {probe_t.num_pods} pod "
        f"rows ({int(ref.any_fit.sum())} fit somewhere, "
        f"{int(ref.fit_count.sum())} fitting pairs)", flush=True,
    )
    phase("4f the probe against a dense path", t0)

    # where the burst estimate's time goes: the host operand build (mask
    # engine, packing) and the scan call on the card
    names = sorted(templates)
    t0 = time.perf_counter()
    arrays = _build_group_arrays(burst, names, templates, pad=bucket_size(len(burst)))
    t_build = time.perf_counter() - t0
    burst_caps = np.full(len(names), estimator.limiter.node_cap(0), np.int32)
    burst_ops = ffd_scan.operands_from_numpy(*arrays, burst_caps, dev)
    burst_scan_ms = event_ms(lambda: ffd_scan.ffd_binpack_groups_cuda(
        *burst_ops[:3], bucket_size(int(burst_caps.max())), burst_ops[3]
    ))
    print(
        f"# burst estimate {t_burst:.3f} s: host operand build {t_build:.3f} s, "
        f"scan call {burst_scan_ms:.3f} ms on the card; headline {t_headline:.3f} s, "
        f"replicated {t_replicated:.3f} s, affinity workload {t_aff:.3f} s, "
        f"replicated affinity {t_replicated_aff:.3f} s, fit-K4 {t_fit:.3f} s", flush=True,
    )
    print(f"# total {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
