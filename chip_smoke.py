#!/usr/bin/env python3
"""Runs the PyTorch port's main paths, the scale-up estimate with and
without dynamic inter-pod affinity and hard topology spread, the cluster
snapshot's predicate fit, and the scale-up and scale-down halves of a
reconcile tick, on one CUDA card through its hand-written kernels, and
holds every kernel against its plain PyTorch version.

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
      exact patch of the exception-row and single-cell pods, whose true
      rows go through K4's rows entry);
   i. the plain route's shape gate: a 300-pod world with 7 f32 planes
      (fractional memory, four host ports) at a scan cap of 8192 through
      ``estimate_many``, whose carry exceeds a block's shared memory, so
      the torch loop serves it ("binpack_loop"), and the same world with 6
      planes, which launches K1;
   j. the scale-up tick: the snapshot world of (h) plus (b)'s 30k burst in
      a ``ClusterSnapshot`` on the card, run through ``run_once``'s
      sequence (static_autoscaler.py:629-631, :712): ``fork``,
      ``FilterOutSchedulablePodListProcessor.process`` (the hinting
      simulator's ``greedy_schedule`` loop on the card), ``revert``, then
      ``ScaleUpOrchestrator.scale_up`` over what is still pending, on a
      ``TestCloudProvider`` whose 100 groups are (b)'s templates with the
      world's zone key beside "zone" (min 0, max 1000, target 0),
      least-waste with seeded ties; the estimate must launch the kernel
      its route names (K1/K2 on ``ffd_scan``, K3 on ``ffd_scan_aff``);
   k. the same tick with one burst pod in twenty that carries no selector
      and no toleration given a zone DoNotSchedule spread (maxSkew 1) on
      one of the world's first 24 apps: the spread context over the placed
      pods, the gate and commit in the greedy loop, and the orchestrator's
      cluster context into K3 with at most 32 spread terms;
   l. the tick sequence over one ``IncrementalPacker`` carried across
      ticks (``tools/tick_probe.run_sequence``): tick 1 on (j)'s listing
      through ``ClusterSnapshot(packer=...)`` (the packer's first update, a
      full build; its result must equal (j)'s), then the world one scan
      interval after the burst (the pods tick 1 filtered bound to their
      nodes, the nodes its IncreaseSize asked for up, 1% of the running
      pods gone, 1000 new pending pods) and tick 2, then the steady state
      (tick 2's filtered pods bound, 200 gone, 200 new) and tick 3; ticks
      2 and 3 must be incremental (no full pack) and dirty no more pod rows
      than twice the pods their churn changed;
   m. the scale-down half of two reconcile loops
      (``tools/scaledown_probe.run_scale_down``, static_autoscaler.py:
      788-880) on (h)'s world after a scale-in (every placed pod of apps
      0-99 gone), on a ``TestCloudProvider`` with one group a node shape and
      a ``FakeClusterAPI`` of the listing, at ``AutoscalingOptions()``: at
      t = 0 ``update_cluster_state`` over every node (utilization on the
      card, empty detection, the drain rules, one removal dispatch of 30
      candidates) and ``nodes_to_delete`` (nothing yet: no node unneeded
      long enough); at t = 601 the same, then
      ``ScaleDownActuator.start_deletion`` (taints, deletions);
   n. the same on the listing whose placed pods of apps 100-123 carry a
      zone DoNotSchedule spread, every eligible non-empty node simulated in
      one ``removal_feasibility_spread`` dispatch (thousands of lanes) and
      ten drains validated by ``joint_removal_feasibility_spread``, then
      evicted and deleted. The scale-down half runs no hand kernel.
   Every kernel of the paths must have launched;
4. each kernel at its headline shape against its plain version on the same
   card tensors, exactly: K1/K2 on all 500 groups, K3 on its three
   launches (all 100 groups of the affinity workload, all 16 of each
   spread world), each with its launch geometry, chain floor, the search
   counts of the data and the bound recounted from them; the main paths'
   results against the plain versions' results; the
   estimator's results and choices against the same calls on the CPU (the
   CPU takes a stride sample of the templates for the dynamic worlds:
   each group's result depends on its own template only); the gate worlds
   against the CPU; K4 on all 100k pods of the tiled fit and on the
   probe's two launches, and its rows entry on the probe's special rows,
   with K4's launch geometry, registers and SASS instructions a pair
   (4e); the probe's ``fit_reduce_exact`` on all 131 072 pod rows against
   a reduction of ``dense_sched()`` rows chunked by pods, and its exact
   patch timed in parts (4f); both ticks again on a ``ClusterSnapshot``
   on the CPU of the same objects: every filtered key and assignment, the
   snapshot after the revert, the whole ScaleUpResult and the provider's
   target sizes equal (4g); the tick sequence: tick 2's tensors against a
   full pack of its listing on the card by pod key and node name, and the
   sequence replayed on the CPU through a packer of its own, ticks 2 and 3
   whole and equal (4h); the resident arena: a second packer with a
   ``DeviceArena`` on the card replays the three listings, serves tensors
   equal bit for bit to the first packer's, seeds on tick 1 alone and
   never rolls back, each apply's span on the card by CUDA events (4i);
   3m repeated whole on the CPU, both loops and the actuation field for
   field (the eligible names, every utilization bit for bit, the empty,
   simulated and unneeded names, every ``NodeToRemove`` with its
   destinations, the unremovable reasons, the ``ActuationResult`` and the
   target sizes) (4j); 256 seeded lanes of 3n's removal dispatch repeated
   on the CPU from the same operands, and its joint pass whole (4k);
5. timings with CUDA events, each run queued behind ~10 ms of a spinning
   card so that they time the card and not the host's launches: each
   kernel alone, its whole entry call, and the plain version; K3 on the
   zone and hostname spread worlds; K4 on the probe's operands, the whole
   ``fit_reduce_exact`` there and its exact patch in parts; each tick's
   split by the host clock (pack, spread context, greedy loop, commit
   loop, scale_up with its estimate, kernel and expander; the three ticks
   of the sequence too), the greedy
   loop's span on the card (CUDA events around it), its launches, kernels
   and device time a step (torch.profiler on 100 steps, which run
   eagerly, less a run of one step), and the card-busy time and idle
   share derived from them; each scale-down loop's split by the host
   clock (pack, eligibility with the utilization's span on the card,
   empty detection, the drain rules, the removal dispatch's span, the
   joint validation, actuation) and the dispatch's lanes, slots stepped,
   lane chunk, launches and device time a step (torch.profiler) and idle
   share.

The last two lines of standard output are the kernels line (one JSON
object) and ``{"ok": true, "device": {...}}``. Without a CUDA card, or
outside a checkout of the repo, it exits non-zero and prints nothing on
standard output.
"""
from __future__ import annotations

import json
import os
import re
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
HOST_LEAD_CYCLES = 20_000_000  # ~10 ms of the card's clock before each timing
GATE_PODS = 300          # the plain-route gate worlds
GATE_MAX_NODES = 5000    # a scan cap of 8192
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
# The kernels' search, as their plain versions count it: blocks tested
# against their summaries, candidate blocks searched, rounds (one barrier
# each), placements (one barrier each), and the node tests of a plain scan;
# the bound counts the fewer of the two searches' fit tests
SEARCH_COUNTS = ("summary_tests", "candidate_blocks", "rounds", "placements", "node_tests")
NODE_BLOCK = 32          # nodes a block summary covers (ops/ffd_scan.py)


def fit_tests(stats: dict) -> int:
    """The node fit tests the data needs: a plain scan's, or the pruned
    search's summary tests and the node tests of its candidate blocks,
    whichever is fewer."""
    pruned = stats["summary_tests"] + NODE_BLOCK * stats["candidate_blocks"]
    return min(stats["node_tests"], pruned)


def k3_operations(stats: dict, R: int) -> int:
    return fit_tests(stats) * R + sum(stats[k] * w for k, w in K3_OPS.items())


def k3_work(stats: dict, R: int) -> str:
    return " + ".join(
        [f"min({stats['node_tests']} node tests, {stats['summary_tests']} summary tests "
         f"+ {NODE_BLOCK} x {stats['candidate_blocks']} candidate blocks) = "
         f"{fit_tests(stats)} fit tests x {R}"]
        + [f"{stats[k]} {k} x {w}" for k, w in K3_OPS.items()]
    )


def search_line(stats: dict, steps: int, P_pad: int) -> str:
    """The search counts a group step, and the busiest group's a step."""
    return (
        f"search over {steps} group steps: "
        + ", ".join(f"{stats[k]} {k} ({stats[k] / steps:.4f} a step)" for k in SEARCH_COUNTS)
        + "; the busiest group: "
        + ", ".join(f"{stats[f'max_group_{k}']} {k} ({stats[f'max_group_{k}'] / P_pad:.4f} a step)"
                    for k in SEARCH_COUNTS[1:4])
    )


def k4_registers(report: str) -> list:
    """'<kernel>: <registers line>' for each kernel of ptxas's report."""
    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            short = re.search(r"\d(fit_reduce_(?:kernel|generic))ILi(\d+)E", m.group(1))
            gate = {"0": "class bits", "1": "class bytes", "2": "rows"}.get(short.group(2), "?") if short else "?"
            name = f"{short.group(1)}<{gate}>" if short else m.group(1)
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}")
    return out


# SASS opcodes issued on the ALU pipe (logic, compares, integer add and
# select); IMAD, FADD and the uniform datapath are not
ALU_OPS = ("LOP3", "FSETP", "ISETP", "PLOP3", "SEL", "IADD3", "VIADD", "SHF", "LEA", "POPC",
           "FLO", "BREV", "VIMNMX", "IMNMX", "FMNMX", "PRMT")


def k4_sass_loops(lib_path) -> dict:
    """{live resources: (instructions a pair, ALU instructions a pair)} of
    the class-bits kernel's inner loops, from ``cuobjdump -sass``: a loop is
    a backward branch whose body holds one predicated instruction a pair
    (the verdict's bit) besides the branch, shared-memory loads and, at NL
    live resources, NL FSETP a pair."""
    import os

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        if "fit_reduce_kernelILi0E" not in func.split("\n", 1)[0]:
            continue
        rows = []
        for line in func.splitlines():
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9.]+)", line)
            if m:
                rows.append((int(m.group(1), 16), m.group(2), m.group(3), line))
        for addr, _, op, line in rows:
            target = re.search(r"BRA\s+.*?0x([0-9a-f]+)", line)
            if not op.startswith("BRA") or not target or int(target.group(1), 16) >= addr:
                continue
            body = [r for r in rows if int(target.group(1), 16) <= r[0] <= addr]
            pairs = sum(1 for r in body if r[1] and not r[2].startswith("BRA"))
            fsetp = sum(1 for r in body if r[2].startswith("FSETP"))
            if pairs < 8 or fsetp % pairs or not any(r[2].startswith("LDS") for r in body):
                continue
            nl = fsetp // pairs
            alu = sum(1 for r in body if r[2].split(".")[0] in ALU_OPS)
            if nl not in out or len(body) / pairs < out[nl][0]:
                out[nl] = (len(body) / pairs, alu / pairs)
    return out


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
    from autoscaler_tpu_torch.snapshot.arena import DeviceArena
    from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot
    from autoscaler_tpu_torch.snapshot.incremental import IncrementalPacker
    from autoscaler_tpu_torch.snapshot.tensors import bucket_size
    from autoscaler_tpu_torch.tools import scaledown_probe, tick_probe
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
    # the gate worlds: unique pods with fractional memory (the f32 route)
    # and 4 or 3 distinct host ports (one virtual plane each)
    gate_worlds = {}
    for ports in (4, 3):
        g_rng = np.random.default_rng(21)
        pods_g = []
        for i in range(GATE_PODS):
            pod = build_test_pod(f"gate-{i}", cpu_m=float(g_rng.integers(50, 2000)),
                                 mem=(float(g_rng.integers(64, 2048)) + 0.5) * MB)
            if i % 3 == 0:
                pod.host_ports = (9000 + i % ports,)
            pods_g.append(pod)
        gate_worlds[ports] = (pods_g, {
            f"ng-{j}": build_test_node(f"gate-t{j}", cpu_m=4000.0 * (1 + j), mem=8 * GB)
            for j in range(3)
        })
    fit_np = build_fit_workload()
    fit_ops = tuple(torch.tensor(a, device=dev) for a in fit_np)   # copies
    world_nodes, world_pods = build_snapshot_world()
    snapshot = ClusterSnapshot()                   # device=None: the card
    for node in world_nodes:
        snapshot.add_node(node)
    for pod in world_pods:
        snapshot.add_pod(pod)
    world_pending = snapshot.pending_pods()
    # the scale-up ticks: 3b's templates, each copied with the world's zone
    # key beside "zone" (3b's operands stay as they were), and the burst
    # with one pod in twenty of those that carry no selector and no
    # toleration given a zone DoNotSchedule spread on one of the world's
    # first 24 apps (the placed pods of that app count)
    tick_templates = tick_probe.zoned_templates(templates)
    spread_burst = tick_probe.spread_burst(burst)
    # the scale-down runs: the world after a scale-in, and the same with the
    # next 24 apps' placed pods spread by zone
    down_listings = {
        "3m": (scaledown_probe.scale_in_listing(world_nodes, world_pods), {}),
        "3n": (scaledown_probe.scale_in_listing(
            world_nodes, world_pods, spread_apps=scaledown_probe.SPREAD_IN_APPS),
            scaledown_probe.WIDE_REFIT),
    }
    phase("operand set-up", t0)

    class Group:
        def __init__(self, name, template):
            self.name, self.template = name, template

        def id(self):
            return self.name

        def template_node_info(self):
            return self.template

    def event_ms(fn, reps=REPS):
        """Mean device time of ``reps`` calls, by CUDA events. The card
        first spins for HOST_LEAD_CYCLES, so that the host queues the calls
        ahead of it and the events time the card, not the host's launches."""
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_LEAD_CYCLES)
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

    rows_launches = []
    real_rows = fit_reduce.fit_reduce_rows

    def capture_fit(*operands):
        out = real_fit(*operands)
        probe_launches.append((operands, out))
        return out

    def capture_rows(*operands):
        out = real_rows(*operands)
        rows_launches.append((operands, out))
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
    fit_reduce.fit_reduce_rows = capture_rows
    try:
        (probe_t, probe_meta, probe_first, t_pack, t_probe), counts, _ = run_path(
            "snapshot probe", probe_path
        )
    finally:
        fit_reduce.fit_reduce_cuda = real_fit
        fit_reduce.fit_reduce_rows = real_rows
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
    check(counts["fit_reduce_rows"] == 2, "the snapshot probe did not run K4's rows entry twice")

    # the plain route's gate: 7 f32 planes at a scan cap of 8192 ask for
    # more shared memory than a block may use (the torch loop serves); 6
    # planes launch K1
    gate_limiter = ThresholdBasedEstimationLimiter(max_nodes=GATE_MAX_NODES)
    gate_card = {}
    for ports, route in ((4, "binpack_loop"), (3, "ffd_scan")):
        pods_g, tmpl_g = gate_worlds[ports]
        out, counts, _ = run_path(
            f"plain-route gate ({3 + ports} planes)",
            lambda: BinpackingNodeEstimator(gate_limiter).estimate_many(pods_g, tmpl_g),
        )
        check(counts[f"route:{route}"] == 1 and counts["ffd_scan_f32"] == int(route == "ffd_scan")
              and sum(counts[f"route:{k}"] for k in binpacking.ROUTES) == 1,
              f"the {3 + ports}-plane world did not take the {route} route")
        gate_card[ports] = out
    # the scale-up half of a reconcile tick (static_autoscaler.py:629-631,
    # :712): fork, filter-out-schedulable, revert, scale_up on the
    # TestCloudProvider; the burst without (3j) and with (3k) spread
    tick_card = {}
    for label, extra in (("3j", burst), ("3k", spread_burst)):
        rec, counts, _ = run_path(f"scale-up tick {label}", lambda extra=extra: tick_probe.run_tick(
            world_nodes, world_pods, extra, tick_templates, dev, timed=True))
        tick_card[label] = rec
        out = rec["out"]
        route = [k for k in ("ffd_scan", "ffd_scan_aff") if counts[f"route:{k}"]]
        check(len(route) == 1 and sum(counts[f"route:{k}"] for k in binpacking.ROUTES) == 1,
              f"tick {label}: the estimate did not take one kernel route: {counts}")
        kernel_launches = (counts["ffd_scan_swar"] + counts["ffd_scan_f32"]
                           if route[0] == "ffd_scan" else counts["ffd_scan_aff"])
        check(kernel_launches == 1 and counts["fit_reduce"] == 0,
              f"tick {label}: the estimate did not launch the kernel of its route {route[0]}")
        check(label == "3j" or route[0] == "ffd_scan_aff",
              "tick 3k: the spread leftovers did not take K3")
        check(rec["greedy_devices"] == ("cuda", "cuda"),
              f"tick {label}: greedy_schedule's outputs are not on the card")
        check(rec["reverted"], f"tick {label}: revert() did not restore the snapshot")
        res = out["result"]
        check(res.scaled_up and res.new_nodes > 0 and out["filtered"] and out["still"],
              f"tick {label}: filtered nothing, left nothing or scaled nothing")
        rec["route"] = route[0]
        grown = {g: n for g, n in out["sizes"] if n}
        print(
            f"# tick {label}: {rec['pending']} pending in ({len(extra)} burst), "
            f"{len(out['filtered'])} filtered onto existing nodes, {len(out['still'])} "
            f"still pending; route {route[0]}, launches "
            f"{ {k: v for k, v in counts.items() if v} }; spread terms S = "
            f"{rec['spread_terms']} interned (K3's S = {rec['k3_spread']}); chosen "
            f"{res.chosen_group}, new_nodes {res.new_nodes}, executed {res.executed}, "
            f"{res.options_considered} options; target sizes after: {grown}", flush=True,
        )
    check(tick_card["3k"]["spread_terms"] <= 32 and tick_card["3k"]["k3_spread"] <= 32,
          "tick 3k: more spread terms than K3's bitset holds")
    # the tick sequence over one incremental packer: tick 1 on 3j's listing
    # (the packer's first update, a full build), then two churns as a watch
    # cache delivers them (tick_probe.CHURNS), each followed by a tick whose
    # pack is the delta alone
    seq_packer = IncrementalPacker(device=dev)
    seq, counts, _ = run_path("tick sequence (3 ticks)", lambda: tick_probe.run_sequence(
        world_nodes, list(world_pods) + burst, tick_templates, dev, seq_packer, timed=True))
    check([rec["packer"]["full_packs"] for *_, rec in seq] == [1, 1, 1]
          and [rec["packer"]["incremental_updates"] for *_, rec in seq] == [0, 1, 2],
          "tick sequence: ticks 2 and 3 were not incremental")
    check(counts["route:ffd_scan"] == len(seq)
          and counts["ffd_scan_swar"] + counts["ffd_scan_f32"] == len(seq),
          f"tick sequence: each tick's estimate did not launch K1/K2 once: {counts}")
    diff = tick_probe.tick_differences(seq[0][3]["out"], tick_card["3j"]["out"])
    check(not diff, f"tick sequence: tick 1 differs from tick 3j in {diff}")
    for k, entry in enumerate(seq):
        nodes_k, pods_k, churned, rec = entry
        rec["route"] = rec["kernel"][0]
        print(tick_probe.sequence_line(str(k + 1), entry), flush=True)
        check(rec["greedy_devices"] == ("cuda", "cuda") and rec["reverted"]
              and rec["out"]["filtered"], f"tick sequence: tick {k + 1} did not filter on the card")
        check(len(pods_k) < rec["tensors"].num_pods and len(nodes_k) < rec["tensors"].num_nodes,
              f"tick sequence: tick {k + 1} outgrew its buckets")
        if churned is not None:
            changed = churned["bound"] + churned["removed"] + churned["arrived"]
            check(rec["packer"]["pod_rows"] <= 2 * changed,
                  f"tick sequence: tick {k + 1} dirtied {rec['packer']['pod_rows']} pod rows "
                  f"for {changed} changed pods")
    # the scale-down half of two reconcile loops, with the defaults (3m) and
    # with every eligible non-empty node simulated under spread (3n)
    down_card = {}
    for label, (listing, options_kw) in down_listings.items():
        rec, counts, _ = run_path(f"scale-down {label}", lambda listing=listing, kw=options_kw: (
            scaledown_probe.run_scale_down(*listing, dev, kw, timed=True)))
        down_card[label] = rec
        check(not any(counts.values()), f"scale-down {label} launched a kernel: {counts}")
        (loop1, loop2), act = rec["out"]["loops"], rec["out"]["actuation"]
        check(not loop1["plan"]["empty"] and not loop1["plan"]["drain"],
              f"scale-down {label}: the first loop planned deletions")
        check(loop2["plan"]["empty"] and act["deleted_empty"] and not act["failed"],
              f"scale-down {label}: the second loop deleted no empty node")
        fn, ops = rec["loops"][-1]["dispatch_ops"]
        check(ops[0].pod_req.device == dev and ops[1].device == dev,
              f"scale-down {label}: the removal dispatch did not run on the card")
        if label == "3m":
            check(len(loop2["simulated"]) == 30 and fn is not None,
                  "scale-down 3m: not 30 candidates simulated")
        else:
            check(fn.__name__ == "removal_feasibility_spread"
                  and len(loop2["simulated"]) == loop2["pool"] > 1000,
                  "scale-down 3n: the wide spread refit did not run")
            check(rec["loops"][-1]["joint_ops"][0].__name__ == "joint_removal_feasibility_spread"
                  and act["deleted_drain"] and act["evicted_pods"],
                  "scale-down 3n: no drain was validated jointly and deleted")
        print(scaledown_probe.summary_line(label, rec), flush=True)
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
        # and the kernel on an all-zero stream (every pod fits node 0: a
        # step is one summary pass, one round and a placement), the floor of
        # its chain of dependent steps
        ms = event_ms(lambda: kernel_fn(*plain_args))
        call_ms = event_ms(
            lambda: ffd_scan.ffd_binpack_groups_cuda(*args[:3], HEADLINE_MAX_NODES, args[3])
        )
        plain_ms = event_ms(lambda: plain_fn(*plain_args), reps=1)
        zeros = torch.zeros_like(ops.stream)
        floor_ms = event_ms(lambda: kernel_fn(zeros, *plain_args[1:]))
        del zeros

        P_pad = ops.stream.shape[1]
        steps = G * P_pad
        bytes_moved = (
            ops.stream.numel() * 4 + ops.allocs.numel() * 4 + ops.caps.numel() * 4
            + (NP * 4 if ops.plan is not None else 0)
            + G * NP * HEADLINE_MAX_NODES * 4 + G * 4 + G * P_pad
        )
        ops_per_plane = 4 if ops.plan is not None else 1   # or, sub, and, cmp | cmp
        operations = fit_tests(stats) * NP * ops_per_plane
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
            "call_ms": call_ms,
            "chain_floor_ms": floor_ms,
            "us_per_step": ms * 1e3 / P_pad,
        })
        print(
            f"# {name}: {ms:.3f} ms kernel ({ms * 1e3 / P_pad:.4f} us a step), "
            f"{call_ms:.3f} ms whole call, {plain_ms:.1f} ms plain, chain floor "
            f"{floor_ms:.3f} ms ({floor_ms * 1e3 / P_pad:.4f} us a step), parity exact "
            f"on all {G} groups", flush=True,
        )
        # the launch geometry (the shared memory from the kernel library
        # itself), and the search the data needs, as the plain version counts it
        print(
            f"# {name} launch: {G} blocks (one a group) of {ffd_scan.GROUP_WARPS} warps, "
            f"{ffd_scan.smem_bytes(NP, HEADLINE_MAX_NODES)} B dynamic shared memory a "
            f"block; {search_line(stats, steps, P_pad)}", flush=True,
        )
        # the bound's inputs, computed from this run's shapes and data
        print(
            f"# {name} bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({kernels[-1]['bound_by']}): G={G} P={P} P_pad={P_pad} planes={NP} "
            f"max_nodes={HEADLINE_MAX_NODES}, {bytes_moved} B moved ({bytes_ms:.4f} ms), "
            f"min({stats['node_tests']} node tests, {stats['summary_tests']} summary tests "
            f"+ {NODE_BLOCK} x {stats['candidate_blocks']} candidate blocks) = "
            f"{fit_tests(stats)} fit tests "
            f"x {NP} planes x {ops_per_plane} = {operations} operations ({ops_ms:.4f} ms)",
            flush=True,
        )
        del ops, got, want, plain_res
    phase("4a K1/K2 against their plain versions", t4)

    # K3 on its three main-path launches: the affinity workload (all 100
    # groups and all 20k pods), and the operands that the two spread worlds'
    # estimate_many handed it (S = 32: the only launches where the spread
    # gates and count planes run; all 16 groups). Each against its plain
    # version with the search counts of the data, then timed, with its
    # chain floor (all-zero requests and bits: every pod on node 0, a step
    # is one summary pass, one round and a placement)
    aff_prep = ffd_scan_affinity.prepare_scan_aff(**aff_ops, max_nodes=AFFINITY_MAX_NODES)
    aff_got = ffd_scan_affinity.ffd_scan_aff(aff_prep)
    torch.cuda.synchronize()
    k3_launches = [("affinity workload", aff_prep, aff_got, res_aff, None)] + [
        (f"{variant} spread world", *captured[variant], None, spread_card[variant][2])
        for variant in spread_worlds
    ]
    for label, ops, got, main_res, host_s in k3_launches:
        t0 = time.perf_counter()
        G_k, P_pad_k, R_k = ops.stream.shape
        M_k = ops.max_nodes
        plain_args = (ops.stream, ops.bits, ops.allocs, ops.caps, ops.nl, ops.hl, ops.spstat,
                      ops.num_planes, ops.num_spread, M_k)
        stats = {}
        want = ffd_scan_affinity._scan_plain_aff(*plain_args, stats=stats)
        torch.cuda.synchronize()
        log(f"ffd_scan_aff ({label}): plain version with work count "
            f"{time.perf_counter() - t0:.1f} s")
        max_err = 0.0
        for field, a, b in zip(("free", "opened", "placed"), want, got):
            check(a.dtype == b.dtype and a.shape == b.shape, f"ffd_scan_aff ({label}): {field} layout")
            check(torch.equal(a, b), f"ffd_scan_aff ({label}): {field} differs from the plain version")
            max_err = max(max_err, float((a.double() - b.double()).abs().max()))
        if main_res is not None:
            plain_res = ffd_scan_affinity.finish_scan_aff(ops, *want)
            for field, a, b in zip(plain_res._fields, plain_res, main_res):
                check(torch.equal(a, b),
                      f"ffd_scan_aff ({label}): main-path {field} differs from the plain version")
            del plain_res
        ms = event_ms(lambda: ffd_scan_affinity.ffd_scan_aff(ops))
        zeros = ops._replace(stream=torch.zeros_like(ops.stream), bits=torch.zeros_like(ops.bits))
        floor_ms = event_ms(lambda: ffd_scan_affinity.ffd_scan_aff(zeros))
        del zeros, want
        bytes_moved = sum(
            x.numel() * 4 for x in (ops.stream, ops.bits, ops.allocs, ops.caps, ops.nl, ops.hl,
                                    ops.spstat) if x is not None
        ) + G_k * R_k * M_k * 4 + G_k * 4 + G_k * P_pad_k
        operations = k3_operations(stats, R_k)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = operations / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        if main_res is not None:
            call_ms = event_ms(lambda: ffd_scan_affinity.ffd_binpack_groups_affinity_cuda(
                **aff_ops, max_nodes=AFFINITY_MAX_NODES
            ))
            plain_ms = event_ms(lambda: ffd_scan_affinity._scan_plain_aff(*plain_args), reps=1)
            extra = f", {call_ms:.3f} ms whole call, {plain_ms:.1f} ms plain"
            kernels.append({
                "name": "ffd_scan_aff",
                "route": "cuda",
                "source": "autoscaler_tpu_torch/csrc/ffd_scan_affinity.cu",
                "replaces": "autoscaler_tpu/ops/pallas_binpack_affinity.py:150",
                "launches": launches["ffd_scan_aff"],
                "max_abs_err": max_err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
                "call_ms": call_ms,
                "chain_floor_ms": floor_ms,
                "us_per_step": ms * 1e3 / P_pad_k,
            })
        else:
            extra = f"; estimate_many + least-waste {host_s:.3f} s host clock"
        print(
            f"# ffd_scan_aff on the {label}: {ms:.3f} ms kernel "
            f"({ms * 1e3 / P_pad_k:.4f} us a step), chain floor {floor_ms:.3f} ms "
            f"({floor_ms * 1e3 / P_pad_k:.4f} us a step), parity exact on all {G_k} groups"
            f"{extra}", flush=True,
        )
        # the launch geometry (the shared memory from the kernel library
        # itself), and the search the data needs, as the plain version counts it
        smem = ffd_scan_affinity.affinity_smem_bytes(R_k, ops.num_planes, ops.num_spread, M_k)
        print(
            f"# ffd_scan_aff launch on the {label}: {G_k} blocks (one a group) of "
            f"{ffd_scan_affinity.GROUP_WARPS} warps ({ffd_scan_affinity.WARP_BLOCKS} candidate "
            f"blocks a warp a round), {smem} B dynamic shared memory a block; "
            f"{search_line(stats, G_k * P_pad_k, P_pad_k)}", flush=True,
        )
        # the bound's inputs, computed from this run's shapes and data
        print(
            f"# ffd_scan_aff bound on the {label} {bound_ms:.4f} ms ({bound_by}): G={G_k} "
            f"P_pad={P_pad_k} R={R_k} planes={ops.num_planes} bit_planes={ops.bits.shape[2]} "
            f"S={ops.num_spread} max_nodes={M_k}, {bytes_moved} B moved ({bytes_ms:.4f} ms), "
            f"{k3_work(stats, R_k)} = {operations} operations ({ops_ms:.4f} ms); "
            f"{ms / bound_ms:.1f}x the bound", flush=True,
        )
        phase(f"4b K3 on the {label} against its plain version", t0)
    del aff_got, k3_launches, captured

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
    for ports, (pods_g, tmpl_g) in gate_worlds.items():
        compare_sampled(f"plain-route gate world ({3 + ports} planes)",
                        BinpackingNodeEstimator(gate_limiter, device="cpu"), pods_g, tmpl_g,
                        gate_card[ports], 1)

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

    fit_stats, probe_stats, rows_stats = {}, {}, {}
    max_err = hold("fit_reduce (fit-K4)", fit_reduce._fit_reduce_plain(*fit_ops, stats=fit_stats),
                   res_fit)
    for k, (operands, got) in enumerate(probe_launches):
        max_err = max(max_err, hold(
            f"fit_reduce (probe launch {k})",
            fit_reduce._fit_reduce_plain(*operands, stats=probe_stats if k == 0 else None), got,
        ))
    rows_err = 0.0
    for k, (operands, got) in enumerate(rows_launches):
        rows_err = max(rows_err, hold(
            f"fit_reduce_rows (probe launch {k})",
            fit_reduce._fit_reduce_rows_plain(*operands, stats=rows_stats if k == 0 else None), got,
        ))
    ms = event_ms(lambda: fit_reduce.fit_reduce_cuda(*fit_ops))
    plain_ms = event_ms(lambda: fit_reduce._fit_reduce_plain(*fit_ops), reps=1)
    probe_ops = probe_launches[0][0]
    probe_k4_ms = event_ms(lambda: fit_reduce.fit_reduce_cuda(*probe_ops))
    rows_ops = rows_launches[0][0]
    rows_ms = event_ms(lambda: fit_reduce.fit_reduce_rows(*rows_ops))
    rows_plain_ms = event_ms(lambda: fit_reduce._fit_reduce_rows_plain(*rows_ops), reps=1)
    call_ms = event_ms(lambda: fit_reduce.fit_reduce_exact(probe_t))
    P_f, R_f = fit_ops[0].shape
    N_f = fit_ops[1].shape[0]
    CP_f, CN_f = fit_ops[4].shape
    # operands read once (f32 rows, i32 classes, bool mask and validity),
    # outputs written once (bool, i32, i32); the operations: a class test a
    # live pair, and the compares of each pair that passes it up to the first
    # that fails, on the resources that can fail in its (block, tile) only
    # (the fewer of the plain and the pruned count: see _fit_reduce_plain)
    bytes_moved = (P_f * R_f * 4 + N_f * R_f * 4 + P_f * 4 + N_f * 4 + CP_f * CN_f + N_f
                   + P_f * (1 + 4 + 4))
    operations = fit_stats["class_tests"] + fit_stats["live_compares"]
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
        "call_ms": call_ms,
    })
    # the rows entry on the probe's special rows: the slots read once, and
    # for the real slots alone their R requests and [N] bool rows (padding
    # slots are never read); the outputs written once
    S_r, R_r = rows_ops[0].shape
    N_r = rows_ops[1].shape[0]
    real_r = int((rows_ops[3] >= 0).sum())
    rows_bytes = (real_r * R_r * 4 + N_r * R_r * 4 + real_r * N_r + S_r * 4
                  + S_r * (1 + 4 + 4))
    rows_operations = rows_stats["row_tests"] + rows_stats["live_compares"]
    rows_bytes_ms = rows_bytes / HBM_BYTES_PER_S * 1e3
    rows_ops_ms = rows_operations / FP32_OPS_PER_S * 1e3
    kernels.append({
        "name": "fit_reduce_rows",
        "route": "cuda",
        "source": "autoscaler_tpu_torch/csrc/fit_reduce.cu",
        "replaces": "autoscaler_tpu/ops/pallas_fit.py:78",
        "launches": launches["fit_reduce_rows"],
        "max_abs_err": rows_err,
        "ms": rows_ms,
        "plain_ms": rows_plain_ms,
        "bound_ms": max(rows_bytes_ms, rows_ops_ms),
        "bound_by": "bytes" if rows_bytes_ms >= rows_ops_ms else "operations",
        "library_ms": None,
    })
    probe_ops_count = probe_stats["class_tests"] + probe_stats["live_compares"]
    print(
        f"# fit_reduce: {ms:.3f} ms kernel at fit-K4 ({P_f} pods x {N_f} nodes, "
        f"{ms * 1e9 / (P_f * N_f):.4f} ps a pair), {plain_ms:.1f} ms plain, parity exact on "
        f"all {P_f} pods; probe: {probe_k4_ms:.3f} ms kernel, {call_ms:.3f} ms whole "
        f"fit_reduce_exact (exact patch {call_ms - probe_k4_ms:.3f} ms), parity exact on "
        f"both launches ({len(probe_launches)})", flush=True,
    )
    print(
        f"# fit_reduce bound {max(bytes_ms, ops_ms):.4f} ms ({kernels[-2]['bound_by']}): "
        f"P={P_f} N={N_f} R={R_f} CP={CP_f} CN={CN_f}, {bytes_moved} B moved "
        f"({bytes_ms:.4f} ms), {fit_stats['class_tests']} class tests + "
        f"min({fit_stats['compares']} compares, {fit_stats['live_compares']} on live "
        f"resources) = {operations} operations ({ops_ms:.4f} ms); "
        f"{ms / max(bytes_ms, ops_ms):.2f}x the bound; probe launch: "
        f"{probe_stats['class_tests']} class tests + min({probe_stats['compares']} "
        f"compares, {probe_stats['live_compares']} on live resources) = {probe_ops_count} "
        f"operations ({probe_ops_count / FP32_OPS_PER_S * 1e3:.4f} ms at the peak rate; "
        f"{probe_k4_ms / max(bytes_ms, probe_ops_count / FP32_OPS_PER_S * 1e3):.2f}x)",
        flush=True,
    )
    print(
        f"# fit_reduce_rows: {rows_ms:.3f} ms kernel on the probe's {S_r} special slots "
        f"({real_r} pods) x "
        f"{N_r} nodes (R={R_r}), {rows_plain_ms:.1f} ms plain, parity exact on both launches "
        f"({len(rows_launches)}); bound {max(rows_bytes_ms, rows_ops_ms):.4f} ms "
        f"({kernels[-1]['bound_by']}): {rows_bytes} B moved ({rows_bytes_ms:.4f} ms), "
        f"{rows_stats['row_tests']} row tests + min({rows_stats['compares']} compares, "
        f"{rows_stats['live_compares']} on live resources) = {rows_operations} operations "
        f"({rows_ops_ms:.4f} ms); {rows_ms / max(rows_bytes_ms, rows_ops_ms):.2f}x the bound",
        flush=True,
    )
    # the launch geometry and shared memory (from the kernel library), the
    # registers (ptxas), the live resources a (block, tile) the data leaves,
    # and the SASS instructions a pair of the inner loops
    smi_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sm_hz = float(smi_clock) * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, ops_l, stats_l in (("fit-K4", fit_ops, fit_stats),
                                  ("probe", probe_ops, probe_stats)):
        P_l, R_l = ops_l[0].shape
        N_l = ops_l[1].shape[0]
        CP_l, CN_l = ops_l[4].shape
        gx, gy, per_sm = fit_reduce.launch_geometry(P_l, N_l, R_l, CP_l, CN_l)
        print(
            f"# fit_reduce launch at {label}: grid {gx} x {gy} blocks of 128 threads "
            f"({per_sm} resident an SM, {sms} SMs), "
            f"{fit_reduce.smem_bytes(R_l, CP_l, CN_l)} B dynamic shared memory a block; "
            f"live resources a (block, tile): {stats_l['live_counts']}", flush=True,
        )
    gx, gy, per_sm = fit_reduce.launch_geometry(S_r, N_r, R_r, rows=True)
    print(f"# fit_reduce_rows launch: grid {gx} x {gy} ({per_sm} resident an SM), "
          f"{fit_reduce.rows_smem_bytes(R_r)} B dynamic shared memory a block", flush=True)
    for line in k4_registers(_build.BUILD_LOGS["fit_reduce"]):
        print(f"# fit_reduce.cu {line}", flush=True)
    loops = k4_sass_loops(_build.build("fit_reduce")["fit_reduce"])
    pairs = P_f * N_f
    for nl, (per_pair, alu_per_pair) in sorted(loops.items()):
        print(
            f"# fit_reduce SASS inner loop at {nl} live resources: {per_pair:.3f} instructions "
            f"a pair, {alu_per_pair:.3f} on the ALU pipe; floor at fit-K4's {pairs} pairs "
            f"({sms} SMs at {smi_clock} MHz): issue {pairs * per_pair / (sms * 128 * sm_hz) * 1e3:.4f}"
            f" ms, ALU pipe {pairs * alu_per_pair / (sms * 64 * sm_hz) * 1e3:.4f} ms", flush=True,
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
    # the exact patch in parts: the static special slots, their true rows,
    # the rows entry, and the scatter over K4's result
    E_p, K_p = probe_t.exc_rows.shape[0], probe_t.cell_pod.shape[0]
    special = fit_reduce.special_pods(probe_t)
    srows = fit_reduce.special_rows(probe_t)
    sreq = probe_t.pod_req[special.clamp(min=0)]
    slots = special.to(torch.int32)
    part = fit_reduce.fit_reduce_rows(sreq, free_d, srows, slots)
    base = fit_reduce.fit_reduce_cuda(*probe_ops)
    parts_ms = {
        "slots": event_ms(lambda: fit_reduce.special_pods(probe_t)),
        "row build": event_ms(lambda: fit_reduce.special_rows(probe_t)),
        "request gather": event_ms(lambda: probe_t.pod_req[special.clamp(min=0)]),
        "fit and reduction (rows entry)": event_ms(lambda: fit_reduce.fit_reduce_rows(
            sreq, free_d, srows, slots)),
        "scatter": event_ms(lambda: fit_reduce.patch_reduction(
            base, special, part, probe_t.pod_valid)),
        "free": event_ms(probe_t.free),
    }
    print(
        f"# probe exact patch: S = E + K = {E_p} + {K_p} = {E_p + K_p} slots "
        f"({int((special >= 0).sum())} pods), {N_r} nodes; "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in parts_ms.items())
        + f"; sum {sum(parts_ms.values()):.4f} ms; whole call {call_ms:.3f} ms = K4 "
        f"{probe_k4_ms:.3f} ms + {call_ms - probe_k4_ms:.3f} ms", flush=True,
    )
    del special, srows, sreq, slots, part, base
    phase("4f the probe against a dense path", t0)

    # both ticks again on ClusterSnapshots on the CPU, of the same objects:
    # every filtered key and assignment, the snapshot after the revert, the
    # whole ScaleUpResult and the provider afterwards must be equal
    for label, extra in (("3j", burst), ("3k", spread_burst)):
        t0 = time.perf_counter()
        cpu_rec = tick_probe.run_tick(world_nodes, world_pods, extra, tick_templates, "cpu")
        on_cpu, on_card = cpu_rec["out"], tick_card[label]["out"]
        diff = tick_probe.tick_differences(on_card, on_cpu)
        check(not diff, f"tick {label}: {diff} differ from the CPU")
        print(
            f"# tick {label}: card equals CPU: {len(on_cpu['filtered'])} filtered keys and "
            f"their assignments, {len(on_cpu['still'])} still pending, the snapshot after "
            f"revert, the whole ScaleUpResult ({on_cpu['result'].chosen_group} "
            f"+{on_cpu['result'].new_nodes}) and {len(on_cpu['sizes'])} target sizes; on "
            f"the CPU: pack {cpu_rec['pack_s']:.3f} s, filter-out {cpu_rec['filter_s']:.3f} s, "
            f"scale_up {cpu_rec['scale_up_s']:.3f} s", flush=True,
        )
        phase(f"4g tick {label} on the CPU", t0)

    # the tick sequence: tick 2's tensors against a full pack of the same
    # objects on the card, by pod key and node name; then the sequence
    # replayed on the CPU through a packer of its own (tick 1 its update
    # alone: 4g ran the whole tick on this listing), ticks 2 and 3 whole
    t4h = t0 = time.perf_counter()
    nodes_2, pods_2, _, rec_2 = seq[1]
    full_2, full_meta_2 = tick_probe.listing_snapshot(nodes_2, pods_2, dev).tensors()
    diff = tick_probe.tensors_differences(rec_2["tensors"], rec_2["meta"], full_2, full_meta_2)
    check(not diff, f"tick sequence: tick 2's tensors differ from a full pack in {diff}")
    print(f"# sequence tick 2: tensors equal a full pack of its listing by pod key and node "
          f"name (mask verdicts of all {full_meta_2.num_pods} pods, requests, allocatables, "
          f"used, groups, assignments); the full pack {time.perf_counter() - t0:.3f} s "
          f"with the comparison", flush=True)
    del full_2, full_meta_2
    cpu_packer = IncrementalPacker(device="cpu")
    for k, (nodes_k, pods_k, _, rec) in enumerate(seq):
        t0 = time.perf_counter()
        if k == 0:
            tick_probe.listing_snapshot(nodes_k, pods_k, "cpu", cpu_packer).tensors()
            print(f"# sequence tick 1 on the CPU: the packer's update {time.perf_counter() - t0:.3f}"
                  f" s host clock", flush=True)
            continue
        cpu_rec = tick_probe.run_tick(nodes_k, pods_k, (), tick_templates, "cpu",
                                      packer=cpu_packer)
        diff = tick_probe.tick_differences(rec["out"], cpu_rec["out"])
        check(not diff, f"tick sequence: tick {k + 1} differs from the CPU in {diff}")
        check(cpu_rec["packer"] == rec["packer"],
              f"tick sequence: tick {k + 1}'s packer counts differ from the CPU's")
        print(f"# sequence tick {k + 1}: card equals CPU ({len(cpu_rec['out']['filtered'])} "
              f"filtered, {len(cpu_rec['out']['still'])} still pending, the whole "
              f"ScaleUpResult); on the CPU: {time.perf_counter() - t0:.3f} s host clock, pack "
              f"{cpu_rec['pack_s']:.3f} s", flush=True)
        del cpu_rec
    del cpu_packer
    phase("4h the tick sequence against a full pack and on the CPU", t4h)

    # the resident arena: a second packer with a DeviceArena on the card
    # replays the three listings (packer updates only); what it serves must
    # equal the first packer's tensors bit for bit (they stay valid: that
    # packer uploads anew what changed), tick 1 seeds, ticks 2 and 3 apply
    # deltas with no full upload, and nothing rolls back
    t0 = time.perf_counter()
    arena = DeviceArena(device=dev)
    arena_packer = IncrementalPacker(arena=arena, device=dev)
    real_apply = arena.apply
    apply_ms = []

    def timed_apply(program):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_apply(program)
        stop.record()
        apply_ms.append((start, stop))
        return out

    arena.apply = timed_apply
    for k, (nodes_k, pods_k, _, rec) in enumerate(seq):
        t1 = time.perf_counter()
        served, served_meta = tick_probe.listing_snapshot(
            nodes_k, pods_k, dev, arena_packer).tensors()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t1
        start, stop = apply_ms[-1]
        stats = arena.take_stats()
        diff = tick_probe.fields_differing(served, rec["tensors"])
        check(not diff and served_meta.pod_index == rec["meta"].pod_index
              and served_meta.node_index == rec["meta"].node_index,
              f"arena: tick {k + 1}'s served tensors differ from the packer's in {diff}")
        check(served.pod_req.device == dev, f"arena: tick {k + 1} served off the card")
        check(stats["rollbacks"] == 0, f"arena: tick {k + 1} rolled back: {stats}")
        check((stats["full_uploads"] > 0) == (k == 0) and stats["promotions"] == int(k == 0),
              f"arena: tick {k + 1} {'did not seed' if k == 0 else 'uploaded in full'}: {stats}")
        print(f"# arena tick {k + 1}: update {host_s:.3f} s host clock, apply span on the card "
              f"{start.elapsed_time(stop):.3f} ms (CUDA events), stats {stats}, clones "
              f"{arena.clones}, served tensors equal the packer's bit for bit", flush=True)
        del served, served_meta
    arena.apply = real_apply
    del arena_packer, arena
    phase("4i the arena replay", t0)

    # 3m again on the CPU through a planner and actuator of its own, field
    # for field; 3n's removal dispatch on 256 seeded lanes (lanes are
    # independent) and its joint pass whole, on the CPU from the same operands
    t0 = time.perf_counter()
    listing, options_kw = down_listings["3m"]
    cpu_rec = scaledown_probe.run_scale_down(*listing, "cpu", options_kw)
    on_card, on_cpu = down_card["3m"]["out"], cpu_rec["out"]
    diff = scaledown_probe.scaledown_differences(on_card, on_cpu)
    fields = sum(len(lp) for lp in on_cpu["loops"]) + len(on_cpu["actuation"])
    utils = sum(len(lp["utilization"]) for lp in on_cpu["loops"])
    print(f"# scale-down 3m: card against CPU: {len(on_cpu['loops'])} loops and the "
          f"actuation, {fields} fields ({utils} utilizations bit for bit, "
          f"{sum(len(lp['plan']['unremovable']) for lp in on_cpu['loops'])} unremovable "
          f"reasons); first difference {diff[0] if diff else None}; on the CPU "
          f"{time.perf_counter() - t0:.3f} s host clock", flush=True)
    check(not diff, f"scale-down 3m: the card differs from the CPU in {diff}")
    del cpu_rec
    phase("4j scale-down 3m on the CPU", t0)
    t0 = time.perf_counter()
    lanes, fields, first = scaledown_probe.cpu_lanes_check(down_card["3n"]["loops"][-1]["dispatch_ops"])
    print(f"# scale-down 3n: removal dispatch, {lanes} lanes x {fields} fields on the CPU "
          f"against the card; first difference {first}", flush=True)
    check(first is None, f"scale-down 3n: lanes differ from the CPU at {first}")
    drains, fields, first = scaledown_probe.cpu_joint_check(down_card["3n"]["loops"][-1]["joint_ops"])
    print(f"# scale-down 3n: joint pass, {drains} drains x {fields} fields on the CPU "
          f"against the card; first difference {first}", flush=True)
    check(first is None, f"scale-down 3n: the joint pass differs from the CPU at {first}")
    phase("4k scale-down 3n lanes and joint pass on the CPU", t0)

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
    # where the ticks' time goes (tools/tick_probe.split_line): the host
    # clock of each part; the greedy loop's span on the card, its launches
    # and device time a step (torch.profiler), the card-busy time and the
    # idle share derived from them; the estimate's kernel on its operands
    seq_ticks = {f"sequence {k + 1}": rec for k, (*_, rec) in enumerate(seq)}
    for label, rec in {**tick_card, **seq_ticks}.items():
        _, kernel_fn, kernel_args = rec["kernel"]
        print(tick_probe.split_line(label, rec, tick_probe.profile_tick(rec),
                                    event_ms(lambda: kernel_fn(*kernel_args))), flush=True)
    # where the scale-down loops' time goes (tools/scaledown_probe.split_line)
    for label, rec in down_card.items():
        prof = scaledown_probe.dispatch_profile(rec["loops"][-1]["dispatch_ops"])
        print(scaledown_probe.split_line(label, rec, prof), flush=True)
    print(f"# total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi_line, flush=True)       # again: the head of a long log may be cut

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
