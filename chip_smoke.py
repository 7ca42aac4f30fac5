#!/usr/bin/env python3
"""Runs the PyTorch port's main path, the scale-up estimate, on one CUDA
card through its hand-written kernels, and holds every kernel against its
plain PyTorch version.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases (any failure raises and exits non-zero):

1. device: the card's name and power limit (nvidia-smi) and PyTorch's name;
2. build: the CUDA source compiled with nvcc; the ptxas report
   (registers, static shared memory, spills);
3. the main path, with every launch count set to 0 just before it and read
   just after: the repo's headline estimate (bench.py's workload: 100k
   pending pods × 500 node groups, 1000-node cap, 6 resource axes) through
   ``ffd_binpack_groups_cuda`` with integral requests (SWAR kernel K2) and
   with fractional memory (f32 kernel K1); then the object-level estimator
   on a 30k-pod pending burst × 100 node-group templates, the least-waste
   expander's choice, and a replicated-pods burst (the run-compressed
   route). Every kernel of the path must have launched;
4. each kernel at the headline shape against its plain version on the same
   card tensors, all groups and all pods, exactly; the main path's
   results against the plain versions' results; the estimator's results
   and choice against the same calls on the CPU;
5. timings with CUDA events: each kernel alone, the whole
   ``ffd_binpack_groups_cuda`` call, and the plain version.

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

# The card's peak rates (NVIDIA H100 SXM data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12   # non-tensor f32; also used for the int32 ops, a lower bound

BURST_PODS = 30_000      # BASELINE.md's 30k-pod burst (scalability_tests.md:30-34)
BURST_TEMPLATES = 100
REPLICATED_PODS = 30_000
REPLICATED_CONTROLLERS = 300
REPS = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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

    from autoscaler_tpu_torch.estimator.binpacking import (
        BinpackingNodeEstimator,
        _build_group_arrays,
    )
    from autoscaler_tpu_torch.expander.core import Option, build_strategy
    from autoscaler_tpu_torch.kube.objects import MEMORY, OwnerRef, Taint, Toleration
    from autoscaler_tpu_torch.ops import _build, ffd_scan
    from autoscaler_tpu_torch.snapshot.tensors import bucket_size
    from autoscaler_tpu_torch.utils.test_utils import GB, MB, build_test_node, build_test_pod
    from autoscaler_tpu_torch.utils.workload import HEADLINE_MAX_NODES, build_workload

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

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
    # (the line after each function's properties); the carry's dynamic
    # shared memory is printed with each kernel below
    for line in (_build.BUILD_LOG or "").splitlines():
        if "Used" in line or "spill" in line:
            print(f"# {_build.SOURCE.name}: {line.strip()}", flush=True)

    # -- operands of the main path (set-up: not part of the path) ----------
    req, masks, allocs, caps = build_workload()
    req_frac = req.copy()
    req_frac[:, MEMORY] += 0.5            # fractional memory refuses the SWAR plan
    P = req.shape[0]
    G = masks.shape[0]
    headline = ffd_scan.operands_from_numpy(req, masks, allocs, caps, dev)
    headline_frac = ffd_scan.operands_from_numpy(req_frac, masks, allocs, caps, dev)

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

    def choose(results):
        strategy = build_strategy(["least-waste"], seed=0)
        options = [
            Option(node_group=Group(g, templates[g]), node_count=n, pods=pods)
            for g, (n, pods) in sorted(results.items()) if n > 0 and pods
        ]
        best = strategy.best_option(options)
        return (best.node_group.id() if best else None), strategy.last_table

    # -- 3. the main path ---------------------------------------------------
    for name in ffd_scan.LAUNCHES:
        ffd_scan.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    res_swar = ffd_scan.ffd_binpack_groups_cuda(
        *headline[:3], max_nodes=HEADLINE_MAX_NODES, node_caps=headline[3]
    )
    res_f32 = ffd_scan.ffd_binpack_groups_cuda(
        *headline_frac[:3], max_nodes=HEADLINE_MAX_NODES, node_caps=headline_frac[3]
    )
    torch.cuda.synchronize()
    t_headline = time.perf_counter() - t0
    estimator = BinpackingNodeEstimator()          # device=None: the card
    before_burst = dict(ffd_scan.LAUNCHES)
    t0 = time.perf_counter()
    burst_card = estimator.estimate_many(burst, templates)
    choice_card = choose(burst_card)
    t_burst = time.perf_counter() - t0
    before_replicated = dict(ffd_scan.LAUNCHES)
    t0 = time.perf_counter()
    replicated_card = estimator.estimate_many(replicated, templates)
    t_replicated = time.perf_counter() - t0
    launches = dict(ffd_scan.LAUNCHES)
    check(
        before_replicated["ffd_scan_swar"] == before_burst["ffd_scan_swar"] + 1,
        "the burst estimate did not run the SWAR kernel",
    )
    check(launches == before_replicated, "the replicated burst did not take the runs route")
    print(
        f"# main path: headline K2+K1 {t_headline:.3f} s, 30k burst estimate + "
        f"expander {t_burst:.3f} s, replicated burst {t_replicated:.3f} s, "
        f"launches {launches}", flush=True,
    )
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    check(
        sum(len(p) for _, p in burst_card.values()) > 0 and choice_card[0] is not None,
        "the burst estimate scheduled nothing",
    )

    # -- 4. kernels against their plain versions, results against the CPU ----
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

    t0 = time.perf_counter()
    cpu_estimator = BinpackingNodeEstimator(device="cpu")
    burst_cpu = cpu_estimator.estimate_many(burst, templates)
    choice_cpu = choose(burst_cpu)
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
        f"scan call {burst_scan_ms:.3f} ms on the card", flush=True,
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
