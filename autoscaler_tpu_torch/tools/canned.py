"""The canned scenarios, built in code: the fifteen documents of the JAX
package's ``benchmarks/scenarios/`` (fourteen scenarios and the policy
gym's suite) as the port's scenario engine reads them, and chip_smoke's
4v, which runs each of them on the card against the CPU.

    python3 -m autoscaler_tpu_torch.tools.canned                  # one card, then the CPU
    python3 -m autoscaler_tpu_torch.tools.canned --device cpu     # the CPU alone
    python3 -m autoscaler_tpu_torch.tools.canned --write DIR      # the documents as files

Each ``doc(name)`` equals its file key for key, with the estimator's rung
names the port's (``pallas`` → ``cuda``, ``xla`` → ``torch``; either
package's spec reads either name). Nothing is resized, re-seeded or
shortened; ``tests/test_torch_canned.py`` pins each document's canonical
SHA-256 (``canonical_sha256``). ``scenario_docs()`` lists the nineteen
plain scenarios: the fourteen, then the suite's five, each of which runs
as a scenario of its own.

On the card (``run``, ``card_problems``). A scenario that arms no fault on
a device rung decides on the card as on the CPU: the decision log byte
for byte, the score report apart from its walls, with the serving rung
named as the CPU names it (``drill_probe.comparable``). Four arm one
(``DEVICE_FAULTS``); on the card they differ from the CPU by design,
because the card's rungs are strict there (``estimator/binpacking.py``):
an injected fault or an open breaker on the cuda rung, or on the torch
rung where a dispatch routes around the cuda rung (dedup, one template),
raises, and the tick records the typed error, where the CPU descends the
ladder to its host rungs. What the card must do in each of them:

- ``kernel_fault_ladder``, ``device_lost_ladder``, ``gym_kernel_fault``:
  the cuda and torch rungs faulted (``device_lost`` faults both) from the
  fault's tick until ``clear_faults``. Every tick before the first fault
  decides as on the CPU. While a fault is armed nothing launches and
  nothing is served, on the host rungs neither: every estimate raises
  (most take the dedup route, as the pods are all alike, and the rest
  the cuda rung), and its tick records the typed error. After the clear a
  breaker the faults opened raises until its cooldown admits a half-open
  probe, which closes it when its rung next serves (a dedup dispatch
  leaves the cuda rung's probe unresolved on the card; the CPU closes it
  there, as its cuda rung is unavailable on the host). So no host rung
  serves after the clear, each card rung that serves again was closed by
  such a probe and is not tripped at the end, and past the cooldown a
  tick errs only where the CPU's does (``device_lost_ladder``'s API fault
  window crashes run_once on both; ``gym_kernel_fault``'s default
  cooldown outlasts the run).
- ``fleet_tenants``: a fault on the torch rung for two rounds, which the
  fleet's batches take on the CPU. On the card the batched rung is the
  cuda rung (K2), which the fault does not name, so no batch degrades:
  every ticket is answered on ``fleet_batched`` and equals its solo
  dispatch, where the CPU's faulted rounds descend to the oracle rung.
  The rounds before the fault decide as on the CPU.

``card_problems`` holds each design against the run, and the rest against
the CPU's run of the same document.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import sys
from typing import Dict, List, Tuple

from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.tools import drill_probe

SUITE = "gym_suite"
NAMES = (
    # the fault ladders
    "kernel_fault_ladder", "device_lost_ladder", "fault_backoff", "skip_reasons",
    "spot_reclaim",
    # the fleet
    "fleet_tenants", "fleet_overload", "fleet_rolling_restart",
    # the state machinery
    "arena_churn", "preemption_storm", "priority_inversion",
    # the workload shapes
    "burst_small", "diurnal_medium", "drain_heavy",
    SUITE,
)
FLEET = ("fleet_tenants", "fleet_overload", "fleet_rolling_restart")
# the scenarios that arm a fault on a device rung (module docstring)
DEVICE_FAULTS = ("kernel_fault_ladder", "device_lost_ladder", "fleet_tenants",
                 "gym_kernel_fault")


# -- building blocks: each writes the keys its file has, in its order -------------------


def _group(name, min_size, max_size, initial_size, cpu_m, mem_mb, provision_ticks, **extra):
    return {"name": name, "min_size": min_size, "max_size": max_size,
            "initial_size": initial_size, "cpu_m": cpu_m, "mem_mb": mem_mb, **extra,
            "provision_ticks": provision_ticks}


def _steady(rate, cpu_m, mem_mb, **extra):
    return {"kind": "steady", "rate": rate, "cpu_m": cpu_m, "mem_mb": mem_mb, **extra}


def _burst(at_tick, count, cpu_m, mem_mb, prefix, **extra):
    return {"at_tick": at_tick, "kind": "pod_burst", "count": count, "cpu_m": cpu_m,
            "mem_mb": mem_mb, "prefix": prefix, **extra}


def _complete(at_tick, count, prefix):
    return {"at_tick": at_tick, "kind": "pod_complete", "count": count, "prefix": prefix}


def _flap(at_tick, group, count, duration_ticks):
    return {"at_tick": at_tick, "kind": "node_flap", "group": group, "count": count,
            "duration_ticks": duration_ticks}


def _fault(at_tick, **fault):
    return {"at_tick": at_tick, "kind": "fault", "fault": fault}


def _clear(at_tick):
    return {"at_tick": at_tick, "kind": "clear_faults"}


def _ladder_faults(at_tick, clear_tick):
    """The cuda and torch rungs faulted at ``at_tick``, cleared at
    ``clear_tick`` (the messages are the files')."""
    return [
        _fault(at_tick, kind="kernel_fault", rung="cuda",
               message="Mosaic compile fault (injected)"),
        _fault(at_tick, kind="kernel_fault", rung="torch",
               message="XLA dispatch fault (injected)"),
        _clear(clear_tick),
    ]


# -- the fault ladders ------------------------------------------------------------------


def kernel_fault_ladder() -> dict:
    return {
        "name": "kernel_fault_ladder", "seed": 7, "ticks": 20, "tick_interval_s": 10.0,
        "node_groups": [_group("pool", 0, 30, 1, 4000.0, 16384.0, 1)],
        "workloads": [_steady(4.0, 1500.0, 1024.0, start_tick=1, end_tick=15,
                              completion_rate=0.25)],
        "events": _ladder_faults(2, 10),
        "options": {"kernel_breaker_failure_threshold": 3, "kernel_breaker_cooldown_s": 30.0},
    }


def device_lost_ladder() -> dict:
    return {
        "name": "device_lost_ladder", "seed": 11, "ticks": 22, "tick_interval_s": 10.0,
        "node_groups": [_group("pool", 0, 30, 1, 4000.0, 16384.0, 1)],
        "workloads": [_steady(4.0, 1500.0, 1024.0, start_tick=1, end_tick=19,
                              completion_rate=0.25)],
        "events": [
            _fault(2, kind="device_lost", message="TPU device lost (injected)"),
            _clear(9),
            _fault(13, kind="kube_api_error", end_tick=3,
                   message="apiserver unavailable (injected 503)"),
        ],
        "options": {"kernel_breaker_failure_threshold": 3, "kernel_breaker_cooldown_s": 30.0},
    }


def fault_backoff() -> dict:
    return {
        "name": "fault_backoff", "seed": 13, "ticks": 24, "tick_interval_s": 10.0,
        "node_groups": [
            _group("flaky", 0, 10, 1, 4000.0, 16384.0, 1),
            _group("standby", 0, 10, 1, 4000.0, 16384.0, 1, price_per_hour=2.5),
        ],
        "events": [
            _burst(1, 16, 1800.0, 2048.0, "burst"),
            _burst(12, 8, 1800.0, 2048.0, "late"),
        ],
        "faults": [
            {"kind": "scale_up_error", "group": "flaky", "probability": 1.0, "start_tick": 0,
             "end_tick": 6, "message": "cloud rejected the resize (quota)"},
            {"kind": "instance_error", "group": "standby", "probability": 1.0,
             "start_tick": 0, "end_tick": 3, "error_class": "OUT_OF_RESOURCES",
             "message": "machine failed: insufficient capacity in zone"},
        ],
        "options": {"expander": "price,least-waste",
                    "initial_node_group_backoff_duration_s": 40.0,
                    "max_node_group_backoff_duration_s": 120.0},
    }


def skip_reasons() -> dict:
    return {
        "name": "skip_reasons", "seed": 11, "ticks": 20, "tick_interval_s": 10.0,
        "node_groups": [
            _group("pool", 0, 30, 1, 4000.0, 16384.0, 1),
            _group("tight", 0, 20, 0, 1600.0, 2048.0, 1),
            _group("capped", 0, 1, 1, 1000.0, 2048.0, 1),
            _group("broken", 0, 10, 0, 8000.0, 32768.0, 1),
        ],
        "workloads": [_steady(3.0, 1500.0, 1024.0, start_tick=1, end_tick=12,
                              completion_rate=0.2)],
        "faults": [
            {"kind": "scale_up_error", "group": "tight",
             "message": "quota exceeded for machine family (injected)"},
            {"kind": "template_error", "group": "broken",
             "message": "machine shape unavailable (injected)"},
        ],
    }


def spot_reclaim() -> dict:
    return {
        "name": "spot_reclaim", "seed": 61, "ticks": 24, "tick_interval_s": 10.0,
        "node_groups": [_group("pool", 0, 24, 4, 4000.0, 16384.0, 2)],
        "workloads": [
            _steady(2.5, 700.0, 640.0, start_tick=1, end_tick=16, completion_rate=0.1,
                    priority=1),
            _steady(1.5, 1200.0, 1024.0, start_tick=1, end_tick=16, priority=100),
        ],
        "faults": [
            {"kind": "spot_reclaim", "group": "pool", "start_tick": 10, "end_tick": 11,
             "priority_cutoff": 50, "message": "spot capacity reclaimed (injected)"},
        ],
        "options": {"preemption_enabled": True, "scale_down_unneeded_time_s": 40.0},
    }


# -- the fleet --------------------------------------------------------------------------

_TENANT_KEYS = ("name", "pods", "groups", "max_nodes", "cpu_m", "mem_mb", "whatif")


def fleet_tenants() -> dict:
    tenants = [
        ("edge-small", 9, 3, 12, 400.0, 384.0, False),
        ("batch-medium", 30, 6, 24, 750.0, 1024.0, False),
        ("spot-whatif", 24, 8, 32, 500.0, 512.0, True),
        ("ml-wide", 64, 4, 48, 2000.0, 8192.0, False),
        ("web-large", 120, 12, 64, 300.0, 256.0, False),
        ("spiky-tiny", 3, 2, 4, 900.0, 2048.0, True),
    ]
    return {
        "name": "fleet_tenants", "seed": 7, "ticks": 8, "tick_interval_s": 10.0,
        "fleet": {"tenants": [dict(zip(_TENANT_KEYS, t)) for t in tenants]},
        "events": [
            _fault(3, kind="kernel_fault", rung="torch", start_tick=0, end_tick=2,
                   message="injected batched-rung fault: the batch must degrade to the "
                           "oracle rung with every co-batched tenant's answer intact"),
            _clear(5),
        ],
        "options": {"kernel_breaker_cooldown_s": 20.0},
    }


def _spec_event(at_tick, kind, fault_kind="", end_tick=0, message="", latency_s=0.0):
    """An event as a spec's ``to_dict`` writes it: every field, most at its
    default (``fleet_overload.json`` was written so)."""
    out = {"at_tick": at_tick, "count": 0, "cpu_m": 500.0, "duration_ticks": 1}
    if fault_kind:
        out["fault"] = {"end_tick": end_tick, "error_class": "OTHER", "group": "",
                        "kind": fault_kind, "latency_s": latency_s, "message": message,
                        "probability": 1.0, "rung": "", "start_tick": 0}
    out.update({"group": "", "kind": kind, "mem_mb": 512.0, "prefix": "",
                "spread_zone_skew": 0})
    return out


def fleet_overload() -> dict:
    tenants = [
        ("steady-a", 400.0, 3, 12, 384.0, 9, 1, False),
        ("steady-b", 600.0, 4, 16, 768.0, 14, 1, False),
        ("whatif-c", 500.0, 4, 16, 512.0, 12, 1, True),
        ("storm-d", 450.0, 3, 12, 448.0, 10, 6, False),
    ]
    return {
        "events": [
            _spec_event(8, "fault", fault_kind="sidecar_crash", end_tick=5,
                        message="sidecar process killed mid-run"),
            _spec_event(15, "clear_faults"),
            _spec_event(16, "fault", fault_kind="rpc_slow", end_tick=2, latency_s=1.5,
                        message="injected slow sidecar RPCs"),
            _spec_event(19, "clear_faults"),
        ],
        "fleet": {"tenants": [
            {"cpu_m": cpu, "deadline_s": 60.0, "groups": groups, "max_nodes": max_nodes,
             "mem_mb": mem, "name": name, "pods": pods, "requests_per_round": rpr,
             "whatif": whatif}
            for name, cpu, groups, max_nodes, mem, pods, rpr, whatif in tenants]},
        "name": "fleet_overload",
        "options": {"fleet_batch_scenarios": 8, "fleet_max_queue_depth": 64,
                    "fleet_prewarm": True, "fleet_shape_buckets": "16x4x8",
                    "fleet_tenant_burst": 3.0, "fleet_tenant_qps": 0.1,
                    "kernel_breaker_cooldown_s": 20.0},
        "seed": 21, "tick_interval_s": 30.0, "ticks": 30,
    }


# the tiers of fleet_rolling_restart, as the option's JSON text
_TIERS = {
    "bronze": {"burst": 0, "default_deadline_s": 20.0, "qps": 0.0, "queue_share": 0.25,
               "shed_priority": 10, "tenants": ["bronze-c"]},
    "default": {"burst": 2.0, "default_deadline_s": 10.0, "qps": 0.1, "queue_share": 0.5,
                "shed_priority": 20},
    "gold": {"burst": 8, "default_deadline_s": 60.0, "qps": 2.0, "queue_share": 0.75,
             "shed_priority": 0, "tenants": ["gold-a", "gold-b"]},
}


def fleet_rolling_restart() -> dict:
    def restart(at_tick, replica):
        return {"at_tick": at_tick, "fault": {
            "end_tick": 4, "kind": "replica_restart",
            "message": f"replica-{replica} rolling restart", "replica": replica,
            "start_tick": 0}, "kind": "fault"}

    return {
        "events": [
            {"at_tick": 2, "fault": {"end_tick": 2, "kind": "endpoint_flap",
                                     "message": "replica-2 endpoint flapping",
                                     "probability": 0.6, "replica": 2, "start_tick": 0},
             "kind": "fault"},
            restart(5, 0), restart(11, 1), restart(16, 2),
            {"at_tick": 21, "kind": "clear_faults"},
        ],
        "fleet": {"replicas": 3, "tenants": [
            {"cpu_m": 400.0, "groups": 3, "max_nodes": 12, "mem_mb": 384.0, "name": "gold-a",
             "pods": 9},
            {"cpu_m": 600.0, "groups": 4, "max_nodes": 16, "mem_mb": 768.0, "name": "gold-b",
             "pods": 14, "whatif": True},
            {"cpu_m": 450.0, "groups": 3, "max_nodes": 12, "mem_mb": 448.0,
             "name": "bronze-c", "pods": 10, "requests_per_round": 6},
            {"cpu_m": 500.0, "groups": 4, "max_nodes": 16, "mem_mb": 512.0, "name": "free-d",
             "pods": 12, "requests_per_round": 6},
        ]},
        "name": "fleet_rolling_restart",
        "options": {"fleet_batch_scenarios": 8, "fleet_max_queue_depth": 16,
                    "fleet_prewarm": True, "fleet_shape_buckets": "16x4x8",
                    "fleet_tenant_tiers": json.dumps(_TIERS, sort_keys=True),
                    "kernel_breaker_cooldown_s": 20.0},
        "seed": 33, "tick_interval_s": 30.0, "ticks": 24,
    }


# -- the state machinery ----------------------------------------------------------------


def arena_churn() -> dict:
    return {
        "name": "arena_churn", "seed": 23, "ticks": 24, "tick_interval_s": 10.0,
        "node_groups": [_group("pool", 0, 40, 5, 8000.0, 32768.0, 1)],
        "workloads": [_steady(3.0, 600.0, 512.0, start_tick=1, end_tick=20,
                              completion_rate=0.3)],
        "events": [
            _burst(2, 40, 1500.0, 2048.0, "storm"),
            _burst(5, 60, 900.0, 1024.0, "wave"),
            _fault(8, kind="arena_fault", end_tick=1,
                   message="arena apply fault (injected): double-buffer rollback"),
            _clear(9),
            _complete(10, 50, "storm"),
            {"at_tick": 12, "kind": "node_flap", "count": 2, "group": "pool",
             "duration_ticks": 2},
            _complete(14, 40, "wave"),
        ],
        "options": {"arena_enabled": True,
                    "arena_buckets": "8x8x8,64x8x8,64x16x8,128x16x8,128x32x8",
                    "scale_down_unneeded_time_s": 30.0, "scale_down_delay_after_add_s": 30.0},
    }


def preemption_storm() -> dict:
    return {
        "name": "preemption_storm", "seed": 16, "ticks": 24, "tick_interval_s": 10.0,
        "node_groups": [_group("pool", 0, 6, 4, 4000.0, 16384.0, 2)],
        "workloads": [_steady(3.0, 800.0, 768.0, start_tick=1, end_tick=18,
                              completion_rate=0.15, priority=10)],
        "events": [
            _burst(2, 16, 900.0, 1024.0, "batch", priority=10),
            _burst(6, 20, 1500.0, 2048.0, "storm", priority=100),
            _burst(8, 10, 1200.0, 1024.0, "storm2", priority=200),
            _complete(14, 25, "storm"),
        ],
        "options": {"preemption_enabled": True, "scale_down_unneeded_time_s": 40.0},
    }


def priority_inversion() -> dict:
    return {
        "name": "priority_inversion", "seed": 29, "ticks": 20, "tick_interval_s": 10.0,
        "node_groups": [_group("pool", 0, 4, 3, 4000.0, 16384.0, 3)],
        "events": [
            _burst(1, 12, 900.0, 1024.0, "filler", priority=10),
            _burst(4, 8, 1400.0, 1536.0, "polite", priority=100, preemption_policy="Never"),
            _burst(4, 6, 1400.0, 1536.0, "pushy", priority=50),
            _burst(6, 5, 600.0, 512.0, "scavenger", priority=-5),
            _complete(12, 8, "filler"),
        ],
        "options": {"preemption_enabled": True, "expendable_pods_priority_cutoff": 0,
                    "scale_down_unneeded_time_s": 40.0},
    }


# -- the workload shapes ----------------------------------------------------------------


def burst_small() -> dict:
    return {
        "name": "burst_small", "seed": 42, "ticks": 15, "tick_interval_s": 10.0,
        "node_groups": [
            _group("pool-a", 0, 12, 2, 4000.0, 16384.0, 1, zone="zone-a"),
            _group("pool-b", 0, 12, 1, 8000.0, 32768.0, 2, zone="zone-b",
                   price_per_hour=1.8),
        ],
        "events": [
            _burst(2, 30, 1500.0, 1024.0, "web", spread_zone_skew=4),
            _complete(8, 20, "web"),
        ],
        "workloads": [_steady(2.0, 300.0, 256.0, completion_rate=0.25)],
    }


def diurnal_medium() -> dict:
    return {
        "name": "diurnal_medium", "seed": 11, "ticks": 48, "tick_interval_s": 30.0,
        "node_groups": [_group("day-pool", 1, 20, 3, 4000.0, 16384.0, 1)],
        "workloads": [{"kind": "diurnal", "rate": 10.0, "period_ticks": 24, "cpu_m": 700.0,
                       "mem_mb": 512.0, "completion_rate": 0.3}],
        "options": {"scale_down_delay_after_add_s": 60.0},
    }


def drain_heavy() -> dict:
    return {
        "name": "drain_heavy", "seed": 29, "ticks": 30, "tick_interval_s": 15.0,
        "node_groups": [_group("batch", 1, 16, 8, 4000.0, 16384.0, 1)],
        "events": [_flap(10, "batch", 2, 3)],
        "workloads": [{"kind": "drain_heavy", "rate": 10.0, "cpu_m": 900.0, "mem_mb": 800.0,
                       "completion_rate": 0.35}],
    }


# -- the policy gym's suite -------------------------------------------------------------


def gym_suite() -> dict:
    """Five scenarios that share the tuner's seeds: diurnal, spike,
    drain-heavy, kernel-fault and a preemption storm."""
    return {"name": SUITE, "scenarios": [
        {
            "name": "gym_diurnal", "seed": 101, "ticks": 30, "tick_interval_s": 30.0,
            "node_groups": [
                _group("small-pool", 1, 16, 2, 2000.0, 8192.0, 1, price_per_hour=0.4),
                _group("big-pool", 0, 8, 1, 8000.0, 32768.0, 2, price_per_hour=1.4),
            ],
            "workloads": [{"kind": "diurnal", "rate": 8.0, "period_ticks": 16,
                           "cpu_m": 700.0, "mem_mb": 512.0, "completion_rate": 0.3}],
        },
        {
            "name": "gym_spike", "seed": 211, "ticks": 24, "tick_interval_s": 15.0,
            "node_groups": [_group("burst-pool", 1, 20, 2, 4000.0, 16384.0, 1)],
            "workloads": [{"kind": "spike", "rate": 12.0, "period_ticks": 8, "cpu_m": 900.0,
                           "mem_mb": 768.0, "completion_rate": 0.4}],
        },
        {
            "name": "gym_drain", "seed": 307, "ticks": 24, "tick_interval_s": 15.0,
            "node_groups": [_group("batch", 1, 16, 6, 4000.0, 16384.0, 1)],
            "events": [_flap(8, "batch", 2, 2)],
            "workloads": [{"kind": "drain_heavy", "rate": 8.0, "cpu_m": 900.0,
                           "mem_mb": 800.0, "completion_rate": 0.4}],
        },
        {
            "name": "gym_kernel_fault", "seed": 401, "ticks": 20, "tick_interval_s": 10.0,
            "node_groups": [_group("pool", 0, 24, 1, 4000.0, 16384.0, 1)],
            "workloads": [_steady(4.0, 1200.0, 1024.0, start_tick=1, end_tick=14,
                                  completion_rate=0.3)],
            "events": _ladder_faults(2, 10),
        },
        {
            "name": "gym_preempt_storm", "seed": 409, "ticks": 24, "tick_interval_s": 15.0,
            "node_groups": [_group("spot-pool", 1, 6, 4, 4000.0, 16384.0, 2)],
            "workloads": [_steady(3.0, 800.0, 640.0, start_tick=1, end_tick=20,
                                  completion_rate=0.2, priority=10)],
            "events": [
                _burst(5, 14, 1500.0, 1536.0, "storm", priority=100),
                _complete(14, 10, "storm"),
            ],
            "options": {"preemption_enabled": True},
        },
    ]}


_MAKE = {name: globals()[name] for name in NAMES}


def doc(name: str) -> dict:
    """The canned document ``name`` (a fresh copy each call)."""
    return _MAKE[name]()


def canonical_sha256(document: dict) -> str:
    """SHA-256 of ``document`` as canonical JSON: keys sorted, compact
    separators."""
    text = json.dumps(document, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(text.encode()).hexdigest()


def scenario_docs() -> List[Tuple[str, dict]]:
    """The nineteen plain scenarios: the fourteen documents, then the
    suite's five, each as a scenario of its own."""
    out = [(name, doc(name)) for name in NAMES if name != SUITE]
    return out + [(s["name"], s) for s in doc(SUITE)["scenarios"]]


def write_all(directory: str) -> Dict[str, str]:
    """Each of the fifteen documents as ``<directory>/<name>.json`` →
    {name: path}."""
    os.makedirs(directory, exist_ok=True)
    out = {}
    for name in NAMES:
        path = os.path.join(directory, f"{name}.json")
        with open(path, "w") as f:
            json.dump(doc(name), f, indent=2)
            f.write("\n")
        out[name] = path
    return out


def is_fleet(document: dict) -> bool:
    return "fleet" in document


# -- runs on a device -------------------------------------------------------------------


def run(document: dict, device=None) -> dict:
    """One run of ``document`` on ``device`` through the port's driver
    (``drill_probe.run_drill`` with its tick log, or ``run_fleet``) →
    {"result", "seconds", and "ticks" (the tick log) or "launches" (a
    fleet's, counted from the run's start)}."""
    if is_fleet(document):
        before = drill_probe.launch_counts()
        result, seconds = drill_probe.run_fleet(document, device)
        return {"result": result, "seconds": seconds,
                "launches": drill_probe.count_delta(drill_probe.launch_counts(), before)}
    ticks: list = []
    result, seconds = drill_probe.run_drill(document, device, tick_log=ticks)
    return {"result": result, "seconds": seconds, "ticks": ticks}


def fault_window(document: dict) -> Tuple[int, int]:
    """[the first tick whose event arms a fault on a device rung, the
    clear after it) of ``document``."""
    start = min(e["at_tick"] + e["fault"].get("start_tick", 0)
                for e in document["events"] if e["kind"] == "fault"
                and e["fault"]["kind"] in ("kernel_fault", "device_lost"))
    return start, min(e["at_tick"] for e in document["events"]
                      if e["kind"] == "clear_faults" and e["at_tick"] > start)


KERNELS = ("ffd_scan_f32", "ffd_scan_swar", "ffd_scan_aff")
CARD_RUNGS = ("cuda", "torch")


def _rung(served_key: str) -> str:
    """The rung that served a tick log's "route:reason"."""
    route = served_key.split(":")[0]
    return next((r for r in CARD_RUNGS if route.startswith(r)), "host")


def card_problems(name: str, document: dict, card: dict, cpu_view: dict) -> List[str]:
    """4v's checks of the card's run of ``document`` (``run``) against the
    CPU's (``drill_probe.comparable`` of the CPU's run): the module
    docstring's designs."""
    view = drill_probe.comparable(card["result"])
    if name not in DEVICE_FAULTS:
        return drill_probe.view_differences(view, cpu_view)
    start, clear = fault_window(document)
    bad = []
    if view["log"][:start] != cpu_view["log"][:start]:
        bad.append(f"the decision log differs from the CPU's before the first fault "
                   f"(tick {start})")
    result = card["result"]
    if is_fleet(document):
        rounds = [json.loads(line) for line in view["log"]]
        routes = {t["route"] for r in rounds for t in r["tenants"]}
        if routes != {"fleet_batched"}:
            bad.append(f"routes {sorted(routes)}, not fleet_batched alone")
        if not result.all_match() or result.unresolved:
            bad.append("a ticket unanswered or unequal to its solo dispatch")
        if any(r["outcomes"].get("failed") for r in rounds):
            bad.append("failed tickets: the fault reached a rung the card engages")
        if not card["launches"].get("ffd_scan_swar", 0) + card["launches"].get(
                "ffd_scan_f32", 0):
            bad.append("no batch launched K1/K2")
        return bad
    ticks = card["ticks"]
    for t in ticks:
        for e in t["errors"]:
            if "run_once crashed" not in e:
                bad.append(f"tick {t['tick']}: untyped error {e}")
    for t in ticks[start:clear]:
        launched = {k: t["launches"][k] for k in KERNELS if t["launches"].get(k)}
        if launched:
            bad.append(f"tick {t['tick']}: {launched} launched while faulted")
        if t["served"]:
            bad.append(f"tick {t['tick']}: served {t['served']} with the card's rungs "
                       f"faulted")
    if not any(t["errors"] for t in ticks[start:clear]):
        bad.append("no faulted tick recorded a typed error")
    from autoscaler_tpu_torch.config.options import AutoscalingOptions

    cooldown = document.get("options", {}).get(
        "kernel_breaker_cooldown_s", AutoscalingOptions().kernel_breaker_cooldown_s)
    recover = clear + math.ceil(cooldown / document["tick_interval_s"])
    cpu_erred = {json.loads(rec)["tick"] for rec in cpu_view["log"]
                 if json.loads(rec)["errors"]}
    for t in ticks[recover:]:
        if t["errors"] and t["tick"] not in cpu_erred:
            bad.append(f"tick {t['tick']}: an error past the breakers' cooldown, where the "
                       f"CPU's tick has none")
    late = {_rung(k) for t in ticks[clear:] for k in t["served"]}
    if "host" in late:
        bad.append("a host rung served after the clear")
    transitions = result.metrics.estimator_breaker_transitions_total
    for rung in sorted(late & set(CARD_RUNGS)):
        if transitions.get(rung=rung, from_state="half_open", to_state="closed") < 1:
            bad.append(f"the {rung} rung served after the clear with no half-open probe "
                       f"closing it")
        if rung in ticks[-1]["degraded"]:
            bad.append(f"the {rung} rung still tripped after serving again")
    return bad


def line(name: str, card: dict, cpu_seconds: float) -> dict:
    """4v's line for one scenario: ticks (rounds), card and CPU seconds,
    the routes served and the kernels' launches."""
    result = card["result"]
    if "ticks" in card:
        served: Dict[str, int] = {}
        launches: Dict[str, int] = {}
        for t in card["ticks"]:
            for k, v in t["served"].items():
                served[k] = served.get(k, 0) + v
            for k, v in t["launches"].items():
                launches[k] = launches.get(k, 0) + v
        ticks = len(card["ticks"])
        errors = sum(1 for t in card["ticks"] if t["errors"])
    else:
        served, launches = {}, dict(card["launches"])
        for r in result.records:
            for t in r.tenants:
                served[t.route] = served.get(t.route, 0) + 1
        ticks, errors = len(result.records), 0
    return {"scenario": name, "ticks": ticks, "card_s": round(card["seconds"], 3),
            "cpu_s": round(cpu_seconds, 3), "routes": dict(sorted(served.items())),
            "launches": dict(sorted(launches.items())), "ticks_with_errors": errors}


def tick_summary(ticks: list) -> list:
    """A tick log's ticks that launched, served, erred or ran degraded, as
    [tick, launches, served, errors (their first 60 characters), degraded
    rungs]."""
    return [[t["tick"], t["launches"], t["served"], [e[:60] for e in t["errors"]],
             t["degraded"]]
            for t in ticks if t["launches"] or t["served"] or t["errors"] or t["degraded"]]


def cpu_view(name: str) -> Tuple[float, dict]:
    """The scenario ``name`` (``scenario_docs``) on the CPU → (seconds,
    ``drill_probe.comparable``): chip_smoke 4v's CPU side, in a worker."""
    out = run(dict(scenario_docs())[name], "cpu")
    return out["seconds"], drill_probe.comparable(out["result"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--write", default="", help="write the fifteen documents into DIR")
    args = ap.parse_args(argv)
    if args.write:
        for name, path in write_all(args.write).items():
            print(f"{name}: {path}")
        return 0
    dev = resolve_device(args.device)
    problems = []
    for name, document in scenario_docs():
        out = run(document, dev)
        if dev.type == "cpu":
            print(json.dumps(line(name, out, out["seconds"]), sort_keys=True), flush=True)
            continue
        cpu_s, view = cpu_view(name)
        print(json.dumps(line(name, out, cpu_s), sort_keys=True), flush=True)
        if name in DEVICE_FAULTS and "ticks" in out:
            print(f"# {name} by tick {tick_summary(out['ticks'])}", flush=True)
        problems += [f"{name}: {p}" for p in card_problems(name, document, out, view)]
    for p in problems:
        print(f"FAIL: {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
