"""CLI process entrypoint: flags → options, HTTP observability server, and
the reconcile loop.

Reference: cluster-autoscaler/main.go — flag surface :92-227,
createAutoscalingOptions :229-337, metrics/health-check/snapshotz HTTP
server :508-523, the scan-interval loop :471-489. Leader election (:525-573)
runs under --leader-elect: a coordination.k8s.io Lease elects one active
replica (utils/leaderelection.LeaderElector + KubeLease); the process is
stateless so failover needs no handover — a follower simply waits for the
lease and rebuilds its world from the next LIST.

Usage:
    python -m autoscaler_tpu_torch.main --provider=test --scan-interval=10 \
        --expander=least-waste --max-nodes-total=100 --address=:8085

The port of ``autoscaler_tpu/main.py``: the same flags, options, bindings
and fail-closed exits, plus ``--device`` (default: the first CUDA card;
``cpu`` runs the plain versions on the host), which takes the place of the
JAX package's CPU pin. The providers are test, gce, clusterapi,
externalgrpc and externalgrpc-ref; the cluster is the in-memory
``FakeClusterAPI`` or a Kubernetes API (``--kube-api``, ``--kubeconfig``)
through ``kube/client.KubeClusterAPI``. ``grpc``, ``google.protobuf`` and
``yaml`` are imported only in the branches that need them (externalgrpc,
externalgrpc-ref, ``--cloud-config``, ``--kubeconfig``). ``/perfz``
serves the perf observatory's per-tick records (``--perf-enabled``), with
the cost model behind ``--perf-cost-model``; ``/health-check``, ``/status``
and the status ConfigMap report the estimator's tripped kernel rungs.
``--compile-cache-dir`` names the directory of the kernel libraries
(``ops/_build.py``; without it, ``build/kernels/`` of a checkout or the
installed default): on a card, ``main`` loads every library the loop
launches from there before the first tick, building the missing ones all
at once, and ends with a non-zero exit before any tick when a build fails
or a library is missing with no ``nvcc``. An image's prebuild
(``python -m autoscaler_tpu_torch.ops.build_kernels``) makes that load
compile nothing.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.fleet.buckets import (
    DEFAULT_ARENA_BUCKETS as _ARENA_DEFAULT_BUCKETS,
    DEFAULT_BUCKETS as _FLEET_DEFAULT_BUCKETS,
)


def _bool_flag(s: str) -> bool:
    """Accept the usual spellings; reject typos instead of silently
    defaulting (an operator's '--x=0' must not read as True)."""
    v = s.strip().lower()
    if v in ("true", "1", "yes", "on"):
        return True
    if v in ("false", "0", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-autoscaler", description=__doc__)
    # the reference's most-used flags (main.go:92-227), same semantics
    p.add_argument("--scan-interval", type=float, default=10.0)
    p.add_argument("--v", type=int, default=0, help="log verbosity (klog -v)")
    p.add_argument("--max-nodes-total", type=int, default=0)
    p.add_argument("--cores-total", default="0:320000")
    p.add_argument("--memory-total", default="0:6400000")
    p.add_argument("--estimator", default="binpacking")
    p.add_argument("--expander", default="random",
                   help="comma-separated chain, e.g. priority,least-waste")
    p.add_argument("--expander-priority-config-file", default="",
                   help="hot-reloaded YAML/JSON {priority: [group regexes]} "
                        "file for the priority expander")
    p.add_argument("--expander-priority-config-map", default="",
                   help="live ConfigMap (in --namespace) with a 'priorities' "
                        "key for the priority expander; the reference's "
                        "cluster-autoscaler-priority-expander. Needs "
                        "--kube-api. Takes precedence over the file.")
    p.add_argument("--max-nodes-per-scaleup", type=int, default=1000)
    p.add_argument("--balance-similar-node-groups", action="store_true")
    p.add_argument("--scale-down-enabled", type=_bool_flag, default=True)
    p.add_argument("--scale-down-delay-after-add", type=float, default=600.0)
    p.add_argument("--scale-down-delay-after-delete", type=float, default=0.0)
    p.add_argument("--scale-down-delay-after-failure", type=float, default=180.0)
    p.add_argument("--scale-down-unneeded-time", type=float, default=600.0)
    p.add_argument("--scale-down-unready-time", type=float, default=1200.0)
    p.add_argument("--scale-down-utilization-threshold", type=float, default=0.5)
    p.add_argument("--scale-down-non-empty-candidates-count", type=int, default=30)
    p.add_argument("--scale-down-candidates-pool-ratio", type=float, default=0.1)
    p.add_argument("--scale-down-candidates-pool-min-count", type=int, default=50)
    p.add_argument("--max-empty-bulk-delete", type=int, default=10)
    p.add_argument("--max-graceful-termination-sec", type=float, default=600.0)
    p.add_argument("--max-total-unready-percentage", type=float, default=45.0)
    p.add_argument("--ok-total-unready-count", type=int, default=3)
    p.add_argument("--max-node-provision-time", type=float, default=900.0)
    p.add_argument("--enforce-node-group-min-size", action="store_true")
    p.add_argument("--new-pod-scale-up-delay", type=float, default=0.0)
    p.add_argument("--expendable-pods-priority-cutoff", type=int, default=-10)
    p.add_argument("--provider", "--cloud-provider", default="test",
                   help="cloud provider (reference --cloud-provider): test, "
                        "gce, clusterapi (MachineDeployment/MachineSet "
                        "scaling over the management cluster's CRD API), "
                        "externalgrpc (native tensor protocol), or "
                        "externalgrpc-ref (the reference's externalgrpc.proto "
                        "wire format — existing provider binaries plug in "
                        "unmodified)")
    p.add_argument("--cloud-config", default="",
                   help="provider config file (reference --cloud-config); "
                        "for externalgrpc*: YAML with an `address:` key")
    p.add_argument("--address", default=":8085", help="observability HTTP bind")
    p.add_argument("--profiling", action="store_true",
                   help="expose /debug/pprof/* (main.go:518-520)")
    p.add_argument("--health-check-max-inactivity", "--max-inactivity",
                   type=float, default=600.0)
    p.add_argument("--health-check-max-failing-time", "--max-failing-time",
                   type=float, default=900.0)
    p.add_argument("--max-consecutive-run-once-failures", type=int, default=0,
                   help="crash-only loop: hard-exit (abnormally, for the "
                        "supervisor to restart) after N consecutive "
                        "run_once failures; 0 = never, rely on the "
                        "health-check failing deadline")
    p.add_argument("--run-once-soft-deadline", type=float, default=0.0,
                   help="watchdog soft deadline per loop tick in seconds: "
                        "exceeded -> all-thread stack dump to stderr; "
                        "0 = auto (max of 4x scan interval and 60s)")
    p.add_argument("--rpc-address", action="append", default=[],
                   help="sidecar gRPC endpoint(s) for embedders that build "
                        "a TpuSimulationClient (repeat, or comma-separate, "
                        "for failover: the client fails over on "
                        "UNAVAILABLE/drain with jittered bounded backoff)")
    p.add_argument("--rpc-hedge", type=_bool_flag, default=False,
                   help="hedge idempotent Estimate/BatchEstimate against "
                        "the next --rpc-address endpoint after a "
                        "p99-derived delay (first answer wins, loser "
                        "cancelled; never past the caller's deadline)")
    p.add_argument("--rpc-default-deadline", type=float, default=30.0,
                   help="default deadline for sidecar RPCs without an "
                        "explicit timeout, so a wedged sidecar fails the "
                        "call instead of hanging the loop")
    p.add_argument("--kernel-breaker-failure-threshold", type=int, default=3,
                   help="consecutive failures tripping an estimator kernel "
                        "rung's circuit breaker open")
    p.add_argument("--kernel-breaker-cooldown", type=float, default=120.0,
                   help="seconds a tripped kernel rung stays open before a "
                        "half-open probe re-tests it")
    p.add_argument("--kube-client-get-retries", type=int, default=2,
                   help="transient-failure retries for idempotent control-"
                        "plane GETs (429/5xx honoring Retry-After, "
                        "transport errors); 0 disables")
    p.add_argument("--max-iterations", type=int, default=0,
                   help="stop after N loops (0 = forever); for testing")
    p.add_argument("--initial-node-group-backoff-duration", type=float, default=300.0)
    p.add_argument("--max-node-group-backoff-duration", type=float, default=1800.0)
    p.add_argument("--node-group-backoff-reset-timeout", type=float, default=10800.0)
    p.add_argument("--scale-down-unready-enabled",
                   type=_bool_flag, default=True)
    p.add_argument("--node-delete-delay-after-taint", type=float, default=0.0,
                   help="pause between taint and delete; 0 (default) because "
                        "the actuation wave is synchronous here (see options.py)")
    p.add_argument("--cordon-node-before-terminating", action="store_true")
    p.add_argument("--ignore-daemonsets-utilization", action="store_true")
    p.add_argument("--ignore-taint", action="append", default=[],
                   help="startup taint key ignored in templates (repeatable)")
    p.add_argument("--balancing-label", action="append", default=[],
                   help="compare node groups for similarity using ONLY "
                        "these label values (reference --balancing-label; "
                        "repeatable; overrides the resource comparator)")
    p.add_argument("--balancing-ignore-label", action="append", default=[],
                   help="extra label excluded from group similarity (repeatable)")
    p.add_argument("--node-group-auto-discovery", action="append", default=[],
                   help="provider auto-discovery spec (repeatable)")
    p.add_argument("--nodes", action="append", default=[],
                   help="node group spec min:max:<MIG url> (repeatable; "
                        "gce provider, reference --nodes)")
    p.add_argument("--gce-project", default="",
                   help="GCP project for the gce provider's auto-discovery")
    p.add_argument("--gce-api-url", default="",
                   help="compute API base URL override (tests/proxies); "
                        "empty = https://compute.googleapis.com/compute/v1")
    p.add_argument("--gce-token-file", default="",
                   help="file holding a bearer token for the compute API, "
                        "re-read per request so an external refresher "
                        "(e.g. a sidecar fetching metadata-server tokens) "
                        "just works; REQUIRED with --provider=gce")
    p.add_argument("--kube-api", "--kubernetes", default="",
                   help="control plane binding: 'in-cluster', or an API "
                        "server URL (empty with --provider=test uses the "
                        "in-memory fake)")
    p.add_argument("--kubeconfig", default="",
                   help="kubeconfig file for out-of-cluster runs (token- or "
                        "cert-based credentials; exec plugins are not run). "
                        "Mutually exclusive with a --kube-api URL.")
    p.add_argument("--max-drain-parallelism", type=int, default=1,
                   help="concurrent node drains (actuator worker pool)")
    p.add_argument("--max-scale-down-parallelism", type=int, default=10)
    p.add_argument("--scale-down-simulation-timeout", type=float, default=30.0)
    p.add_argument("--max-pod-eviction-time", type=float, default=120.0)
    p.add_argument("--max-bulk-soft-taint-count", type=int, default=10)
    p.add_argument("--max-bulk-soft-taint-time", type=float, default=3.0)
    p.add_argument("--unremovable-node-recheck-timeout", type=float, default=300.0)
    p.add_argument("--node-deletion-batcher-interval", type=float, default=0.0,
                   help="0 = flush per add (reference default)")
    p.add_argument("--skip-nodes-with-system-pods", type=_bool_flag, default=True)
    p.add_argument("--skip-nodes-with-local-storage", type=_bool_flag, default=True)
    p.add_argument("--skip-nodes-with-custom-controller-pods",
                   type=_bool_flag, default=True)
    p.add_argument("--min-replica-count", type=int, default=0)
    p.add_argument("--ignore-mirror-pods-utilization", action="store_true")
    p.add_argument("--scale-up-from-zero", type=_bool_flag, default=True)
    p.add_argument("--node-autoprovisioning-enabled", action="store_true")
    p.add_argument("--max-autoprovisioned-node-group-count", type=int, default=15)
    p.add_argument("--emit-per-nodegroup-metrics", action="store_true")
    p.add_argument("--user-agent", default="tpu-autoscaler")
    p.add_argument("--kube-client-qps", type=float, default=5.0,
                   help="client-side request rate limit (0 disables)")
    p.add_argument("--kube-client-burst", type=int, default=10)
    p.add_argument("--leader-elect", type=_bool_flag, default=False,
                   help="run under Lease-based leader election (needs a "
                        "control-plane binding); the reference defaults "
                        "this ON in-cluster")
    p.add_argument("--leader-elect-lease-name", default="tpu-autoscaler")
    p.add_argument("--parallel-drain", type=_bool_flag, default=True,
                   help="accepted for compatibility: the planner here IS "
                        "the reference's parallel-drain path (no legacy mode)")
    p.add_argument("--daemonset-eviction-for-empty-nodes",
                   type=_bool_flag, default=False)
    p.add_argument("--daemonset-eviction-for-occupied-nodes",
                   type=_bool_flag, default=True)
    p.add_argument("--max-nodegroup-binpacking-duration", type=float,
                   default=10.0, help="per-group estimate budget (main.go:216)")
    p.add_argument("--node-info-cache-expire-time", type=float, default=60.0,
                   help="template NodeInfo cache TTL seconds")
    p.add_argument("--compile-cache-dir", "--jax-compilation-cache-dir",
                   dest="compile_cache_dir",
                   default="/tmp/autoscaler_tpu_xla_cache",
                   help="directory of the CUDA kernel libraries (and of the "
                        "native rung's, in its native/): on a card every "
                        "library the loop launches is loaded from it before "
                        "the first tick, the missing ones built there with "
                        "nvcc; a prebuilt directory (python -m "
                        "autoscaler_tpu_torch.ops.build_kernels --out DIR) "
                        "makes the start compile nothing. Without the flag, "
                        "build/kernels/ of a checkout or the installed "
                        "default; the value shown is the JAX package's XLA "
                        "cache path, kept so that both packages' options "
                        "compare equal, and is not read unless given")
    p.add_argument("--arena-enabled", type=_bool_flag, default=False,
                   help="resident device arena: keep packed snapshot "
                        "tensors on-device across ticks and ship only "
                        "delta scatters for dirtied rows "
                        "(snapshot/arena.py, ROADMAP item 2)")
    p.add_argument("--arena-buckets", default=_ARENA_DEFAULT_BUCKETS,
                   help="comma-separated PxNxR power-of-two prewarm "
                        "buckets for the arena apply-kernel ladder (same "
                        "grammar as --fleet-shape-buckets; R is a cap)")
    p.add_argument("--preemption-enabled", type=_bool_flag, default=False,
                   help="priority-aware eviction packing each tick "
                        "(autoscaler_tpu/preempt via ops/preempt.py): plan "
                        "and actuate evictions of strictly-lower-priority "
                        "residents for pending pods no node fits outright; "
                        "off reproduces today's decisions byte-for-byte")
    p.add_argument("--preemption-churn-weight", type=float, default=0.0,
                   help="expander score penalty per eviction a scale-up "
                        "option leaves standing (0 = churn-blind ranking)")
    p.add_argument("--debugging-snapshot-enabled", type=_bool_flag, default=True,
                   help="serve /snapshotz captures")
    p.add_argument("--tracing-enabled", type=_bool_flag, default=True,
                   help="serve /tracez (flight-recorder span trees; the "
                        "tracer itself always runs, bounded)")
    p.add_argument("--trace-ring-size", type=int, default=64,
                   help="how many recent tick traces the in-memory flight "
                        "recorder keeps")
    p.add_argument("--trace-slow-tick-threshold", type=float, default=2.0,
                   help="ticks slower than this (wall seconds) get their "
                        "full span tree logged and the trace pinned in the "
                        "flight recorder; 0 disables")
    p.add_argument("--jax-profiler-dir", default="",
                   help="capture a torch.profiler session per tick into "
                        "<dir>/tick_<id>/trace.json (Chrome trace) — device "
                        "timeline keyed by the same tick id as the host "
                        "trace (debug tool; named as in the JAX package)")
    p.add_argument("--perf-enabled", type=_bool_flag, default=True,
                   help="serve /perfz (per-tick perf records: compile "
                        "telemetry, cost model, residency; the observatory "
                        "itself always runs, bounded)")
    p.add_argument("--perf-cost-model", type=_bool_flag, default=False,
                   help="record the cost model (bytes and operations of the "
                        "route's search, from the call's shapes) per new "
                        "(kernel route, shape signature)")
    p.add_argument("--perf-ring-size", type=int, default=64,
                   help="how many recent per-tick perf records the "
                        "in-memory ring keeps")
    p.add_argument("--explain-enabled", type=_bool_flag, default=True,
                   help="serve /explainz (per-tick decision records: "
                        "constraint attribution, expander scoring table, "
                        "skip/backoff state; the explainer itself always "
                        "runs, bounded)")
    p.add_argument("--explain-ring-size", type=int, default=64,
                   help="how many recent per-tick decision records the "
                        "in-memory ring keeps")
    p.add_argument("--journal-enabled", type=_bool_flag, default=True,
                   help="serve /journalz (per-tick keyframe/delta state "
                        "records — the black-box flight journal; the "
                        "recorder itself always runs, bounded)")
    p.add_argument("--journal-ring-size", type=int, default=64,
                   help="how many recent per-tick state records the "
                        "in-memory journal ring keeps")
    p.add_argument("--journal-keyframe-interval", type=int, default=16,
                   help="write a full journal keyframe every K ticks even "
                        "without a packer reseed or shape change")
    p.add_argument("--journal-probe-interval", type=int, default=0,
                   help="every N ticks, reconstruct the newest journaled "
                        "tick and bit-compare it (and its fit verdicts) "
                        "against the live packer state; drift becomes a "
                        "metric + trace event (0 = off)")
    p.add_argument("--journal-path", default="",
                   help="append the flight journal as JSONL to this file "
                        "for post-mortem reconstruct/diff/replay "
                        "(python -m autoscaler_tpu.journal; empty = "
                        "in-memory ring only)")
    p.add_argument("--fleet-coalesce-window-ms", type=float, default=5.0,
                   help="fleet serving: how long the coalescer waits after "
                        "the first queued estimate request before "
                        "dispatching the batch (autoscaler_tpu/fleet)")
    p.add_argument("--fleet-shape-buckets", default=_FLEET_DEFAULT_BUCKETS,
                   help="fleet serving: comma-separated PxGxR power-of-two "
                        "shape buckets requests pad into — the closed "
                        "compile-cache key set of the service")
    p.add_argument("--fleet-prewarm", type=_bool_flag, default=True,
                   help="fleet serving: compile every configured bucket at "
                        "startup so the first real request never compiles")
    p.add_argument("--fleet-batch-scenarios", type=int, default=8,
                   help="fleet serving: scenario slots per coalesced batch "
                        "(the batched kernel's leading axis)")
    p.add_argument("--fleet-max-tenant-labels", type=int, default=64,
                   help="fleet serving: distinct tenant labels admitted on "
                        "the per-tenant SLI metric series before later "
                        "tenants aggregate into __overflow__ (cardinality "
                        "guard for /metrics; 0 = unbounded)")
    p.add_argument("--fleet-max-queue-depth", type=int, default=0,
                   help="fleet overload armor: shed submits typed "
                        "(RESOURCE_EXHAUSTED + retry-after) past this "
                        "coalescing-queue depth; 0 = unbounded")
    p.add_argument("--fleet-tenant-qps", type=float, default=0.0,
                   help="fleet overload armor: per-tenant token-bucket "
                        "quota in requests/second (0 = no quotas); "
                        "over-quota submits shed typed with retry-after")
    p.add_argument("--fleet-tenant-burst", type=float, default=0.0,
                   help="fleet overload armor: token-bucket burst "
                        "capacity (0 = max(qps, 1))")
    p.add_argument("--fleet-tenant-tiers", default="",
                   help="tenant quota tiers, JSON tier name -> {qps, "
                        "burst, queue_share, default_deadline_s, "
                        "shed_priority, tenants} incl. a 'default' "
                        "catch-all; supersedes --fleet-tenant-qps with "
                        "per-tier budgets and tier-priority shed order")
    p.add_argument("--fleet-drain-grace-s", type=float, default=5.0,
                   help="sidecar drain: grace server.stop() allows "
                        "in-flight RPCs after admission closed and the "
                        "coalescer flushed (SIGTERM/preStop path)")
    p.add_argument("--slo-enabled", type=_bool_flag, default=True,
                   help="serve /sloz (per-SLO multi-window burn rates and "
                        "window history; the SLO engine itself always "
                        "runs, bounded)")
    p.add_argument("--gym-rollout-workers", type=int, default=4,
                   help="policy gym: concurrent candidate rollouts per "
                        "tuning stage (autoscaler_tpu/gym)")
    p.add_argument("--gym-objective-weights", default="",
                   help='policy gym: objective weights as '
                        '"slo=1,cost=8,churn=0.25" (empty = scorer '
                        "defaults); humans and the tuner read the same "
                        "scalar")
    p.add_argument("--gym-fleet-coalesce", type=_bool_flag, default=True,
                   help="policy gym: route rollout estimator dispatches "
                        "through the shared fleet coalescer (scores are "
                        "identical either way)")
    p.add_argument("--record-duplicated-events", type=_bool_flag, default=False,
                   help="post every event instead of suppressing repeats "
                        "within the correlator window")
    p.add_argument("--gce-concurrent-refreshes", type=int, default=1,
                   help="concurrent MIG listings per refresh (main.go:194)")
    p.add_argument("--force-ds", type=_bool_flag, default=False,
                   help="charge suitable pending DaemonSets onto new-node "
                        "capacity (reference --force-ds)")
    p.add_argument("--grpc-expander-url", default="",
                   help="external gRPC expander target (expander grpc in chain)")
    p.add_argument("--cluster-name", default="")
    p.add_argument("--namespace", default="kube-system")
    p.add_argument("--status-config-map-name", default="cluster-autoscaler-status")
    p.add_argument("--write-status-configmap",
                   type=_bool_flag, default=True)
    # the port's one extra flag, in place of the JAX package's CPU pin
    p.add_argument("--device", default=None,
                   help="torch device the loop runs on (default: the first "
                        "CUDA card; 'cpu' runs the plain versions on the "
                        "host)")
    return p


def options_from_args(args: argparse.Namespace) -> AutoscalingOptions:
    """createAutoscalingOptions analog (main.go:229)."""
    cores_min, cores_max = (float(x) for x in args.cores_total.split(":"))
    mem_min, mem_max = (float(x) for x in args.memory_total.split(":"))
    opts = AutoscalingOptions(
        scan_interval_s=args.scan_interval,
        max_nodes_total=args.max_nodes_total,
        min_cores_total=cores_min * 1000,
        max_cores_total=cores_max * 1000,
        min_memory_total=mem_min * 1024,
        max_memory_total_mib=mem_max * 1024,
        estimator=args.estimator,
        expander=args.expander,
        priority_config_file=args.expander_priority_config_file,
        priority_config_map=args.expander_priority_config_map,
        max_nodes_per_scaleup=args.max_nodes_per_scaleup,
        balance_similar_node_groups=args.balance_similar_node_groups,
        scale_down_enabled=args.scale_down_enabled,
        scale_down_delay_after_add_s=args.scale_down_delay_after_add,
        scale_down_delay_after_delete_s=args.scale_down_delay_after_delete,
        scale_down_delay_after_failure_s=args.scale_down_delay_after_failure,
        scale_down_utilization_threshold=args.scale_down_utilization_threshold,
        scale_down_non_empty_candidates_count=args.scale_down_non_empty_candidates_count,
        scale_down_candidates_pool_ratio=args.scale_down_candidates_pool_ratio,
        scale_down_candidates_pool_min_count=args.scale_down_candidates_pool_min_count,
        max_empty_bulk_delete=args.max_empty_bulk_delete,
        max_graceful_termination_s=args.max_graceful_termination_sec,
        max_total_unready_percentage=args.max_total_unready_percentage,
        ok_total_unready_count=args.ok_total_unready_count,
        max_node_provision_time_s=args.max_node_provision_time,
        enforce_node_group_min_size=args.enforce_node_group_min_size,
        new_pod_scale_up_delay_s=args.new_pod_scale_up_delay,
        expendable_pods_priority_cutoff=args.expendable_pods_priority_cutoff,
        cloud_provider=args.provider,
        max_inactivity_s=args.health_check_max_inactivity,
        max_failing_time_s=args.health_check_max_failing_time,
        max_consecutive_run_once_failures=(
            args.max_consecutive_run_once_failures
        ),
        run_once_soft_deadline_s=args.run_once_soft_deadline,
        rpc_default_deadline_s=args.rpc_default_deadline,
        kernel_breaker_failure_threshold=args.kernel_breaker_failure_threshold,
        kernel_breaker_cooldown_s=args.kernel_breaker_cooldown,
        initial_node_group_backoff_duration_s=args.initial_node_group_backoff_duration,
        max_node_group_backoff_duration_s=args.max_node_group_backoff_duration,
        node_group_backoff_reset_timeout_s=args.node_group_backoff_reset_timeout,
        scale_down_unready_enabled=args.scale_down_unready_enabled,
        node_delete_delay_after_taint_s=args.node_delete_delay_after_taint,
        cordon_node_before_terminating=args.cordon_node_before_terminating,
        ignore_daemonsets_utilization=args.ignore_daemonsets_utilization,
        ignored_taints=list(args.ignore_taint),
        balancing_label_keys=list(args.balancing_label),
        balancing_extra_ignored_labels=list(args.balancing_ignore_label),
        node_group_auto_discovery=list(args.node_group_auto_discovery),
        cluster_name=args.cluster_name,
        config_namespace=args.namespace,
        status_config_map_name=args.status_config_map_name,
        write_status_configmap=args.write_status_configmap,
        max_drain_parallelism=args.max_drain_parallelism,
        max_scale_down_parallelism=args.max_scale_down_parallelism,
        scale_down_simulation_timeout_s=args.scale_down_simulation_timeout,
        max_pod_eviction_time_s=args.max_pod_eviction_time,
        max_bulk_soft_taint_count=args.max_bulk_soft_taint_count,
        max_bulk_soft_taint_time_s=args.max_bulk_soft_taint_time,
        unremovable_node_recheck_timeout_s=args.unremovable_node_recheck_timeout,
        node_deletion_batcher_interval_s=args.node_deletion_batcher_interval,
        skip_nodes_with_system_pods=args.skip_nodes_with_system_pods,
        skip_nodes_with_local_storage=args.skip_nodes_with_local_storage,
        skip_nodes_with_custom_controller_pods=(
            args.skip_nodes_with_custom_controller_pods
        ),
        min_replica_count=args.min_replica_count,
        ignore_mirror_pods_utilization=args.ignore_mirror_pods_utilization,
        scale_up_from_zero=args.scale_up_from_zero,
        node_autoprovisioning_enabled=args.node_autoprovisioning_enabled,
        max_autoprovisioned_node_group_count=(
            args.max_autoprovisioned_node_group_count
        ),
        record_per_node_group_metrics=args.emit_per_nodegroup_metrics,
        user_agent=args.user_agent,
        grpc_expander_url=args.grpc_expander_url,
        daemonset_eviction_for_empty_nodes=(
            args.daemonset_eviction_for_empty_nodes
        ),
        daemonset_eviction_for_occupied_nodes=(
            args.daemonset_eviction_for_occupied_nodes
        ),
        max_nodegroup_binpacking_duration_s=(
            args.max_nodegroup_binpacking_duration
        ),
        node_info_cache_expire_time_s=args.node_info_cache_expire_time,
        debugging_snapshot_enabled=args.debugging_snapshot_enabled,
        tracing_enabled=args.tracing_enabled,
        trace_ring_size=args.trace_ring_size,
        trace_slow_tick_threshold_s=args.trace_slow_tick_threshold,
        jax_profiler_dir=args.jax_profiler_dir,
        perf_enabled=args.perf_enabled,
        perf_cost_model=args.perf_cost_model,
        perf_ring_size=args.perf_ring_size,
        explain_enabled=args.explain_enabled,
        explain_ring_size=args.explain_ring_size,
        journal_enabled=args.journal_enabled,
        journal_ring_size=args.journal_ring_size,
        journal_keyframe_interval=args.journal_keyframe_interval,
        journal_probe_interval=args.journal_probe_interval,
        journal_path=args.journal_path,
        fleet_coalesce_window_ms=args.fleet_coalesce_window_ms,
        fleet_shape_buckets=args.fleet_shape_buckets,
        fleet_prewarm=args.fleet_prewarm,
        fleet_batch_scenarios=args.fleet_batch_scenarios,
        fleet_max_tenant_labels=args.fleet_max_tenant_labels,
        fleet_max_queue_depth=args.fleet_max_queue_depth,
        fleet_tenant_qps=args.fleet_tenant_qps,
        fleet_tenant_burst=args.fleet_tenant_burst,
        fleet_tenant_tiers=args.fleet_tenant_tiers,
        fleet_drain_grace_s=args.fleet_drain_grace_s,
        rpc_addresses=list(args.rpc_address),
        rpc_hedge=args.rpc_hedge,
        slo_enabled=args.slo_enabled,
        arena_enabled=args.arena_enabled,
        arena_buckets=args.arena_buckets,
        preemption_enabled=args.preemption_enabled,
        preemption_churn_weight=args.preemption_churn_weight,
        compile_cache_dir=args.compile_cache_dir,
        gym_rollout_workers=args.gym_rollout_workers,
        gym_objective_weights=args.gym_objective_weights,
        gym_fleet_coalesce=args.gym_fleet_coalesce,
        force_daemonsets=args.force_ds,
    )
    opts.node_group_defaults.scale_down_unneeded_time_s = args.scale_down_unneeded_time
    opts.node_group_defaults.scale_down_unready_time_s = args.scale_down_unready_time
    opts.node_group_defaults.scale_down_utilization_threshold = (
        args.scale_down_utilization_threshold
    )
    return opts


class ObservabilityServer:
    """/metrics, /health-check, /snapshotz, /status (main.go:508-523),
    /tracez, /perfz, /explainz, plus /debug/pprof/* when profiling is
    enabled (main.go:518-520)."""

    def __init__(self, autoscaler, address: str = ":8085", profiling: bool = False):
        host, _, port = address.rpartition(":")
        self.host = host or "0.0.0.0"
        self.port = int(port)
        self.autoscaler = autoscaler
        self.profiling = profiling
        self._server: Optional[ThreadingHTTPServer] = None
        self._started_tracemalloc = False

    def start(self) -> int:
        autoscaler = self.autoscaler
        profiling = self.profiling

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: str, ctype="text/plain"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/metrics":
                    # content negotiation: exemplars (trace-id suffixes on
                    # histogram buckets) are only legal in the OpenMetrics
                    # dialect — a classic 0.0.4 scraper gets the plain
                    # exposition, an OpenMetrics-aware one (Prometheus with
                    # exemplar storage) opts in via Accept
                    om_type = "application/openmetrics-text"
                    if om_type in (self.headers.get("Accept") or ""):
                        self._send(
                            200,
                            autoscaler.metrics.registry.expose(
                                openmetrics=True
                            ),
                            f"{om_type}; version=1.0.0; charset=utf-8",
                        )
                    else:
                        self._send(200, autoscaler.metrics.registry.expose())
                elif self.path == "/health-check":
                    ok, msg = autoscaler.health_check.healthy()
                    # degraded (kernel rungs tripped, decisions flowing on a
                    # lower rung) is visible but NOT unhealthy: restarting
                    # the process would not heal a faulting device, and the
                    # whole point of the ladder is staying alive through it
                    degraded = getattr(
                        autoscaler, "degraded_rungs", lambda: []
                    )()
                    if ok and degraded:
                        msg = f"{msg} (degraded: {','.join(degraded)})"
                    self._send(200 if ok else 500, msg)
                elif self.path == "/snapshotz":
                    if autoscaler.debugger is None:
                        self._send(404, "debugging snapshotter disabled")
                        return
                    autoscaler.debugger.request()
                    payload = autoscaler.debugger.get()
                    self._send(
                        200,
                        payload or json.dumps({"status": "armed for next loop"}),
                        "application/json",
                    )
                elif self.path.startswith("/tracez"):
                    # flight recorder (autoscaler_tpu/trace): gated like
                    # /snapshotz — the tracer always records, the endpoint
                    # is the opt-out
                    tracer = getattr(autoscaler, "tracer", None)
                    enabled = getattr(
                        autoscaler.options, "tracing_enabled", True
                    )
                    if tracer is None or tracer.recorder is None or not enabled:
                        self._send(404, "tracing disabled (--tracing-enabled)")
                        return
                    from urllib.parse import parse_qs, urlparse

                    url = urlparse(self.path)
                    if url.path.rstrip("/") not in ("", "/tracez"):
                        self._send(404, "not found")
                        return
                    q = parse_qs(url.query)
                    fmt = q.get("format", [""])[0]
                    raw_id = q.get("id", [None])[0]
                    trace_id = None
                    if raw_id is not None:
                        try:
                            trace_id = int(raw_id)
                        except ValueError:
                            self._send(400, f"bad trace id {raw_id!r}")
                            return
                    rec = tracer.recorder
                    if fmt == "chrome":
                        body = rec.chrome(trace_id)
                        if body is None:
                            self._send(404, f"no trace {trace_id}")
                            return
                        self._send(200, body, "application/json")
                    elif fmt:
                        self._send(400, f"unknown format {fmt!r}")
                    elif trace_id is not None:
                        body = rec.detail_json(trace_id)
                        if body is None:
                            self._send(404, f"no trace {trace_id}")
                            return
                        self._send(200, body, "application/json")
                    else:
                        self._send(200, rec.list_json(), "application/json")
                elif self.path.startswith("/perfz"):
                    # perf observatory (autoscaler_tpu_torch/perf): gated
                    # like /tracez — the observatory always records, the
                    # endpoint is the opt-out
                    obs = getattr(autoscaler, "observatory", None)
                    enabled = getattr(
                        autoscaler.options, "perf_enabled", True
                    )
                    if obs is None or not enabled:
                        self._send(
                            404, "perf observatory disabled (--perf-enabled)"
                        )
                        return
                    from urllib.parse import parse_qs, urlparse

                    url = urlparse(self.path)
                    if url.path.rstrip("/") not in ("", "/perfz"):
                        self._send(404, "not found")
                        return
                    q = parse_qs(url.query)
                    raw_tick = q.get("tick", [None])[0]
                    if raw_tick is not None:
                        try:
                            tick = int(raw_tick)
                        except ValueError:
                            self._send(400, f"bad tick {raw_tick!r}")
                            return
                        body = obs.detail_json(tick)
                        if body is None:
                            self._send(404, f"no perf record for tick {tick}")
                            return
                        self._send(200, body, "application/json")
                    else:
                        self._send(200, obs.list_json(), "application/json")
                elif self.path.startswith("/explainz"):
                    # decision explainer (autoscaler_tpu/explain): gated
                    # like /perfz — the explainer always records, the
                    # endpoint is the opt-out
                    explainer = getattr(autoscaler, "explainer", None)
                    enabled = getattr(
                        autoscaler.options, "explain_enabled", True
                    )
                    if explainer is None or not enabled:
                        self._send(
                            404, "decision explainer disabled (--explain-enabled)"
                        )
                        return
                    from urllib.parse import parse_qs, urlparse

                    url = urlparse(self.path)
                    if url.path.rstrip("/") not in ("", "/explainz"):
                        self._send(404, "not found")
                        return
                    q = parse_qs(url.query)
                    raw_tick = q.get("tick", [None])[0]
                    pod = q.get("pod", [None])[0]
                    group = q.get("group", [None])[0]
                    if raw_tick is not None:
                        try:
                            tick = int(raw_tick)
                        except ValueError:
                            self._send(400, f"bad tick {raw_tick!r}")
                            return
                        body = explainer.detail_json(tick)
                        if body is None:
                            self._send(
                                404, f"no decision record for tick {tick}"
                            )
                            return
                        self._send(200, body, "application/json")
                    elif pod is not None:
                        self._send(200, explainer.pod_json(pod), "application/json")
                    elif group is not None:
                        self._send(
                            200, explainer.group_json(group), "application/json"
                        )
                    else:
                        self._send(200, explainer.list_json(), "application/json")
                elif self.path.startswith("/sloz"):
                    # SLO burn-rate engine (autoscaler_tpu/slo): gated like
                    # /perfz — the engine always computes windows, the
                    # endpoint is the opt-out
                    engine = getattr(autoscaler, "slo", None)
                    enabled = getattr(
                        autoscaler.options, "slo_enabled", True
                    )
                    if engine is None or not enabled:
                        self._send(
                            404, "SLO engine disabled (--slo-enabled)"
                        )
                        return
                    from urllib.parse import parse_qs, urlparse

                    url = urlparse(self.path)
                    if url.path.rstrip("/") not in ("", "/sloz"):
                        self._send(404, "not found")
                        return
                    q = parse_qs(url.query)
                    slo_name = q.get("slo", [None])[0]
                    if slo_name is not None:
                        body = engine.detail_json(slo_name)
                        if body is None:
                            self._send(
                                400,
                                f"unknown SLO {slo_name!r} (declared: "
                                f"{', '.join(engine.spec_names())})",
                            )
                            return
                        self._send(200, body, "application/json")
                    else:
                        self._send(200, engine.list_json(), "application/json")
                elif self.path.startswith("/journalz"):
                    # flight journal (autoscaler_tpu/journal): gated like
                    # /explainz — the recorder always journals, the
                    # endpoint is the opt-out. ?tick= drills into one
                    # record, ?diff=a,b renders the semantic state diff
                    # between two reconstructed ticks
                    journal = getattr(autoscaler, "journal", None)
                    enabled = getattr(
                        autoscaler.options, "journal_enabled", True
                    )
                    if journal is None or not enabled:
                        self._send(
                            404, "flight journal disabled (--journal-enabled)"
                        )
                        return
                    from urllib.parse import parse_qs, urlparse

                    url = urlparse(self.path)
                    if url.path.rstrip("/") not in ("", "/journalz"):
                        self._send(404, "not found")
                        return
                    q = parse_qs(url.query)
                    tick_raw = q.get("tick", [None])[0]
                    diff_raw = q.get("diff", [None])[0]
                    if tick_raw is not None:
                        try:
                            tick = int(tick_raw)
                        except ValueError:
                            self._send(400, f"bad tick {tick_raw!r}")
                            return
                        body = journal.detail_json(tick)
                        if body is None:
                            self._send(
                                404, f"no journal record for tick {tick}"
                            )
                            return
                        self._send(200, body, "application/json")
                    elif diff_raw is not None:
                        try:
                            tick_a, tick_b = (
                                int(t) for t in diff_raw.split(",")
                            )
                        except ValueError:
                            self._send(
                                400, f"bad diff {diff_raw!r} (want a,b)"
                            )
                            return
                        self._send(
                            200,
                            journal.diff_json(tick_a, tick_b),
                            "application/json",
                        )
                    else:
                        self._send(200, journal.list_json(), "application/json")
                elif self.path == "/status":
                    from autoscaler_tpu_torch.clusterstate.status import build_status

                    explainer = getattr(autoscaler, "explainer", None)
                    self._send(
                        200,
                        build_status(
                            autoscaler.csr, time.time(),
                            autoscaler.options.cluster_name,
                            degraded_rungs=autoscaler.degraded_rungs(),
                            last_decision=(
                                explainer.last_decision_summary()
                                if explainer is not None else None
                            ),
                        ).render(),
                    )
                elif self.path.startswith("/debug/pprof"):
                    if not profiling:
                        self._send(404, "profiling disabled (--profiling)")
                        return
                    from urllib.parse import parse_qs, urlparse

                    from autoscaler_tpu_torch.utils import pprof

                    url = urlparse(self.path)
                    if url.path.rstrip("/") == "/debug/pprof":
                        self._send(200, pprof.PPROF_INDEX)
                    elif url.path == "/debug/pprof/profile":
                        q = parse_qs(url.query)
                        try:
                            secs = float(q.get("seconds", ["5"])[0])
                        except ValueError:
                            self._send(400, "bad seconds parameter")
                            return
                        if not (0 < secs <= 60):
                            self._send(400, "seconds must be in (0, 60]")
                            return
                        if not pprof.PROFILE_LOCK.acquire(blocking=False):
                            self._send(429, "a profile is already running")
                            return
                        try:
                            body = pprof.SamplingProfiler().run(secs)
                        finally:
                            pprof.PROFILE_LOCK.release()
                        self._send(200, body)
                    elif url.path == "/debug/pprof/heap":
                        self._send(200, pprof.heap_profile())
                    elif url.path == "/debug/pprof/threadz":
                        self._send(200, pprof.thread_dump())
                    else:
                        self._send(404, "unknown pprof endpoint")
                else:
                    self._send(404, "not found")

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        if profiling:
            import tracemalloc

            if not tracemalloc.is_tracing():
                tracemalloc.start()
                self._started_tracemalloc = True
        self.port = self._server.server_address[1]
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return self.port

    def stop(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()
        if self._started_tracemalloc:
            import tracemalloc

            tracemalloc.stop()
            self._started_tracemalloc = False


def run_loop(
    autoscaler,
    scan_interval_s: float,
    max_iterations: int = 0,
    still_leader=None,
    max_consecutive_failures: int = 0,
    watchdog=None,
) -> bool:
    """The steady, CRASH-ONLY loop (main.go:471-489).

    One uncaught exception must not kill the process: each iteration's
    failure is caught, typed via utils/errors.to_autoscaler_error (the
    original traceback rides ``__cause__``), counted, and the loop keeps
    going — the HealthCheck failing deadline (no successful run_once for
    max-failing-time) remains the restart authority, and
    ``max_consecutive_failures`` (--max-consecutive-run-once-failures)
    adds an optional fast hard exit, returning False so main() exits
    abnormally for the supervisor. ``watchdog`` (utils/pprof.LoopWatchdog)
    is armed around each tick: a tick that overruns its soft deadline gets
    an all-thread stack dump before the liveness probe acts.

    still_leader: optional callback consulted between iterations under
    leader election — returning False stops the loop so the process can
    exit and be restarted as a follower (main.go:568 OnStoppedLeading)."""
    from autoscaler_tpu_torch.utils.errors import to_autoscaler_error

    log = logging.getLogger("run_loop")
    iterations = 0
    consecutive_failures = 0
    while True:
        loop_start = time.monotonic()
        if watchdog is not None:
            watchdog.arm()
        try:
            autoscaler.run_once(now_ts=time.time())
            consecutive_failures = 0
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — crash-only: log, count, go on
            err = to_autoscaler_error(e)
            consecutive_failures += 1
            log.error(
                "run_once crashed (%s, consecutive failure %d): %s",
                err.error_type.value, consecutive_failures, err,
                exc_info=err,
            )
            # activity (not success): the inactivity deadline stays quiet,
            # the failing deadline keeps ticking toward a probe restart
            health = getattr(autoscaler, "health_check", None)
            if health is not None:
                health.update_last_activity()
            metrics = getattr(autoscaler, "metrics", None)
            if metrics is not None:
                metrics.errors_total.inc(type=err.error_type.value)
            if (
                max_consecutive_failures
                and consecutive_failures >= max_consecutive_failures
            ):
                print(
                    f"run_once failed {consecutive_failures} times in a row "
                    "(--max-consecutive-run-once-failures); exiting for "
                    "supervisor restart",
                    file=sys.stderr,
                )
                return False
        finally:
            if watchdog is not None:
                watchdog.disarm()
        iterations += 1
        if max_iterations and iterations >= max_iterations:
            return True
        if still_leader is not None and not still_leader():
            print("lost leadership; exiting loop", file=sys.stderr)
            return False
        elapsed = time.monotonic() - loop_start
        time.sleep(max(scan_interval_s - elapsed, 0.0))


def kernel_dir(args: argparse.Namespace, argv=None) -> Optional[str]:
    """The ``--compile-cache-dir`` given on the command line, or None when
    it was not given (or given empty): its parser default is the JAX
    package's XLA path, which the port does not read."""
    given = sys.argv[1:] if argv is None else argv
    if any(a.startswith(("--compile", "--jax-compilation")) for a in given):
        return args.compile_cache_dir or None
    return None


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    chosen = kernel_dir(args, argv)
    if chosen is None:
        return _main(args)
    from autoscaler_tpu_torch.ops import _build

    with _build.build_dir(chosen):
        return _main(args)


def preload_kernels(device) -> Optional[str]:
    """On a card, every library the loop launches (and the sidecar that
    serves its estimates), loaded before the first tick or request (the
    missing ones built at once); logs the seconds and how many
    compilers ran. → None, or the error that ends the process. On the
    CPU nothing is built or loaded."""
    if device.type != "cuda":
        return None
    from autoscaler_tpu_torch.ops import _build

    try:
        secs, compilers = _build.preload(*_build.LOOP_SOURCES)
    except (RuntimeError, OSError) as e:
        return f"kernel libraries in {_build.BUILD_DIR} failed to load: {e}"
    print(f"tpu-autoscaler: kernel libraries {', '.join(_build.LOOP_SOURCES)} loaded "
          f"from {_build.BUILD_DIR} in {secs:.3f} s, {compilers} compilers ran",
          flush=True)
    return None


def _main(args: argparse.Namespace) -> int:
    opts = options_from_args(args)
    from autoscaler_tpu_torch.utils import klogx

    klogx.set_verbosity(args.v)
    logging.basicConfig(level=logging.INFO)

    from autoscaler_tpu_torch.core.static_autoscaler import StaticAutoscaler
    from autoscaler_tpu_torch.debugging import DebuggingSnapshotter

    if args.kube_api and args.kubeconfig:
        # pure argv validation comes before any cloud I/O
        print("--kube-api and --kubeconfig are mutually exclusive",
              file=sys.stderr)
        return 2
    if args.leader_elect and not (args.kube_api or args.kubeconfig):
        print("--leader-elect requires a control-plane binding "
              "(--kube-api or --kubeconfig)", file=sys.stderr)
        return 2

    if opts.cloud_provider == "test":
        from autoscaler_tpu_torch.cloudprovider.test_provider import TestCloudProvider

        provider = TestCloudProvider()
    elif opts.cloud_provider == "gce":
        from autoscaler_tpu_torch.cloudprovider.gce import build_gce_provider
        from autoscaler_tpu_torch.cloudprovider.gce_rest import (
            DEFAULT_BASE_URL,
            RestGceApi,
        )

        if args.gce_token_file:
            token_path = args.gce_token_file

            def token_fn() -> str:
                # re-read per request so an external refresher (sidecar
                # writing a fresh token) just works
                with open(token_path) as f:
                    return f.read().strip()
        else:
            print(
                "gce provider needs --gce-token-file (metadata-server "
                "fetch is the deploy site's refresher)",
                file=sys.stderr,
            )
            return 2
        if opts.node_group_auto_discovery and not args.gce_project:
            print(
                "--node-group-auto-discovery needs --gce-project (the "
                "aggregated MIG listing is project-scoped; without it "
                "discovery silently finds nothing)",
                file=sys.stderr,
            )
            return 2
        gce_api = RestGceApi(
            token_fn,
            base_url=args.gce_api_url or DEFAULT_BASE_URL,
            user_agent=opts.user_agent,
            project=args.gce_project or None,
        )
        try:
            provider = build_gce_provider(
                args.nodes, gce_api,
                auto_discovery=opts.node_group_auto_discovery,
                concurrent_refreshes=args.gce_concurrent_refreshes,
            )
        except ValueError as e:  # malformed --nodes/discovery spec
            print(str(e), file=sys.stderr)
            return 2
        if not (args.kube_api or args.kubeconfig):
            # pairing real MIG mutations with the empty in-memory fake would
            # mark every healthy instance unregistered and, after
            # max-node-provision-time, DELETE real VMs — fail closed
            print(
                "--provider=gce requires --kube-api (in-cluster or URL): "
                "without a real control-plane binding every MIG instance "
                "looks unregistered and would be cleaned up",
                file=sys.stderr,
            )
            return 2
    elif opts.cloud_provider in ("externalgrpc", "externalgrpc-ref"):
        # endpoint from the reference-shaped --cloud-config ({address: ...})
        address = ""
        if args.cloud_config:
            import yaml

            try:
                with open(args.cloud_config) as f:
                    cfg = yaml.safe_load(f) or {}
            except (OSError, yaml.YAMLError) as e:
                print(f"--cloud-config unreadable: {e}", file=sys.stderr)
                return 2
            address = str(cfg.get("address", "") or "") if isinstance(
                cfg, dict
            ) else ""
        if not address:
            print(
                f"--provider={opts.cloud_provider} needs --cloud-config with an "
                "`address: host:port` entry (reference externalgrpc "
                "README.md contract)",
                file=sys.stderr,
            )
            return 2
        if opts.cloud_provider == "externalgrpc":
            from autoscaler_tpu_torch.cloudprovider.external_grpc import (
                ExternalGrpcCloudProvider,
            )

            provider = ExternalGrpcCloudProvider(address)
        else:
            from autoscaler_tpu_torch.rpc.refcompat import RefProtocolCloudProvider

            provider = RefProtocolCloudProvider(address)
    elif opts.cloud_provider == "clusterapi":
        # the management cluster IS the cloud: scale MachineDeployments/
        # MachineSets through the same control plane the autoscaler watches
        # (reference cloudprovider/clusterapi; annotation-driven discovery)
        if not (args.kube_api or args.kubeconfig):
            print(
                "--provider=clusterapi requires a management-cluster "
                "binding (--kube-api or --kubeconfig)",
                file=sys.stderr,
            )
            return 2
        from autoscaler_tpu_torch.cloudprovider.clusterapi import (
            build_clusterapi_provider,
        )
        from autoscaler_tpu_torch.kube.client import KubeRestClient

        # same construction rules (incl. in-cluster + qps/burst throttling
        # + clean kubeconfig failure) as the kube-client block below
        if args.kubeconfig:
            try:
                capi_rest = KubeRestClient.from_kubeconfig(
                    args.kubeconfig, user_agent=opts.user_agent,
                    qps=args.kube_client_qps, burst=args.kube_client_burst,
                    get_retries=args.kube_client_get_retries,
                )
            except (OSError, ValueError) as e:
                print(f"--kubeconfig {args.kubeconfig}: {e}", file=sys.stderr)
                return 2
        elif args.kube_api == "in-cluster":
            capi_rest = KubeRestClient.in_cluster(
                user_agent=opts.user_agent,
                qps=args.kube_client_qps, burst=args.kube_client_burst,
                get_retries=args.kube_client_get_retries,
            )
        else:
            capi_rest = KubeRestClient(
                args.kube_api, user_agent=opts.user_agent,
                qps=args.kube_client_qps, burst=args.kube_client_burst,
                get_retries=args.kube_client_get_retries,
            )
        try:
            provider = build_clusterapi_provider(
                capi_rest, auto_discovery=opts.node_group_auto_discovery
            )
        except ValueError as e:
            print(f"--node-group-auto-discovery: {e}", file=sys.stderr)
            return 2
    else:
        print(
            f"unknown cloud provider {opts.cloud_provider!r} (available: test, "
            "gce, externalgrpc, externalgrpc-ref, clusterapi)",
            file=sys.stderr,
        )
        return 2

    if args.expander_priority_config_map and not (
        args.kube_api or args.kubeconfig
    ):
        # fail closed, like --provider=gce: without a control-plane binding
        # the ConfigMap can never be read and the priority expander would
        # silently behave as unconfigured
        print(
            "--expander-priority-config-map requires --kube-api "
            "(the ConfigMap is read from the live control plane); use "
            "--expander-priority-config-file for a mounted config",
            file=sys.stderr,
        )
        return 2

    if args.kube_api or args.kubeconfig:
        from autoscaler_tpu_torch.kube.client import KubeClusterAPI, KubeRestClient

        if args.kubeconfig:
            try:
                client = KubeRestClient.from_kubeconfig(
                    args.kubeconfig, user_agent=opts.user_agent,
                    qps=args.kube_client_qps, burst=args.kube_client_burst,
                    get_retries=args.kube_client_get_retries,
                )
            except (OSError, ValueError) as e:
                print(f"--kubeconfig {args.kubeconfig}: {e}", file=sys.stderr)
                return 2
        elif args.kube_api == "in-cluster":
            client = KubeRestClient.in_cluster(
                user_agent=opts.user_agent,
                qps=args.kube_client_qps, burst=args.kube_client_burst,
                get_retries=args.kube_client_get_retries,
            )
        else:
            client = KubeRestClient(
                args.kube_api, user_agent=opts.user_agent,
                qps=args.kube_client_qps, burst=args.kube_client_burst,
                get_retries=args.kube_client_get_retries,
            )
        api = KubeClusterAPI(
            client, watch=True,
            record_duplicated_events=args.record_duplicated_events,
        )
    else:
        from autoscaler_tpu_torch.kube.api import FakeClusterAPI

        api = FakeClusterAPI()
    if not args.parallel_drain:
        # accepted for reference-command-line compatibility only: the
        # planner here IS the parallel-drain path; there is no legacy
        # serial mode to fall back to
        print("WARNING: --parallel-drain=false is a no-op (the planner is "
              "always the parallel-drain path)", file=sys.stderr)
    autoscaler = StaticAutoscaler(
        provider, api, opts,
        debugger=DebuggingSnapshotter() if opts.debugging_snapshot_enabled else None,
        device=args.device,
    )
    failed = preload_kernels(autoscaler.device)
    if failed is not None:
        # no tick runs without its kernels: nothing descends to the torch
        # rung or the host
        print(failed, file=sys.stderr)
        return 1
    server = ObservabilityServer(autoscaler, args.address, profiling=args.profiling)
    port = server.start()
    print(f"tpu-autoscaler: observability on :{port}, scan interval "
          f"{opts.scan_interval_s}s, device {autoscaler.device}")
    from autoscaler_tpu_torch.utils.pprof import LoopWatchdog

    soft_deadline = opts.run_once_soft_deadline_s or max(
        4 * opts.scan_interval_s, 60.0
    )
    watchdog = LoopWatchdog(soft_deadline)
    try:
        if args.leader_elect:
            from autoscaler_tpu_torch.kube.client import KubeLease
            from autoscaler_tpu_torch.utils.leaderelection import LeaderElector

            elector = LeaderElector(
                KubeLease(client, args.leader_elect_lease_name,
                          opts.config_namespace)
            )
            print(f"waiting for leadership as {elector.identity}")
            outcome = {"clean": True}

            def lead(still_leader):
                outcome["clean"] = run_loop(
                    autoscaler, opts.scan_interval_s, args.max_iterations,
                    still_leader=still_leader,
                    max_consecutive_failures=(
                        opts.max_consecutive_run_once_failures
                    ),
                    watchdog=watchdog,
                )

            elector.run(lead)
            if not outcome["clean"]:
                # abnormal exit so supervisors restart the replica
                # (main.go:568 OnStoppedLeading is a Fatalf)
                return 1
        else:
            clean = run_loop(
                autoscaler, opts.scan_interval_s, args.max_iterations,
                max_consecutive_failures=opts.max_consecutive_run_once_failures,
                watchdog=watchdog,
            )
            if not clean:
                # abnormal exit so supervisors restart the replica
                return 1
    except KeyboardInterrupt:
        pass
    finally:
        watchdog.stop()
        server.stop()
        close = getattr(api, "close", None)
        if close is not None:  # stop KubeClusterAPI watch threads
            close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
