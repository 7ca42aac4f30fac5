"""Sidecar launcher: ``python -m autoscaler_tpu_torch.rpc``.

The deploy manifests used to inline ``python -c "...serve(...)..."`` with
no flag surface, which left every --fleet-* knob parsed by the host
process but unreachable by the sidecar that actually serves BatchEstimate.
This entrypoint closes that gap: it parses the sidecar-relevant flags,
folds them into AutoscalingOptions, and hands them to ``serve()`` — so
``--fleet-shape-buckets``/``--fleet-coalesce-window-ms``/
``--fleet-batch-scenarios`` configure the coalescer, ``--fleet-prewarm``
compiles every bucket before the port is announced, and the overload
armor (``--fleet-max-queue-depth``/``--fleet-tenant-qps``/
``--fleet-tenant-burst``) guards admission.

Graceful drain (the ARCHITECTURE.md "Fleet overload & drain" lifecycle):

    SIGTERM (or preStop GET /drain)
      → readiness bit down (/healthz 503; the chart's readinessProbe
        pulls the endpoint out of rotation)
      → stop admitting (every RPC refuses UNAVAILABLE + drain detail;
        clients fail over to another endpoint immediately)
      → flush in-flight coalescer buckets (every admitted ticket
        resolves or fails typed — zero hangs)
      → server.stop(--fleet-drain-grace-s) and exit 0.

The port of ``autoscaler_tpu/rpc/__main__.py``, with ``--device`` (default:
the first CUDA card; ``cpu`` runs the ops on the host) and
``--compile-cache-dir`` as the port's ``main.py`` takes them: on a card the
sidecar loads every kernel library it can launch before it binds its port,
and ends non-zero if one is missing and cannot be built.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading

from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.fleet import FleetCoalescer
from autoscaler_tpu_torch.fleet.buckets import DEFAULT_BUCKETS
from autoscaler_tpu_torch.main import _bool_flag, preload_kernels
from autoscaler_tpu_torch.rpc.service import (
    DrainState,
    drain_server,
    serve,
    start_health_server,
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m autoscaler_tpu_torch.rpc", description=__doc__,
    )
    p.add_argument("--address", default="127.0.0.1:9090",
                   help="host:port to bind (port 0 picks a free one)")
    p.add_argument("--max-workers", type=int, default=8,
                   help="gRPC handler threads; the coalescing window only "
                        "pays off when concurrent tenants can be admitted")
    # the --fleet-* surface, same spellings/defaults as the host process
    # (main.build_arg_parser) so one flag vocabulary configures both sides
    p.add_argument("--fleet-coalesce-window-ms", type=float, default=5.0)
    p.add_argument("--fleet-shape-buckets", default=DEFAULT_BUCKETS)
    p.add_argument("--fleet-prewarm", type=_bool_flag, default=True)
    p.add_argument("--fleet-batch-scenarios", type=int, default=8)
    p.add_argument("--fleet-max-tenant-labels", type=int, default=64)
    # overload armor + drain (fleet/admission.py, service.drain_server)
    p.add_argument("--fleet-max-queue-depth", type=int, default=0,
                   help="shed submits typed (RESOURCE_EXHAUSTED + "
                        "retry-after) past this queue depth; 0 = unbounded")
    p.add_argument("--fleet-tenant-qps", type=float, default=0.0,
                   help="per-tenant token-bucket quota, requests/second; "
                        "0 = no quotas")
    p.add_argument("--fleet-tenant-burst", type=float, default=0.0,
                   help="token-bucket burst capacity; 0 = max(qps, 1)")
    p.add_argument("--fleet-tenant-tiers", default="",
                   help="tenant quota tiers, JSON tier name -> {qps, "
                        "burst, queue_share, default_deadline_s, "
                        "shed_priority, tenants} incl. a 'default' "
                        "catch-all; supersedes --fleet-tenant-qps")
    p.add_argument("--fleet-drain-grace-s", type=float, default=5.0,
                   help="how long server.stop() waits for in-flight RPCs "
                        "after the drain sequence flushed the coalescer")
    p.add_argument("--health-port", type=int, default=8081,
                   help="HTTP readiness surface: GET /healthz (200 ready, "
                        "503 draining — the chart's readinessProbe) and "
                        "GET /drain (preStop: begin draining). "
                        "0 disables, -1 binds an ephemeral port")
    p.add_argument("--health-host", default="0.0.0.0",
                   help="bind address for the readiness surface; the "
                        "default answers the kubelet's pod-IP httpGet "
                        "probes (127.0.0.1 would make readinessProbe and "
                        "preStop fail in-cluster)")
    p.add_argument("--device", default=None,
                   help="torch device the sidecar's ops and coalescer run "
                        "on (default: the first CUDA card; 'cpu' runs the "
                        "plain versions on the host)")
    p.add_argument("--compile-cache-dir", default="",
                   help="directory of the CUDA kernel libraries, as the host "
                        "process takes it: on a card every library is loaded "
                        "from it before the port is bound, the missing ones "
                        "built there with nvcc (default: build/kernels/ of a "
                        "checkout, else the installed default)")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if not args.compile_cache_dir:
        return _serve(args)
    from autoscaler_tpu_torch.ops import _build

    with _build.build_dir(args.compile_cache_dir):
        return _serve(args)


def _serve(args: argparse.Namespace) -> int:
    failed = preload_kernels(resolve_device(args.device))
    if failed is not None:
        # no request is served without its kernels
        print(failed, file=sys.stderr)
        return 1
    options = AutoscalingOptions(
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
    )
    drain = DrainState()
    fleet = FleetCoalescer.from_options(options, device=args.device)
    server, port = serve(
        args.address, max_workers=args.max_workers, fleet=fleet, drain=drain,
        device=args.device,
    )
    health_port = 0
    httpd = None
    if args.health_port != 0:
        httpd, health_port = start_health_server(
            drain, port=max(args.health_port, 0), host=args.health_host
        )
    print(f"tpu-autoscaler sidecar serving on port {port} "
          f"(buckets={options.fleet_shape_buckets}, "
          f"prewarm={options.fleet_prewarm}, "
          f"max_queue_depth={options.fleet_max_queue_depth}, "
          f"tenant_qps={options.fleet_tenant_qps}, "
          f"health_port={health_port})", flush=True)

    # SIGTERM (kubelet pod termination) and SIGINT both enter the drain
    # sequence; the handler only sets an event — the actual drain runs on
    # the main thread so signal-context restrictions never bite
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    print("sidecar drain: readiness down, admission closed, flushing "
          "in-flight buckets", flush=True)
    drain_server(
        server, fleet=fleet, drain=drain, grace_s=options.fleet_drain_grace_s
    )
    if httpd is not None:
        # the health server answers 503 throughout the drain (so the
        # readinessProbe sees the bit) and shuts down only once the gRPC
        # port is closed
        httpd.shutdown()
    print("sidecar drained cleanly", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
