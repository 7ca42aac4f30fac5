"""gRPC sidecar service + host-side client.

The process split mirrors the BASELINE north-star: a host control plane
(Go/Python, owns cluster watch + actuation) flattens cluster state to dense
tensors and calls a device-owning sidecar over gRPC; the sidecar runs the
batched kernels. The protocol (protos/autoscaler.proto) is modeled on the
reference's in-tree gRPC plugin seams (expander/grpcplugin/protos/
expander.proto:10, cloudprovider/externalgrpc/protos/externalgrpc.proto:29).

Service handlers are registered via grpc's generic-handler API (no
grpc_tools codegen needed; messages come from protoc --python_out).

The port of ``autoscaler_tpu/rpc/service.py``. The servicer runs the
port's ops on its ``device`` (``ffd_binpack_groups``, the fleet
coalescer, ``greedy_schedule``, ``removal_feasibility``); the service
name, metadata keys and drain detail are the JAX package's byte for byte
(they are protocol), so either package's client talks to either sidecar.
This module, ``fleet_pb2`` and ``expander/grpc_.py`` are the only ones of
the serving paths that import ``grpc`` or ``google.protobuf``.
"""
from __future__ import annotations

import contextlib
import random
import threading
import time
from concurrent import futures
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch

import grpc

from autoscaler_tpu_torch import trace
from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.metrics import metrics as metrics_mod
from autoscaler_tpu_torch.rpc import autoscaler_pb2 as pb
from autoscaler_tpu_torch.rpc import fleet_pb2 as fleet_pb

SERVICE_NAME = "autoscaler_tpu.TpuSimulation"

# gRPC metadata key carrying the caller's trace context
# ("<trace_id>:<span_id>", trace.current_context): the sidecar adopts it as
# the parent of its serving span so the two processes' span trees join
# under ONE trace id. The fleet proto additionally carries it as a first-
# class field (BatchEstimateRequest.trace_context) for programmatic
# clients that bypass gRPC.
TRACE_METADATA_KEY = "x-autoscaler-trace-context"

# trailing-metadata key carrying the server's pacing hint on
# RESOURCE_EXHAUSTED (seconds, decimal string) — the gRPC analog of the
# HTTP Retry-After header utils/http.RetryPolicy already honors
RETRY_AFTER_METADATA_KEY = "retry-after-s"

# the drain detail prefix on UNAVAILABLE: the client failover path keys on
# it (a draining sidecar means "go elsewhere NOW", not "backoff and retry
# here"), and hack/verify.sh's live-drain gate asserts it surfaces
DRAIN_DETAIL = "draining: sidecar shutting down"


class DrainState:
    """The sidecar's readiness bit. ``begin_drain()`` flips it exactly
    once; RPC handlers consult :meth:`ready` to stop admitting (UNAVAILABLE
    + drain detail) and the health endpoint serves it as
    readinessProbe/preStop state (deploy/chart wires /healthz + /drain)."""

    def __init__(self) -> None:
        self._draining = threading.Event()

    def ready(self) -> bool:
        return not self._draining.is_set()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def begin_drain(self) -> None:
        self._draining.set()


def start_health_server(drain: DrainState, port: int = 0, host: str = "127.0.0.1"):
    """Serve the sidecar's readiness surface on a daemon thread:

    - ``GET /healthz`` — 200 ``ok`` while ready, 503 ``draining`` after
      drain begins (the chart's readinessProbe);
    - ``GET/POST /drain`` — flips the drain bit and returns 200 (the
      chart's preStop hook, so admission closes BEFORE SIGTERM lands).

    → (httpd, bound_port). Callers shut it down with httpd.shutdown()."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _respond(self, code: int, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            if self.path == "/healthz":
                if drain.ready():
                    self._respond(200, b"ok\n")
                else:
                    self._respond(503, b"draining\n")
            elif self.path == "/drain":
                drain.begin_drain()
                self._respond(200, b"draining\n")
            else:
                self._respond(404, b"not found\n")

        do_POST = do_GET  # noqa: N815 — preStop httpGet vs kubectl POST

        def log_message(self, *args):  # silence per-probe stderr noise
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(
        target=httpd.serve_forever, name="sidecar-healthz", daemon=True
    )
    thread.start()
    return httpd, httpd.server_address[1]


def _metadata_context(context) -> str:
    """Extract the caller's trace context from gRPC invocation metadata
    (best-effort: propagation must never fail a request)."""
    try:
        md = context.invocation_metadata()
    except Exception:  # noqa: BLE001 — fake/partial test contexts
        return ""
    for key, value in md or ():
        if key == TRACE_METADATA_KEY:
            return str(value)
    return ""


def _f32(blob: bytes, *shape: int) -> np.ndarray:
    return np.frombuffer(blob, np.dtype("<f4")).reshape(shape).copy()


def _i32(blob: bytes, *shape: int) -> np.ndarray:
    return np.frombuffer(blob, np.dtype("<i4")).reshape(shape).copy()


def _u8(blob: bytes, *shape: int) -> np.ndarray:
    return np.frombuffer(blob, np.uint8).reshape(shape).astype(bool)


def _checked_blob(
    blob: bytes, dtype, shape: tuple, name: str, context
) -> np.ndarray:
    """Decode one operand blob with its axes VALIDATED: a blob whose byte
    count disagrees with the declared axes aborts the RPC as
    INVALID_ARGUMENT with the one consistent message shape — previously
    each servicer method re-decoded raw and a mismatched axis surfaced as
    an opaque numpy reshape error deep in the handler."""
    want = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if len(blob) != want:
        context.abort(
            grpc.StatusCode.INVALID_ARGUMENT,
            f"operand axis mismatch: {name} carries {len(blob)} bytes but "
            f"the declared axes {tuple(int(d) for d in shape)} require {want}",
        )
    return (
        np.frombuffer(blob, np.dtype(dtype)).reshape(shape).copy()
    )


def _decode_estimate_operands(request, context):
    """THE checked decode path shared by Estimate and BatchEstimate (the
    two RPCs carrying the estimator operand set): resource-axis schema
    check, then every blob validated against the declared (P, G, R) axes.
    → (pod_req [P,R] f32, masks [G,P] bool, allocs [G,R] f32, caps [G]
    i32)."""
    _check_resource_axis(request.pods, context)
    P = request.pods.num_pods
    R = request.pods.num_resources
    G = len(request.group_ids)
    if P < 0 or R <= 0 or G <= 0:
        context.abort(
            grpc.StatusCode.INVALID_ARGUMENT,
            f"operand axis mismatch: P={P}, R={R}, G={G} do not describe "
            "an estimable request (need R > 0 and at least one group)",
        )
    pod_req = _checked_blob(
        request.pods.requests, "<f4", (P, R), "pods.requests", context
    )
    masks = _checked_blob(
        request.pod_masks, np.uint8, (G, P), "pod_masks", context
    ).astype(bool)
    allocs = _checked_blob(
        request.template_allocs, "<f4", (G, R), "template_allocs", context
    )
    caps = _checked_blob(
        request.node_caps, "<i4", (G,), "node_caps", context
    )
    return pod_req, masks, allocs, caps


def _check_resource_axis(pods: "pb.PackedPods", context) -> None:
    """Extended-resource schema contract: when the
    caller names extended columns, the resource axis must be exactly
    base-6 + those names — a silent mismatch would let a device-plugin
    column be read as (or shadow) a base axis and flip verdicts without
    any error. Aborts the RPC as INVALID_ARGUMENT on violation."""
    from autoscaler_tpu_torch.kube import objects as k8s

    ext = list(pods.extended_resources)
    if ext and pods.num_resources != k8s.NUM_RESOURCES + len(ext):
        context.abort(
            grpc.StatusCode.INVALID_ARGUMENT,
            f"num_resources={pods.num_resources} but schema is "
            f"{k8s.NUM_RESOURCES} base + {len(ext)} extended {ext}",
        )


class TpuSimulationServicer:
    """Device-side implementation: each RPC is one batched kernel dispatch.

    ``residency`` (a perf.ResidencyLedger, optional) accounts each method's
    unpacked what-if batch tensors in the ``scenario_batches`` pool — the
    sidecar's contribution to device_resident_bytes.

    ``fleet`` (a fleet.FleetCoalescer, optional) backs the BatchEstimate
    coalescing surface; absent, the first BatchEstimate builds a default
    coalescer (default buckets, pre-warm off) so the RPC works out of the
    box — deploy sites pass FleetCoalescer.from_options for the
    --fleet-* knobs.

    ``tracer`` (a trace.Tracer, optional): the sidecar-side flight
    recorder. Each Estimate/BatchEstimate opens one ``rpcServe`` serving
    trace that ADOPTS the caller's propagated trace context (gRPC metadata
    / the fleet proto's trace_context field) — client and sidecar spans
    for one request share one trace id, so /tracez on either process joins
    the tree. Absent, a bounded default is created (always-on, like the
    host-side tracer).

    ``device``: where the ops run (None = the first CUDA card; "cpu" the
    host)."""

    def __init__(self, residency=None, fleet=None, tracer=None, drain=None,
                 device=None):
        self.device = resolve_device(device)
        self.residency = residency
        self.fleet = fleet
        if tracer is None:
            tracer = trace.Tracer(recorder=trace.FlightRecorder(capacity=64))
        self.tracer = tracer
        # drain (a DrainState, optional): once begin_drain() fires, every
        # RPC is refused UNAVAILABLE + DRAIN_DETAIL before touching the
        # coalescer — new work goes elsewhere while in-flight buckets flush
        self.drain = drain
        self._fleet_lock = threading.Lock()

    def _check_admitting(self, context) -> None:
        if self.drain is not None and self.drain.draining:
            context.abort(grpc.StatusCode.UNAVAILABLE, DRAIN_DETAIL)

    @staticmethod
    def _abort_admission(context, e) -> None:
        """Typed fleet shed → gRPC status (the mapping fleet/errors.py
        documents): drain → UNAVAILABLE + drain detail (fail over), queue
        expiry → DEADLINE_EXCEEDED (do NOT resend), overload →
        RESOURCE_EXHAUSTED with the retry-after hint in trailing metadata
        AND the detail text."""
        from autoscaler_tpu_torch.fleet import FleetDeadlineError, FleetDrainError

        if isinstance(e, FleetDrainError):
            context.abort(grpc.StatusCode.UNAVAILABLE, f"{DRAIN_DETAIL}: {e}")
        if isinstance(e, FleetDeadlineError):
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        retry_after = float(getattr(e, "retry_after_s", 0.0))
        context.set_trailing_metadata(
            ((RETRY_AFTER_METADATA_KEY, f"{retry_after:.6f}"),)
        )
        context.abort(
            grpc.StatusCode.RESOURCE_EXHAUSTED,
            f"fleet overload ({getattr(e, 'outcome', 'shed')}): {e}",
        )

    def _ensure_fleet(self):
        with self._fleet_lock:
            if self.fleet is None:
                from autoscaler_tpu_torch.fleet import FleetCoalescer

                self.fleet = FleetCoalescer(device=self.device)
            # ensure_running, NOT start: a request racing the drain must
            # never re-arm a stopping coalescer (its submit raises the
            # typed FleetDrainError instead, mapped to UNAVAILABLE+detail)
            self.fleet.ensure_running()
            return self.fleet

    @contextlib.contextmanager
    def _account(self, method: str, *arrays):
        """Account the unpacked batch tensors as resident for the duration
        of the dispatch, released when the RPC returns — the what-if batch
        is garbage once the response is serialized, and leaving it seated
        would report dead tensors as live until the next call."""
        if self.residency is None:
            yield
            return
        from autoscaler_tpu_torch.perf import POOL_SCENARIO_BATCHES, array_bytes

        self.residency.set(
            POOL_SCENARIO_BATCHES, method, array_bytes(list(arrays))
        )
        try:
            yield
        finally:
            self.residency.drop(POOL_SCENARIO_BATCHES, method)

    def _t(self, a) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def Estimate(self, request: pb.EstimateRequest, context) -> pb.EstimateResponse:
        from autoscaler_tpu_torch.ops.binpack import ffd_binpack_groups

        self._check_admitting(context)
        pod_req, masks, allocs, caps = _decode_estimate_operands(request, context)
        with self.tracer.tick(
            metrics_mod.RPC_SERVE,
            parent_context=_metadata_context(context),
            method="Estimate",
        ), self._account("Estimate", pod_req, masks, allocs, caps):
            # graftlint: disable=GL003 — sidecar server side: the ladder lives in the CLIENT process (TpuSimulationClient's caller); a fault here surfaces as an RPC error the client's ladder absorbs
            res = ffd_binpack_groups(
                self._t(pod_req),
                self._t(masks),
                self._t(allocs),
                max_nodes=int(request.max_nodes),
                node_caps=self._t(caps),
            )
            return pb.EstimateResponse(
                node_counts=np.asarray(res.node_count.cpu(), np.dtype("<i4")).tobytes(),
                scheduled=np.asarray(res.scheduled.cpu(), np.uint8).tobytes(),
            )

    def BatchEstimate(
        self, request: "fleet_pb.BatchEstimateRequest", context
    ) -> "fleet_pb.BatchEstimateResponse":
        """The fleet serving surface: park the tenant's request in the
        coalescer's admission queue and block until its batch dispatches —
        N concurrent tenants pay ONE sharded mesh dispatch per shape
        bucket per window instead of N. Operands ride the SAME checked
        decode path as Estimate, so an axis mismatch fails identically on
        both routes."""
        self._check_admitting(context)
        pod_req, masks, allocs, caps = _decode_estimate_operands(request, context)
        G = len(request.group_ids)
        prices = None
        if request.prices:
            prices = _checked_blob(
                request.prices, "<f4", (G,), "prices", context
            )
        from autoscaler_tpu_torch.fleet import (
            FleetAdmissionError,
            FleetDeadlineError,
            FleetDrainError,
            FleetOverloadError,
            FleetRequest,
        )

        fleet = self._ensure_fleet()
        # the proto field wins (programmatic clients), gRPC metadata is the
        # fallback (the stub stamps both); the ticket carries it into the
        # shared fleetDispatch span's links
        ctx = request.trace_context or _metadata_context(context)
        # the caller's remaining deadline budget rides into the ticket so
        # the coalescer can shed it typed if it expires in the queue
        remaining = context.time_remaining()
        with self.tracer.tick(
            metrics_mod.RPC_SERVE,
            parent_context=ctx,
            method="BatchEstimate",
            tenant=request.tenant_id or "anonymous",
        ), self._account("BatchEstimate", pod_req, masks, allocs, caps):
            try:
                ticket = fleet.submit(
                    FleetRequest(
                        tenant_id=request.tenant_id or "anonymous",
                        pod_req=pod_req,
                        pod_masks=masks,
                        template_allocs=allocs,
                        node_caps=caps,
                        max_nodes=int(request.max_nodes),
                        prices=prices,
                        trace_context=ctx,
                        deadline_s=remaining,
                    )
                )
            except FleetAdmissionError as e:
                self._abort_admission(context, e)
            # the coalescing window plus dispatch must finish inside the
            # caller's deadline — never block PAST it (gRPC has already
            # cancelled the RPC by then, and an over-wait pins an executor
            # worker). With no deadline set, bound the wait anyway: window
            # plus a dispatch allowance, so a wedged dispatcher fails the
            # RPC instead of hanging the handler.
            timeout = (
                remaining if remaining is not None
                else fleet.window_s + 30.0
            )
            try:
                answer = ticket.result(timeout=timeout)
            except TimeoutError:
                context.abort(
                    grpc.StatusCode.DEADLINE_EXCEEDED,
                    "fleet batch did not dispatch within the deadline",
                )
            except (FleetOverloadError, FleetDrainError, FleetDeadlineError) as e:
                # a ticket shed AFTER admission (queue expiry, drain flush)
                # surfaces with the same typed status as an admission shed
                self._abort_admission(context, e)
            except Exception as e:  # noqa: BLE001 — every fleet rung failed;
                # surface the typed ladder error to the caller
                context.abort(grpc.StatusCode.INTERNAL, f"fleet dispatch failed: {e}")
            return fleet_pb.BatchEstimateResponse(
                node_counts=np.ascontiguousarray(
                    answer.node_counts, "<i4"
                ).tobytes(),
                scheduled=np.ascontiguousarray(
                    answer.scheduled, np.uint8
                ).tobytes(),
                bucket=answer.bucket,
                batch_size=answer.batch_size,
                padding_waste=answer.padding_waste,
                route=answer.route,
                best_group=answer.best_group,
                best_cost=answer.best_cost,
            )

    def TrySchedule(self, request: pb.TryScheduleRequest, context) -> pb.TryScheduleResponse:
        """Greedy kernel over packed tensors. When the request carries a
        SpreadContext, the kernel runs greedy_schedule's within-wave
        topology-spread re-counting — the same path the host-side
        HintingSimulator drives — so a remote sidecar caller no longer gets
        the batch-width overpack of a context-free call (PREDICATES.md
        divergence 2, its RPC-surface note)."""
        from autoscaler_tpu_torch.ops.schedule import greedy_schedule
        from autoscaler_tpu_torch.snapshot.tensors import SnapshotTensors

        self._check_admitting(context)
        _check_resource_axis(request.pods, context)
        P = request.pods.num_pods
        R = request.pods.num_resources
        N = request.num_nodes
        pod_req = _f32(request.pods.requests, P, R)
        free = _f32(request.node_free, N, R)
        mask = _u8(request.sched_mask, P, N)
        slots = _i32(request.pod_slots, -1)
        hints = _i32(request.hints, -1)
        with self._account("TrySchedule", pod_req, free, mask, slots, hints):
            spread = None
            if request.HasField("spread"):
                sp = request.spread
                S, D = sp.num_terms, sp.num_domains
                spread = tuple(
                    self._t(a)
                    for a in (
                        _u8(sp.sp_of, P, S),
                        _u8(sp.sp_match, P, S),
                        _i32(sp.node_dom, S, N),
                        _u8(sp.sp_elig, S, N),
                        _u8(sp.dom_valid, S, D),
                        _i32(sp.static_counts, S, D),
                        _i32(sp.skew, S),
                        _i32(sp.min_dom, S),
                        _i32(sp.domnum, S),
                    )
                )
            snap = SnapshotTensors(
                node_alloc=self._t(free),
                node_used=self._t(np.zeros((N, R), np.float32)),
                node_valid=self._t(np.ones((N,), bool)),
                node_group=self._t(np.full((N,), -1, np.int32)),
                pod_req=self._t(pod_req),
                pod_valid=self._t(np.ones((P,), bool)),
                pod_node=self._t(np.full((P,), -1, np.int32)),
                sched_mask=self._t(mask),
            )
            res = greedy_schedule(
                snap, self._t(slots), self._t(hints), spread=spread
            )
            return pb.TryScheduleResponse(
                placed=np.asarray(res.placed.cpu(), np.uint8).tobytes(),
                dest=np.asarray(res.dest.cpu(), np.dtype("<i4")).tobytes(),
            )

    def FindNodesToRemove(
        self, request: pb.FindNodesToRemoveRequest, context
    ) -> pb.FindNodesToRemoveResponse:
        from autoscaler_tpu_torch.ops.scaledown import removal_feasibility
        from autoscaler_tpu_torch.snapshot.tensors import SnapshotTensors

        self._check_admitting(context)
        _check_resource_axis(request.pods, context)
        P = request.pods.num_pods
        R = request.pods.num_resources
        N = request.num_nodes
        S = request.slots_per_node
        pod_req = _f32(request.pods.requests, P, R)
        alloc = _f32(request.node_alloc, N, R)
        used = _f32(request.node_used, N, R)
        mask = _u8(request.sched_mask, P, N)
        cands = _i32(request.candidate_nodes, -1)
        slots = _i32(request.pod_slots, len(cands), S)
        blocked = _u8(request.blocked, len(cands))
        with self._account(
            "FindNodesToRemove", pod_req, alloc, used, mask, cands, slots,
            blocked,
        ):
            snap = SnapshotTensors(
                node_alloc=self._t(alloc),
                node_used=self._t(used),
                node_valid=self._t(np.ones((N,), bool)),
                node_group=self._t(np.full((N,), -1, np.int32)),
                pod_req=self._t(pod_req),
                pod_valid=self._t(np.ones((P,), bool)),
                pod_node=self._t(np.full((P,), -1, np.int32)),
                sched_mask=self._t(mask),
            )
            res = removal_feasibility(
                snap, self._t(cands), self._t(slots), self._t(blocked)
            )
            return pb.FindNodesToRemoveResponse(
                feasible=np.asarray(res.feasible.cpu(), np.uint8).tobytes(),
                destinations=np.asarray(res.destinations.cpu(), np.dtype("<i4")).tobytes(),
            )

    def BestOptions(self, request: pb.BestOptionsRequest, context) -> pb.BestOptionsResponse:
        """Least-waste-style reduction over the option list (the expander
        gRPC seam; host embeddings can point the reference's own
        --grpc-expander-url at this)."""
        self._check_admitting(context)
        if not request.options:
            return pb.BestOptionsResponse()
        scored = sorted(
            request.options,
            key=lambda o: (o.score_hint if o.score_hint else -len(o.pod_keys)),
        )
        return pb.BestOptionsResponse(best=[scored[0]])


_METHODS = {
    "Estimate": (pb.EstimateRequest, pb.EstimateResponse),
    "BatchEstimate": (
        fleet_pb.BatchEstimateRequest, fleet_pb.BatchEstimateResponse
    ),
    "TrySchedule": (pb.TryScheduleRequest, pb.TryScheduleResponse),
    "FindNodesToRemove": (pb.FindNodesToRemoveRequest, pb.FindNodesToRemoveResponse),
    "BestOptions": (pb.BestOptionsRequest, pb.BestOptionsResponse),
}


def _generic_handler(servicer: TpuSimulationServicer) -> grpc.GenericRpcHandler:
    handlers = {}
    for name, (req_cls, _resp_cls) in _METHODS.items():
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req_cls.FromString,
            response_serializer=lambda msg: msg.SerializeToString(),
        )
    return grpc.method_handlers_generic_handler(SERVICE_NAME, handlers)


def serve(
    address: str = "127.0.0.1:0",
    max_workers: int = 4,
    residency=None,
    fleet=None,
    options=None,
    tracer=None,
    slo=None,
    drain=None,
    device=None,
):
    """→ (server, bound_port). The sidecar process entrypoint. ``fleet``
    (a fleet.FleetCoalescer) backs BatchEstimate; when absent and
    ``options`` (an AutoscalingOptions) is given, one is built from the
    --fleet-* surface via FleetCoalescer.from_options — buckets, window,
    batch width, pre-warm, and the overload-armor knobs (queue depth,
    tenant quotas) all take effect (``python -m autoscaler_tpu_torch.rpc``
    is the flag-parsing launcher). ``device`` is where the servicer's ops
    and a coalescer it builds run (None = the first CUDA card). ``drain``
    (a DrainState) makes the server drainable: once its bit flips, every
    RPC refuses UNAVAILABLE + DRAIN_DETAIL while drain_server() flushes
    in-flight work. The coalescing window only pays off when max_workers
    admits concurrent tenants."""
    if fleet is None and options is not None:
        from autoscaler_tpu_torch.fleet import FleetCoalescer

        # ``slo`` (an slo.SloEngine built on fleet_slos()) rides into the
        # coalescer so every served ticket feeds the fleet_e2e objective —
        # the sidecar-side half of fleet mission control
        fleet = FleetCoalescer.from_options(options, slo=slo, device=device)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers(
        (
            _generic_handler(
                TpuSimulationServicer(
                    residency=residency, fleet=fleet, tracer=tracer,
                    drain=drain, device=device,
                )
            ),
        )
    )
    port = server.add_insecure_port(address)
    server.start()
    return server, port


def drain_server(server, fleet=None, drain=None, grace_s: float = 5.0) -> None:
    """The graceful drain sequence (SIGTERM / preStop path, in order):

    1. flip the drain bit — readiness goes 503, new RPCs refuse
       UNAVAILABLE + DRAIN_DETAIL (clients fail over immediately);
    2. stop the coalescer — its own drain bit sheds racing submits typed
       while the final flush answers every in-flight bucket;
    3. ``server.stop(grace_s)`` — in-flight handlers finish inside the
       grace, then the port closes.

    Idempotent: a second call finds everything already stopped."""
    if drain is not None:
        drain.begin_drain()
    if fleet is not None:
        fleet.stop()
    server.stop(grace=grace_s).wait(timeout=grace_s + 1.0)


class TpuSimulationClient:
    """Host-side stub with health-weighted endpoint balancing, typed-status
    retry scoping, and optional hedging.

    ``target`` names one endpoint or several (comma-separated string or a
    sequence — the --rpc-address surface). With several, every endpoint's
    health is scored continuously (fleet/balance.EndpointBalancer: EWMA
    latency, windowed error rate, consecutive-UNAVAILABLE streak,
    drain-observed bit) and BOTH first attempts and failover/hedge targets
    come from a power-of-two-choices pick over those scores with
    breaker-style outlier ejection — a flapping replica stops eating
    first-attempt traffic after a few failures instead of keeping its
    static rotation slot. On UNAVAILABLE the client fails over to a picked
    healthy endpoint with jittered bounded backoff (RetryPolicy semantics;
    a drain-detail UNAVAILABLE skips the backoff — the server just said
    "go elsewhere NOW"). The resend scope is a closed matrix:

    - UNAVAILABLE        → reconnect/fail over and resend, bounded
      (every RPC here is a pure function of its request);
    - RESOURCE_EXHAUSTED → honor the server's retry-after trailing
      metadata, at most once, never past the caller's deadline — a blind
      resend is exactly the extra load a shedding server cannot absorb.
      The honored sleep carries bounded jitter from the injected rng seam:
      co-shed tenants must NOT all retry at the same instant (a
      synchronized herd straight back into admission);
    - DEADLINE_EXCEEDED  → NEVER resent: retrying a timed-out estimate
      doubles load exactly when the server is drowning;
    - anything else      → raised as-is.

    ``default_timeout_s`` is the deadline applied when a call site passes
    none (plumbed from ``AutoscalingOptions.rpc_default_deadline_s``); the
    whole retry/failover/hedge budget lives INSIDE it — the client never
    spends past the caller's deadline.

    ``hedge=True`` additionally hedges the idempotent Estimate /
    BatchEstimate: when the primary hasn't answered after a p99-derived
    delay (learned from this client's own recent latencies), a second
    attempt fires at a balancer-picked HEALTHY endpoint; first answer
    wins, the loser is cancelled. An endpoint that is ejected, draining,
    or mid-UNAVAILABLE-streak is never hedged at — a hedge fired at a
    draining sidecar burns deadline budget for a guaranteed UNAVAILABLE —
    and when no healthy alternative exists the hedge is skipped entirely.
    Off by default — hedging doubles worst-case load.

    ``clock``/``sleep``/``rng`` are injectable for tests; production
    callers take the wall defaults (the client is NOT on the replay path —
    loadgen drives the coalescer in-process)."""

    # the hedgeable subset: pure estimate reads (TrySchedule and friends
    # are pure too, but hedging is only worth its load cost on the two
    # fleet-facing hot calls)
    HEDGED_METHODS = ("Estimate", "BatchEstimate")
    # floor used until enough latency samples exist to derive a p99
    HEDGE_MIN_DELAY_S = 0.05
    # bounded jitter fraction on the honored retry-after sleep: the pause
    # lands in [hint, hint * (1 + this)] so co-shed tenants desynchronize
    # instead of herding back into admission at the same instant
    RETRY_AFTER_JITTER = 0.25

    def __init__(
        self,
        target: Union[str, Sequence[str]],
        default_timeout_s: Optional[float] = None,
        hedge: bool = False,
        failover_base_sleep_s: float = 0.05,
        failover_max_sleep_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        rng: Callable[[], float] = random.random,
    ):
        raw = [target] if isinstance(target, str) else list(target)
        # every element may itself be comma-separated (--rpc-address
        # accepts both "repeat the flag" and "comma-join" forms, and the
        # repeated form must not smuggle an unsplit "a:1,b:2" into
        # grpc.insecure_channel as one bogus endpoint)
        targets = [
            piece.strip()
            for entry in raw
            for piece in str(entry).split(",")
            if piece.strip()
        ]
        if not targets:
            raise ValueError("TpuSimulationClient needs at least one endpoint")
        # dedupe preserving order: the earlier static rotation tolerated a
        # repeated --rpc-address (it just revisited the endpoint), and a
        # duplicate must keep being a config wrinkle, not a startup crash
        # (EndpointBalancer rejects duplicates — one health record per
        # endpoint)
        seen: set = set()
        targets = [t for t in targets if not (t in seen or seen.add(t))]
        self._targets = targets
        self._active = 0
        self.default_timeout_s = default_timeout_s
        self.hedge = hedge
        self._clock = clock
        self._sleep = sleep
        self._rng = rng
        from autoscaler_tpu_torch.fleet.balance import EndpointBalancer

        # per-endpoint health scorer + P2C picker (ARCHITECTURE.md "Fleet
        # HA"): first attempts, failover targets, and hedge legs all come
        # from its picks; every call outcome feeds it back
        self._balancer = EndpointBalancer(targets, clock=clock, rng=rng)
        from autoscaler_tpu_torch.utils.http import RetryPolicy

        # the failover pacing: same jittered-bounded-exponential semantics
        # as the kube/GCE REST boundary, one attempt per endpoint plus one
        self._backoff = RetryPolicy(
            attempts=len(targets) + 1,
            base_sleep_s=failover_base_sleep_s,
            max_sleep_s=failover_max_sleep_s,
            sleep=sleep,
            rng=rng,
        )
        # recent per-method success latencies (bounded) — the hedge-delay
        # derivation input
        from collections import deque

        self._latency = {m: deque(maxlen=64) for m in self.HEDGED_METHODS}
        # guards the mutable connection state (_active, _channel,
        # _retired): hedging reads it from worker context while a
        # failover rewrites it
        self._conn_lock = threading.Lock()
        # channels replaced by an explicit _reconnect are RETIRED, not
        # closed: another thread may have an RPC in flight on one, and
        # closing it would turn that call into CANCELLED "Channel closed!"
        # instead of its real status. The graveyard is bounded; close()
        # empties it.
        self._retired: List[Any] = []
        # ONE long-lived channel per target, shared by first attempts,
        # failovers, and hedge legs. Failover SWITCHES channels instead of
        # rebuilding them: gRPC channels self-heal when their endpoint
        # returns, and rebuilding per failing thread made a thundering
        # failover overflow the retire graveyard and close channels with
        # live callers (their in-flight calls died CANCELLED instead of
        # failing over — caught by the two-sidecar SIGKILL drill).
        self._channels: dict = {}
        self._channel = self._channel_for(self._targets[0])

    @property
    def _target(self) -> str:
        with self._conn_lock:
            return self._targets[self._active]

    def endpoint_health(self) -> dict:
        """Per-endpoint scorer snapshot (score, EWMA, error rate, streak,
        drain bit, breaker state) — the observability surface the
        two-sidecar drill asserts rebalancing on."""
        return self._balancer.snapshot()

    def _channel_for(self, target: str):
        """The per-target channel cache (first attempts, failovers, and
        hedge legs all draw from it): one long-lived channel per endpoint,
        created lazily, never torn down by routine failover — no
        connection setup on a latency-critical leg, no close racing a
        live caller."""
        with self._conn_lock:
            channel = self._channels.get(target)
            if channel is None:
                channel = grpc.insecure_channel(target)
                self._channels[target] = channel
            return channel

    def close(self) -> None:
        with self._conn_lock:
            channels = [self._channel] + self._retired
            channels += list(self._channels.values())
            self._channels = {}
            self._retired = []
        for channel in channels:
            try:
                channel.close()
            except Exception:  # noqa: BLE001 — a dead channel may refuse
                pass

    def _reconnect(self) -> None:
        """Rebuild the ACTIVE target's channel (the single-endpoint
        reconnect-in-place path; multi-endpoint failover switches cached
        channels instead and never calls this)."""
        with self._conn_lock:
            target = self._targets[self._active]
        fresh = grpc.insecure_channel(target)
        doomed = []
        with self._conn_lock:
            self._retired.append(self._channel)
            self._channel = fresh
            self._channels[target] = fresh
            # bound the graveyard: anything this deep has no live callers
            while len(self._retired) > 4:
                doomed.append(self._retired.pop(0))
        for channel in doomed:
            try:
                channel.close()
            except Exception:  # noqa: BLE001 — a dead channel may refuse
                pass

    def _switch_to(self, target: str) -> None:
        """Make ``target`` the active endpoint on its cached (self-
        healing) channel — the failover/rebalance move. No channel is
        rebuilt or closed, so the threads still blocked on the previous
        endpoint keep their in-flight calls and surface REAL statuses."""
        channel = self._channel_for(target)
        with self._conn_lock:
            self._active = self._targets.index(target)
            self._channel = channel

    def _failover(self, failed: Optional[str] = None) -> None:
        """Move off ``failed`` (default: the current endpoint) to a
        balancer-picked alternative on its cached channel. A
        single-endpoint client (no alternative exists) reconnects in
        place — the historical behavior. When the pick lands on the
        ALREADY-active endpoint (a racing thread failed over first) this
        is a no-op: rebuilding the healthy channel per failing thread
        would churn the retire graveyard into closing channels that still
        have live callers (their calls would die CANCELLED instead of
        surfacing real statuses)."""
        with self._conn_lock:
            current = self._targets[self._active]
        # deferred release: the picked endpoint becomes (or already is)
        # the active one, and the NEXT rpc on it reports the outcome via
        # record_response/record_failure — statically unprovable
        # graftlint: disable=GL016 — probe slot resolves through the next rpc's outcome on the now-active endpoint
        nxt = self._balancer.pick(exclude=(failed or current,))
        if nxt is None:
            self._reconnect()
            return
        if nxt != current:
            self._switch_to(nxt)

    def _ensure_primary(self) -> str:
        """Health-weighted FIRST-attempt selection (the static-rotation
        replacement): ask the balancer for today's best endpoint and
        switch channels only when it differs from the active one.
        Single-endpoint clients skip the pick entirely — there is nothing
        to balance, and the seated channel (tests seat scripted ones)
        must stay untouched. Returns the active target."""
        if len(self._targets) == 1:
            return self._targets[0]
        # deferred release: the pick selects the endpoint the imminent
        # first attempt rides, and that attempt's record_response/
        # record_failure is the slot's outcome — statically unprovable
        # graftlint: disable=GL016 — probe slot resolves through the imminent first attempt's outcome
        target = self._balancer.pick()
        with self._conn_lock:
            current = self._targets[self._active]
        if target is not None and target != current:
            self._switch_to(target)
            return target
        return current

    def _note_latency(self, method: str, seconds: float) -> None:
        samples = self._latency.get(method)
        if samples is not None:
            samples.append(seconds)

    def _hedge_delay(self, method: str) -> float:
        """The p99 of this client's own recent successes for ``method`` —
        hedging earlier than that fires on healthy tail latency; later
        wastes the win. Falls back to a floor until enough samples exist."""
        samples = self._latency.get(method)
        if not samples or len(samples) < 5:
            return self.HEDGE_MIN_DELAY_S
        ordered = sorted(samples)
        idx = max(0, int(0.99 * len(ordered)) - 1)
        return max(ordered[idx], self.HEDGE_MIN_DELAY_S)

    @staticmethod
    def _packed_pods(
        pod_req: np.ndarray, extended_resources: Sequence[str]
    ) -> "pb.PackedPods":
        from autoscaler_tpu_torch.kube import objects as k8s

        P, R = pod_req.shape
        ext = list(extended_resources)
        if ext and R != k8s.NUM_RESOURCES + len(ext):
            raise ValueError(
                f"pod_req has {R} columns but schema is "
                f"{k8s.NUM_RESOURCES} base + {len(ext)} extended {ext}"
            )
        return pb.PackedPods(
            requests=np.ascontiguousarray(pod_req, "<f4").tobytes(),
            num_pods=P,
            num_resources=R,
            extended_resources=ext,
        )

    @staticmethod
    def _retry_after_from(error) -> Optional[float]:
        """The server's pacing hint from RESOURCE_EXHAUSTED trailing
        metadata (RETRY_AFTER_METADATA_KEY, seconds)."""
        try:
            trailing = error.trailing_metadata() or ()
        except Exception:  # noqa: BLE001 — duck-typed test errors
            return None
        for key, value in trailing:
            if key == RETRY_AFTER_METADATA_KEY:
                try:
                    return max(float(value), 0.0)
                except (TypeError, ValueError):
                    return None
        return None

    @staticmethod
    def _is_drain(error) -> bool:
        try:
            return str(error.details() or "").startswith(DRAIN_DETAIL)
        except Exception:  # noqa: BLE001 — duck-typed test errors
            return False

    def _call(self, method: str, request, timeout: Optional[float] = None):
        req_cls, resp_cls = _METHODS[method]
        if timeout is None:
            timeout = self.default_timeout_s
        # the whole retry/failover/hedge budget lives inside the caller's
        # deadline: every resend's timeout is the REMAINING budget, and a
        # backoff that would outlive it raises instead of sleeping
        deadline_ts = self._clock() + timeout if timeout is not None else None

        def remaining() -> Optional[float]:
            if deadline_ts is None:
                return None
            return deadline_ts - self._clock()

        # one span per sidecar RPC — failovers and retry-after waits are
        # events INSIDE it, so a tick slowed by a sidecar restart shows one
        # long rpcCall span with failover markers, not mystery gaps
        with trace.span(
            metrics_mod.RPC_CALL, method=method,
            deadline_s=timeout if timeout is not None else 0.0,
        ):
            # cross-process propagation: THE rpcCall span is the remote
            # parent — stamped into gRPC metadata on every method, and
            # into the fleet proto's trace_context field when the message
            # carries one (BatchEstimate), so the sidecar's serving span
            # adopts this exact span and the trees join under one id
            ctx = trace.current_context()
            metadata = ((TRACE_METADATA_KEY, ctx),) if ctx else None
            if (
                ctx
                and hasattr(request, "trace_context")
                and not request.trace_context
            ):
                request.trace_context = ctx

            def send(send_target: str, budget: Optional[float]):
                # the channel must be THIS attempt's target, not the
                # shared active channel: a concurrent thread's failover
                # can rewrite self._channel between the pick and the
                # send, and then the balancer would charge this call's
                # outcome to an endpoint it never talked to (ejecting a
                # healthy survivor on a dead replica's UNAVAILABLE).
                # Single-endpoint clients keep the seated channel — there
                # is no attribution to get wrong, and tests seat scripted
                # channels there.
                if len(self._targets) == 1:
                    with self._conn_lock:
                        channel = self._channel
                else:
                    channel = self._channel_for(send_target)
                rpc = channel.unary_unary(
                    f"/{SERVICE_NAME}/{method}",
                    request_serializer=lambda msg: msg.SerializeToString(),
                    response_deserializer=resp_cls.FromString,
                )
                if metadata is None:
                    # no active trace: keep the bare call shape (duck-typed
                    # channels in tests need not accept the kwarg)
                    return rpc(request, timeout=budget)
                return rpc(request, timeout=budget, metadata=metadata)

            max_attempts = max(2, len(self._targets) + 1)
            quota_retried = False
            hedging = (
                self.hedge
                and method in self.HEDGED_METHODS
                and len(self._targets) > 1
            )
            attempt = 0
            while True:
                attempt += 1
                # first attempt gets the caller's full deadline; every
                # resend runs on what's LEFT of it. The first attempt's
                # TARGET is a balancer pick (health-weighted P2C, not a
                # static rotation slot); resends run on whatever endpoint
                # the failover picked.
                if attempt == 1:
                    target = self._ensure_primary()
                else:
                    with self._conn_lock:
                        target = self._targets[self._active]
                budget = timeout if attempt == 1 else remaining()
                try:
                    if hedging:
                        return self._hedged_send(
                            method, request, budget, metadata, resp_cls,
                            target,
                        )
                    t0 = self._clock()
                    resp = send(target, budget)
                    self._note_latency(method, self._clock() - t0)
                    self._balancer.record_success(
                        target, self._clock() - t0
                    )
                    return resp
                except grpc.RpcError as e:
                    code = e.code() if hasattr(e, "code") else None
                    # hedged sends did their own per-leg health accounting
                    # (and the re-raised error may be the HEDGE leg's, not
                    # the primary's) — recording it here again would
                    # double-charge the primary or charge it with a status
                    # another endpoint returned
                    if code is grpc.StatusCode.UNAVAILABLE:
                        # health feedback even when out of attempts: the
                        # NEXT call's pick must know this endpoint failed
                        if not hedging:
                            self._balancer.record_failure(
                                target, unavailable=True,
                                drain=self._is_drain(e),
                            )
                    elif code is grpc.StatusCode.DEADLINE_EXCEEDED:
                        # a slowness signal (error rate + EWMA pressure),
                        # NOT an outage signal — no UNAVAILABLE streak
                        if not hedging:
                            self._balancer.record_failure(
                                target, unavailable=False
                            )
                    else:
                        # every OTHER status (RESOURCE_EXHAUSTED shed,
                        # INVALID_ARGUMENT, INTERNAL, ...) was still an
                        # ANSWER: the endpoint is alive. This must reach
                        # the balancer — a half-open probe whose outcome
                        # is never recorded holds the single-flight slot
                        # forever and wedges the endpoint out of rotation
                        if not hedging:
                            self._balancer.record_response(target)
                    if (
                        code is grpc.StatusCode.UNAVAILABLE
                        and attempt < max_attempts
                    ):
                        # failover: a drain detail skips the backoff (the
                        # server said "go elsewhere NOW"); plain
                        # unavailability pays the jittered bounded pause
                        pause = (
                            0.0 if self._is_drain(e)
                            else self._backoff.backoff_s(attempt, None)
                        )
                        rem = remaining()
                        if rem is not None and pause >= rem:
                            raise
                        trace.add_event(
                            "rpc.failover", method=method, attempt=attempt,
                            drain=self._is_drain(e),
                        )
                        if pause > 0.0:
                            self._sleep(pause)
                        self._failover(failed=target)
                        continue
                    if (
                        code is grpc.StatusCode.RESOURCE_EXHAUSTED
                        and not quota_retried
                    ):
                        retry_after = self._retry_after_from(e)
                        rem = remaining()
                        if retry_after is not None:
                            # bounded jitter on the honored hint: every
                            # co-shed tenant got the SAME retry-after, and
                            # sleeping it exactly marches the whole herd
                            # back into admission at one instant. The rng
                            # rides the injected seam so replays with a
                            # seeded rng stay byte-stable. Whether the
                            # retry happens at all is decided by the
                            # UNJITTERED hint; the jitter then expands
                            # only into HALF the headroom past it, so the
                            # resend always keeps some budget — sleeping
                            # to exactly the deadline would doom the
                            # retry to DEADLINE_EXCEEDED, losing a call
                            # the unjittered sleep would have saved.
                            pause = retry_after * (
                                1.0 + self.RETRY_AFTER_JITTER * self._rng()
                            )
                            if rem is None or retry_after < rem:
                                if rem is not None:
                                    pause = min(
                                        pause,
                                        retry_after
                                        + 0.5 * (rem - retry_after),
                                    )
                                quota_retried = True
                                trace.add_event(
                                    "rpc.retry_after", method=method,
                                    retry_after_s=retry_after,
                                )
                                if pause > 0.0:
                                    self._sleep(pause)
                                continue
                    # DEADLINE_EXCEEDED and everything else: NEVER resent
                    raise

    def _hedged_send(
        self, method, request, budget, metadata, resp_cls,
        primary_target: Optional[str] = None,
    ):
        """Hedge one idempotent call: primary now, a second leg at a
        balancer-picked HEALTHY endpoint after the p99-derived delay;
        first answer wins, the loser is cancelled. Both legs share the
        caller's remaining budget.

        The hedge target is chosen at FIRE time, not call time (health can
        change during the delay), via ``EndpointBalancer.pick_hedge``: an
        ejected, draining, or UNAVAILABLE-streaking endpoint is never
        hedged at — a hedge into a known-bad replica spends deadline
        budget on a guaranteed failure — and when no healthy alternative
        exists the hedge is skipped (the primary leg keeps the whole
        budget)."""

        def future_on(channel, leg_budget):
            rpc = channel.unary_unary(
                f"/{SERVICE_NAME}/{method}",
                request_serializer=lambda msg: msg.SerializeToString(),
                response_deserializer=resp_cls.FromString,
            )
            if metadata is None:
                return rpc.future(request, timeout=leg_budget)
            return rpc.future(request, timeout=leg_budget, metadata=metadata)

        t0 = self._clock()
        deadline_ts = t0 + budget if budget is not None else None
        if primary_target is None:
            # direct invocation (tests seat a scripted self._channel):
            # primary is whatever is active right now
            with self._conn_lock:
                channel = self._channel
                primary_target = self._targets[self._active]
        else:
            # _call named the target — the leg must ride THAT target's
            # cached channel, not the shared active one a concurrent
            # failover may have rewritten (outcome attribution feeds the
            # balancer; see _call.send)
            channel = self._channel_for(primary_target)
        primary = future_on(channel, budget)
        fired = threading.Event()
        primary.add_done_callback(lambda _f: fired.set())
        delay = self._hedge_delay(method)
        if budget is not None:
            delay = min(delay, max(budget, 0.0))
        # each leg carries its own start instant: the balancer's latency
        # sample must be the LEG's service time, not time-since-t0 — a
        # winning hedge measured from t0 would charge the healthy rescuer
        # with the hedge delay plus the slow primary's elapsed time,
        # drifting the picker TOWARD the degraded endpoint
        legs = [(primary, primary_target, t0)]
        if not fired.wait(timeout=delay):
            rem = (
                deadline_ts - self._clock() if deadline_ts is not None
                else None
            )
            # budget check BEFORE the pick: pick_hedge may hand out a
            # half-open probe slot, and a pick taken with the budget
            # already exhausted would never reach an outcome — the slot
            # (and its endpoint's probe budget) would leak until restart
            hedge_target = (
                self._balancer.pick_hedge(primary_target)
                if rem is None or rem > 0
                else None
            )
            if hedge_target is not None:
                trace.add_event(
                    "rpc.hedge", method=method, target=hedge_target,
                    delay_s=round(delay, 6),
                )
                # long-lived cached channel: no connection setup on the
                # latency-critical hedge leg
                hedge = future_on(
                    self._channel_for(hedge_target), rem
                )
                hedge.add_done_callback(lambda _f: fired.set())
                legs.append((hedge, hedge_target, self._clock()))
        try:
            pending = list(legs)
            last_error: Optional[BaseException] = None
            while pending:
                fired.clear()
                for entry in list(pending):
                    leg, leg_target, leg_start = entry
                    if not leg.done():
                        continue
                    pending.remove(entry)
                    try:
                        result = leg.result()
                    except Exception as e:  # noqa: BLE001 — grpc future errs
                        code = e.code() if hasattr(e, "code") else None
                        if code is grpc.StatusCode.UNAVAILABLE:
                            self._balancer.record_failure(
                                leg_target, unavailable=True,
                                drain=self._is_drain(e),
                            )
                        elif code is grpc.StatusCode.DEADLINE_EXCEEDED:
                            # same slowness-not-outage semantics as the
                            # unhedged path, attributed to the leg that
                            # actually timed out
                            self._balancer.record_failure(
                                leg_target, unavailable=False
                            )
                        else:
                            # any other status is still an ANSWER (see
                            # _call): resolve a held probe, clear streak
                            self._balancer.record_response(leg_target)
                        last_error = e
                        continue
                    for loser, loser_target, _start in pending:
                        loser.cancel()
                        # a cancelled leg never reaches an outcome: if its
                        # pick was a half-open probe, return the slot —
                        # nothing else ever will
                        self._balancer.release(loser_target)
                    # caller-perceived latency (feeds the hedge-delay p99)
                    # runs from t0; the ENDPOINT's sample runs from its
                    # own leg start
                    self._note_latency(method, self._clock() - t0)
                    self._balancer.record_success(
                        leg_target, self._clock() - leg_start
                    )
                    return result
                if pending and not fired.wait(
                    timeout=(
                        deadline_ts - self._clock() + 0.1
                        if deadline_ts is not None else None
                    )
                ):
                    for leg, leg_target, _start in pending:
                        leg.cancel()
                        self._balancer.release(leg_target)
                    break
            if last_error is not None:
                raise last_error
            raise TimeoutError(
                f"hedged {method} exhausted its deadline budget"
            )
        finally:
            for leg, leg_target, _start in legs:
                if not leg.done():
                    leg.cancel()
                    self._balancer.release(leg_target)

    def estimate(
        self,
        pod_req: np.ndarray,
        pod_masks: np.ndarray,
        template_allocs: np.ndarray,
        group_ids: Sequence[str],
        node_caps: np.ndarray,
        max_nodes: int,
        extended_resources: Sequence[str] = (),
    ):
        """`extended_resources` names the pod_req/template_allocs columns
        beyond the base 6, in packer.extended_schema order (pass
        `packer_meta.extended_resources` straight through) — the wire
        carries the schema so the sidecar keeps device-plugin fit
        dimensions instead of silently dropping them."""
        P, R = pod_req.shape
        resp = self._call(
            "Estimate",
            pb.EstimateRequest(
                pods=self._packed_pods(pod_req, extended_resources),
                pod_masks=np.ascontiguousarray(pod_masks, np.uint8).tobytes(),
                template_allocs=np.ascontiguousarray(template_allocs, "<f4").tobytes(),
                group_ids=list(group_ids),
                node_caps=np.ascontiguousarray(node_caps, "<i4").tobytes(),
                max_nodes=max_nodes,
            ),
        )
        G = len(group_ids)
        counts = np.frombuffer(resp.node_counts, "<i4")
        scheduled = (
            np.frombuffer(resp.scheduled, np.uint8).reshape(G, -1).astype(bool)
        )
        return counts, scheduled

    def batch_estimate(
        self,
        pod_req: np.ndarray,
        pod_masks: np.ndarray,
        template_allocs: np.ndarray,
        group_ids: Sequence[str],
        node_caps: np.ndarray,
        max_nodes: int,
        tenant_id: str = "",
        prices: Optional[np.ndarray] = None,  # [G] — present = what-if rank
        extended_resources: Sequence[str] = (),
        timeout: Optional[float] = None,
    ):
        """The fleet path of estimate(): same operands and same return
        shape (counts [G], scheduled [G, P]) plus a provenance dict
        (bucket, batch_size, padding_waste, route, best_group, best_cost).
        The sidecar coalesces concurrent tenants into one sharded mesh
        dispatch per shape bucket; the answer is byte-identical to the
        solo route. The deadline must cover the coalescing window
        (--fleet-coalesce-window-ms) on top of the dispatch."""
        P, R = pod_req.shape
        G = len(group_ids)
        resp = self._call(
            "BatchEstimate",
            fleet_pb.BatchEstimateRequest(
                pods=self._packed_pods(pod_req, extended_resources),
                pod_masks=np.ascontiguousarray(pod_masks, np.uint8).tobytes(),
                template_allocs=np.ascontiguousarray(
                    template_allocs, "<f4"
                ).tobytes(),
                group_ids=list(group_ids),
                node_caps=np.ascontiguousarray(node_caps, "<i4").tobytes(),
                max_nodes=max_nodes,
                tenant_id=tenant_id,
                prices=(
                    b"" if prices is None
                    else np.ascontiguousarray(prices, "<f4").tobytes()
                ),
            ),
            timeout=timeout,
        )
        counts = np.frombuffer(resp.node_counts, "<i4")
        scheduled = (
            np.frombuffer(resp.scheduled, np.uint8).reshape(G, -1).astype(bool)
        )
        meta = {
            "bucket": resp.bucket,
            "batch_size": int(resp.batch_size),
            "padding_waste": float(resp.padding_waste),
            "route": resp.route,
            "best_group": int(resp.best_group),
            "best_cost": float(resp.best_cost),
        }
        return counts, scheduled, meta

    def try_schedule(
        self,
        pod_req: np.ndarray,     # [P, R]
        node_free: np.ndarray,   # [N, R]
        sched_mask: np.ndarray,  # [P, N]
        pod_slots: np.ndarray,   # [K]
        hints: np.ndarray,       # [K]
        spread: Optional[tuple] = None,  # affinity.build_spread_schedule_context
        extended_resources: Sequence[str] = (),
    ):
        """→ (placed [K] bool, dest [K] i32). `spread` is the host-side
        9-array context; packing it onto the wire gives the remote kernel
        host-path within-wave spread semantics. `extended_resources` names
        the resource columns beyond the base 6 (see estimate)."""
        P, R = pod_req.shape
        N = node_free.shape[0]
        spread_msg = None
        if spread is not None:
            (sp_of, sp_match, node_dom, sp_elig, dom_valid,
             static_counts, skew, min_dom, domnum) = (
                np.asarray(a) for a in spread
            )
            spread_msg = pb.SpreadContext(
                sp_of=np.ascontiguousarray(sp_of, np.uint8).tobytes(),
                sp_match=np.ascontiguousarray(sp_match, np.uint8).tobytes(),
                node_dom=np.ascontiguousarray(node_dom, "<i4").tobytes(),
                sp_elig=np.ascontiguousarray(sp_elig, np.uint8).tobytes(),
                dom_valid=np.ascontiguousarray(dom_valid, np.uint8).tobytes(),
                static_counts=np.ascontiguousarray(
                    static_counts, "<i4"
                ).tobytes(),
                skew=np.ascontiguousarray(skew, "<i4").tobytes(),
                min_dom=np.ascontiguousarray(min_dom, "<i4").tobytes(),
                domnum=np.ascontiguousarray(domnum, "<i4").tobytes(),
                num_terms=int(sp_of.shape[1]),
                num_domains=int(dom_valid.shape[1]),
            )
        resp = self._call(
            "TrySchedule",
            pb.TryScheduleRequest(
                pods=self._packed_pods(pod_req, extended_resources),
                node_free=np.ascontiguousarray(node_free, "<f4").tobytes(),
                sched_mask=np.ascontiguousarray(sched_mask, np.uint8).tobytes(),
                pod_slots=np.ascontiguousarray(pod_slots, "<i4").tobytes(),
                hints=np.ascontiguousarray(hints, "<i4").tobytes(),
                num_nodes=N,
                spread=spread_msg,
            ),
        )
        placed = np.frombuffer(resp.placed, np.uint8).astype(bool)
        dest = np.frombuffer(resp.dest, "<i4")
        return placed, dest

    def best_options(
        self, options: Sequence[pb.Option], timeout: Optional[float] = None
    ) -> List[pb.Option]:
        resp = self._call(
            "BestOptions",
            pb.BestOptionsRequest(options=list(options)),
            timeout=timeout,
        )
        return list(resp.best)
