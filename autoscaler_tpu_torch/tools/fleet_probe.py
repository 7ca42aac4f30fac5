"""The scenario batching and fleet-serving paths on the card: chip_smoke's
3u (the what-if at BASELINE config 5, the scenario expander, K3 over a
group mesh), 3v (a coalesced fleet of tenants, the estimator's fleet
lane), 4q (their holds) and 5d (the fleet's fault walk).

    python3 -m autoscaler_tpu_torch.tools.fleet_probe                 # one card
    python3 -m autoscaler_tpu_torch.tools.fleet_probe --device cpu --small

The tenants are ``bench.py --fleet``'s form at real widths: independent
clusters' scale-up estimates (P pods × G groups, cpu in millicores and
memory in MiB, both integral, pods 1; templates of 4-32 cores and 8-64 GiB;
caps 1-1000; every second tenant with prices) served by one shared
estimator service. ``fleet_tenants`` draws them from a seed;
``bench_tenants`` copies bench.py's 32 × 8 × 8 worlds. ``round_record``
writes one fleet decision-ledger record (``fleet/ledger.FLEET_SCHEMA``)
of a served round, each tenant's verdict with its digest and its
fairness certificate (``match_solo``: byte-equal to a solo dispatch of
the same operands); ``submit_flush`` and ``serve_round`` drive a round.
The functions that take a ``request_cls`` (a ``FleetRequest`` class) or a
coalescer are duck-typed, so the CPU tests drive the JAX package's
coalescer through them too.
"""
from __future__ import annotations

import argparse
import hashlib
import statistics
import sys
import threading
import time

import numpy as np
import torch

from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.fleet.ledger import FLEET_SCHEMA
from autoscaler_tpu_torch.kube.objects import CPU, MEMORY, NUM_RESOURCES, PODS

BUCKETS = "1024x32x8,4096x64x8"   # 3v's configured shape buckets
BATCH = 8                          # scenario slots of a batch
TENANTS = 16                       # 3v's tenants, besides the ad-hoc one
ADHOC = (6000, 100)                # one tenant past every bucket (P, G)
SCENARIOS = 8                      # BASELINE config 5's spot-pricing scenarios
SPOT_DISCOUNT = 0.7
REVOKE_PROB = 0.3
LANE_PODS = 3000                   # each fleet-lane estimator's slice of the burst
SMALL = {"pods": (512, 1024), "groups": (8, 32)}   # 4q's tenants: the 1024x32x8 bucket


def _request_cls():
    from autoscaler_tpu_torch.fleet.coalescer import FleetRequest

    return FleetRequest


def tenant_request(rng, tenant, P, G, priced, request_cls=None):
    """One tenant's estimate at width P × G: integral cpu and memory."""
    request_cls = request_cls or _request_cls()
    req = np.zeros((P, NUM_RESOURCES), np.float32)
    req[:, CPU] = rng.integers(50, 2000, P)
    req[:, MEMORY] = rng.integers(64, 8192, P)
    req[:, PODS] = 1
    allocs = np.zeros((G, NUM_RESOURCES), np.float32)
    allocs[:, CPU] = rng.choice([4000, 8000, 16000, 32000], G)
    allocs[:, MEMORY] = rng.choice([8192, 16384, 32768, 65536], G)
    allocs[:, PODS] = 110
    masks = rng.random((G, P)) > 0.05
    caps = rng.integers(1, 1001, G).astype(np.int32)
    prices = rng.uniform(0.5, 3.0, G).astype(np.float32) if priced else None
    return request_cls(
        tenant_id=tenant, pod_req=req, pod_masks=masks, template_allocs=allocs,
        node_caps=caps, max_nodes=P, prices=prices,
    )


def fleet_tenants(seed=0, n=TENANTS, pods=(512, 4096), groups=(8, 64), adhoc=ADHOC,
                  request_cls=None):
    """``n`` tenants of P in ``pods``, G in ``groups`` (inclusive), every
    second one priced, then (when ``adhoc``) one tenant of ``adhoc`` =
    (P, G) that no configured bucket holds."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        P = int(rng.integers(pods[0], pods[1] + 1))
        G = int(rng.integers(groups[0], groups[1] + 1))
        out.append(tenant_request(rng, f"tenant-{t:02d}", P, G, t % 2 == 0, request_cls))
    if adhoc:
        out.append(tenant_request(rng, "tenant-adhoc", *adhoc, True, request_cls))
    return out


def bench_tenants(K=8, seed=42, request_cls=None):
    """bench.py --fleet's K tenants: 32 pods × 8 groups × 8 resources,
    drawn in its order from its seed."""
    request_cls = request_cls or _request_cls()
    P, G, R = 32, 8, 8
    rng = np.random.default_rng(seed)
    return [
        request_cls(
            tenant_id=f"bench-{t}",
            pod_req=rng.integers(1, 100, (P, R)).astype(np.float32),
            pod_masks=rng.random((G, P)) > 0.2,
            template_allocs=rng.integers(100, 500, (G, R)).astype(np.float32),
            node_caps=rng.integers(1, 16, G).astype(np.int32),
            max_nodes=P,
        )
        for t in range(K)
    ]


def fractional(req):
    """A copy of ``req`` with half a MiB more memory on every pod: no SWAR
    plan, so a batch holding it runs K1."""
    out = type(req)(**{**req.__dict__})
    out.pod_req = req.pod_req.copy()
    out.pod_req[:, MEMORY] += 0.5
    out.tenant_id = req.tenant_id + "-frac"
    return out


def decimal(req, seed=0):
    """A copy of ``req`` whose memory requests are decimal megabytes read
    in MiB (k · 10^6 / 2^20, k in 1..59) against 1–3 GiB nodes: no SWAR
    plan, and with tens of pods a node the usage summed in f32 rounds apart
    from alloc − free."""
    rng = np.random.default_rng(seed)
    P, G = req.pod_masks.shape[1], req.pod_masks.shape[0]
    out = type(req)(**{**req.__dict__})
    out.pod_req = req.pod_req.copy()
    out.pod_req[:, MEMORY] = (rng.integers(1, 60, P) * 1000**2 / 1024**2).astype(np.float32)
    out.template_allocs = req.template_allocs.copy()
    out.template_allocs[:, MEMORY] = rng.integers(1, 4, G) * 1024.0
    out.tenant_id = req.tenant_id + "-dec"
    return out


def solo(req, device=None):
    """The tenant's solo dispatch (``parallel/mesh.fleet_solo_estimate``)."""
    from autoscaler_tpu_torch.parallel.mesh import fleet_solo_estimate

    return fleet_solo_estimate(req.pod_req, req.pod_masks, req.template_allocs,
                               req.node_caps, req.max_nodes, device=device)


def verdict_bytes(counts, scheduled) -> bytes:
    return (np.ascontiguousarray(counts, "<i4").tobytes()
            + np.ascontiguousarray(scheduled, np.uint8).tobytes())


def verdict_row(req, answer, solo_out, tier="") -> dict:
    """One tenant's decision-ledger row: its answer, the sha256 of its
    verdict bytes, and whether they equal its solo dispatch's."""
    fleet = verdict_bytes(answer.node_counts, answer.scheduled)
    return {
        "tenant": req.tenant_id,
        "bucket": answer.bucket,
        "batch_size": answer.batch_size,
        "padding_waste": answer.padding_waste,
        "route": answer.route,
        "node_counts": [int(c) for c in answer.node_counts],
        "scheduled_pods": int(np.asarray(answer.scheduled).sum()),
        "verdict_sha256": hashlib.sha256(fleet).hexdigest(),
        "match_solo": fleet == verdict_bytes(*solo_out),
        "best_group": answer.best_group,
        "endpoint": "",
        "failovers": 0,
        "tier": tier,
    }


def submit_flush(co, reqs, timeout=60.0):
    """Submit ``reqs`` to coalescer ``co``, flush, and collect → (answers:
    one FleetAnswer a request, or the exception its submit or ticket
    raised, a TimeoutError for a ticket the flush left unresolved;
    admitted: whether each submit returned a ticket)."""
    tickets = []
    for req in reqs:
        try:
            tickets.append(co.submit(req))
        except Exception as e:  # noqa: BLE001 — a typed shed is an answer
            tickets.append(e)
    co.flush()
    admitted = [not isinstance(tk, Exception) for tk in tickets]
    answers = []
    for tk in tickets:
        if isinstance(tk, Exception):
            answers.append(tk)
        elif not tk.done():
            answers.append(TimeoutError("unresolved"))
        else:
            try:
                answers.append(tk.result(timeout=timeout))
            except Exception as e:  # noqa: BLE001
                answers.append(e)
    return answers, admitted


def round_record(co, reqs, answers, admitted, solo_fn, tick=0, now_ts=0.0) -> dict:
    """The round's fleet decision-ledger record (``fleet/ledger.
    FLEET_SCHEMA``) of ``submit_flush``'s answers: a verdict row a resolved
    tenant (``solo_fn(req)`` is its solo dispatch, for the fairness
    certificate), a shed row a typed shed (at submit, or after it: an
    expiry), the tenants whose batch failed under ``errors``, and the
    outcome tally."""
    rows, shed, errors = [], [], []
    outcomes = {"resolved": 0, "shed": 0, "expired": 0, "failed": 0, "unresolved": 0}
    for req, answer, ticketed in zip(reqs, answers, admitted):
        outcome = getattr(answer, "outcome", None)
        if not isinstance(answer, BaseException):
            rows.append(verdict_row(req, answer, solo_fn(req), co.tier_name(req.tenant_id)))
            outcomes["resolved"] += 1
        elif type(answer) is TimeoutError:
            outcomes["unresolved"] += 1
        elif outcome is not None:
            shed.append({"tenant": req.tenant_id, "outcome": outcome})
            outcomes["expired" if ticketed else "shed"] += 1
        else:
            errors.append(f"{req.tenant_id}: {type(answer).__name__}")
            outcomes["failed"] += 1
    return {
        "schema": FLEET_SCHEMA, "tick": tick, "now_ts": now_ts, "tenants": rows,
        "degraded": sorted(co.degraded()), "errors": sorted(errors), "shed": shed,
        "outcomes": {k: outcomes[k] for k in sorted(outcomes)},
    }


def serve_round(co, reqs, solo_fn, tick=0, now_ts=0.0):
    """``submit_flush`` then ``round_record`` → (answers, record)."""
    answers, admitted = submit_flush(co, reqs)
    return answers, round_record(co, reqs, answers, admitted, solo_fn, tick, now_ts)


def answer_view(answer) -> dict:
    """A FleetAnswer (or an exception) as plain values, for equality."""
    if isinstance(answer, BaseException):
        return {"error": type(answer).__name__}
    return {
        "node_counts": np.asarray(answer.node_counts).tolist(),
        "scheduled": verdict_bytes(answer.node_counts, answer.scheduled).hex(),
        "bucket": answer.bucket, "batch_size": answer.batch_size,
        "padding_waste": answer.padding_waste, "route": answer.route,
        "best_group": answer.best_group, "best_cost": answer.best_cost,
    }


def host_best(req, counts, scheduled):
    """The what-if ranking of one tenant on the host in f64: the first
    argmin of price · count + penalty · pending."""
    from autoscaler_tpu_torch.parallel.mesh import UNSCHEDULED_PENALTY

    pending = req.pod_req.shape[0] - np.asarray(scheduled).sum(axis=1)
    cost = (np.asarray(req.prices, np.float64) * np.asarray(counts, np.float64)
            + UNSCHEDULED_PENALTY * pending.astype(np.float64))
    return int(np.argmin(cost)), float(cost.min())


def fleet_metric_lines(metrics) -> list:
    """The exposition's fleet family lines (``*_fleet_*``)."""
    return [line for line in metrics.registry.expose().splitlines() if "_fleet_" in line]


def coalescer(device, buckets=BUCKETS, batch=BATCH, metrics=None, **kw):
    """A FleetCoalescer on a 1×1 mesh of ``device``, on a still clock
    (every lifecycle stamp 0) unless ``clock=`` is given."""
    from autoscaler_tpu_torch.fleet.coalescer import FleetCoalescer
    from autoscaler_tpu_torch.parallel.mesh import make_mesh

    kw.setdefault("clock", lambda: 0.0)
    return FleetCoalescer(buckets=buckets, batch_scenarios=batch, metrics=metrics,
                          mesh=make_mesh([resolve_device(device)]), **kw)


def fleet_view(device=None, seed=1, n=BATCH) -> dict:
    """4q's fleet: ``n`` tenants at the 1024x32x8 bucket served by a
    prewarmed coalescer on ``device`` → its answers, its decision-ledger
    record and its fleet metric lines (on the still clock, so the
    lifecycle histograms read 0 on any device)."""
    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics

    dev = resolve_device(device)
    m = AutoscalerMetrics()
    co = coalescer(dev, buckets="1024x32x8", metrics=m)
    co.prewarm()
    reqs = fleet_tenants(seed, n, adhoc=None, **SMALL)
    answers, record = serve_round(co, reqs, lambda r: solo(r, dev))
    return {"answers": [answer_view(a) for a in answers], "record": record,
            "metrics": fleet_metric_lines(m)}


def serve(reqs, device=None, metrics=None, reps=0, buckets=BUCKETS, capture=False):
    """3v: a prewarmed coalescer on ``device`` serves ``reqs`` in one
    flush → {"answers", "record", "solo", "serve_s", "prewarm_s",
    "launches" (K1/K2's in the flush), "routes" (the flush's
    ``parallel/mesh.FLEET_ROUTES``), "batches" (the flush's),
    "captured" (with ``capture``, each of the flush's kernel launches with
    copies of its operands and outputs: ``loop_probe.KernelCapture``),
    "coalescer"}; with ``reps`` > 0 also the median batched and
    sequential round over ``reps`` more rounds each, as bench.py --fleet
    times them ("batched_s", "sequential_s")."""
    import contextlib

    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics
    from autoscaler_tpu_torch.ops import ffd_scan
    from autoscaler_tpu_torch.parallel.mesh import FLEET_ROUTES
    from autoscaler_tpu_torch.tools.loop_probe import KernelCapture

    dev = resolve_device(device)
    metrics = metrics if metrics is not None else AutoscalerMetrics()
    co = coalescer(dev, buckets=buckets, metrics=metrics, clock=time.monotonic)
    t0 = time.perf_counter()
    warmed = co.prewarm()
    prewarm_s = _synced(dev, t0)
    solos = {}

    def solo_of(req):
        if req.tenant_id not in solos:
            solos[req.tenant_id] = solo(req, dev)
        return solos[req.tenant_id]

    launches0, routes0 = dict(ffd_scan.LAUNCHES), dict(FLEET_ROUTES)
    batches0 = sum(metrics.fleet_batches_total.values.values())
    recorder = KernelCapture() if capture else contextlib.nullcontext()
    t0 = time.perf_counter()
    with recorder:
        answers, admitted = submit_flush(co, reqs, timeout=0.0)
        serve_s = _synced(dev, t0)
    # the flush's counts, read before the solo dispatches of the record
    out = {
        "launches": {k: ffd_scan.LAUNCHES[k] - launches0[k] for k in launches0},
        "routes": {k: FLEET_ROUTES[k] - routes0[k] for k in routes0},
        "batches": int(sum(metrics.fleet_batches_total.values.values()) - batches0),
        "captured": recorder.launches if capture else [],
        "answers": answers, "serve_s": serve_s, "prewarm_s": prewarm_s, "warmed": warmed,
        "coalescer": co,
    }
    out["record"] = round_record(co, reqs, answers, admitted, solo_of)
    out["solo"] = solos
    if reps:
        def batched():
            t0 = time.perf_counter()
            tickets = [co.submit(r) for r in reqs]
            co.flush()
            for tk in tickets:
                tk.result(timeout=0.0)
            return _synced(dev, t0)

        def sequential():
            t0 = time.perf_counter()
            for r in reqs:
                solo(r, dev)
            return _synced(dev, t0)

        out["batched_s"] = statistics.median(batched() for _ in range(reps))
        out["sequential_s"] = statistics.median(sequential() for _ in range(reps))
    return out


def _synced(dev, t0) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def serve_problems(reqs, out) -> list:
    """What 3v must not show: on a card, a batch that did not launch K1/K2
    once; a tenant served off the batched route, an answer unequal to its
    solo dispatch, a what-if best group unequal to the host's f64
    argmin."""
    bad = []
    on_card = out["coalescer"].device.type == "cuda"
    if on_card and (sum(out["launches"].values()) != out["batches"]
                    or out["routes"] != {"cuda": out["batches"], "torch_scan": 0}):
        bad.append(f"{out['batches']} batches, launches {out['launches']}, routes "
                   f"{out['routes']}")
    rows = {row["tenant"]: row for row in out["record"]["tenants"]}
    for req, answer in zip(reqs, out["answers"]):
        if isinstance(answer, BaseException):
            bad.append(f"{req.tenant_id}: {type(answer).__name__}: {answer}")
            continue
        row = rows[req.tenant_id]
        if answer.route != "fleet_batched":
            bad.append(f"{req.tenant_id}: route {answer.route}")
        if not row["match_solo"]:
            bad.append(f"{req.tenant_id}: differs from its solo dispatch")
        if req.prices is not None:
            best = host_best(req, *out["solo"][req.tenant_id])
            if (answer.best_group, answer.best_cost) != best:
                bad.append(f"{req.tenant_id}: best {answer.best_group, answer.best_cost} "
                           f"!= host {best}")
    return bad


def estimator_lane(pods, templates, device=None, metrics=None, n=2, lane_pods=LANE_PODS):
    """3v's fleet lane: ``n`` BinpackingNodeEstimators on ``device``, each
    with a FleetEstimatorClient on one started coalescer (5 ms window),
    each estimating its own ``lane_pods`` slice of ``pods`` × ``templates``
    from a thread of its own; then each estimator's solo estimate of the
    same slice → {"fleet": [...], "solo": [...], "equal": [...],
    "batches": the coalescer's batch count, "seconds"}."""
    from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
    from autoscaler_tpu_torch.gym.env import FleetEstimatorClient

    dev = resolve_device(device)
    co = coalescer(dev, metrics=metrics, window_s=0.005, clock=time.monotonic)
    ests = [
        BinpackingNodeEstimator(metrics=metrics, device=dev,
                                fleet_client=FleetEstimatorClient(co, f"estimator-{k}"))
        for k in range(n)
    ]
    slices = [pods[k * lane_pods:(k + 1) * lane_pods] for k in range(n)]
    fleet = [None] * n
    errors = []

    def run(k):
        try:
            fleet[k] = ests[k].estimate_many(slices[k], templates)
        except Exception as e:  # noqa: BLE001 — reported, then checked
            errors.append(f"estimator-{k}: {e!r}")

    co.start()
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        co.stop()
    seconds = _synced(dev, t0)
    batches = int(sum(co.metrics.fleet_batches_total.values.values())) if co.metrics else None
    solo_out = []
    for est, sl in zip(ests, slices):
        est.fleet_client = None
        solo_out.append(est.estimate_many(sl, templates))
    canon = [_canon(r) for r in fleet]
    return {"fleet": canon, "solo": [_canon(r) for r in solo_out], "errors": errors,
            "equal": [a == _canon(b) for a, b in zip(canon, solo_out)],
            "batches": batches, "seconds": seconds,
            "scheduled": [sum(len(p) for _, p in r.values()) if r else 0 for r in fleet]}


def _canon(result):
    if result is None:
        return None
    return {g: (n, sorted(p.key() for p in pods)) for g, (n, pods) in result.items()}


def whatif_operands(pod_req, masks, allocs, caps, S=SCENARIOS, seed=0):
    """BASELINE config 5's S spot-pricing scenarios over one estimate's
    operands, drawn as ``ScenarioStrategy`` draws them: the allocs shared
    by every scenario, a base price uniform in 0.5-3.0 a group, and in
    each scenario a group's spot price (base × SPOT_DISCOUNT) unless its
    spot is revoked (probability REVOKE_PROB) → (pod_req, masks, allocs
    [S, G, R], prices [S, G] f32, caps)."""
    rng = np.random.default_rng(seed)
    G = masks.shape[0]
    base = rng.uniform(0.5, 3.0, G)
    prices = np.zeros((S, G), np.float32)
    for g in range(G):
        for s in range(S):
            spot_available = rng.random() > REVOKE_PROB
            prices[s, g] = base[g] * (SPOT_DISCOUNT if spot_available else 1.0)
    allocs_s = np.ascontiguousarray(np.broadcast_to(allocs, (S,) + allocs.shape))
    return pod_req, masks, allocs_s, prices, caps


def whatif_host(pod_req, prices, counts, scheduled):
    """The what-if's expander reduction on the host in f32, as the mesh
    computes it (two products and a sum, each rounded): counts [G] and
    scheduled [G, P] of the one estimate every scenario shares → (costs
    [S, G], best [S], best_cost [S])."""
    from autoscaler_tpu_torch.parallel.mesh import UNSCHEDULED_PENALTY

    valid = np.asarray(pod_req)[:, PODS] > 0
    pending = valid.sum() - (np.asarray(scheduled) & valid[None, :]).sum(axis=1)
    costs = (np.asarray(prices, np.float32) * np.asarray(counts).astype(np.float32)
             + np.float32(UNSCHEDULED_PENALTY) * pending.astype(np.float32))
    return costs, costs.argmin(axis=1), costs.min(axis=1)


def whatif_problems(res, counts, scheduled, pod_req, prices) -> list:
    """3u's hold: every scenario's node counts equal the one estimate's,
    and the costs, best group and best cost equal the host's."""
    costs, best, best_cost = whatif_host(pod_req, prices, counts, scheduled)
    bad = []
    got = res.node_counts.cpu().numpy()
    if not (got == np.asarray(counts)[None, :]).all():
        differ = sorted(set(np.nonzero(got != counts)[0]))
        bad.append(f"node_counts differ in scenarios {differ}")
    for name, a, b in (("total_costs", res.total_costs, costs),
                       ("best_group", res.best_group, best),
                       ("best_cost", res.best_cost, best_cost)):
        if not np.array_equal(a.cpu().numpy(), b):
            bad.append(f"{name} differs from the host's")
    return bad


class TemplateGroup:
    """A node group stand-in for the expander: its template, a max size and
    a target size."""

    def __init__(self, name, template, max_size=1000, target=0):
        self.name, self.template = name, template
        self._max, self._target = max_size, target

    def id(self):
        return self.name

    def template_node_info(self):
        return self.template

    def max_size(self):
        return self._max

    def target_size(self):
        return self._target


def expansion_options(results, templates, option_cls=None):
    """The expansion options of an estimate's results (group → (count,
    pods)): one a group that schedules any pod."""
    if option_cls is None:
        from autoscaler_tpu_torch.expander.core import Option as option_cls
    return [option_cls(node_group=TemplateGroup(g, templates[g]), node_count=n, pods=list(p))
            for g, (n, p) in sorted(results.items()) if n > 0 and p]


def strategy_problems(strategy, options, chosen, device=None) -> list:
    """The scenario expander's choice held on the host: its what-if's
    counts equal one solo dispatch of the shared operands (every scenario
    shares the allocs), its costs and best groups equal ``whatif_host``'s,
    and the modal best group names ``chosen``."""
    from autoscaler_tpu_torch.parallel.mesh import fleet_solo_estimate

    res = strategy.last_whatif
    pod_req, masks, allocs, prices, caps = strategy.operands(
        options, res.node_counts.shape[0], 1)
    counts, sched = fleet_solo_estimate(pod_req, masks, allocs[0], caps,
                                        strategy.max_nodes, device=device)
    bad = whatif_problems(res, counts, sched, pod_req, prices)
    _, best, _ = whatif_host(pod_req, prices, counts, sched)
    modal = int(np.bincount(best[best < len(options)], minlength=len(options)).argmax())
    if options[modal] is not chosen:
        bad.append(f"chose {chosen.node_group.id()}, the host {options[modal].node_group.id()}")
    return bad


def small_worlds(seed=5):
    """4q's small worlds for ``ffd_binpack_scenarios``: bench.py --fleet's
    8 tenants stacked, the same with padded zero slots and cap-0 groups,
    a stack with one fractional tenant (the batch takes K1), and four of
    bench.py's tenants with decimal memory (K1; node_used summed from the
    node each pod took, as the XLA scan sums it) → [(label, scen_req,
    scen_masks, scen_allocs, scen_caps, max_nodes)]."""
    from autoscaler_tpu_torch.fleet.buckets import BucketSpec, pad_operands

    def stack(reqs, S, bucket, zero_caps=()):
        out = [np.zeros((S, bucket.pods, bucket.resources), np.float32),
               np.zeros((S, bucket.groups, bucket.pods), bool),
               np.zeros((S, bucket.groups, bucket.resources), np.float32),
               np.zeros((S, bucket.groups), np.int32)]
        for s, r in enumerate(reqs):
            caps = np.minimum(r.node_caps, r.max_nodes).astype(np.int32)
            for k, a in enumerate(pad_operands(bucket, r.pod_req, r.pod_masks,
                                               r.template_allocs, caps)):
                out[k][s] = a
        for s, g in zero_caps:
            out[3][s, g] = 0
        return out

    bench = bench_tenants()
    b32 = BucketSpec(32, 8, 8)
    rng = np.random.default_rng(seed)
    mixed = [tenant_request(rng, f"m{k}", int(rng.integers(20, 33)), int(rng.integers(3, 9)),
                            False) for k in range(3)]
    b_mixed = BucketSpec(32, 8, 8)
    return [
        ("bench 32x8x8 x 8", *stack(bench, 8, b32), 32),
        ("padded slots, cap-0 groups", *stack(bench[:5], 8, b32, zero_caps=((0, 1), (3, 7))), 32),
        ("fractional tenant (K1)", *stack(mixed + [fractional(mixed[0])], 4, b_mixed), 32),
        ("decimal tenants (K1)", *stack([decimal(r, k) for k, r in enumerate(bench[:4])], 4,
                                         b32), 32),
    ]


def hold_scenarios(worlds, device=None) -> list:
    """Each small world through ``ffd_binpack_scenarios_cuda`` (one K1/K2
    launch on a card), its plain version (``ops/binpack.
    ffd_binpack_scenarios``) and the serial oracle
    (``scenario_binpack_reference``) → one {"label", "route", "equal",
    "differ", "max_abs_err"} a world."""
    from autoscaler_tpu_torch.estimator.reference_impl import scenario_binpack_reference
    from autoscaler_tpu_torch.ops import ffd_scan
    from autoscaler_tpu_torch.ops.binpack import ffd_binpack_scenarios

    dev = resolve_device(device)
    held = []
    for label, req, masks, allocs, caps, M in worlds:
        args = [torch.tensor(a, device=dev) for a in (req, masks, allocs, caps)]
        before = dict(ffd_scan.LAUNCHES)
        # graftlint: disable=GL003 — the probe holds the kernel against its plain version and oracle directly, by design: it measures the kernel, not the ladder
        got = ffd_scan.ffd_binpack_scenarios_cuda(*args[:3], M, args[3])
        route = [k for k in ffd_scan.LAUNCHES if ffd_scan.LAUNCHES[k] != before[k]]
        # graftlint: disable=GL003 — the probe holds the kernel against its plain version and oracle directly, by design: it measures the kernel, not the ladder
        want = ffd_binpack_scenarios(*args[:3], max_nodes=M, scen_caps=args[3])
        oc, os_ = scenario_binpack_reference(req, masks, allocs, M, caps)
        differ, err = [], 0.0
        for field, a, b in zip(want._fields, want, got):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                differ.append(field)
            elif a.numel():
                err = max(err, float((a.double() - b.double()).abs().max()))
        if not np.array_equal(got.node_count.cpu().numpy(), oc):
            differ.append("node_count (oracle)")
        if not np.array_equal(got.scheduled.cpu().numpy(), os_):
            differ.append("scheduled (oracle)")
        held.append({"label": label, "route": route, "equal": not differ, "differ": differ,
                     "max_abs_err": err, "shape": list(req.shape)})
    return held


def fault_walk(device=None, seed=3, cooldown_s=10.0, threshold=2):
    """5d: faults injected on the coalescer's batched rung (``cuda`` on a
    card, ``torch`` off it) for ``threshold`` batches, which opens its
    breaker; one more batch while it is open; then, past the cooldown on
    the coalescer's injected clock, one clean batch → {"rung", "steps":
    [(error or route, degraded)], "oracle_batches", "failed_tickets",
    "answers_equal"}. On a card each faulted batch fails its tickets with
    the error; off it the batch descends to the oracle."""
    from autoscaler_tpu_torch.estimator.ladder import KernelLadder
    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics

    dev = resolve_device(device)
    rung = "cuda" if dev.type == "cuda" else "torch"
    clock = {"t": 0.0}
    m = AutoscalerMetrics()
    co = coalescer(dev, buckets="1024x32x8", metrics=m, clock=lambda: clock["t"],
                   ladder=KernelLadder(failure_threshold=threshold, cooldown_s=cooldown_s))
    reqs = fleet_tenants(seed, 2, adhoc=None, **SMALL)
    want = [verdict_bytes(*solo(r, dev)) for r in reqs]
    steps, equal = [], []

    def batch():
        tickets = [co.submit(r) for r in reqs]
        co.flush()
        outs = []
        for r, tk, w in zip(reqs, tickets, want):
            try:
                a = tk.result(timeout=60.0)
                outs.append(a.route)
                equal.append(verdict_bytes(a.node_counts, a.scheduled) == w)
            except Exception as e:  # noqa: BLE001
                outs.append(f"{type(e).__name__}: {e}")
        steps.append((outs, sorted(co.degraded())))

    co.ladder.fault_hook = lambda r: "kernel_fault" if r == rung else None
    for _ in range(threshold):
        batch()
    co.ladder.fault_hook = None
    batch()                        # the breaker is open: cooldown not elapsed
    clock["t"] = cooldown_s + 1.0
    batch()                        # the half-open probe
    oracle = int(sum(n for key, n in m.fleet_batches_total.values.items()
                     if dict(key)["route"] == "fleet_oracle"))
    failed = int(sum(n for key, n in m.fleet_ticket_outcomes_total.values.items()
                     if dict(key)["outcome"] == "failed"))
    return {"rung": rung, "card": dev.type == "cuda", "steps": steps,
            "oracle_batches": oracle, "failed_tickets": failed, "answers_equal": equal}


def walk_problems(walk) -> list:
    """What 5d must show on a card: the faulted batches and the one past
    the open breaker fail every ticket and no oracle serves; the breaker
    is open after the faults; the probe closes it and serves the batch on
    its route with answers equal to solo."""
    bad = []
    steps = walk["steps"]
    n = len(steps) - 2
    for k, (outs, degraded) in enumerate(steps[:-1]):
        if not all(o.startswith("FleetError") for o in outs):
            bad.append(f"batch {k + 1} did not fail its tickets: {outs}")
        if k >= n - 1 and degraded != [walk["rung"]]:
            bad.append(f"batch {k + 1}: degraded {degraded}")
    outs, degraded = steps[-1]
    if outs != ["fleet_batched"] * len(outs) or degraded:
        bad.append(f"the probe: {outs}, degraded {degraded}")
    if walk["oracle_batches"] or walk["failed_tickets"] != 2 * (len(steps) - 1):
        bad.append(f"oracle batches {walk['oracle_batches']}, failed tickets "
                   f"{walk['failed_tickets']}")
    if not walk["answers_equal"] or not all(walk["answers_equal"]):
        bad.append("the probe's answers differ from solo")
    return bad


def strategy_prices(templates, seed=0) -> dict:
    """On-demand node prices of the groups, uniform in 0.5-3.0."""
    rng = np.random.default_rng(seed)
    return {g: float(rng.uniform(0.5, 3.0)) for g in sorted(templates)}


def whatif_path(dev, pod_req, masks, allocs, caps, max_nodes):
    """3u's what-if: BASELINE config 5's scenarios over one estimate's
    operands on a 1×1 mesh of ``dev``, each scenario's FFD through
    ``ffd_binpack_groups_cuda`` → (WhatIfResult, the operands)."""
    from autoscaler_tpu_torch.ops.ffd_scan import ffd_binpack_groups_cuda
    from autoscaler_tpu_torch.parallel.mesh import make_mesh, whatif_best_options

    ops = whatif_operands(pod_req, masks, allocs, caps)
    args = [torch.tensor(a, device=dev) for a in ops]
    res = whatif_best_options(make_mesh([dev]), *args, max_nodes=max_nodes,
                              binpack_fn=ffd_binpack_groups_cuda, scenario_loop=True)
    return res, ops


def strategy_path(dev, results, templates, max_nodes):
    """3u's scenario expander over the expansion options of an estimate's
    results → (strategy, options, its choice)."""
    from autoscaler_tpu_torch.expander.scenario import ScenarioStrategy

    options = expansion_options(results, templates)
    strategy = ScenarioStrategy(strategy_prices(templates), num_scenarios=SCENARIOS,
                                spot_discount=SPOT_DISCOUNT, preemption_prob=REVOKE_PROB,
                                seed=0, max_nodes=max_nodes, device=dev)
    return strategy, options, strategy.best_option(options)


def affinity_path(dev, aff_ops, max_nodes):
    """3u's K3 over a 1-device group mesh: ``sharded_affinity_estimate(
    use_pallas=True)`` on the affinity workload's operands."""
    from autoscaler_tpu_torch.parallel.mesh import Mesh, sharded_affinity_estimate

    o = aff_ops
    return sharded_affinity_estimate(
        Mesh([dev], ("group",)), o["pod_req"], o["pod_masks"], o["template_allocs"],
        o["node_caps"], max_nodes, o["match"], o["aff_of"], o["anti_of"],
        o["node_level"], o["has_label"], spread=o["spread"], use_pallas=True,
    )


def main(argv=None) -> int:
    from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics
    from autoscaler_tpu_torch.ops import ffd_scan, ffd_scan_affinity
    from autoscaler_tpu_torch.tools import tick_probe
    from autoscaler_tpu_torch.utils import workload as wl

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the first card)")
    ap.add_argument("--small", action="store_true",
                    help="4q's small fleet and worlds only (a CPU's size)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    bad = []
    if not args.small:
        t0 = time.perf_counter()
        req, masks, allocs, caps = wl.build_workload()
        ops = ffd_scan.operands_from_numpy(req, masks, allocs, caps, dev)
        # graftlint: disable=GL003 — the probe holds the kernel against its plain version and oracle directly, by design: it measures the kernel, not the ladder
        ref = ffd_scan.ffd_binpack_groups_cuda(*ops[:3], wl.HEADLINE_MAX_NODES, ops[3])
        t1 = time.perf_counter()
        res, w = whatif_path(dev, req, masks, allocs, caps, wl.HEADLINE_MAX_NODES)
        t_whatif = _synced(dev, t1)
        bad += whatif_problems(res, ref.node_count.cpu().numpy(), ref.scheduled.cpu().numpy(),
                               req, w[3])
        templates, burst = tick_probe.burst_operands()
        results = BinpackingNodeEstimator(device=dev).estimate_many(burst, templates)
        strategy, options, chosen = strategy_path(dev, results, templates, wl.HEADLINE_MAX_NODES)
        bad += strategy_problems(strategy, options, chosen, dev)
        aff = ffd_scan_affinity.affinity_operands_from_numpy(*wl.build_affinity_workload(
            wl.AFFINITY_PODS, wl.AFFINITY_GROUPS, wl.AFFINITY_TERMS), device=dev)
        got = affinity_path(dev, aff, wl.AFFINITY_MAX_NODES)
        # graftlint: disable=GL003 — the probe holds the kernel against its plain version and oracle directly, by design: it measures the kernel, not the ladder
        want = ffd_scan_affinity.ffd_binpack_groups_affinity_cuda(
            **aff, max_nodes=wl.AFFINITY_MAX_NODES)
        bad += [f"affinity {f}" for f, a, b in zip(want._fields, want, got)
                if not torch.equal(a, b)]
        print(f"# what-if: {t_whatif:.3f} s for {SCENARIOS} scenarios, strategy chose "
              f"{chosen.node_group.id()} ({strategy.last_route}) of {len(options)}; "
              f"launches {ffd_scan.LAUNCHES} {ffd_scan_affinity.LAUNCHES}; "
              f"{time.perf_counter() - t0:.3f} s; problems {bad}", flush=True)
    reqs = (fleet_tenants(1, BATCH, adhoc=None, **SMALL) if args.small
            else fleet_tenants())
    out = serve(reqs, dev, AutoscalerMetrics(), reps=0 if args.small else 3,
                buckets="1024x32x8" if args.small else BUCKETS)
    bad += serve_problems(reqs, out)
    print(f"# fleet: {len(reqs)} tenants, prewarm {out['prewarm_s']:.3f} s, served in "
          f"{out['serve_s']:.3f} s; batched {out.get('batched_s')} s, sequential "
          f"{out.get('sequential_s')} s a round; problems {bad}", flush=True)
    if not args.small:
        lane = estimator_lane(burst, templates, dev)
        print(f"# fleet lane: equal {lane['equal']}, batches {lane['batches']}, "
              f"{lane['seconds']:.3f} s, errors {lane['errors']}", flush=True)
        bad += [] if all(lane["equal"]) and not lane["errors"] else ["fleet lane"]
    held = hold_scenarios(small_worlds(), dev)
    for h in held:
        print(f"# scenarios {h['label']}: {h['route']}, equal {h['equal']} {h['differ']}",
              flush=True)
    bad += [h["label"] for h in held if not h["equal"]]
    walk = fault_walk(dev)
    print(f"# fleet fault walk ({walk['rung']}): {walk['steps']}", flush=True)
    if walk["card"]:
        bad += walk_problems(walk)
    print(f"# problems {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
