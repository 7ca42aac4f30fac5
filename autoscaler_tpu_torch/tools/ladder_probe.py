"""The estimator's kernel ladder on the card: chip_smoke's 5a (the perf
records of a reconcile loop and the ladder's proof), 5b (a fault walk) and
5c (the native and Python rungs against the cuda rung).

    python3 -m autoscaler_tpu_torch.tools.ladder_probe               # one card
    python3 -m autoscaler_tpu_torch.tools.ladder_probe --device cpu  # the host

The world is 4l's: the reconcile loop's listing and burst at a tenth of
their size (``loop_probe.loop_world(tenth=True)``: 1 500 nodes, a 3 000-pod
burst, the burst's 100 zoned templates as node groups).

- ``fault_walk``: one reconcile loop's autoscaler (``loop_probe.build_loop``)
  and its estimator's ladder. A healthy estimate of the burst, then
  ``FAULTS`` faults armed on the cuda rung through ``ladder.fault_hook``;
  the breaker opens at the third and ``/health-check`` reads degraded
  while it is open; past the cooldown one half-open probe closes it. On a
  card each faulted estimate raises, as does the estimate past the open
  breaker (the kernels have no fallback there), and the cuda rung serves
  the healthy and the probe step. Off a card each step descends to the
  torch rung. Every served step's decisions equal the first's.
- ``host_rungs``: the native library built at first use (timed), then the
  burst on the native rung (every group) and on the Python oracle (every
  ``PYTHON_STRIDE``-th group: its serial loops take seconds a group), each
  served by an estimator on the CPU with the rungs above it faulted,
  against the cuda rung's decisions.
- ``LadderWatch``: the card's estimators' counters and warnings, the proof
  that nothing on a card path faulted, descended or was forced.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
import urllib.error
import urllib.request
from collections import Counter

import torch

from autoscaler_tpu_torch import native_bridge
from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
from autoscaler_tpu_torch.estimator.ladder import KernelLadder
from autoscaler_tpu_torch.main import ObservabilityServer
from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics
from autoscaler_tpu_torch.ops import ffd_scan
from autoscaler_tpu_torch.tools import loop_probe
from autoscaler_tpu_torch.utils.errors import AutoscalerError

FAULTS = 3
PYTHON_STRIDE = 50


class LadderWatch:
    """What the card's estimators did, read from their own counters on one
    shared ``AutoscalerMetrics`` (``estimator_kernel_route_total``,
    ``estimator_kernel_rung_attempts_total``,
    ``estimator_breaker_transitions_total``) as differences since the last
    ``reset``, and every record at WARNING or above on the ``estimator``
    logger, caught by a logging handler until ``close``. ``problems``
    names what a card path must never do outside a fault walk."""

    # the reasons a card dispatch may be served below the cuda rung for:
    # the shape gates and the run-compressed routes
    ALLOWED_BELOW_CUDA = ("smem", "spread_width", "dedup")
    # the card's rung of a dispatch no hand kernel serves, with the cuda
    # rung's automatic skip: the preemption pass; and the fleet lane, whose
    # dispatch the shared coalescer serves on its own cuda rung
    CARD_TORCH_ROUTES = (("torch_preempt", "unsupported"), ("fleet_coalesced", "ok"))
    FAMILIES = ("estimator_kernel_route_total", "estimator_kernel_rung_attempts_total",
                "estimator_breaker_transitions_total")

    def __init__(self, metrics):
        self.metrics = metrics
        self.warnings: list = []
        watch = self

        class Handler(logging.Handler):
            def emit(self, record):
                watch.warnings.append(f"{record.levelname}: {record.getMessage()}")

        self._handler = Handler(level=logging.WARNING)
        logging.getLogger("estimator").addHandler(self._handler)
        self.reset()

    def close(self) -> None:
        logging.getLogger("estimator").removeHandler(self._handler)

    def reset(self) -> None:
        """Count from here: the counters' values now, and no warning."""
        self._base = {name: dict(getattr(self.metrics, name).values)
                      for name in self.FAMILIES}
        self.warnings.clear()

    def since(self, family: str) -> Counter:
        """{labels as a dict's items: increase since the last reset}."""
        base = self._base[family]
        return Counter({key: value - base.get(key, 0.0)
                        for key, value in getattr(self.metrics, family).values.items()
                        if value != base.get(key, 0.0)})

    def counts(self) -> dict:
        """{"route:<route>": n} and {"route:<route>:<reason>": n}."""
        out: dict = {}
        for key, n in self.since("estimator_kernel_route_total").items():
            labels = dict(key)
            for name in (f"route:{labels['route']}",
                         f"route:{labels['route']}:{labels['reason']}"):
                out[name] = out.get(name, 0) + int(n)
        return out

    def problems(self) -> list:
        """Since the last reset: fault attempts, dispatches served below
        the cuda rung for another reason than the shape gates or dedup
        (the preemption pass's torch rung is its card rung, the fleet
        lane's the coalescer's), forced
        dispatches, breaker transitions and estimator warnings."""
        out = [f"rung {dict(key)['rung']}: {int(n)} fault attempts"
               for key, n in self.since("estimator_kernel_rung_attempts_total").items()
               if dict(key)["outcome"] == "fault"]
        for key, n in self.since("estimator_kernel_route_total").items():
            labels = dict(key)
            if labels["reason"] == "forced" or (
                    labels["route"] not in ("cuda", "cuda_affinity")
                    and labels["reason"] not in self.ALLOWED_BELOW_CUDA
                    and (labels["route"], labels["reason"]) not in self.CARD_TORCH_ROUTES):
                out.append(f"{labels['route']} served on the card ({labels['reason']}) "
                           f"x{int(n)}")
        out += [f"breaker {dict(key)['rung']}: {dict(key)['from_state']} -> "
                f"{dict(key)['to_state']} x{int(n)}"
                for key, n in self.since("estimator_breaker_transitions_total").items()]
        return out + self.warnings


def perf_lines(sa) -> list:
    """One line for each of the autoscaler's perf records: its residency
    pools, the arena's delta rows, its dispatches by route with their
    dispatch seconds, and from the tick's trace the host wall of the
    ``perfRecord`` span (the record's cost), of the ``estimate`` spans and
    of the ``deviceDispatch`` spans (the ladder's rung engagements)."""
    traces = {t.root.attrs.get("trace_id"): t for t in sa.tracer.recorder.traces()}
    lines = []
    for rec in sa.observatory.records():
        by_route = Counter(d["route"] for d in rec["dispatches"])
        served_s = sum(d["dispatch_s"] for d in rec["dispatches"])
        arena = rec.get("arena")
        spans = traces[rec["tick"]].spans if rec["tick"] in traces else []

        def wall(name):
            return sum(sp.wall_s for sp in spans if sp.name == name)

        lines.append(
            f"# perf record: tick {rec['tick']} at {rec['now_ts']} s, resident bytes "
            f"{rec['resident_bytes']}, arena delta rows "
            f"{arena.get('delta_rows', 0) if arena else 'none (no arena)'}, dispatches by "
            f"route {dict(sorted(by_route.items()))} ({served_s:.6f} s served, "
            f"{sum(1 for d in rec['dispatches'] if d['cold'])} cold); host wall: perfRecord "
            f"{wall('perfRecord') * 1e3:.3f} ms, estimate {wall('estimate'):.6f} s, "
            f"{sum(1 for sp in spans if sp.name == 'deviceDispatch')} deviceDispatch "
            f"{wall('deviceDispatch'):.6f} s"
        )
    return lines


def _kernel_launches() -> int:
    return sum(ffd_scan.LAUNCHES.values())


def _routes(metrics) -> dict:
    return {(dict(k)["route"], dict(k)["reason"]): n
            for k, n in metrics.estimator_kernel_route_total.values.items()}


def _decisions(out) -> dict:
    return {g: (c, [p.name for p in pods]) for g, (c, pods) in out.items()}


def fault_walk(nodes, pods, burst, groups, device=None, faults=FAULTS) -> dict:
    """The walk above on ``device`` → {"steps": [(decisions or None,
    kernel launches, seconds, degraded rungs, (/health-check code, body),
    the error a step raised or None)], "routes": {(route, reason): n},
    "card": whether the device is CUDA, "cooldown": s, "threshold": n}."""
    sa, _, _ = loop_probe.build_loop(nodes, pods, burst, groups, device)
    est, ladder = sa.scale_up_orchestrator.estimator, sa.kernel_ladder()
    card = torch.device(est.device).type == "cuda"
    threshold = ladder.breakers["cuda"].failure_threshold
    cooldown = ladder.breakers["cuda"].cooldown_s
    armed = {"left": 0}

    def hook(rung):
        if rung == "cuda" and armed["left"]:
            armed["left"] -= 1
            return "kernel_fault"
        return None

    ladder.fault_hook = hook
    server = ObservabilityServer(sa, "127.0.0.1:0")
    port = server.start()

    def health():
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health-check",
                                        timeout=60) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    times = [float(k) for k in range(faults + 2)] + [faults + 1.0 + cooldown]
    steps = []
    try:
        for step, now in enumerate(times):
            if step == 1:
                armed["left"] = faults
            ladder.tick(now)
            before = _kernel_launches()
            t0 = time.perf_counter()
            out, raised = None, None
            try:
                out = _decisions(est.estimate_many(burst, groups))
            except AutoscalerError as e:
                raised = str(e)
            if card:
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            steps.append((out, _kernel_launches() - before, secs, ladder.degraded(), health(),
                          raised))
    finally:
        server.stop()
    return {"steps": steps, "routes": _routes(est.metrics), "card": card, "cooldown": cooldown,
            "threshold": threshold,
            "faults": est.metrics.estimator_kernel_rung_attempts_total.get(
                rung="cuda", outcome="fault")}


def walk_problems(walk: dict, faults=FAULTS) -> list:
    """What the fault walk must show and did not: the breaker opening at
    the threshold and closing on the probe, and the health check reading
    degraded exactly while it is open. On a card every faulted step and
    the step past an open breaker raise, and the cuda rung serves the
    others with equal decisions; off a card every step is served, by the
    torch rung, with equal decisions."""
    steps, out, card = walk["steps"], [], walk["card"]
    opened = walk["threshold"] <= faults
    degraded = [[]] + [["cuda"] if opened and k >= walk["threshold"] else []
                       for k in range(1, faults + 1)] + [["cuda"] if opened else [], []]
    raising = [False] + [card] * faults + [card and opened, False]
    if [s[5] is not None for s in steps] != raising:
        out.append(f"raised {[s[5] for s in steps]}, not where {raising}")
    if any(s[0] != steps[0][0] for s, r in zip(steps, raising) if not r):
        out.append("a rung decided differently")
    if [s[3] for s in steps] != degraded:
        out.append(f"degraded rungs {[s[3] for s in steps]}, not {degraded}")
    for s, want in zip(steps, degraded):
        if s[4][0] != 200 or (("degraded: cuda" in s[4][1]) != bool(want)):
            out.append(f"/health-check answered {s[4]} while degraded was {want}")
    if card:
        want_routes = {("cuda", "ok"): 2}
        launches = [1] + [0] * faults + [0 if opened else 1, 1]
        if [s[1] for s in steps] != launches:
            out.append(f"kernel launches {[s[1] for s in steps]}, not {launches}")
    else:
        want_routes = {("torch_scan", "not_cuda"): 2, ("torch_scan", "kernel_fault"): faults,
                       ("torch_scan", "breaker_open"): 1}
    if walk["routes"] != want_routes:
        out.append(f"routes {walk['routes']}, not {want_routes}")
    if walk["faults"] != faults:
        out.append(f"{walk['faults']} cuda fault attempts counted, not {faults}")
    return out


def host_rungs(burst, groups, want, stride=PYTHON_STRIDE) -> dict:
    """The native rung on every group, the Python oracle on every
    ``stride``-th, each served by an estimator on the CPU with the rungs
    above it faulted (the host rungs read the numpy operands wherever the
    estimator runs), against ``want`` (the cuda rung's decisions) →
    {"build_s", "native": (s, groups, equal, {(route, reason): n}),
    "python_ref": (the same)}."""
    t0 = time.perf_counter()
    ok = native_bridge.available()
    out = {"build_s": time.perf_counter() - t0, "built": ok,
           "error": native_bridge.build_error()}
    for rung, faulted, names in (
        ("native", ("torch",), sorted(groups)),
        ("python_ref", ("torch", "native"), sorted(groups)[::stride]),
    ):
        ladder = KernelLadder()
        ladder.fault_hook = lambda r, faulted=faulted: "kernel_fault" if r in faulted else None
        est = BinpackingNodeEstimator(metrics=AutoscalerMetrics(), ladder=ladder, device="cpu")
        t1 = time.perf_counter()
        got = _decisions(est.estimate_many(burst, {g: groups[g] for g in names}))
        out[rung] = (time.perf_counter() - t1, len(names),
                     got == {g: want[g] for g in names}, _routes(est.metrics))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the first card)")
    args = ap.parse_args(argv)
    nodes, pods, burst, groups = loop_probe.loop_world(tenth=True)
    walk = fault_walk(nodes, pods, burst, groups, args.device)
    print(walk_line(walk), flush=True)
    bad = walk_problems(walk)
    rungs = host_rungs(burst, groups, walk["steps"][0][0])
    print(host_line(rungs), flush=True)
    bad += [f"{rung} rung decided differently" for rung in ("native", "python_ref")
            if not rungs[rung][2]]
    for problem in bad:
        print(f"# problem: {problem}", flush=True)
    return 1 if bad else 0


def walk_line(walk: dict) -> str:
    return (
        f"# fault walk: threshold {walk['threshold']}, cooldown {walk['cooldown']} s; per step "
        f"(kernel launches, seconds, degraded, /health-check): "
        f"{[(k, round(t, 3), d, h, e) for _, k, t, d, h, e in walk['steps']]}; "
        f"routes {walk['routes']}"
    )


def host_line(rungs: dict) -> str:
    return (
        f"# host rungs: native library built in {rungs['build_s']:.3f} s host clock "
        f"({'ok' if rungs['built'] else rungs['error']}); native {rungs['native'][0]:.3f} s on "
        f"{rungs['native'][1]} groups (equal {rungs['native'][2]}), Python "
        f"{rungs['python_ref'][0]:.3f} s on {rungs['python_ref'][1]} groups "
        f"(equal {rungs['python_ref'][2]})"
    )


if __name__ == "__main__":
    sys.exit(main())
