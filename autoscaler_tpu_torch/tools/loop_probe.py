"""The reconcile loop on the card: chip_smoke's 3o (three ticks of
``StaticAutoscaler.run_once`` at full size), 3p (the observability server
on 3o's autoscaler), 3q (``python -m autoscaler_tpu_torch.main`` in a
subprocess) and 4l (3o's sequence at a tenth of the size, on the card and
on the CPU, compared field by field).

    python3 -m autoscaler_tpu_torch.tools.loop_probe                 # one card
    python3 -m autoscaler_tpu_torch.tools.loop_probe --device cpu --tenth

The listing is the scale-down probe's (``tools/scaledown_probe``): the
snapshot probe's world after a scale-in, 15 000 nodes in one node group a
node shape (min 0). On top of it the scale-up ticks' 30 000-pod burst is
pending, and the burst's 100 templates (each with the world's zone key
beside "zone") are node groups of min 0, max 1000 and target 0. One
``StaticAutoscaler`` runs on a ``FakeClusterAPI`` and a
``TestCloudProvider`` with ``AutoscalingOptions()``, a journal probe every
tick and the expander chain priority,least-waste with seeded ties
(``LOOP_OPTIONS``), at ``LOOP_TICKS``:

- tick 1 (t = 0 s): filter-out on the freed capacity, then ``scale_up``;
  the scale-down half runs its update in cooldown;
- between ticks (``churn``) the API binds each filtered pod to the node
  its hint names; the nodes the tick's IncreaseSize calls asked for come
  up from their group's template with the still-pending pods bound onto
  them first fit; pods they cannot hold leave the listing (a loop at the
  real scan interval would have scaled for them in the ticks skipped
  here); then the arrivals are listed;
- tick 2 (t = 601 s): past the add delay and the unneeded time, the
  scale-down half deletes;
- tick 3 (t = 1202 s): ``ARRIVALS`` new pending pods of the burst's
  distribution, one in twenty with a zone DoNotSchedule spread, so the
  estimate takes the dynamic route.

``churn`` and ``tick_state`` read and write the objects only through
their fields and the provider's and API's methods, so the same functions
drive the JAX package's twins of these objects (the tests do).
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import sys
import time
from collections import Counter

import numpy as np
import torch

from autoscaler_tpu_torch import trace
from autoscaler_tpu_torch.config.options import AutoscalingOptions
from autoscaler_tpu_torch.core.static_autoscaler import StaticAutoscaler
from autoscaler_tpu_torch.metrics import metrics as metrics_mod
from autoscaler_tpu_torch.ops import ffd_scan, ffd_scan_affinity, fit_reduce
from autoscaler_tpu_torch.tools.scaledown_probe import (
    fake_api,
    scale_in_listing,
    shape_provider,
)
from autoscaler_tpu_torch.tools.tick_probe import (
    TICK_MAX_SIZE,
    ZONES,
    burst_operands,
    burst_pods,
    canon,
    node_from_template,
    spread_burst,
    zoned_templates,
)
from autoscaler_tpu_torch.utils.workload import (
    SNAPSHOT_NODES,
    SNAPSHOT_PODS,
    SNAPSHOT_PORT_NODES,
    build_snapshot_world,
)

LOOP_TICKS = (0.0, 601.0, 1202.0)  # past the 600 s add delay and unneeded time
ARRIVALS = 1000                    # tick 3's new pending pods (a tenth at 4l)
# AutoscalingOptions() but for the journal probe every tick and the
# expander chain priority,least-waste (one priority tier that every group
# matches, as the bound loop's live ConfigMap has it) with a seed for its
# random tie-break, so that two runs choose alike
LOOP_OPTIONS = {"journal_probe_interval": 1, "expander": "priority,least-waste",
                "expander_priorities": {10: [".*"]}, "expander_random_seed": 0}
# the tick's phases as the tracer's span names, in the order a tick runs them
SPLIT = (
    ("poll", metrics_mod.POLL),
    ("update_state", metrics_mod.UPDATE_STATE),
    ("snapshot_build", metrics_mod.SNAPSHOT_BUILD),
    ("filter_out", metrics_mod.FILTER_OUT_SCHEDULABLE),
    ("preempt", metrics_mod.PREEMPT_PLAN),
    ("scale_up", metrics_mod.SCALE_UP),
    ("scale_down", metrics_mod.SCALE_DOWN),
    ("explain", metrics_mod.EXPLAIN_RECORD),
    ("journal", metrics_mod.JOURNAL_RECORD),
    ("slo", metrics_mod.SLO_WINDOW),
)


def loop_world(tenth: bool = False, seed: int = 0):
    """→ (nodes, pods, burst, groups): the scale-in listing, the pending
    burst and the burst's zoned templates by group name; ``tenth`` cuts
    the world, its port DaemonSet and the burst to a tenth."""
    cut = 10 if tenth else 1
    nodes, pods = build_snapshot_world(
        N=SNAPSHOT_NODES // cut, P=SNAPSHOT_PODS // cut,
        port_nodes=SNAPSHOT_PORT_NODES // cut, seed=seed,
    )
    nodes, pods = scale_in_listing(nodes, pods)
    templates, burst = burst_operands(seed)
    return nodes, pods, burst[: len(burst) // cut], zoned_templates(templates)


def build_loop(nodes, pods, burst, groups, device=None, clock=None, metrics=None,
               options=None):
    """→ (autoscaler, provider, api) of the port on ``device``: the shape
    groups owning ``nodes``, a group per burst template (min 0, max
    TICK_MAX_SIZE, target 0), the listing with the burst pending. With
    ``clock``, the tracer's timeline clock is that callable (the SLO
    window's tick durations then replay alike on any device). The
    autoscaler counts on ``metrics`` (None = an AutoscalerMetrics of its
    own) and runs at ``LOOP_OPTIONS`` updated by ``options``."""
    provider = shape_provider(nodes)
    for gid, template in sorted(groups.items()):
        provider.add_node_group(gid, 0, TICK_MAX_SIZE, 0, template)
    api = fake_api(nodes, list(pods) + list(burst))
    options = AutoscalingOptions(**{**LOOP_OPTIONS, **(options or {})})
    kw = {} if metrics is None else {"metrics": metrics}
    if clock is not None:
        kw.setdefault("metrics", metrics_mod.AutoscalerMetrics())
        kw["tracer"] = trace.Tracer(
            clock=clock, metrics=kw["metrics"],
            recorder=trace.FlightRecorder(capacity=options.trace_ring_size),
            slow_tick_threshold_s=options.trace_slow_tick_threshold_s,
        )
    return StaticAutoscaler(provider, api, options, device=device, **kw), provider, api


def arrivals(n: int, seed: int):
    """``n`` pending pods of the burst's distribution drawn from ``seed``;
    one in twenty, of those with no selector and no toleration, spread by
    zone on one of the world's apps as in the scale-up tick 3k, and
    pinned to the burst groups' nodes of a zone by their "zone" label (a
    zone-spread deployment on a node pool of its own), so that the pods
    the cluster cannot place yet reach the estimate with their spread."""
    out = spread_burst(burst_pods(np.random.default_rng(seed), n, prefix=f"arrive-{seed}"))
    for i, pod in enumerate(out):
        if pod.topology_spread:
            out[i] = dataclasses.replace(pod, node_selector={"zone": ZONES[i % 3]})
    return out


def _tolerated(pod, node) -> bool:
    return all(
        t.effect not in ("NoSchedule", "NoExecute")
        or any(tol.tolerates(t) for tol in pod.tolerations)
        for t in node.taints
    )


def _fits(pod, node, used) -> bool:
    a, r = node.allocatable, pod.requests
    return (
        all(node.labels.get(k) == v for k, v in pod.node_selector.items())
        and _tolerated(pod, node)
        and used[0] + r.cpu_m <= a.cpu_m
        and used[1] + r.memory <= a.memory
        and used[2] + 1 <= a.pods
    )


def churn(sa, api, provider, calls_before: int, seed: int, arriving=()) -> dict:
    """The listing at the next tick, as a watch cache delivers it
    (a changed pod is a new object, unchanged objects stay the same): each
    pending pod whose hint names a listed node is bound there; each node
    the IncreaseSize calls after ``calls_before`` asked for comes up from
    its group's template, and the still-pending pods are bound onto these
    nodes first fit (by key); pods none of them holds leave the listing;
    ``arriving`` pods are listed. → the counts of each."""
    hints = sa.pod_list_processor.hinting.hints

    def bind(key, node_name):
        pod = copy.copy(api.pods[key])
        pod.node_name = node_name
        api.pods[key] = pod

    pending = sorted(k for k, p in api.pods.items() if not p.node_name)
    bound = 0
    for key in pending:
        hinted = hints.get(key)
        if hinted is not None and hinted in api.nodes:
            bind(key, hinted)
            bound += 1
    groups = {g.id(): g for g in provider.node_groups()}
    new_nodes = []
    for gid, delta in provider.scale_up_calls[calls_before:]:
        for k in range(delta):
            node = node_from_template(groups[gid].template_node_info(),
                                      f"{gid}-t{seed}-{k}")
            provider.add_node(gid, node)
            api.add_node(node)
            new_nodes.append([node, [0.0, 0.0, 0]])
    placed = gone = 0
    for key in pending:
        pod = api.pods[key]
        if pod.node_name:
            continue
        for node, used in new_nodes:
            if _fits(pod, node, used):
                used[0] += pod.requests.cpu_m
                used[1] += pod.requests.memory
                used[2] += 1
                bind(key, node.name)
                placed += 1
                break
        else:
            del api.pods[key]
            gone += 1
    for pod in arriving:
        api.add_pod(pod)
    return {"bound": bound, "new_nodes": len(new_nodes), "placed": placed,
            "gone": gone, "arrived": len(arriving)}


def result_canon(result):
    """canon of a RunOnceResult, the actuation's lists sorted: the
    actuator's workers append the nodes they delete and the pods they
    evict in the order they finish."""
    down = result.scale_down
    if down is not None:
        down = dataclasses.replace(
            down, deleted_empty=sorted(down.deleted_empty),
            deleted_drain=sorted(down.deleted_drain), evicted_pods=sorted(down.evicted_pods),
        )
    return canon(dataclasses.replace(result, scale_down=down))


def tick_state(sa, api, provider, result, full=False) -> dict:
    """What a tick leaves behind, in plain values that compare across
    devices and packages: the RunOnceResult, the provider's groups and
    calls, the API's nodes, pods, evictions, events and ConfigMaps, and the
    tick's lines of the decision, journal and SLO ledgers (with ``full``,
    every line of each ledger so far)."""
    from autoscaler_tpu_torch.explain.ledger import record_line as explain_line
    from autoscaler_tpu_torch.journal.ledger import record_line as journal_line
    from autoscaler_tpu_torch.slo.ledger import record_line as slo_line

    if full:
        ledgers = {
            "decision": [explain_line(r) for r in sa.explainer.records()],
            "journal": [journal_line(r) for r in sa.journal.records()],
            "slo": [slo_line(r) for r in sa.slo.records()],
        }
    else:
        explain, journal, slo = (
            sa.explainer.last_record(), sa.journal.records(), sa.slo.last_record()
        )
        ledgers = {
            "decision": explain_line(explain) if explain is not None else None,
            "journal": journal_line(journal[-1]) if journal else None,
            "slo": slo_line(slo) if slo is not None else None,
        }
    return {
        "result": result_canon(result),
        "groups": [(g.id(), g.min_size(), g.max_size(), g.target_size())
                   for g in provider.node_groups()],
        "scale_up_calls": list(provider.scale_up_calls),
        "scale_down_calls": sorted(provider.scale_down_calls),
        "nodes": {name: (sorted((t.key, t.value, t.effect) for t in n.taints),
                         n.unschedulable, n.ready)
                  for name, n in sorted(api.nodes.items())},
        "pods": {key: p.node_name for key, p in sorted(api.pods.items())},
        "evicted": sorted(api.evicted),
        "events": sorted(api.events),
        "configmaps": canon(api.configmaps),
        **ledgers,
    }


def state_differences(a: dict, b: dict) -> list:
    """The keys of two ``tick_state`` records that differ."""
    return sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))


def span_split(sa) -> dict:
    """Host seconds of the last tick's phases, from its trace's span tree
    (wall clock): the root and each phase of ``SPLIT`` (0 when the tick
    skipped it)."""
    last = sa.tracer.recorder.traces()[-1]
    out = {"tick": last.root.wall_s}
    for key, name in SPLIT:
        out[key] = sum(s.wall_s for s in last.spans if s.name == name)
    return out


class JournalTimer:
    """Host seconds of the journal's parts in each tick, by wrapping the
    autoscaler's packer sink (capture: the first materialization's copy to
    host arrays), ``record_tick`` (the delta encode and the line) and
    ``probe`` (reconstruct and the fit check), and of the packer's updates
    (the pack, capture included)."""

    def __init__(self, sa):
        self.sa, self.times = sa, {}
        journal, packer = sa.journal, sa._packer
        self._undo = [(journal, "observe_update", journal.observe_update),
                      (journal, "record_tick", journal.record_tick),
                      (journal, "probe", journal.probe),
                      (packer, "update", packer.update)]
        for obj, name, fn in self._undo:
            setattr(obj, name, self._timed(name, fn))
        packer.journal_sink = journal.observe_update

    def _timed(self, name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0
        return run

    def take(self) -> dict:
        times, self.times = self.times, {}
        return times

    def undo(self) -> None:
        for obj, name, fn in self._undo:
            setattr(obj, name, fn)
        self.sa._packer.journal_sink = self.sa.journal.observe_update


def _plain_aff(ops):
    return ffd_scan_affinity._scan_plain_aff(
        ops.stream, ops.bits, ops.allocs, ops.caps, ops.nl, ops.hl, ops.spstat,
        ops.num_planes, ops.num_spread, ops.max_nodes,
    )


# the kernel wrappers a tick reaches: (module, attribute, the name its
# launch count goes by, its plain version on the same operands)
KERNELS = (
    (ffd_scan, "ffd_scan_f32", "ffd_scan_f32", ffd_scan._scan_plain_f32),
    (ffd_scan, "ffd_scan_swar", "ffd_scan_swar", ffd_scan._scan_plain_swar),
    (ffd_scan_affinity, "ffd_scan_aff", "ffd_scan_aff", _plain_aff),
    (fit_reduce, "fit_reduce_cuda", "fit_reduce", fit_reduce._fit_reduce_plain),
    (fit_reduce, "fit_reduce_rows", "fit_reduce_rows", fit_reduce._fit_reduce_rows_plain),
)


def _frozen(x):
    """A copy of a wrapper's operands or outputs that later in-place writes
    (the arena's, a resident buffer's) cannot reach."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        items = [_frozen(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


class KernelCapture:
    """Within ``with``, every call of a kernel wrapper in ``KERNELS`` is
    recorded in ``launches`` as (its count name, its operands, its outputs)
    and its keyword arguments where it was given any, operands and outputs
    copied at the call, so
    that each launch can be held against its plain version afterwards
    (``hold_launches``). The wrappers themselves run and count as before."""

    def __init__(self):
        self.launches = []
        self._real = []

    def __enter__(self):
        for mod, attr, name, _ in KERNELS:
            fn = getattr(mod, attr)
            self._real.append((mod, attr, fn))
            setattr(mod, attr, self._recording(name, fn))
        return self

    def _recording(self, name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            launch = (name, _frozen(args), _frozen(out))
            self.launches.append(launch + (dict(kw),) if kw else launch)
            return out
        return call

    def __exit__(self, *exc):
        for mod, attr, fn in self._real:
            setattr(mod, attr, fn)
        self._real = []
        return False

    def counts(self) -> Counter:
        return Counter(launch[0] for launch in self.launches)


def hold_launches(launches) -> list:
    """Each captured launch against its plain version on the same
    operands, every field with its dtype and shape → one (name, the
    operand stream's or request rows' shape, max abs difference, the
    fields that differ) a launch."""
    plain = {name: fn for _, _, name, fn in KERNELS}
    held = []
    for name, args, got, *kw in launches:
        want = plain[name](*args, **(kw[0] if kw else {}))
        differ = [] if len(want) == len(got) else ["outputs"]
        err = 0.0
        fields = getattr(want, "_fields", ("free", "opened", "placed", "node_of"))
        for field, a, b in zip(fields, want, got):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                differ.append(field)
            elif a.numel():
                err = max(err, float((a.double() - b.double()).abs().max()))
        lead = args[0].stream if name == "ffd_scan_aff" else args[0]
        held.append((name, list(lead.shape), err, differ))
    return held


def run_loop_ticks(nodes, pods, burst, groups, device=None, timed=False,
                   arrive=ARRIVALS, debugger=None, replayable=False, metrics=None,
                   options=None, arriving=arrivals):
    """3o's three ticks on ``device``; a ``debugger`` (a
    ``DebuggingSnapshotter``) is attached and armed before the last tick,
    which it captures. ``replayable`` runs the tracer on a timeline clock
    that reads each tick's ``now_ts``, so that two runs (on two devices)
    write the same SLO windows; otherwise the ticks are timed by the wall
    clock. The autoscaler counts on ``metrics`` and takes ``options``
    (``build_loop``); tick 3's pods are ``arriving(arrive, 2)``. →
    {"autoscaler", "provider", "api", "ticks": [{"result",
    "state", "churn", "probe", and with ``timed`` the "split" and
    "journal" seconds}]}."""
    timeline = {"now": 0.0}
    clock = (lambda: timeline["now"]) if replayable else None
    sa, provider, api = build_loop(nodes, pods, burst, groups, device, clock, metrics,
                                   options)
    sa.debugger = debugger
    timer = JournalTimer(sa) if timed else None
    probes = []
    probe = sa.journal.probe

    def recording_probe():
        verdict = probe()
        probes.append(verdict)
        return verdict

    sa.journal.probe = recording_probe
    ticks, calls, churned = [], 0, None
    try:
        for k, now in enumerate(LOOP_TICKS):
            if k:
                churned = churn(sa, api, provider, calls, seed=k,
                                arriving=arriving(arrive, k) if k == 2 else ())
                calls = len(provider.scale_up_calls)
            if debugger is not None and k == len(LOOP_TICKS) - 1:
                debugger.request()
            if timer is not None:
                timer.take()
            timeline["now"] = now
            result = sa.run_once(now_ts=now)
            entry = {"result": result, "churn": churned,
                     "state": tick_state(sa, api, provider, result),
                     "unremovable": len(sa.scale_down_planner.last_unremovable()),
                     "probe": probes[-1] if probes else None}
            if timer is not None:
                entry["split"], entry["journal"] = span_split(sa), timer.take()
            ticks.append(entry)
    finally:
        sa.journal.probe = probe
        if timer is not None:
            timer.undo()
    return {"autoscaler": sa, "provider": provider, "api": api, "ticks": ticks}


def tick_line(label: str, entry: dict) -> str:
    """One printed line a tick: the RunOnceResult's summary, the churn
    before it, the host split, the journal's parts and the probe."""
    r = entry["result"]
    up, down = r.scale_up, r.scale_down
    parts = [
        f"# loop tick {label}: pending {r.pending_pods}, filtered {r.filtered_schedulable}, "
        f"unneeded {r.unneeded_nodes}, cooldown {r.scale_down_in_cooldown}, "
        f"errors {r.errors}",
        "scale_up " + (f"{up.chosen_group} +{up.new_nodes} executed {up.executed}, "
                       f"{len(up.pods_remain_unschedulable)} left" if up else "none"),
        "scale_down " + (f"empty {len(down.deleted_empty)}, drained {len(down.deleted_drain)}, "
                         f"evicted {len(down.evicted_pods)}" if down else "none"),
    ]
    if entry["churn"] is not None:
        parts.append(f"churn before {entry['churn']}")
    if "split" in entry:
        parts.append("split " + ", ".join(f"{k} {v:.3f}" for k, v in entry["split"].items()))
        j = entry["journal"]
        pack = j.get("update", 0.0) - j.get("observe_update", 0.0)
        parts.append(
            f"pack {pack:.3f} s (capture {j.get('observe_update', 0.0):.3f}), journal "
            f"encode {j.get('record_tick', 0.0):.3f}, probe {j.get('probe', 0.0):.3f} s"
        )
    parts.append(f"probe {entry['probe']}")
    return "; ".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the first card)")
    ap.add_argument("--tenth", action="store_true", help="4l's size: a tenth of 3o's")
    args = ap.parse_args(argv)
    nodes, pods, burst, groups = loop_world(args.tenth)
    out = run_loop_ticks(nodes, pods, burst, groups, args.device, timed=True,
                         arrive=ARRIVALS // (10 if args.tenth else 1))
    drift = False
    for k, entry in enumerate(out["ticks"]):
        print(tick_line(str(k + 1), entry), flush=True)
        drift |= bool(entry["probe"] and entry["probe"].get("drift"))
    return 1 if drift else 0


if __name__ == "__main__":
    sys.exit(main())
