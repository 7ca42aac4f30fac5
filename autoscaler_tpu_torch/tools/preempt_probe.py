"""The preemption pass on the card: chip_smoke's 3t (three ``run_once``
ticks of the reconcile loop's world with priorities and preemption on),
4o (3t at 4l's tenth, on the card and on the CPU) and 4p (the main loop
against its plain version and the serial oracle on small worlds).

    python3 -m autoscaler_tpu_torch.tools.preempt_probe                 # one card
    python3 -m autoscaler_tpu_torch.tools.preempt_probe --device cpu --tenth

The world is ``loop_probe``'s (the scale-in listing, the burst and its
groups) with priorities and a wave of whole-node pods, a priority storm
on a busy cluster: the placed pods of apps 100-199 at priority 0 (the
victims), every other pod of the listing at 1 000, the burst, the wave
(``STORM_WAVE`` pods of 15 cores, more than the free capacity holds) and
tick 3's arrivals at 10 000 with one in five at ``preemptionPolicy:
Never``; the host-port DaemonSet's pods are never victims
(``preempt/policy.victim_eligible``). Without the wave the pods that
filter-out leaves are the burst's zone-selector pods, which no listed
node can take, evicting or not. The autoscaler runs at
``loop_probe.LOOP_OPTIONS`` with ``--preemption-enabled`` and a churn
weight of 1.0, the journal on; between ticks ``loop_probe.churn`` as in
3o. After the ticks ``replay`` runs ``python -m
autoscaler_tpu_torch.journal replay`` over their journal and decision
ledger.

``storm_worlds`` copies bench.py's preemption storm generator (24 worlds
of 96 pods × 12 nodes, 2 resources) and ``wide_worlds`` draws a few worlds
of a few hundred pods × 50 nodes with 6 resources and memory in bytes
(decimal M requests against Gi allocatable); ``hold_plain`` runs each
through the main loop, the plain version and the oracle.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.estimator.reference_impl import ffd_binpack_preempt_reference
from autoscaler_tpu_torch.explain.ledger import record_line as explain_line
from autoscaler_tpu_torch.journal.ledger import record_line as journal_line
from autoscaler_tpu_torch.ops.preempt import ffd_binpack_preempt, ffd_binpack_preempt_plain
from autoscaler_tpu_torch.tools import loop_probe
from autoscaler_tpu_torch.utils.test_utils import build_test_pod

PREEMPT_OPTIONS = {"preemption_enabled": True, "preemption_churn_weight": 1.0}
STORM_WAVE = 9000                   # whole-node pods of the wave (a tenth at 4o)
LOW_APPS = range(100, 200)          # apps whose placed pods are the victims
PRIO_LOW, PRIO_REST, PRIO_BURST = 0, 1000, 10_000
NEVER_EVERY = 5                     # one burst pod in five may not evict
OPERANDS = ("pod_req", "pod_valid", "pod_node", "pod_priority", "pod_can_preempt",
            "pod_evictable", "node_alloc", "node_used", "node_valid", "sched_mask")
FIELDS = ("scheduled", "placed_node", "victim_of")


def _low(pod) -> bool:
    app = pod.labels.get("app", "")
    return bool(pod.node_name) and app.startswith("app-") and int(app[4:]) in LOW_APPS


def storm_burst(pods):
    """The pods at the burst's priority, one in five at Never."""
    return [dataclasses.replace(p, priority=PRIO_BURST,
                                preemption_policy="Never" if i % NEVER_EVERY == 0 else "")
            for i, p in enumerate(pods)]


def prioritize(pods, burst):
    """→ (pods, burst) of the storm: the listing's pods at PRIO_LOW (placed
    pods of LOW_APPS) or PRIO_REST, the burst through ``storm_burst``."""
    return ([dataclasses.replace(p, priority=PRIO_LOW if _low(p) else PRIO_REST)
             for p in pods], storm_burst(burst))


def storm_arrivals(n: int, seed: int):
    """``loop_probe.arrivals`` at the burst's priority."""
    return storm_burst(loop_probe.arrivals(n, seed))


def storm_wave(n: int, seed: int = 0):
    """``n`` pending pods of nearly a 16-core node each (15 cores, 8-14
    GiB): a wave that the cluster's free capacity cannot hold whole."""
    rng = np.random.default_rng((seed, 13))
    return [build_test_pod(f"storm-{i}", cpu_m=15_000.0,
                           mem=float(rng.integers(8, 15)) * 2**30)
            for i in range(n)]


def preempt_world(tenth: bool = False, seed: int = 0):
    """→ (nodes, pods, burst, groups): ``loop_probe.loop_world`` with the
    storm's priorities, the wave (``storm_wave``) after the burst."""
    nodes, pods, burst, groups = loop_probe.loop_world(tenth, seed)
    wave = storm_wave(STORM_WAVE // (10 if tenth else 1), seed)
    pods, burst = prioritize(pods, burst + wave)
    return nodes, pods, burst, groups


def run_preempt_ticks(nodes, pods, burst, groups, device=None, timed=False,
                      arrive=loop_probe.ARRIVALS, replayable=False, metrics=None):
    """3t's three ticks on ``device`` (``loop_probe.run_loop_ticks`` with
    preemption on and the storm's arrivals); each tick's entry gains its
    "preemption" summary (``tick_preemption``)."""
    out = loop_probe.run_loop_ticks(
        nodes, pods, burst, groups, device, timed=timed, arrive=arrive,
        replayable=replayable, metrics=metrics, options=PREEMPT_OPTIONS,
        arriving=storm_arrivals)
    sa = out["autoscaler"]
    decisions, journal = sa.explainer.records(), sa.journal.records()
    for k, entry in enumerate(out["ticks"]):
        entry["preemption"] = tick_preemption(decisions[k], journal[k], entry["result"])
    return out


def tick_preemption(decision: dict, journal: dict, result) -> dict:
    """One tick's preemption pass: the eligible pending pods (the journal's
    note), the admitted pods, the planned and actuated evictions and the
    failed ones, and the route that served it (the decision record)."""
    section = decision.get("preemption") or {}
    ctx = journal.get("ctx") or {}
    return {
        "eligible": len(ctx.get("preempt_eligible") or ()),
        "admitted": result.preempt_admitted,
        "planned": len(section.get("evictions") or ()),
        "evicted": len(result.preempted_pods),
        "failed": len(ctx.get("preempt_evict_failed") or ()),
        "route": section.get("route"),
    }


def write_ledgers(sa, directory: str):
    """The autoscaler's journal and decision ledger as JSONL files in
    ``directory`` → (journal path, ledger path)."""
    journal = os.path.join(directory, "journal.jsonl")
    ledger = os.path.join(directory, "decisions.jsonl")
    with open(journal, "w") as f:
        f.writelines(journal_line(r) for r in sa.journal.records())
    with open(ledger, "w") as f:
        f.writelines(explain_line(r) for r in sa.explainer.records())
    return journal, ledger


def replay(sa, device=None) -> dict:
    """``python -m autoscaler_tpu_torch.journal replay`` over the
    autoscaler's journal and decision ledger, in a subprocess on
    ``device`` → {"rc", "verdict" (its last line), "stderr", "seconds"}."""
    with tempfile.TemporaryDirectory() as tmp:
        journal, ledger = write_ledgers(sa, tmp)
        argv = [sys.executable, "-m", "autoscaler_tpu_torch.journal", "replay", journal,
                "--explain-ledger", ledger]
        if device is not None:
            argv += ["--device", str(device)]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__)))))
        seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    return {"rc": proc.returncode, "verdict": json.loads(lines[-1]) if lines else None,
            "stderr": proc.stderr[-2000:], "seconds": seconds}


def replay_in_process(sa, device=None) -> list:
    """``journal.replay.replay_journal`` over the autoscaler's journal and
    decision ledger in this process, the passes on ``device`` → one
    verdict a tick."""
    from autoscaler_tpu_torch.journal import JournalReader
    from autoscaler_tpu_torch.journal.replay import replay_journal

    records = sa.explainer.records()
    lines = [explain_line(r) for r in records]
    return replay_journal(JournalReader(sa.journal.records()), records, lines, device=device)


def tick_views(out, device=None) -> dict:
    """What 4o compares between two devices: each tick's state
    (``loop_probe.tick_state``: the result, the API's pods and evictions,
    the decision, journal and SLO lines) and preemption summary, and the
    journal's replay verdicts on ``device``."""
    return {"states": [e["state"] for e in out["ticks"]],
            "preemption": [e["preemption"] for e in out["ticks"]],
            "replay": replay_in_process(out["autoscaler"], device)}


def plan_line(label: str, entry: dict) -> str:
    """One printed line a tick: the pass's counts and route, and the
    ``preemptPlan`` span's host seconds when the tick was timed."""
    p = entry["preemption"]
    line = (f"# preempt tick {label}: eligible {p['eligible']}, admitted {p['admitted']}, "
            f"planned evictions {p['planned']}, evicted {p['evicted']} "
            f"(failed {p['failed']}), route {p['route']}")
    if "split" in entry:
        line += f", preemptPlan {entry['split']['preempt']:.3f} s"
    return line


# -- small worlds: the main loop against its plain version and the oracle


def _empty_world(P: int, N: int, R: int) -> dict:
    return dict(
        pod_req=np.zeros((P, R), np.float32), pod_valid=np.zeros((P,), bool),
        pod_node=np.full((P,), -1, np.int32), pod_priority=np.zeros((P,), np.int32),
        pod_can_preempt=np.zeros((P,), bool), pod_evictable=np.zeros((P,), bool),
        node_alloc=np.zeros((N, R), np.float32), node_used=np.zeros((N, R), np.float32),
        node_valid=np.ones((N,), bool), sched_mask=np.ones((P, N), bool),
    )


def storm_worlds(trials: int = 24, seed: int = 1601) -> list:
    """bench.py's preemption storm (its ``--preempt`` gate): ``trials``
    worlds of 96 pods × 12 nodes × 2 resources drawn in turn from one
    generator: low-priority residents packed ~85% full, then 24 pending
    pods of priority 50-199, one in five at Never."""
    rng = np.random.default_rng(seed)
    P, N, R = 96, 12, 2
    worlds = []
    for _ in range(trials):
        w = _empty_world(P, N, R)
        w["node_alloc"][:, 0] = rng.choice([4000.0, 8000.0], size=N)
        w["node_alloc"][:, 1] = 16384.0
        i = 0
        for n in range(N):
            while w["node_used"][n, 0] < 0.85 * w["node_alloc"][n, 0] and i < P - 24:
                req = np.array([float(rng.integers(300, 1200)),
                                float(rng.integers(256, 1024))], np.float32)
                if w["node_used"][n, 0] + req[0] > w["node_alloc"][n, 0]:
                    break
                w["pod_req"][i] = req
                w["pod_valid"][i] = True
                w["pod_node"][i] = n
                w["pod_priority"][i] = int(rng.integers(0, 20))
                w["pod_evictable"][i] = rng.random() > 0.1
                w["node_used"][n] += req
                i += 1
        for j in range(i, i + 24):
            w["pod_req"][j] = (float(rng.integers(800, 2500)), float(rng.integers(512, 2048)))
            w["pod_valid"][j] = True
            w["pod_priority"][j] = int(rng.integers(50, 200))
            w["pod_can_preempt"][j] = rng.random() > 0.2
        worlds.append(w)
    return worlds


GI, M = 2**30, 10**6


def byte_world(rng, P: int = 64, N: int = 8, pending: int = 12) -> dict:
    """A world of 6 resources in the packer's units (millicores, bytes,
    counts) with memory requests in decimal M against allocatable in Gi:
    residents of priority 0-49 (four in five evictable) packed to a random
    depth node by node, up to ``pending`` pending pods of priority 0-119
    (three in four may evict), and one predicate verdict in ten vetoed."""
    w = _empty_world(P, N, 6)
    w["sched_mask"] = rng.random((P, N)) > 0.1
    for n in range(N):
        gi = 32 if rng.random() < 0.5 else 16
        w["node_alloc"][n] = (rng.choice([3920.0, 7910.0]),
                              gi * GI - int(rng.integers(0, 4)) * 100 * 2**20, 100 * GI, 0, 0, 110)
    i = 0
    for n in range(N):
        depth = rng.uniform(0.5, 1.0)
        while i < P - pending:
            eph = rng.integers(0, 5) * GI if rng.random() < 0.3 else rng.integers(0, 3000) * M
            req = np.array([rng.integers(1, 40) * 50, rng.integers(64, 4096) * M, eph, 0, 0, 1],
                           np.float32)
            if np.any(w["node_used"][n] + req > w["node_alloc"][n] * depth):
                break
            w["pod_req"][i] = req
            w["pod_valid"][i] = True
            w["pod_node"][i] = n
            w["pod_priority"][i] = rng.integers(0, 50)
            w["pod_evictable"][i] = rng.random() > 0.2
            w["node_used"][n] += req
            i += 1
    for j in range(i, min(i + int(rng.integers(1, pending + 1)), P)):
        w["pod_req"][j] = (rng.integers(1, 80) * 50, rng.integers(64, 16384) * M,
                           rng.integers(0, 3000) * M, 0, 0, 1)
        w["pod_valid"][j] = True
        w["pod_priority"][j] = rng.integers(0, 120)
        w["pod_can_preempt"][j] = rng.random() > 0.25
    return w


def wide_worlds(count: int = 3, P: int = 240, N: int = 50, seed: int = 1613) -> list:
    """``count`` byte worlds of ``P`` pods × ``N`` nodes, 48 pending pods
    at most."""
    return [byte_world(np.random.default_rng((seed, k)), P, N, pending=48)
            for k in range(count)]


def hold_plain(worlds, device=None) -> list:
    """Each world through the main loop and the plain version on
    ``device`` and the serial oracle → one {"P", "N", "pending", "equal",
    "differ" (the fields where the three disagree), "max_abs_err",
    "main_s", "plain_s", "oracle_s", "evictions", "admitted"} a world."""
    dev = resolve_device(device)
    out = []
    for w in worlds:
        t = {k: torch.tensor(w[k], device=dev) for k in OPERANDS}
        t0 = time.perf_counter()
        # graftlint: disable=GL003 — the probe holds the kernel against its plain version and oracle directly, by design: it measures the kernel, not the ladder
        main = [x.cpu().numpy() for x in ffd_binpack_preempt(**t)]
        t1 = time.perf_counter()
        # graftlint: disable=GL003 — the probe holds the kernel against its plain version and oracle directly, by design: it measures the kernel, not the ladder
        plain = [x.cpu().numpy() for x in ffd_binpack_preempt_plain(**t)]
        t2 = time.perf_counter()
        # graftlint: disable=GL003 — the probe holds the kernel against its plain version and oracle directly, by design: it measures the kernel, not the ladder
        oracle = ffd_binpack_preempt_reference(*(w[k] for k in OPERANDS))
        t3 = time.perf_counter()
        differ, err = [], 0.0
        for field, a, b, c in zip(FIELDS, main, plain, oracle):
            if not (np.array_equal(a, b) and np.array_equal(a, c)):
                differ.append(field)
            err = max(err, float(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()),
                      float(np.abs(a.astype(np.int64) - c.astype(np.int64)).max()))
        out.append({"P": w["pod_req"].shape[0], "N": w["node_alloc"].shape[0],
                    "pending": int((w["pod_valid"] & (w["pod_node"] < 0)).sum()),
                    "equal": not differ, "differ": differ, "max_abs_err": err,
                    "main_s": t1 - t0, "plain_s": t2 - t1, "oracle_s": t3 - t2,
                    "evictions": int((main[2] >= 0).sum()), "admitted": int(main[0].sum())})
    return out


def hold_line(label: str, held: list) -> str:
    worlds = len(held)
    return (f"# preempt {label}: {worlds} worlds ({held[0]['P']}x{held[0]['N']} first), "
            f"main loop = plain = oracle on {sum(h['equal'] for h in held)}, differing "
            f"{[k for k, h in enumerate(held) if not h['equal']]}; admitted "
            f"{sum(h['admitted'] for h in held)}, evictions {sum(h['evictions'] for h in held)}; "
            f"host seconds main {sum(h['main_s'] for h in held):.3f}, plain "
            f"{sum(h['plain_s'] for h in held):.3f}, oracle {sum(h['oracle_s'] for h in held):.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the first card)")
    ap.add_argument("--tenth", action="store_true", help="4l's size: a tenth of 3t's")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    nodes, pods, burst, groups = preempt_world(args.tenth)
    out = run_preempt_ticks(nodes, pods, burst, groups, args.device, timed=True,
                            arrive=loop_probe.ARRIVALS // (10 if args.tenth else 1))
    bad = False
    for k, entry in enumerate(out["ticks"]):
        print(loop_probe.tick_line(str(k + 1), entry), flush=True)
        print(plan_line(str(k + 1), entry), flush=True)
    verdict = replay(out["autoscaler"], args.device)
    print(f"# preempt replay: rc {verdict['rc']}, {verdict['verdict']}, "
          f"{verdict['seconds']:.3f} s", flush=True)
    bad |= verdict["rc"] != 0
    for label, worlds in (("storm worlds", storm_worlds()), ("wide worlds", wide_worlds())):
        held = hold_plain(worlds, args.device)
        print(hold_line(label, held), flush=True)
        bad |= not all(h["equal"] for h in held)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
