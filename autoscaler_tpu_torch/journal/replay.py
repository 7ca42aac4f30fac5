"""Live-vs-replay divergence probing: re-execute a journaled tick's
decision path and byte-compare against the recorded explain-ledger line.

For every journaled tick, ``replay_tick`` reconstructs the decision-input
state, re-runs the preemption pass exactly as the control loop did —
``BinpackingNodeEstimator.estimate_preemption`` over the reconstructed
tensors, the journaled victim-eligibility channel, and the journaled
eligible pending set (preempt/engine.py's row semantics, names from the
journal's tables) — and byte-compares the rebuilt preemption section
against the one in the recorded decision ledger. The kernel route is
spliced from the record (provenance of which rung served the live
dispatch is environment, not state); everything else must match to the
byte. The tick's full explain line is additionally pinned by sha256 to
the hash stamped in the journal, so the ledger on disk is provably the
ledger that was recorded.

Divergence here means one of three things broke: the journal codec, the
determinism contract of the decision path, or the ledger file — exactly
the three failure modes the flight journal exists to catch.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from autoscaler_tpu_torch.journal.codec import sha256_hex
from autoscaler_tpu_torch.journal.reader import JournalReader, ReconstructedState


def _strict(doc: Any) -> str:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def _replan(state: ReconstructedState, eligible: List[str], device=None) -> Dict[str, Any]:
    """Re-run the preemption pass on reconstructed state (the engine's
    plan() semantics, keyed by the journal's name tables) on ``device``."""
    from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
    from autoscaler_tpu_torch.explain.reasons import EVICTION_PREEMPTED_BY

    tensors = state.tensors(device)
    pod_names = state.names.get("pods", [])
    node_names = state.names.get("nodes", [])
    pod_node = state.fields["pod_node"]
    valid = state.fields["pod_valid"].copy()
    elig = set(eligible)
    for row, key in enumerate(pod_names):
        if valid[row] and pod_node[row] < 0 and key not in elig:
            valid[row] = False
    scheduled, placed, victim_of, route = (
        BinpackingNodeEstimator(device=device).estimate_preemption(
            tensors, state.evictable(), pod_valid=valid
        )
    )
    scheduled = np.asarray(scheduled)
    victim_of = np.asarray(victim_of)
    admitted: List[str] = []
    victims: Dict[str, str] = {}
    victim_node: Dict[str, str] = {}
    for row, key in enumerate(pod_names):
        if key is None:
            continue
        if scheduled[row]:
            admitted.append(key)
        evictor = int(victim_of[row])
        if evictor >= 0:
            victims[key] = pod_names[evictor] or ""
            node_row = int(pod_node[row])
            victim_node[key] = (
                node_names[node_row]
                if 0 <= node_row < len(node_names)
                else ""
            ) or ""
    return {
        "route": route,
        "admitted": sorted(admitted),
        "evictions": [
            {
                "pod": victim,
                "reason": EVICTION_PREEMPTED_BY,
                "by": victims[victim],
                "node": victim_node[victim],
            }
            for victim in sorted(victims)
        ],
    }


def replay_tick(
    state: ReconstructedState,
    explain_rec: Optional[Dict[str, Any]],
    explain_line: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """One tick's verdict: {'tick', 'divergence': [findings], 'replayed'}.
    Empty divergence list = the recorded decisions re-derive exactly. The
    preemption pass re-runs on ``device``."""
    divergence: List[str] = []
    replayed = False
    if explain_line is not None and state.explain_sha256:
        got = sha256_hex(explain_line)
        if got != state.explain_sha256:
            divergence.append(
                "explain-ledger line hash "
                f"{got[:12]} != journaled {state.explain_sha256[:12]} — the "
                "ledger on disk is not the ledger that was recorded"
            )
    recorded = None if explain_rec is None else explain_rec.get("preemption")
    eligible = state.ctx.get("preempt_eligible")
    if recorded is None and eligible is None:
        return {"tick": state.tick, "divergence": divergence,
                "replayed": False}
    if recorded is None or eligible is None:
        divergence.append(
            "preemption context mismatch: journal eligible="
            f"{eligible is not None} vs ledger section={recorded is not None}"
        )
        return {"tick": state.tick, "divergence": divergence,
                "replayed": False}
    derived = _replan(state, list(eligible), device)
    # the live route is dispatch provenance (arena vs cold rung), not
    # state — splice it, then require byte equality on the decisions
    derived["route"] = recorded.get("route")
    # actuated evictions: victims minus scale-up-covered evictors minus
    # API failures — coverage and failures are journaled context, the
    # victim set itself is RE-DERIVED (preempt_covered is present exactly
    # when the live tick actuated, i.e. when it had victims)
    covered = state.ctx.get("preempt_covered")
    if covered is not None:
        cov = set(covered)
        failed = set(state.ctx.get("preempt_evict_failed") or ())
        victims = {row["pod"]: row["by"] for row in derived["evictions"]}
        derived["evicted"] = [
            victim
            for victim in sorted(victims)
            if victims[victim] not in cov and victim not in failed
        ]
    replayed = True
    a, b = _strict(derived), _strict(recorded)
    if a != b:
        divergence.append(f"preemption section diverged: replay={a} != "
                          f"recorded={b}")
    return {"tick": state.tick, "divergence": divergence,
            "replayed": replayed}


def replay_journal(
    reader: JournalReader,
    explain_records: List[Dict[str, Any]],
    explain_lines: Optional[List[str]] = None,
    tick: Optional[int] = None,
    device=None,
) -> List[Dict[str, Any]]:
    """Replay every journaled tick (or one) against the decision ledger,
    the preemption passes on ``device``."""
    by_tick: Dict[int, Dict[str, Any]] = {
        rec["tick"]: rec for rec in explain_records if "tick" in rec
    }
    lines_by_tick: Dict[int, str] = {}
    if explain_lines is not None:
        for rec, line in zip(explain_records, explain_lines):
            if "tick" in rec:
                lines_by_tick[rec["tick"]] = line
    results: List[Dict[str, Any]] = []
    for t in reader.ticks():
        if tick is not None and t != tick:
            continue
        state = reader.reconstruct(t)
        rec = by_tick.get(t)
        result = replay_tick(state, rec, lines_by_tick.get(t), device)
        if rec is None and state.explain_sha256:
            result["divergence"].append(
                "journaled tick missing from the decision ledger"
            )
        results.append(result)
    return results
