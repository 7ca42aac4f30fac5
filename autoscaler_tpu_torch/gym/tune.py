"""Cross-entropy / successive-halving population tuner over the policy gym.

Podracer shape (PAPERS.md): a *population* of candidate policies is one
more batch axis on infrastructure that already batches — per-candidate
rollouts run concurrently on a thread pool, and every rollout's estimator
routes its packed dispatches through ONE shared fleet coalescer
(fleet/coalescer.py admission queue), so estimator calls from parallel
rollouts coalesce into shared mesh dispatches exactly as fleet tenants do.
Answers are batch-invariant (the fleet's fairness certificate), so the
coalescer buys dispatch amortization without ever touching a score.

Determinism: ALL randomness flows from one seeded :class:`PolicyRng`
(``np.random.default_rng`` keyed on the tune seed — the loadgen idiom;
no ambient RNG). Candidate sampling happens in the
coordinator thread BEFORE any evaluation, scores are pure functions of
(scenario seed, policy), and ledger records are assembled in candidate
order — so concurrency changes wall time, never a byte of the tuning
ledger. Two runs of the same tune are byte-identical.

The search itself:

- generation 0 = the all-defaults control (id ``defaults``, never pruned
  — the improvement gate's denominator) + K seeded-random candidates;
- each generation runs *successive halving* across the suite: candidates
  are scored scenario by scenario and the worse half is pruned after each
  stage, so hopeless candidates never pay for the full suite;
- survivors get comparable full-suite totals; the elite set feeds a
  cross-entropy update (numeric knobs: clipped gaussians around the elite
  mean; categorical knobs: the elite empirical distribution with an
  exploration floor) for the next generation;
- the best-so-far candidate is retained verbatim (elitism), which is what
  makes the ledger's best-of-generation score non-decreasing — the
  invariant ``ledger.validate_records`` enforces.

The port of ``autoscaler_tpu/gym/tune.py``: every rollout runs on
``TuneConfig.device`` (None = the first CUDA card), and the shared
coalescer serves there, so the thread pool's rollouts share one card.
"""
from __future__ import annotations

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from autoscaler_tpu_torch import trace
from autoscaler_tpu_torch.gym import ledger as gym_ledger
from autoscaler_tpu_torch.gym.env import PolicyGymEnv
from autoscaler_tpu_torch.gym.policy import (
    DEFAULT_POLICY,
    KNOB_SPACE,
    Knob,
    PolicySpec,
)
from autoscaler_tpu_torch.loadgen.suite import SuiteSpec
from autoscaler_tpu_torch.loadgen.score import DEFAULT_WEIGHTS, ObjectiveWeights
from autoscaler_tpu_torch.metrics import metrics as metrics_mod
from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics

# the tuner's INITIAL sampling window per knob — a practical sub-range of
# the declared bounds (sampling uniformly over [0, 3600] cooldown seconds
# would spend generations on obviously-absurd policies); CE then moves
# wherever the elites point, still bounds-checked by PolicySpec.
_INIT_WINDOW: Dict[str, Tuple[float, float]] = {
    "scale_down_utilization_threshold": (0.3, 0.9),
    "scale_down_unneeded_time_s": (0.0, 120.0),
    "scale_down_delay_after_add_s": (0.0, 120.0),
    "kernel_breaker_cooldown_s": (10.0, 300.0),
    "kernel_breaker_failure_threshold": (1, 5),
}


class PolicyRng:
    """The tune's one randomness source: a seeded numpy Generator behind
    the few draw shapes sampling needs. Threaded through explicitly — the
    seam — and only ever touched from the coordinator thread, so the
    draw sequence (hence the ledger) is independent of rollout timing."""

    def __init__(self, seed: int):
        self._rng = np.random.default_rng((int(seed), 15485863))

    def uniform(self, lo: float, hi: float) -> float:
        return float(lo + (hi - lo) * self._rng.random())

    def gauss(self, mu: float, sigma: float) -> float:
        return float(mu + sigma * self._rng.standard_normal())

    def choice(self, seq):
        return seq[int(self._rng.integers(0, len(seq)))]

    def coin(self, p: float) -> bool:
        return bool(self._rng.random() < p)


@dataclass
class TuneConfig:
    generations: int = 4
    population: int = 8
    seed: int = 0
    weights: ObjectiveWeights = field(default_factory=lambda: DEFAULT_WEIGHTS)
    # concurrent rollouts (the population axis; AutoscalingOptions
    # --gym-rollout-workers)
    workers: int = 4
    # route rollout estimator dispatches through one shared fleet
    # coalescer (--gym-fleet-coalesce); scores are identical either way
    fleet_coalesce: bool = True
    elite_count: int = 2
    # successive halving never prunes below this many candidates
    min_alive: int = 2
    rollout_timeout_s: float = 60.0
    # where the rollouts and the shared coalescer run (None = the first
    # CUDA card); never part of the ledger
    device: Any = None

    def __post_init__(self):
        if self.generations < 1 or self.population < 1:
            raise ValueError("generations and population must be >= 1")

    @classmethod
    def from_options(cls, options, **kwargs) -> "TuneConfig":
        """The --gym-* flag surface (config/options.py gym_* fields)."""
        kwargs.setdefault("workers", options.gym_rollout_workers)
        kwargs.setdefault("fleet_coalesce", options.gym_fleet_coalesce)
        kwargs.setdefault(
            "weights", ObjectiveWeights.parse(options.gym_objective_weights)
        )
        return cls(**kwargs)


@dataclass
class TuneResult:
    suite: str
    records: List[Dict[str, Any]]            # the ledger, in order
    best_policy: PolicySpec
    best_total: float
    baseline_total: float
    rollouts: int

    def ledger_lines(self) -> str:
        return "".join(gym_ledger.record_line(rec) for rec in self.records)

    def improvement(self) -> float:
        return round(self.best_total - self.baseline_total, 6)


@dataclass
class _Candidate:
    cid: str
    policy: PolicySpec
    scores: Dict[str, float] = field(default_factory=dict)
    eliminated_after: Optional[str] = None
    total: Optional[float] = None


def _window_sleep(seconds: float) -> None:
    """Wall pacing for the coalescing window thread without the time.sleep
    sanitizer trap (gym/ is replay-scoped; Event.wait is not a replay
    artifact input — it paces dispatch, the answers are batch-invariant)."""
    threading.Event().wait(max(float(seconds), 0.0))


class PopulationTuner:
    def __init__(
        self,
        suite: SuiteSpec,
        config: Optional[TuneConfig] = None,
        metrics: Optional[AutoscalerMetrics] = None,
    ):
        self.suite = suite
        self.config = config or TuneConfig()
        self.metrics = metrics or AutoscalerMetrics()
        self._coalescer = None
        # (policy JSON, scenario) → score, filled coordinator-side only
        self._score_cache: Dict[Tuple[str, str], float] = {}

    # -- sampling --------------------------------------------------------------
    def _sample_initial(self, rng: PolicyRng) -> PolicySpec:
        kw: Dict[str, Any] = {}
        for knob in KNOB_SPACE:
            if not rng.coin(0.75):
                continue        # leave at default: near-baseline diversity
            kw[knob.name] = self._draw_initial(rng, knob)
        return PolicySpec(**kw)

    @staticmethod
    def _draw_initial(rng: PolicyRng, knob: Knob):
        if knob.kind == "choice":
            return rng.choice(knob.choices)
        lo, hi = _INIT_WINDOW.get(knob.name, (knob.lo, knob.hi))
        if knob.kind == "int":
            return int(round(rng.uniform(lo, hi)))
        return round(rng.uniform(lo, hi), 4)

    def _sample_ce(
        self, rng: PolicyRng, elites: List[PolicySpec]
    ) -> PolicySpec:
        """Cross-entropy step: numeric knobs get a clipped gaussian around
        the elite mean (σ = elite spread with a floor so the search never
        collapses), categorical knobs draw from the elite empirical
        distribution with a 25% exploration coin."""
        kw: Dict[str, Any] = {}
        for knob in KNOB_SPACE:
            values = [e.resolved(knob.name) for e in elites]
            if knob.kind == "choice":
                kw[knob.name] = (
                    rng.choice(values) if rng.coin(0.75)
                    else rng.choice(knob.choices)
                )
                continue
            mu = sum(values) / len(values)
            spread = max(values) - min(values)
            lo, hi = _INIT_WINDOW.get(knob.name, (knob.lo, knob.hi))
            sigma = max(spread / 2.0, (hi - lo) * 0.15)
            drawn = min(max(rng.gauss(mu, sigma), knob.lo), knob.hi)
            kw[knob.name] = (
                int(round(drawn)) if knob.kind == "int" else round(drawn, 4)
            )
        return PolicySpec(**kw)

    # -- evaluation ------------------------------------------------------------
    def _rollout_score(self, policy: PolicySpec, scenario) -> float:
        env = PolicyGymEnv(
            scenario,
            weights=self.config.weights,
            coalescer=self._coalescer,
            rollout_timeout_s=self.config.rollout_timeout_s,
            device=self.config.device,
        )
        with trace.span(
            metrics_mod.GYM_ROLLOUT, metrics=self.metrics,
            scenario=scenario.name,
        ):
            result = env.rollout(policy=policy)
        self.metrics.gym_rollouts_total.inc(scenario=scenario.name)
        return result.score

    def _evaluate_stage(
        self, executor: ThreadPoolExecutor, alive: List[_Candidate], scenario
    ) -> None:
        """Score every live candidate on one scenario, concurrently;
        results land keyed by candidate, so completion order is invisible.
        Scores are pure functions of (scenario seed, policy) — the
        determinism contract — so a (policy, scenario) pair already
        evaluated this tune (the elitism carry-over, CE re-draws) reuses
        its score instead of re-paying a full rollout; ledger bytes are
        identical either way."""
        futures = {}
        for cand in alive:
            key = (gym_ledger.stable_json(cand.policy.to_dict()), scenario.name)
            if key in self._score_cache:
                cand.scores[scenario.name] = self._score_cache[key]
            else:
                futures[cand.cid] = (
                    key,
                    executor.submit(self._rollout_score, cand.policy, scenario),
                )
        for cand in alive:
            if cand.cid not in futures:
                continue
            key, fut = futures[cand.cid]
            score = fut.result(
                timeout=self.config.rollout_timeout_s * (scenario.ticks + 1)
            )
            cand.scores[scenario.name] = score
            self._score_cache[key] = score

    # -- the tune --------------------------------------------------------------
    def tune(self) -> TuneResult:
        cfg = self.config
        scenarios = self.suite.scenarios
        names = self.suite.scenario_names()
        rng = PolicyRng(cfg.seed)
        if cfg.fleet_coalesce:
            from autoscaler_tpu_torch.fleet.coalescer import FleetCoalescer

            # perf_counter (the sanctioned measurement clock) + Event-wait
            # pacing: the window thread must not touch the replay-trapped
            # clocks. Breaker cooldowns on the fleet ladder run on this
            # wall clock — fleet answers are batch- and rung-invariant, so
            # nothing score-visible depends on it.
            self._coalescer = FleetCoalescer(
                window_s=0.002,
                metrics=self.metrics,
                clock=time.perf_counter,
                sleep=_window_sleep,
                device=cfg.device,
            )
            self._coalescer.start()
        executor = ThreadPoolExecutor(
            max_workers=max(cfg.workers, 1),
            thread_name_prefix="gym-rollout",
        )
        try:
            return self._tune_inner(executor, rng, scenarios, names)
        finally:
            executor.shutdown(wait=True)
            if self._coalescer is not None:
                self._coalescer.stop()
                self._coalescer = None

    def _tune_inner(self, executor, rng, scenarios, names) -> TuneResult:
        cfg = self.config
        records: List[Dict[str, Any]] = []
        pool: List[_Candidate] = []      # fully-evaluated, all generations
        best_so_far: Optional[_Candidate] = None
        rollouts = 0
        for g in range(cfg.generations):
            with trace.span(
                metrics_mod.GYM_GENERATION, metrics=self.metrics,
                generation=g, population=cfg.population,
            ):
                cands = self._generation_candidates(g, rng, pool)
                pruned = self._halving(executor, cands, scenarios)
                survivors = [c for c in cands if c.eliminated_after is None]
                for cand in survivors:
                    cand.total = round(
                        sum(cand.scores[n] for n in names) / len(names), 6
                    )
                pool.extend(survivors)
                best = max(
                    survivors, key=lambda c: (c.total, c.cid)
                )
                if best_so_far is None or best.total > best_so_far.total:
                    best_so_far = best
                rollouts += sum(len(c.scores) for c in cands)
                self.metrics.gym_generation_best_score.set(
                    float(best_so_far.total)
                )
                if pruned:
                    self.metrics.gym_candidates_pruned_total.inc(
                        float(pruned)
                    )
                records.append(self._record(g, names, cands, best, best_so_far))
        baseline = next(
            c for c in pool if c.cid == gym_ledger.BASELINE_ID
        )
        return TuneResult(
            suite=self.suite.name,
            records=records,
            best_policy=best_so_far.policy,
            best_total=best_so_far.total,
            baseline_total=baseline.total,
            rollouts=rollouts,
        )

    def _generation_candidates(
        self, g: int, rng: PolicyRng, pool: List[_Candidate]
    ) -> List[_Candidate]:
        cfg = self.config
        if g == 0:
            cands = [_Candidate(gym_ledger.BASELINE_ID, DEFAULT_POLICY)]
            cands.extend(
                _Candidate(f"g0c{i}", self._sample_initial(rng))
                for i in range(cfg.population)
            )
            return cands
        elites = [
            c.policy
            for c in sorted(pool, key=lambda c: (-c.total, c.cid))
        ][: max(cfg.elite_count, 1)]
        cands = []
        seen = set()
        for i in range(cfg.population):
            if i == 0:
                policy = elites[0]      # elitism: best-so-far re-enters
            else:
                policy = self._sample_ce(rng, elites)
            # a resampled duplicate would waste a full-suite evaluation
            # AND create ambiguous ledger rows; nudge via fresh draws,
            # RE-CHECKING each (a collapsed CE distribution keeps handing
            # back the elite) — bounded so sampling always terminates
            for _ in range(8):
                if gym_ledger.stable_json(policy.to_dict()) not in seen:
                    break
                policy = self._sample_initial(rng)
            seen.add(gym_ledger.stable_json(policy.to_dict()))
            cands.append(_Candidate(f"g{g}c{i}", policy))
        return cands

    def _halving(
        self, executor, cands: List[_Candidate], scenarios
    ) -> int:
        """Successive halving across the suite; returns how many
        candidates were pruned. The ``defaults`` control is exempt — its
        full-suite total is the improvement gate's denominator."""
        cfg = self.config
        alive = list(cands)
        pruned = 0
        for si, scenario in enumerate(scenarios):
            self._evaluate_stage(executor, alive, scenario)
            last = si == len(scenarios) - 1
            prunable = [
                c for c in alive if c.cid != gym_ledger.BASELINE_ID
            ]
            if last or len(prunable) <= cfg.min_alive:
                continue
            keep = max(
                int(math.ceil(len(prunable) / 2.0)), cfg.min_alive
            )
            cum = lambda c: sum(c.scores.values())  # noqa: E731
            ranked = sorted(prunable, key=lambda c: (-cum(c), c.cid))
            for cand in ranked[keep:]:
                cand.eliminated_after = scenario.name
                pruned += 1
            dropped = {c.cid for c in ranked[keep:]}
            alive = [c for c in alive if c.cid not in dropped]
        return pruned

    def _record(
        self, g: int, names, cands: List[_Candidate], best, best_so_far
    ) -> Dict[str, Any]:
        cfg = self.config
        return {
            "schema": gym_ledger.SCHEMA,
            "suite": self.suite.name,
            "generation": g,
            "generations": cfg.generations,
            "seed": cfg.seed,
            "population": cfg.population,
            "weights": cfg.weights.to_dict(),
            "scenarios": list(names),
            "fleet_coalesced": bool(cfg.fleet_coalesce),
            "candidates": [
                {
                    "id": c.cid,
                    "policy": c.policy.to_dict(),
                    "scores": {k: c.scores[k] for k in sorted(c.scores)},
                    "eliminated_after": c.eliminated_after,
                    **({"total": c.total} if c.total is not None else {}),
                }
                for c in cands
            ],
            "pruned": sum(1 for c in cands if c.eliminated_after is not None),
            "best": {"id": best.cid, "total": best.total},
            "best_so_far": {
                "id": best_so_far.cid,
                "total": best_so_far.total,
                "policy": best_so_far.policy.to_dict(),
            },
        }


def tune_suite(
    suite: SuiteSpec,
    config: Optional[TuneConfig] = None,
    metrics: Optional[AutoscalerMetrics] = None,
) -> TuneResult:
    return PopulationTuner(suite, config, metrics=metrics).tune()
