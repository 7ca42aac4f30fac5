"""Expander framework: choose which expansion option to act on (the port of
``autoscaler_tpu/expander/core.py``: random, most-pods, least-waste, price,
priority, grpc, grpc-ref and the preemption churn filter).

Reference: cluster-autoscaler/expander/expander.go — Option :44, Strategy
:52, Filter :57; chain composition expander/factory/chain.go:25 (filters
in order, the final strategy picks one). ``Option.node_group`` is any
object with ``id()`` (and ``template_node_info()`` for least-waste).
"""
from __future__ import annotations

import random as _random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from autoscaler_tpu_torch.kube.objects import Pod

RANDOM = "random"
MOST_PODS = "most-pods"
LEAST_WASTE = "least-waste"
PRICE = "price"
PRIORITY = "priority"
GRPC = "grpc"
GRPC_REF = "grpc-ref"  # reference expander.proto wire format
PREEMPT_CHURN = "preempt-churn"


@dataclass
class Option:
    """reference expander.go:44."""

    node_group: Any
    node_count: int
    pods: List[Pod] = field(default_factory=list)
    similar_node_groups: List[Any] = field(default_factory=list)

    @property
    def debug(self) -> str:
        return f"{self.node_group.id()}(+{self.node_count}, {len(self.pods)} pods)"


class Filter:
    """Narrows the option list; chained before the final strategy.
    ``name`` labels the filter in the scoring table; ``scores`` exposes the
    per-option figure ``best_options`` ranks by (None = no scalar score)."""

    def best_options(self, options: List[Option]) -> List[Option]:
        raise NotImplementedError

    def scores(self, options: List[Option]) -> Optional[List[float]]:
        return None

    def best_options_from_scores(
        self, options: List[Option], scores: List[float]
    ) -> List[Option]:
        raise NotImplementedError


class Strategy:
    """Picks exactly one option (or None)."""

    def best_option(self, options: List[Option]) -> Optional[Option]:
        raise NotImplementedError


class RandomStrategy(Strategy):
    """reference expander/random/."""

    def __init__(self, seed: Optional[int] = None):
        self._rng = _random.Random(seed)

    def best_option(self, options: List[Option]) -> Optional[Option]:
        return self._rng.choice(options) if options else None


class MostPodsFilter(Filter):
    """reference expander/mostpods/ — maximize pods helped."""

    name = MOST_PODS

    def best_options(self, options: List[Option]) -> List[Option]:
        if not options:
            return []
        return self.best_options_from_scores(options, self.scores(options))

    def scores(self, options: List[Option]) -> Optional[List[float]]:
        return [float(len(o.pods)) for o in options]

    def best_options_from_scores(self, options, scores):
        best = max(scores)
        return [o for s, o in zip(scores, options) if s == best]


class LeastWasteFilter(Filter):
    """reference expander/waste/ — minimize wasted cpu+mem fraction of the
    added capacity."""

    name = LEAST_WASTE

    def best_options(self, options: List[Option]) -> List[Option]:
        if not options:
            return []
        return self.best_options_from_scores(options, self.scores(options))

    def scores(self, options: List[Option]) -> Optional[List[float]]:
        return [self._wasted_fraction(o) for o in options]

    def best_options_from_scores(self, options, scores):
        best = min(scores)
        return [o for s, o in zip(scores, options) if s <= best + 1e-9]

    @staticmethod
    def _wasted_fraction(option: Option) -> float:
        template = option.node_group.template_node_info()
        cap_cpu = template.allocatable.cpu_m * option.node_count
        cap_mem = template.allocatable.memory * option.node_count
        req_cpu = sum(p.requests.cpu_m for p in option.pods)
        req_mem = sum(p.requests.memory for p in option.pods)
        wasted = 0.0
        if cap_cpu > 0:
            wasted += 1.0 - min(req_cpu / cap_cpu, 1.0)
        if cap_mem > 0:
            wasted += 1.0 - min(req_mem / cap_mem, 1.0)
        return wasted


class PreemptionChurnFilter(Filter):
    """Penalize eviction-heavy scale-up options (--preemption-churn-weight).

    Score = weight × churn, lower wins, where churn is the number of
    planned evictions the tick's PreemptionPlan charges to pods the option
    does NOT cover (PreemptionPlan.churn): an option whose new capacity
    absorbs the would-be evictors makes their evictions unnecessary, so it
    outranks an equally-sized option that leaves low-priority residents to
    be displaced. The orchestrator rebinds ``churn_of`` each tick to the
    live plan; with no plan bound (preemption disabled, or nothing planned
    this tick) the filter disengages completely — no score column, no
    elimination — so disabled runs stay byte-identical to pre-preemption
    ledgers."""

    name = PREEMPT_CHURN

    def __init__(self, weight: float):
        self.weight = float(weight)
        # set of covered pod keys → eviction count; rebound per decision
        self.churn_of = None

    def best_options(self, options: List[Option]) -> List[Option]:
        if not options or self.churn_of is None or self.weight <= 0:
            return options
        return self.best_options_from_scores(options, self.scores(options))

    def scores(self, options: List[Option]) -> Optional[List[float]]:
        if self.churn_of is None or self.weight <= 0:
            return None
        return [
            self.weight * float(self.churn_of({p.key() for p in o.pods}))
            for o in options
        ]

    def best_options_from_scores(self, options, scores):
        best = min(scores)
        return [o for s, o in zip(scores, options) if s <= best + 1e-9]


class ChainStrategy(Strategy):
    """reference expander/factory/chain.go:25 — filters in order, fallback
    strategy decides among survivors. Every ``best_option`` call rebuilds
    ``last_table`` (one row per candidate with each scoring filter's figure
    and, for the losers, the filter that eliminated them) and
    ``last_winner``/``last_score``."""

    def __init__(self, filters: Sequence[Filter], fallback: Strategy):
        self.filters = list(filters)
        self.fallback = fallback
        self.last_table: List[dict] = []
        self.last_winner: Optional[str] = None
        self.last_score: Optional[float] = None

    def best_option(self, options: List[Option]) -> Optional[Option]:
        rows = {
            id(o): {
                "group": o.node_group.id(),
                "node_count": int(o.node_count),
                "pods": len(o.pods),
                "scores": {},
                "eliminated_by": None,
            }
            for o in options
        }
        win_scores: Dict[int, float] = {}

        def publish(winner: Optional[Option]) -> Optional[Option]:
            self.last_table = sorted(rows.values(), key=lambda r: r["group"])
            self.last_winner = winner.node_group.id() if winner else None
            self.last_score = win_scores.get(id(winner)) if winner else None
            return winner

        survivors = list(options)
        for f in self.filters:
            fname = getattr(f, "name", None) or type(f).__name__
            scores = f.scores(survivors) if survivors else None
            if scores is not None:
                for o, s in zip(survivors, scores):
                    rows[id(o)]["scores"][fname] = round(float(s), 6)
                    win_scores[id(o)] = round(float(s), 6)
                filtered = f.best_options_from_scores(survivors, scores)
            else:
                filtered = f.best_options(survivors)
            if filtered:
                kept = {id(o) for o in filtered}
                for o in survivors:
                    if id(o) not in kept:
                        rows[id(o)]["eliminated_by"] = fname
            if len(filtered) == 1:
                return publish(filtered[0])
            if filtered:
                survivors = filtered
        return publish(self.fallback.best_option(survivors))


def build_strategy(names: Sequence[str], seed: Optional[int] = None, **kwargs) -> Strategy:
    """Build a chained strategy from expander names, as the reference's
    expander factory does from the --expander flag (factory/chain.go)."""
    filters: List[Filter] = []
    for name in names:
        if name == RANDOM:
            break
        elif name == MOST_PODS:
            filters.append(MostPodsFilter())
        elif name == LEAST_WASTE:
            filters.append(LeastWasteFilter())
        elif name == PRICE:
            from autoscaler_tpu_torch.expander.price import PriceFilter

            if kwargs.get("pricing") is None:
                raise ValueError(
                    "expander 'price' needs a provider pricing model"
                )
            filters.append(PriceFilter(kwargs["pricing"]))
        elif name == PRIORITY:
            if kwargs.get("priorities_fetch"):
                # live ConfigMap read per decision, the reference's actual
                # mechanism (expander/priority/priority.go)
                from autoscaler_tpu_torch.expander.priority import ConfigMapPriorityFilter

                filters.append(
                    ConfigMapPriorityFilter(
                        kwargs["priorities_fetch"],
                        fallback=kwargs.get("priorities"),
                    )
                )
            elif kwargs.get("priorities_path"):
                from autoscaler_tpu_torch.expander.priority import FileWatchingPriorityFilter

                filters.append(
                    FileWatchingPriorityFilter(
                        kwargs["priorities_path"],
                        fallback=kwargs.get("priorities"),
                    )
                )
            else:
                from autoscaler_tpu_torch.expander.priority import PriorityFilter

                filters.append(PriorityFilter(kwargs.get("priorities") or {}))
        elif name == GRPC:
            from autoscaler_tpu_torch.expander.grpc_ import GRPCFilter

            if not kwargs.get("grpc_target"):
                raise ValueError(
                    "expander 'grpc' needs a target (--grpc-expander-url)"
                )
            filters.append(GRPCFilter(
                kwargs["grpc_target"],
                default_deadline_s=kwargs.get("rpc_deadline_s"),
                failover_targets=kwargs.get("rpc_failover_targets"),
                hedge=bool(kwargs.get("rpc_hedge")),
            ))
        elif name == GRPC_REF:
            from autoscaler_tpu_torch.expander.grpc_ import RefGRPCFilter

            if not kwargs.get("grpc_target"):
                raise ValueError(
                    "expander 'grpc-ref' needs a target (--grpc-expander-url)"
                )
            filters.append(RefGRPCFilter(kwargs["grpc_target"]))
        else:
            raise ValueError(f"unknown expander {name!r}")
    return ChainStrategy(filters, RandomStrategy(seed))
