"""Price-based expander.

Reference: cluster-autoscaler/expander/price/price.go:90 (BestOptions):
score an option by the cost of the nodes it adds relative to the value of
the pods it schedules, with a "preferred node shape" unfitness penalty that
nudges toward medium-sized nodes (price.go's preferredNodeSize logic).
Lowest score wins.

The port's copy of ``autoscaler_tpu/expander/price.py``.
"""
from __future__ import annotations

import math
from typing import List

from autoscaler_tpu_torch.cloudprovider.interface import PricingModel
from autoscaler_tpu_torch.expander.core import Filter, Option

# planning horizon the reference prices over (price.go uses ~7d for nodes)
HORIZON_S = 7 * 24 * 3600.0
# penalty shape mirroring price.go's node-unfitness multiplier bounds
UNFITNESS_FLOOR = 1.0
UNFITNESS_CEIL = 2.0


class PriceFilter(Filter):
    name = "price"

    def __init__(self, pricing: PricingModel, preferred_cpu_m: float = 8000.0):
        self.pricing = pricing
        self.preferred_cpu_m = preferred_cpu_m

    def scores(self, options: List[Option]):
        return [self._score(o) for o in options]

    def best_options(self, options: List[Option]) -> List[Option]:
        if not options:
            return []
        return self.best_options_from_scores(options, self.scores(options))

    def best_options_from_scores(self, options, scores):
        best = min(scores)
        return [o for s, o in zip(scores, options) if s <= best * (1 + 1e-9)]

    def _score(self, option: Option) -> float:
        template = option.node_group.template_node_info()
        node_cost = (
            self.pricing.node_price(template, 0.0, HORIZON_S) * option.node_count
        )
        pod_value = sum(self.pricing.pod_price(p, 0.0, HORIZON_S) for p in option.pods)
        base = node_cost / max(pod_value, 1e-9)
        return base * self._unfitness(template)

    def _unfitness(self, template) -> float:
        """Penalize node shapes far from the preferred size (either way), as
        price.go's preferred-node-shape unfitness does: 1.0 at the preferred
        size, growing toward 2.0 with log-distance."""
        cpu = max(template.allocatable.cpu_m, 1.0)
        dist = abs(math.log2(cpu / self.preferred_cpu_m))
        return min(UNFITNESS_FLOOR + 0.25 * dist, UNFITNESS_CEIL)
