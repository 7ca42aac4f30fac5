"""Tenant quota tiers: typed per-tier admission budgets.

The first admission control ran ONE global per-tenant qps knob
(``--fleet-tenant-qps``): every tenant got the same budget, so a paying
"gold" autoscaler and a best-effort batch tenant shed at the same depth.
``--fleet-tenant-tiers`` replaces that with a declarative tier table
(JSON on the flag / chart ``values.fleet.tenantTiers``):

    {
      "gold":    {"qps": 50, "burst": 100, "queue_share": 0.75,
                  "default_deadline_s": 30, "shed_priority": 0,
                  "tenants": ["vip-a", "vip-b"]},
      "default": {"qps": 1, "burst": 2, "queue_share": 0.25,
                  "default_deadline_s": 10, "shed_priority": 10}
    }

Semantics (consumed by fleet/admission.py + the coalescer):

- ``qps``/``burst``  — ONE token bucket per tier, shared by the tier's
  tenants (0 = the tier is unmetered). This is the "quota configs per
  tenant tier rather than one global qps" gap ROADMAP item 1 names.
- ``queue_share``    — the fraction of ``--fleet-max-queue-depth`` this
  tier may occupy; a storming low tier fills its slice and sheds
  ``shed_queue_full`` while gold's slice stays open. This is how "shed
  order under queue pressure prefers low tiers" holds at admission.
- ``default_deadline_s`` — applied to tickets submitted without their own
  deadline, so a tier's latency contract binds even lazy clients.
- ``shed_priority``  — service order under bounded capacity: LOWER serves
  first, HIGHER sheds/waits first (the coalescer orders each flush by it,
  so when ``flush(limit=)`` models a saturated service the bronze tail is
  what stays queued and expires).
- ``tenants``        — exact tenant ids pinned to the tier. Every policy
  MUST declare a ``default`` tier (the catch-all for unlisted tenants;
  it must not pin tenants itself) — an implicit default would silently
  unmeter unknown tenants, the opposite of what quotas are for.

Tier names are a closed, small vocabulary by construction, so the
``tier`` label they put on ``fleet_admission_total`` and the lifecycle
SLI histograms stays inside the existing cardinality bound.

The port's copy of ``autoscaler_tpu/fleet/tiers.py``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

# the mandatory catch-all tier name
DEFAULT_TIER = "default"


class TierError(ValueError):
    """A tier table that doesn't describe a usable policy."""


@dataclass(frozen=True)
class TierSpec:
    """One tier's typed admission budget (see module docstring)."""

    name: str
    qps: float = 0.0
    burst: float = 0.0
    queue_share: float = 1.0
    default_deadline_s: float = 0.0
    shed_priority: int = 0
    tenants: Tuple[str, ...] = ()

    def __post_init__(self):
        if not self.name:
            raise TierError("tier name must be non-empty")
        if self.qps < 0:
            raise TierError(f"tier {self.name!r} qps must be >= 0")
        if self.burst < 0:
            raise TierError(f"tier {self.name!r} burst must be >= 0")
        if not 0.0 < self.queue_share <= 1.0:
            raise TierError(
                f"tier {self.name!r} queue_share must be in (0, 1], got "
                f"{self.queue_share}"
            )
        if self.default_deadline_s < 0:
            raise TierError(
                f"tier {self.name!r} default_deadline_s must be >= 0"
            )
        if self.shed_priority < 0:
            raise TierError(
                f"tier {self.name!r} shed_priority must be >= 0"
            )


class TierPolicy:
    """The resolved tier table: name → spec, tenant → tier."""

    def __init__(self, tiers: Sequence[TierSpec]) -> None:
        names = [t.name for t in tiers]
        if len(set(names)) != len(names):
            raise TierError(f"duplicate tier names in {sorted(names)}")
        self.by_name: Dict[str, TierSpec] = {t.name: t for t in tiers}
        if DEFAULT_TIER not in self.by_name:
            raise TierError(
                "tier policy must declare a 'default' tier (the catch-all "
                "for unlisted tenants — an implicit default would silently "
                "unmeter unknown tenants)"
            )
        if self.by_name[DEFAULT_TIER].tenants:
            raise TierError(
                "the 'default' tier must not pin tenants — it is the "
                "catch-all"
            )
        self.default = self.by_name[DEFAULT_TIER]
        self._tenant_tier: Dict[str, TierSpec] = {}
        for t in tiers:
            for tenant in t.tenants:
                if tenant in self._tenant_tier:
                    raise TierError(
                        f"tenant {tenant!r} pinned to both "
                        f"{self._tenant_tier[tenant].name!r} and {t.name!r}"
                    )
                self._tenant_tier[tenant] = t

    def tier_for(self, tenant_id: str) -> TierSpec:
        return self._tenant_tier.get(tenant_id, self.default)

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.by_name))


# the JSON keys a tier entry may carry (anything else is a typo — fail
# loudly, the flag configures production shedding behavior)
_TIER_FIELDS = (
    "qps", "burst", "queue_share", "default_deadline_s", "shed_priority",
    "tenants",
)


def parse_tiers(text: str) -> Optional[TierPolicy]:
    """``--fleet-tenant-tiers`` JSON → :class:`TierPolicy` (None when the
    flag is empty — tiers off, the global per-tenant quota stands)."""
    if not text or not text.strip():
        return None
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise TierError(f"tenant tiers are not valid JSON: {e}") from None
    if not isinstance(doc, dict) or not doc:
        raise TierError(
            "tenant tiers must be a non-empty JSON object of "
            "{tier name: spec}"
        )
    tiers = []
    for name in sorted(doc):
        entry = doc[name]
        if not isinstance(entry, dict):
            raise TierError(f"tier {name!r} spec must be an object")
        unknown = set(entry) - set(_TIER_FIELDS)
        if unknown:
            raise TierError(
                f"tier {name!r} has unknown fields {sorted(unknown)} "
                f"(known: {list(_TIER_FIELDS)})"
            )
        tenants = entry.get("tenants", [])
        if not isinstance(tenants, list) or not all(
            isinstance(t, str) and t for t in tenants
        ):
            raise TierError(
                f"tier {name!r} tenants must be a list of tenant ids"
            )
        try:
            tiers.append(TierSpec(
                name=name,
                qps=float(entry.get("qps", 0.0)),
                burst=float(entry.get("burst", 0.0)),
                queue_share=float(entry.get("queue_share", 1.0)),
                default_deadline_s=float(entry.get("default_deadline_s", 0.0)),
                shed_priority=int(entry.get("shed_priority", 0)),
                tenants=tuple(tenants),
            ))
        except (TypeError, ValueError) as e:
            if isinstance(e, TierError):
                raise
            raise TierError(f"tier {name!r}: {e}") from None
    return TierPolicy(tiers)
