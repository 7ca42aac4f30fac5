"""Scenario suite: a named, fixed set of scenarios evaluated together.

A suite is a JSON document ``{"name": ..., "scenarios": [<ScenarioSpec>,
...]}`` — each entry is a full loadgen
scenario (its own seed, workloads, faults), so the suite inherits every
determinism property loadgen already certifies. The policy gym
(``gym/``) scores candidate policies across a suite with
SHARED seeds: every candidate replays the identical worlds, which is
what makes per-candidate scores comparable and the tuning ledger
byte-stable. Lives in loadgen (not gym/) because it is pure scenario
plumbing — gym builds on loadgen, never the reverse.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List

from autoscaler_tpu_torch.loadgen.spec import ScenarioSpec, SpecError


@dataclass
class SuiteSpec:
    name: str
    scenarios: List[ScenarioSpec] = field(default_factory=list)

    def __post_init__(self):
        if not self.scenarios:
            raise SpecError(f"suite {self.name!r} needs at least one scenario")
        names = [s.name for s in self.scenarios]
        if len(set(names)) != len(names):
            raise SpecError(f"duplicate scenario names in suite: {names}")
        fleet = [s.name for s in self.scenarios if s.fleet is not None]
        if fleet:
            raise SpecError(
                f"suite scenarios must drive the control loop, not the "
                f"fleet service: {fleet}"
            )

    def scenario_names(self) -> List[str]:
        return [s.name for s in self.scenarios]

    # -- JSON round-trip -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "scenarios": [s.to_dict() for s in self.scenarios],
        }

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "SuiteSpec":
        if not isinstance(doc, dict) or "scenarios" not in doc:
            raise SpecError(
                "suite document must be an object with a 'scenarios' list"
            )
        unknown = set(doc) - {"name", "scenarios"}
        if unknown:
            raise SpecError(f"unknown suite fields {sorted(unknown)}")
        return cls(
            name=str(doc.get("name", "suite")),
            scenarios=[ScenarioSpec.from_dict(s) for s in doc["scenarios"]],
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def load(cls, path: str) -> "SuiteSpec":
        with open(path) as f:
            doc = json.load(f)
        return cls.from_dict(doc)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


def is_suite_doc(doc: Any) -> bool:
    """True when a parsed JSON document is a suite, not a single scenario
    (loadgen's ``validate`` subcommand dispatches on this)."""
    return isinstance(doc, dict) and "scenarios" in doc
