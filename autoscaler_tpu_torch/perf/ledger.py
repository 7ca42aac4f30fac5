"""The ledgers' serialization choke point: sorted-key, tight-separator,
strict JSON, one line a record (the SLO ledger serializes through it).

The port's copy of ``stable_json``, ``record_line`` and ``load_jsonl`` from
``autoscaler_tpu/perf/ledger.py``. The perf ledger's schema, validation
and summary come with the perf observatory (ROADMAP queue 1, the
estimator services item).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List


def stable_json(doc: Any) -> str:
    """Byte-stable one-line JSON (sorted keys, tight separators; exotic
    values degrade to str rather than failing the serving handler)."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"), default=str)


def record_line(rec: Dict[str, Any]) -> str:
    """One ledger line (newline-terminated) for one tick record."""
    return stable_json(rec) + "\n"


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    records: List[Dict[str, Any]] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from None
    return records
