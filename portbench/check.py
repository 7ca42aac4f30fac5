"""What decides ``correct``: the answers the timed path returned against
the plain reference's on the same worlds.

An answer is every group's node count and every pod's verdict in every
group, so the comparison is exact: ``answers_off`` counts the entries of
the answers checked that differ from the reference's (groups whose node
count differs, plus (group, pod) verdicts that differ), limit 0. The two
parts are kept apart for the log.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

LIMITS = {"answers_off": 0}


def compare(pairs: Iterable[Tuple[tuple, object]]) -> Dict[str, int]:
    """``pairs``: (answer, reference) with answer = (node counts [G],
    scheduled [G, P]) and reference a ``reference.*.Answer``."""
    groups = verdicts = 0
    for (counts, scheduled), ref in pairs:
        groups += int(np.count_nonzero(np.asarray(counts) != ref.node_count))
        verdicts += int(np.count_nonzero(np.asarray(scheduled) != ref.scheduled))
    return {"groups_off": groups, "verdicts_off": verdicts, "answers_off": groups + verdicts}


def judged(numbers: Dict[str, int]) -> Dict[str, dict]:
    return {name: {"value": numbers[name], "limit": limit} for name, limit in LIMITS.items()}


def passes(numbers: Dict[str, int]) -> bool:
    return all(numbers[name] <= limit for name, limit in LIMITS.items())
