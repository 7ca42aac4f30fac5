"""Baseline ledger for grandfathered graftlint findings.

``autoscaler_tpu_torch/analysis/lint-baseline.json`` (absent while the
tree scans clean) records findings that predate a rule (or are
accepted debt) as ``(path, rule, message) -> count`` entries — no line
numbers, so pure line drift never churns the file. The gate is a ratchet:

- a finding NOT covered by the baseline fails the run (new debt is barred);
- a baseline entry whose finding count SHRANK is *stale* and also fails
  the run (fixed debt must be struck from the ledger via
  ``--update-baseline``, so the baseline can only shrink and always
  reflects reality).
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.analysis.engine import Finding

Fingerprint = Tuple[str, str, str]  # (path, rule, message)

BASELINE_VERSION = 1


def load(path: str) -> Dict[Fingerprint, int]:
    doc = json.loads(Path(path).read_text(encoding="utf-8"))
    out: Dict[Fingerprint, int] = {}
    for entry in doc.get("findings", []):
        fp = (entry["path"], entry["rule"], entry["message"])
        out[fp] = out.get(fp, 0) + int(entry.get("count", 1))
    return out


def save(
    path: str,
    findings: Sequence[Finding],
    preserve: Optional[Dict[Fingerprint, int]] = None,
) -> int:
    """Write the current findings as the new baseline. ``preserve`` carries
    entries for files the producing scan did NOT visit (a partial-scan
    --update-baseline must not silently strike the unscanned remainder of
    the ledger). Returns the entry count. Deterministic ordering — the
    file diffs cleanly in review."""
    counts: Counter = Counter(preserve or {})
    counts.update(f.fingerprint for f in findings)
    doc = {
        "version": BASELINE_VERSION,
        "comment": (
            "Grandfathered graftlint findings (python -m "
            "autoscaler_tpu_torch.analysis --update-baseline). Entries may only "
            "disappear: fixing a finding without striking it here fails "
            "the gate as stale."
        ),
        "findings": [
            {"path": p, "rule": r, "message": m, "count": c}
            for (p, r, m), c in sorted(counts.items())
        ],
    }
    Path(path).write_text(
        json.dumps(doc, indent=2, sort_keys=False) + "\n", encoding="utf-8"
    )
    return len(counts)


def diff(
    findings: Sequence[Finding], baseline: Dict[Fingerprint, int]
) -> Tuple[List[Finding], List[str]]:
    """→ (new_findings, stale_descriptions).

    Per fingerprint: ``current > baselined`` surfaces the excess findings
    (highest line numbers first dropped into "new" — the oldest occurrences
    stay grandfathered); ``current < baselined`` marks the entry stale.
    """
    by_fp: Dict[Fingerprint, List[Finding]] = {}
    for f in findings:
        by_fp.setdefault(f.fingerprint, []).append(f)
    new: List[Finding] = []
    for fp, group in by_fp.items():
        allowed = baseline.get(fp, 0)
        if len(group) > allowed:
            group = sorted(group, key=Finding.sort_key)
            new.extend(group[allowed:])
    stale: List[str] = []
    for fp, allowed in sorted(baseline.items()):
        current = len(by_fp.get(fp, ()))
        if current < allowed:
            path, rule, message = fp
            stale.append(
                f"{path}: {rule} baselined x{allowed} but found x{current} "
                f"— run --update-baseline to strike it ({message})"
            )
    return sorted(new, key=Finding.sort_key), stale
