"""SARIF 2.1.0 emission for graftlint (``--format sarif``).

SARIF is the one static-analysis interchange format code review UIs
actually ingest (GitHub code scanning, VS Code SARIF viewer), and it has
first-class support for the thing graftlint v2 produces that plain
diagnostics formats cannot carry: *taint witness paths*. Every GL013/GL014
finding's ``Finding.flow`` steps become a SARIF ``codeFlow`` — one
``threadFlow`` whose ordered locations are the source→sink hops, each with
its ``file:line`` region and human note — so a reader clicks through the
exact walk instead of re-deriving it from the message text.

Rule metadata is assembled from two sources that cannot drift apart
accidentally: ``RULE_CATALOG`` (the registered id→title map — a rule that
runs is always listed) and RULES.md (the catalog document; its
``## GLxxx — title`` headings and the prose paragraph under each become
``shortDescription``/``fullDescription``). A rule documented but not
registered, or vice versa, still emits with whatever half is available.

The document is byte-stable: rules sorted by id, results in the engine's
finding order (already sorted), keys sorted by the JSON encoder — two runs
over the same tree diff empty, same contract as ``--format json``.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from autoscaler_tpu_torch.analysis.engine import Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = "https://json.schemastore.org/sarif-2.1.0.json"
TOOL_NAME = "graftlint"

_HEADING_RE = re.compile(r"^##\s+(GL\d{3})\s+—\s+(.+?)\s*$")


def rule_docs(rules_md: str) -> Dict[str, Tuple[str, str]]:
    """``{rule_id: (title, first_paragraph)}`` parsed from RULES.md's
    ``## GLxxx — title`` sections. The first non-empty prose paragraph
    under the heading becomes the full description."""
    out: Dict[str, Tuple[str, str]] = {}
    current: str = ""
    para: List[str] = []
    done: bool = True
    for line in rules_md.splitlines():
        m = _HEADING_RE.match(line)
        if m is not None:
            current = m.group(1)
            out[current] = (m.group(2), "")
            para = []
            done = False
            continue
        if current and not done:
            stripped = line.strip()
            if line.startswith("## "):
                done = True
            elif stripped and not stripped.startswith(("|", "```", "#")):
                para.append(stripped)
            elif para:
                out[current] = (out[current][0], " ".join(para))
                done = True
    if current and para and not done:
        out[current] = (out[current][0], " ".join(para))
    return out


def _load_rule_docs() -> Dict[str, Tuple[str, str]]:
    md = Path(__file__).resolve().parent / "RULES.md"
    try:
        return rule_docs(md.read_text(encoding="utf-8"))
    except OSError:
        return {}


def _location(path: str, line: int, note: str = "") -> dict:
    loc: dict = {
        "physicalLocation": {
            "artifactLocation": {"uri": path, "uriBaseId": "SRCROOT"},
            "region": {"startLine": max(1, int(line))},
        }
    }
    if note:
        loc["message"] = {"text": note}
    return loc


def to_sarif(findings: Sequence[Finding], stale: Sequence[str] = ()) -> dict:
    """One SARIF 2.1.0 document for a scan's NEW findings (the baseline
    diff's output — same population ``--format json`` reports). Stale
    baseline entries become tool-level ``notifications``: they fail the
    gate but have no source location to anchor a result to."""
    from autoscaler_tpu_torch.analysis.rules import RULE_CATALOG

    docs = _load_rule_docs()
    rule_ids = sorted(
        {*RULE_CATALOG, *docs, *(f.rule for f in findings), "GL000"}
    )
    index = {rid: i for i, rid in enumerate(rule_ids)}
    rules = []
    for rid in rule_ids:
        title = RULE_CATALOG.get(rid) or docs.get(rid, ("", ""))[0]
        full = docs.get(rid, ("", ""))[1]
        rule: dict = {"id": rid, "name": rid}
        if title:
            rule["shortDescription"] = {"text": title}
        if full:
            rule["fullDescription"] = {"text": full}
        rules.append(rule)

    results = []
    for f in findings:
        result: dict = {
            "ruleId": f.rule,
            "ruleIndex": index[f.rule],
            "level": "error",
            "message": {"text": f.message},
            "locations": [_location(f.path, f.line)],
        }
        if f.flow:
            result["codeFlows"] = [
                {
                    "threadFlows": [
                        {
                            "locations": [
                                {"location": _location(p, ln, note)}
                                for p, ln, note in f.flow
                            ]
                        }
                    ]
                }
            ]
        results.append(result)

    run: dict = {
        "tool": {
            "driver": {
                "name": TOOL_NAME,
                "informationUri": (
                    "autoscaler_tpu_torch/analysis/RULES.md"
                ),
                "rules": rules,
            }
        },
        "columnKind": "utf16CodeUnits",
        "results": results,
    }
    if stale:
        run["invocations"] = [
            {
                "executionSuccessful": False,
                "toolExecutionNotifications": [
                    {
                        "level": "warning",
                        "message": {"text": f"stale baseline entry: {s}"},
                    }
                    for s in stale
                ],
            }
        ]
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [run],
    }
