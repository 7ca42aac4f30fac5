"""Incremental finding cache for graftlint (opt-in ``--cache``).

The lint is now three passes — per-file rules, the whole-program call
graph (GL006–GL009), and the dataflow/escape pass (GL010–GL012) — and
``tests/test_torch_analysis_tree.py`` runs it three times back-to-back (text gate + two JSON
determinism runs). The cache keeps that wall time flat: per-file rule
findings are keyed by the file's content hash, and the whole-program
finding set is keyed by the hash of the *entire scanned tree*, so an
unchanged tree re-lints without a single ``ast.parse`` and a one-file
edit re-runs only that file's rules plus the (irreducibly whole-program)
cross-file passes.

Correctness properties, by construction:

- **Byte-identical output.** The cache stores *raw* findings (pre-
  suppression, pre-baseline); every downstream step (pragma suppression,
  sorting, baseline diff, JSON rendering) runs identically on cached and
  fresh findings. the tree test runs the scan with and without
  ``--cache`` and diffs the JSON documents.
- **Self-invalidating.** Every key is salted with a digest of the
  analysis package's own sources: editing any rule, the engine, or this
  file flushes the whole cache — stale-rule findings cannot survive an
  analyzer change, and no manual version bump can be forgotten.
- **Scoped to the default rule set.** The engine bypasses the cache
  whenever an explicit ``rules``/``program_rules`` subset is passed
  (fixture tests, partial scans with custom rule lists); only the one
  canonical full-rule scan populates or reads entries.

Layout: one JSON file per key under ``.graftlint-cache/`` (CLI
``--cache-dir`` overrides), content-addressed so concurrent runs can only
ever write identical bytes — a torn/corrupt entry is treated as a miss.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.analysis.engine import ENGINE_VERSION, Finding

_SCHEMA = 2  # v2: findings carry an optional flow (taint witness steps)


def _analysis_salt() -> str:
    """Digest of the analysis package's own sources PLUS the explicit
    engine version and the registered rule table (ids + titles): any
    analyzer edit, engine version bump, or rule addition/removal/retitle
    invalidates every entry — no manual flush can be forgotten."""
    h = hashlib.sha256()
    h.update(f"graftlint-cache/{_SCHEMA}/engine/{ENGINE_VERSION}".encode())
    pkg = Path(__file__).resolve().parent
    for f in sorted(pkg.glob("*.py")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    from autoscaler_tpu_torch.analysis.rules import RULE_CATALOG

    for rule_id in sorted(RULE_CATALOG):
        h.update(f"{rule_id}\0{RULE_CATALOG[rule_id]}\0".encode())
    return h.hexdigest()


class LintCache:
    """Content-addressed finding store. All methods tolerate a missing or
    corrupt backing directory — a cache problem degrades to a miss, never
    to a wrong result."""

    def __init__(self, root: str = ".graftlint-cache"):
        self.root = Path(root)
        self.salt = _analysis_salt()
        # one generation directory per analyzer salt: an analyzer edit
        # makes every old entry unreachable, so stale generations are
        # pruned rather than accreting forever
        self._dir = self.root / self.salt[:16]
        self._pruned = False

    def _prune_stale_generations(self) -> None:
        if self._pruned:
            return
        self._pruned = True
        try:
            for child in self.root.iterdir():
                if child.is_dir() and child.name != self._dir.name:
                    import shutil

                    shutil.rmtree(child, ignore_errors=True)
        except OSError:
            pass

    # -- keys -----------------------------------------------------------------

    def file_key(self, display: str, source: str) -> str:
        h = hashlib.sha256()
        h.update(self.salt.encode())
        h.update(b"file\0")
        h.update(display.encode())
        h.update(b"\0")
        h.update(source.encode())
        return h.hexdigest()

    def program_key(
        self, entries: Sequence[Tuple[str, str]], scan_complete: bool
    ) -> str:
        """Key over the whole scanned tree: (display path, file key)
        pairs plus the scan-completeness bit (GL009 silences itself on
        partial scans — the finding set legitimately differs)."""
        h = hashlib.sha256()
        h.update(self.salt.encode())
        h.update(b"program\0")
        h.update(b"complete" if scan_complete else b"partial")
        for display, fkey in sorted(entries):
            h.update(display.encode())
            h.update(b"\0")
            h.update(fkey.encode())
            h.update(b"\0")
        return h.hexdigest()

    # -- storage --------------------------------------------------------------

    def _path(self, key: str) -> Path:
        return self._dir / f"{key}.json"

    def get(self, key: str) -> Optional[List[Finding]]:
        p = self._path(key)
        try:
            doc = json.loads(p.read_text(encoding="utf-8"))
            return [
                Finding(
                    path=e["path"], line=int(e["line"]),
                    rule=e["rule"], message=e["message"],
                    flow=tuple(
                        (s[0], int(s[1]), s[2]) for s in e.get("flow", ())
                    ),
                )
                for e in doc["findings"]
            ]
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def put(self, key: str, findings: Sequence[Finding]) -> None:
        try:
            self._dir.mkdir(parents=True, exist_ok=True)
            self._prune_stale_generations()
            doc = {
                "findings": [
                    {
                        "path": f.path, "line": f.line,
                        "rule": f.rule, "message": f.message,
                        **({"flow": [list(s) for s in f.flow]} if f.flow else {}),
                    }
                    for f in findings
                ]
            }
            tmp = self._path(key).with_suffix(".tmp")
            tmp.write_text(
                json.dumps(doc, sort_keys=True) + "\n", encoding="utf-8"
            )
            tmp.replace(self._path(key))
        except OSError:
            pass  # a read-only tree degrades to an uncached run
