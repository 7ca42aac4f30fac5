"""graftlint CLI.

Usage::

    python -m autoscaler_tpu_torch.analysis [paths...]
        [--baseline FILE] [--no-baseline] [--update-baseline] [--list-rules]
        [--explain RULE] [--format {text,json,github,sarif}] [--jobs N]

Default paths: ``autoscaler_tpu_torch`` under the current directory. The baseline
defaults to ``autoscaler_tpu_torch/analysis/lint-baseline.json`` discovered by
walking up from the current directory; it never reads or writes the JAX
package's ``hack/`` (``--no-baseline`` disables, ``--baseline`` overrides).

Output formats: ``text`` (findings to stdout, per-rule summary table to
stderr), ``json`` (one machine-readable document on stdout — byte-stable
across runs, the tree test diffs three consecutive runs), ``github``
(workflow-annotation ``::error``/``::warning`` lines; findings carrying a
witness path — GL016 leak paths, taint flows — get one ``::notice`` per
step so the annotated PR shows the whole walk), ``sarif`` (SARIF 2.1.0
with witness paths as codeFlows — see ``sarif.py``).

``--explain RULE`` prints the rule's full RULES.md section (the same
document SARIF rule metadata is assembled from) and exits — the
from-the-terminal answer to "what is GL016 and why did it fire".

``--jobs N`` fans the per-file rules out over N worker processes
(whole-program passes stay in the parent); output is byte-identical to a
serial run.

Exit status: 0 clean; 1 findings or stale baseline entries; 2 usage error
OR internal analyzer error (a crash in the analyzer itself must be
distinguishable from "the tree has findings" — CI treats 1 as a ratchet
failure and 2 as a broken gate).
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path
from typing import Dict, List, Optional

from autoscaler_tpu_torch.analysis import baseline as baseline_mod
from autoscaler_tpu_torch.analysis.engine import (
    Finding,
    ScanStats,
    analyze_sources,
    display_path,
    iter_python_files,
    package_scan_complete,
)
from autoscaler_tpu_torch.analysis.rules import RULE_CATALOG

BASELINE_RELPATH = Path("autoscaler_tpu_torch") / "analysis" / "lint-baseline.json"

JSON_VERSION = 1


def scan_scope(paths: List[str], files: List[str]):
    """→ predicate over baseline display paths: is this entry inside what
    THIS run scanned? Directory arguments contribute a subtree prefix (so
    an entry for a since-DELETED file under a scanned directory still
    counts as in scope and is correctly reported stale); file arguments
    contribute themselves. Entries outside the scope are neither judged
    stale nor struck by --update-baseline."""
    scanned_files = {display_path(f) for f in files}
    prefixes = [
        # display_path needs a file-shaped path: derive the directory's
        # display prefix from a probe filename inside it
        display_path((Path(p) / "_.py").as_posix())[: -len("_.py")]
        for p in paths
        if Path(p).is_dir()
    ]

    def in_scope(display: str) -> bool:
        return display in scanned_files or any(
            display.startswith(pre) for pre in prefixes
        )

    return in_scope


def discover_baseline(start: Optional[Path] = None) -> Optional[Path]:
    here = (start or Path.cwd()).resolve()
    for candidate in (here, *here.parents):
        p = candidate / BASELINE_RELPATH
        if p.is_file():
            return p
    return None


def _rule_summary(
    stats: ScanStats, new: List[Finding]
) -> Dict[str, Dict[str, int]]:
    """Per-rule {findings, suppressed, baselined} rows, every catalog rule
    present (stable table shape) plus GL000 and any unknown rule seen."""
    new_by_rule: Dict[str, int] = {}
    for f in new:
        new_by_rule[f.rule] = new_by_rule.get(f.rule, 0) + 1
    # ScanStats.note counted every kept finding, so the per-rule totals
    # are already in findings_by_rule — baselined = total - new
    total_by_rule = stats.findings_by_rule
    rules = sorted(
        {"GL000", *RULE_CATALOG, *stats.findings_by_rule, *stats.suppressed_by_rule}
    )
    return {
        rule: {
            "findings": new_by_rule.get(rule, 0),
            "suppressed": stats.suppressed_by_rule.get(rule, 0),
            "baselined": total_by_rule.get(rule, 0) - new_by_rule.get(rule, 0),
        }
        for rule in rules
    }


def _print_summary_table(summary: Dict[str, Dict[str, int]], stale: int) -> None:
    """The CI-log drift table: one look shows which rule is ratcheting."""
    print("rule   findings  suppressed  baselined", file=sys.stderr)
    for rule, row in summary.items():
        print(
            f"{rule:<6} {row['findings']:>8}  {row['suppressed']:>10}  "
            f"{row['baselined']:>9}",
            file=sys.stderr,
        )
    if stale:
        print(f"stale baseline entries: {stale}", file=sys.stderr)


def _emit_json(doc: dict) -> None:
    """Byte-stable document: sorted keys, pre-sorted arrays, one trailing
    newline — two runs over the same tree must diff empty."""
    sys.stdout.write(
        json.dumps(doc, sort_keys=True, indent=2, ensure_ascii=False) + "\n"
    )


def _emit_github(new: List[Finding], stale: List[str]) -> None:
    for f in new:
        print(
            f"::error file={f.path},line={f.line},title=graftlint {f.rule}"
            f"::{f.message}"
        )
        # witness walk (GL016 leak paths, GL010/13 taint flows): one
        # ::notice per step, so the annotated PR shows the whole path
        # from acquire to the exit that leaks it, not just the endpoint
        for step, (path, line, note) in enumerate(f.flow, 1):
            print(
                f"::notice file={path},line={line},"
                f"title=graftlint {f.rule} path {step}/{len(f.flow)}"
                f"::{note}"
            )
    for s in stale:
        print(f"::warning title=graftlint stale baseline::{s}")


def _explain(rule_id: str) -> int:
    """Print RULE's full RULES.md section (heading to next ``## `` or
    EOF). Exit 0 on success, 2 when the rule has no section — a typo'd id
    must not silently print nothing and read as documented."""
    md = Path(__file__).resolve().parent / "RULES.md"
    try:
        lines = md.read_text(encoding="utf-8").splitlines()
    except OSError as e:
        print(f"graftlint: cannot read {md}: {e}", file=sys.stderr)
        return 2
    want = rule_id.upper()
    out: List[str] = []
    in_section = False
    for line in lines:
        if line.startswith("## "):
            if in_section:
                break
            in_section = line.startswith(f"## {want} ")
        if in_section:
            out.append(line)
    if not out:
        known = ", ".join(sorted(RULE_CATALOG))
        print(
            f"graftlint: no RULES.md section for {rule_id!r} "
            f"(known rules: {known})",
            file=sys.stderr,
        )
        return 2
    while out and not out[-1].strip():
        out.pop()
    print("\n".join(out))
    return 0


def _run(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="graftlint",
        description=(
            "AST invariant checker: determinism (GL001), span taxonomy "
            "(GL002), ladder bypass (GL003), lock discipline (GL004), "
            "error boundaries (GL005), capture purity (GL006), kernel "
            "shape/tiling contracts (GL007), lock ordering (GL008), "
            "flag wiring (GL009), taint-flow determinism (GL010), "
            "thread escape (GL011), surface gating (GL012), "
            "interprocedural determinism taint (GL013), host-sync leaks "
            "(GL014), recompile hazards (GL015), obligation typestate "
            "(GL016), ledger-schema drift (GL017). "
            "See autoscaler_tpu_torch/analysis/RULES.md."
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="files or directories to scan (default: ./autoscaler_tpu_torch)",
    )
    parser.add_argument(
        "--baseline",
        metavar="FILE",
        help="baseline JSON (default: nearest "
        "autoscaler_tpu_torch/analysis/lint-baseline.json)",
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="report every finding, ignoring any baseline",
    )
    parser.add_argument(
        "--update-baseline",
        action="store_true",
        help="rewrite the baseline from the current findings and exit 0",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    parser.add_argument(
        "--explain",
        metavar="RULE",
        help="print RULE's full RULES.md section and exit",
    )
    parser.add_argument(
        "--format",
        choices=("text", "json", "github", "sarif"),
        default="text",
        help="output format (json and sarif are byte-stable across "
        "identical runs; sarif carries taint paths as codeFlows)",
    )
    parser.add_argument(
        "--jobs",
        type=int,
        default=1,
        metavar="N",
        help="fan per-file rules out over N worker processes (output is "
        "byte-identical to a serial run; whole-program passes stay serial)",
    )
    parser.add_argument(
        "--cache",
        action="store_true",
        help="use the incremental finding cache (.graftlint-cache/): "
        "per-file findings keyed by content hash, whole-program findings "
        "keyed by the tree hash; findings are byte-identical with and "
        "without it (the tree test diffs both)",
    )
    parser.add_argument(
        "--cache-dir",
        metavar="DIR",
        default=".graftlint-cache",
        help="cache directory for --cache (default: ./.graftlint-cache)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule_id, title in sorted(RULE_CATALOG.items()):
            print(f"{rule_id}  {title}")
        return 0

    if args.explain:
        return _explain(args.explain)

    if args.no_baseline and args.update_baseline:
        print(
            "graftlint: --no-baseline and --update-baseline are "
            "contradictory (ignore the ledger vs rewrite it)",
            file=sys.stderr,
        )
        return 2

    paths = args.paths or ["autoscaler_tpu_torch"]
    missing = [p for p in paths if not Path(p).exists()]
    if missing:
        print(f"graftlint: no such path: {', '.join(missing)}", file=sys.stderr)
        return 2
    files = iter_python_files(paths)
    if not files:
        print("graftlint: no python files under given paths", file=sys.stderr)
        return 2
    # one read per file: `files` is already walked for the empty-check, so
    # feed the sources straight to the scan pipeline instead of re-walking
    sources = {f: Path(f).read_text(encoding="utf-8") for f in files}
    cache = None
    if args.cache:
        from autoscaler_tpu_torch.analysis.cache import LintCache

        cache = LintCache(args.cache_dir)
    if args.jobs < 1:
        print("graftlint: --jobs must be >= 1", file=sys.stderr)
        return 2
    findings, stats = analyze_sources(
        sources,
        scan_complete=package_scan_complete(files),
        cache=cache,
        jobs=args.jobs,
    )

    baseline_path: Optional[Path] = None
    if not args.no_baseline:
        if args.baseline:
            baseline_path = Path(args.baseline)
            if not args.update_baseline and not baseline_path.is_file():
                # a typo'd --baseline must not silently degrade to "no
                # baseline" and report every grandfathered finding as new
                print(
                    f"graftlint: baseline file not found: {baseline_path}",
                    file=sys.stderr,
                )
                return 2
        else:
            baseline_path = discover_baseline()

    if args.update_baseline:
        if baseline_path is None:
            baseline_path = Path.cwd() / BASELINE_RELPATH
        baseline_path.parent.mkdir(parents=True, exist_ok=True)
        preserve = {}
        if baseline_path.is_file():
            in_scope = scan_scope(paths, files)
            preserve = {
                fp: c
                for fp, c in baseline_mod.load(str(baseline_path)).items()
                if not in_scope(fp[0])
            }
        entries = baseline_mod.save(str(baseline_path), findings, preserve)
        print(
            f"graftlint: baseline rewritten: {entries} entr"
            f"{'y' if entries == 1 else 'ies'} "
            f"({len(findings)} finding(s)) -> {baseline_path}",
            file=sys.stderr,
        )
        return 0

    baselined = {}
    if baseline_path is not None and baseline_path.is_file():
        baselined = baseline_mod.load(str(baseline_path))
        # staleness is only judged inside this run's scan scope: a partial
        # scan (one file, one subtree) must not read the unscanned
        # remainder of the ledger as "findings that no longer exist" —
        # but an entry for a deleted file UNDER a scanned directory is in
        # scope and correctly reads as stale
        in_scope = scan_scope(paths, files)
        baselined = {fp: c for fp, c in baselined.items() if in_scope(fp[0])}
    new, stale = baseline_mod.diff(findings, baselined)
    summary = _rule_summary(stats, new)

    if args.format == "json":
        _emit_json(
            {
                "version": JSON_VERSION,
                "files": len(files),
                "findings": [
                    {
                        "path": f.path,
                        "line": f.line,
                        "rule": f.rule,
                        "message": f.message,
                    }
                    for f in new
                ],
                "stale": stale,
                "summary": summary,
            }
        )
    elif args.format == "sarif":
        from autoscaler_tpu_torch.analysis.sarif import to_sarif

        _emit_json(to_sarif(new, stale))
    elif args.format == "github":
        _emit_github(new, stale)
    else:
        for f in new:
            print(f.render())
        for s in stale:
            print(f"stale baseline entry: {s}")
        _print_summary_table(summary, len(stale))
    grandfathered = len(findings) - len(new)
    status = (
        f"graftlint: {len(files)} file(s), {len(new)} finding(s), "
        f"{grandfathered} baselined, {len(stale)} stale baseline entr"
        f"{'y' if len(stale) == 1 else 'ies'}"
    )
    print(status, file=sys.stderr)
    return 1 if new or stale else 0


def main(argv: Optional[List[str]] = None) -> int:
    """Exit-code contract wrapper: findings are 1, a crash in the analyzer
    itself is 2 — CI must be able to tell a failed ratchet from a broken
    gate."""
    try:
        return _run(argv)
    except Exception:  # noqa: BLE001 — the boundary IS the contract here
        print("graftlint: internal analyzer error:", file=sys.stderr)
        traceback.print_exc()
        return 2


if __name__ == "__main__":
    sys.exit(main())
