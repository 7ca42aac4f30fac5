"""graftlint — AST invariant checker for the autoscaler's contracts.

Dependency-free (stdlib ``ast``/``tokenize`` only). The engine parses each
file once and dispatches to every rule; findings are suppressed inline with
``# graftlint: disable=RULE — reason`` or grandfathered in
``autoscaler_tpu_torch/analysis/lint-baseline.json`` (absent: the port's tree
scans clean without one, and ``tests/test_torch_analysis_tree.py`` holds it
there).

See ``RULES.md`` (this directory) for the rule catalog and etiquette.
"""
from autoscaler_tpu_torch.analysis.engine import (
    Finding,
    ScanStats,
    analyze_paths,
    analyze_sources,
    check_source,
    scan_file,
    scan_paths,
)
from autoscaler_tpu_torch.analysis.rules import (
    ALL_PROGRAM_RULES,
    ALL_RULES,
    RULE_CATALOG,
)

__all__ = [
    "ALL_PROGRAM_RULES",
    "ALL_RULES",
    "DeterminismSanitizer",
    "Finding",
    "LintCache",
    "RULE_CATALOG",
    "ScanStats",
    "analyze_paths",
    "analyze_sources",
    "check_source",
    "scan_file",
    "scan_paths",
    "source_sites",
]


def __getattr__(name):
    # lazy: the sanitizer patches stdlib modules on install and the cache
    # hashes the package sources on construction — neither belongs in the
    # import path of a plain scan
    if name == "DeterminismSanitizer":
        from autoscaler_tpu_torch.analysis.sanitizer import DeterminismSanitizer

        return DeterminismSanitizer
    if name == "LintCache":
        from autoscaler_tpu_torch.analysis.cache import LintCache

        return LintCache
    if name == "source_sites":
        from autoscaler_tpu_torch.analysis.dataflow import source_sites

        return source_sites
    raise AttributeError(name)
