"""graftlint engine: one parse per file, many checkers.

The autoscaler's headline guarantees are *invariants*, not behaviors a unit
test can pin: byte-identical scenario replay requires every time/randomness
source in the run_once path to flow through an injected seam; "traces and
metrics cannot disagree" requires every span name to be a FunctionLabel;
the degradation ladder only protects the loop if nothing dispatches a
kernel around it. One careless ``time.time()`` silently voids those
contracts until a flaky CI diff catches it. This package polices them
mechanically, at the AST level, with zero third-party dependencies.

Architecture:

- :class:`FileModel` is built ONCE per file (one ``ast.parse``, one
  ``tokenize`` pass for suppression pragmas, one import-alias map) and
  handed to every rule — single parse, many checkers.
- Per-file rules live in :mod:`autoscaler_tpu_torch.analysis.rules`; each is a
  small class with a ``check(model) -> list[Finding]`` method. Rules scope
  themselves to module subsets via :meth:`FileModel.in_module` (paths
  relative to the ``autoscaler_tpu_torch`` package root).
- Whole-program rules (``check_program(graph) -> list[Finding]``) run
  after every file is parsed, over the cross-module call graph
  (:mod:`autoscaler_tpu_torch.analysis.callgraph`) built from the same models —
  capture purity's true transitive reach (GL006), kernel contracts (GL007),
  lock ordering (GL008), flag wiring (GL009).
- Findings are suppressed inline with
  ``# graftlint: disable=RULE[,RULE] — reason`` on the offending line or
  on a comment-only line directly above it. A pragma without a reason is
  itself a finding (GL000) — suppressions are part of the audit surface.
- Grandfathered findings live in a checked-in baseline
  (``autoscaler_tpu_torch/analysis/lint-baseline.json``, see :mod:`autoscaler_tpu_torch.analysis.baseline`);
  the CLI exits nonzero on any non-baselined finding AND on stale baseline
  entries, so the debt ledger can only shrink.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

PACKAGE_DIR_NAME = "autoscaler_tpu_torch"

# Bumped whenever finding semantics or the cached-finding schema change in a
# way the source digest alone would not capture (the cache salts its keys
# with BOTH this and a digest of the analysis sources + rule table).
ENGINE_VERSION = 3

# `# graftlint: disable=GL001,GL004 — reason` (reason separator: any dash
# family or a colon; the reason itself is mandatory — enforced as GL000)
PRAGMA_RE = re.compile(
    r"graftlint:\s*disable=([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
    r"(?:\s*(?:[—–:-]|--)\s*(?P<reason>\S.*))?"
)


def terminal_name(func: ast.AST) -> Optional[str]:
    """Last segment of a call target: ``a.b.c(...)`` → ``c``, ``f(...)`` → ``f``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def self_attr(node: ast.AST) -> Optional[str]:
    """``self._x`` → ``_x`` (the attribute written), unwrapping subscripts:
    ``self._items[k] = v`` writes through ``_items``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def is_lock_attr(name: str) -> bool:
    return name.startswith("_") and name.endswith("lock")


# one hop of a taint witness path: (display path, line, human note).
# Interprocedural rules (GL013) attach these so machine formats (SARIF
# codeFlows) can render the full source→sink walk; text output folds the
# same steps into the message.
FlowStep = Tuple[str, int, str]


@dataclass(frozen=True)
class Finding:
    """One rule violation. ``fingerprint`` (path, rule, message — no line
    number) keys the baseline, so mere line drift doesn't churn it;
    ``flow`` is presentation-only and deliberately excluded."""

    path: str
    line: int
    rule: str
    message: str
    flow: Tuple[FlowStep, ...] = ()

    @property
    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.path, self.rule, self.message)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def sort_key(self) -> Tuple[str, int, str, str]:
        return (self.path, self.line, self.rule, self.message)


def display_path(path: str) -> str:
    """Normalize a filesystem path to the stable form findings report:
    ``autoscaler_tpu_torch/<...>`` when the file sits under an ``autoscaler_tpu_torch``
    directory (invocation-directory independent — the baseline relies on
    this), the given path (posixified) otherwise."""
    parts = Path(path).as_posix().split("/")
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == PACKAGE_DIR_NAME and i < len(parts) - 1:
            return "/".join(parts[i:])
    return Path(path).as_posix()


def module_path(path: str) -> Optional[str]:
    """Path relative to the ``autoscaler_tpu_torch`` package root (``core/x.py``),
    or None for files outside the package. Rules scope on this."""
    disp = display_path(path)
    prefix = PACKAGE_DIR_NAME + "/"
    return disp[len(prefix):] if disp.startswith(prefix) else None


def _import_map(tree: ast.AST) -> Dict[str, str]:
    """local name -> fully qualified dotted origin, e.g.
    ``{"np": "numpy", "mono": "time.monotonic", "trace": "autoscaler_tpu_torch.trace"}``.
    Used to resolve call chains regardless of aliasing."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    out[alias.asname] = alias.name
                else:
                    head = alias.name.split(".")[0]
                    out[head] = head
        elif isinstance(node, ast.ImportFrom):
            base = ("." * node.level) + (node.module or "")
            for alias in node.names:
                local = alias.asname or alias.name
                out[local] = f"{base}.{alias.name}" if base else alias.name
    return out


class FileModel:
    """Everything the rules need about one file, computed once."""

    def __init__(self, path: str, source: str):
        self.path = display_path(path)
        self.module = module_path(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self.imports = _import_map(self.tree)

    def in_module(self, *prefixes: str) -> bool:
        """Is this file inside any of the given package-relative scopes?
        A prefix ending in ``/`` matches a directory subtree; otherwise an
        exact module file."""
        if self.module is None:
            return False
        return any(
            self.module.startswith(p) if p.endswith("/") else self.module == p
            for p in prefixes
        )

    def dotted(self, node: ast.AST, resolve: bool = True) -> Optional[str]:
        """Dotted name of a Name/Attribute chain; with ``resolve`` the
        leading segment is mapped through this file's imports
        (``np.random.default_rng`` → ``numpy.random.default_rng``). None
        for non-name expressions (calls on call results, subscripts, …)."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        if resolve:
            parts[0] = self.imports.get(parts[0], parts[0])
        return ".".join(parts)

    def qualname(self, node: ast.AST) -> Optional[str]:
        return self.dotted(node, resolve=True)

    def is_imported(self, node: ast.AST) -> bool:
        """True when the chain's head name was bound by an import in this
        file — distinguishes the module ``time`` from a local/parameter
        that happens to be named ``time`` (the injected-seam shape)."""
        head = self.dotted(node, resolve=False)
        return head is not None and head.split(".")[0] in self.imports

    def finding(
        self,
        node: ast.AST,
        rule: str,
        message: str,
        flow: Sequence[FlowStep] = (),
    ) -> Finding:
        return Finding(
            path=self.path,
            line=getattr(node, "lineno", 1),
            rule=rule,
            message=message,
            flow=tuple(flow),
        )


def parse_pragmas(
    source: str, path: str
) -> Tuple[Dict[int, Set[str]], List[Finding]]:
    """Scan COMMENT tokens (never string literals) for suppression pragmas.
    Returns {line: {rules}} plus GL000 findings for pragmas missing the
    mandatory reason."""
    pragmas: Dict[int, Set[str]] = {}
    findings: List[Finding] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [
            (tok.start[0], tok.string)
            for tok in tokens
            if tok.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, IndentationError):
        return pragmas, findings
    for line, text in comments:
        m = PRAGMA_RE.search(text)
        if m is None:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        pragmas.setdefault(line, set()).update(rules)
        if not m.group("reason"):
            findings.append(
                Finding(
                    path=display_path(path),
                    line=line,
                    rule="GL000",
                    message=(
                        "suppression pragma missing its reason "
                        "(`# graftlint: disable=RULE — why this is safe`)"
                    ),
                )
            )
    return pragmas, findings


def suppressed_at(
    line: int,
    rules: Set[str],
    pragmas: Dict[int, Set[str]],
    lines: List[str],
) -> bool:
    """THE pragma-application semantics — one implementation shared by the
    engine's finding suppression, GL010's source declassification
    (dataflow.py), and the runtime sanitizer: any of ``rules`` present on
    the line itself, or on a COMMENT-ONLY line directly above (for
    statements too long to carry an inline comment; a pragma trailing
    unrelated code must not leak downward)."""
    same = pragmas.get(line)
    if same and same & rules:
        return True
    above = pragmas.get(line - 1)
    if above and above & rules:
        idx = line - 2  # 0-based index of the pragma line
        if 0 <= idx < len(lines) and lines[idx].lstrip().startswith("#"):
            return True
    return False


def _suppressed(
    finding: Finding, pragmas: Dict[int, Set[str]], lines: List[str]
) -> bool:
    return suppressed_at(finding.line, {finding.rule}, pragmas, lines)


@dataclass
class ScanStats:
    """Per-rule accounting for the CI summary table: how many findings each
    rule RAISED (pre-baseline), and how many were pragma-suppressed. The
    baselined split is layered on by the CLI (it owns the ledger)."""

    files: int = 0
    findings_by_rule: Dict[str, int] = field(default_factory=dict)
    suppressed_by_rule: Dict[str, int] = field(default_factory=dict)

    def note(self, rule: str, suppressed: bool) -> None:
        bucket = self.suppressed_by_rule if suppressed else self.findings_by_rule
        bucket[rule] = bucket.get(rule, 0) + 1


def _apply_suppression(
    findings: List[Finding],
    by_path: Dict[str, Tuple[Dict[int, Set[str]], List[str]]],
    stats: ScanStats,
) -> Tuple[List[Finding], ScanStats]:
    # GL000 (pragma hygiene / parse failure) is deliberately unsuppressible:
    # a reasonless pragma that lists GL000 alongside the rule it silences
    # must not be able to waive the mandatory-reason contract it violates
    kept: List[Finding] = []
    for f in findings:
        pragmas, lines = by_path.get(f.path, ({}, []))
        suppressed = f.rule != "GL000" and _suppressed(f, pragmas, lines)
        stats.note(f.rule, suppressed)
        if not suppressed:
            kept.append(f)
    return sorted(kept, key=Finding.sort_key), stats


def _scan_file_worker(item: Tuple[str, str]):
    """Multiprocessing worker: parse one file and run the canonical
    per-file rule set. Returns ``(path, findings)`` or ``(path, None)`` on
    a parse failure (the parent re-derives the parse finding — same source,
    same error — so worker and serial scans are byte-identical)."""
    path, source = item
    from autoscaler_tpu_torch.analysis import rules as rules_mod

    try:
        model = FileModel(path, source)
    except (SyntaxError, ValueError):
        return (path, None)
    found: List[Finding] = []
    for rule in rules_mod.ALL_RULES:
        found.extend(rule.check(model))
    return (path, found)


def analyze_sources(
    sources: Dict[str, str],
    rules: Optional[Sequence] = None,
    program_rules: Optional[Sequence] = None,
    scan_complete: bool = True,
    cache=None,
    jobs: int = 1,
) -> Tuple[List[Finding], ScanStats]:
    """The one scan pipeline: parse every file once, run the per-file rules,
    build the whole-program call graph, run the program rules, then apply
    suppression pragmas (per finding, against the file it landed in).
    Paths drive rule scoping and need not exist on disk — fixture tests pass
    virtual ``autoscaler_tpu_torch/...`` paths.

    ``cache`` (an ``analysis.cache.LintCache``) stores RAW findings keyed
    by content hash — per file for the per-file rules, per scanned tree
    for the whole-program rules — so an unchanged tree re-lints without
    parsing and a one-file edit re-runs only that file plus the cross-file
    passes. Suppression/sorting run identically on cached and fresh
    findings (byte-identical output, verified by tests/test_torch_analysis_tree.py). The
    cache only applies to the canonical full-rule scan: an explicit
    ``rules``/``program_rules`` subset bypasses it.

    ``jobs`` > 1 fans the per-file rules out over a fork-based process pool
    while the parent parses the models the whole-program passes need — the
    two phases overlap, and results are folded back in sorted path order so
    output stays byte-identical to a serial run. Parallelism applies only
    to the canonical rule set (like the cache) and degrades silently to
    serial where fork is unavailable."""
    use_cache = cache is not None and rules is None and program_rules is None
    canonical_rules = rules is None
    if program_rules is None:
        # an explicit per-file `rules` subset means "only these": program
        # rules then run only when asked for, preserving the pre-whole-
        # program scoping of these entry points
        if rules is not None:
            program_rules = ()
        else:
            from autoscaler_tpu_torch.analysis import rules as rules_mod

            program_rules = rules_mod.ALL_PROGRAM_RULES
    if rules is None:
        from autoscaler_tpu_torch.analysis import rules as rules_mod

        rules = rules_mod.ALL_RULES

    stats = ScanStats(files=len(sources))
    findings: List[Finding] = []
    models: List[FileModel] = []
    by_path: Dict[str, Tuple[Dict[int, Set[str]], List[str]]] = {}

    file_keys: Dict[str, str] = {}
    per_file_cached: Dict[str, Optional[List[Finding]]] = {}
    program_key = None
    if use_cache:
        for path in sorted(sources):
            file_keys[path] = cache.file_key(display_path(path), sources[path])
        program_key = cache.program_key(
            [(display_path(p), k) for p, k in file_keys.items()], scan_complete
        )
        per_file_cached = {p: cache.get(k) for p, k in file_keys.items()}
        program_cached = cache.get(program_key)
        if program_cached is not None and all(
            v is not None for v in per_file_cached.values()
        ):
            # full-tree hit: no parse at all — pragmas (tokenize only) are
            # still read fresh so suppression always reflects the sources
            for path in sorted(sources):
                source = sources[path]
                pragmas, pragma_findings = parse_pragmas(source, path)
                findings.extend(pragma_findings)
                by_path[display_path(path)] = (pragmas, source.splitlines())
                findings.extend(per_file_cached[path])
            findings.extend(program_cached)
            return _apply_suppression(findings, by_path, stats)

    # fan the per-file rules out BEFORE the parent's own parse loop: the
    # pool chews on rule execution while the parent builds the models the
    # whole-program passes need anyway, then results fold back in path order
    pool = None
    pending = None
    if jobs > 1 and canonical_rules:
        fan_out = [
            p for p in sorted(sources) if per_file_cached.get(p) is None
        ]
        if len(fan_out) > 1:
            try:
                import multiprocessing

                ctx = multiprocessing.get_context("fork")
                pool = ctx.Pool(processes=min(jobs, len(fan_out)))
                pending = pool.map_async(
                    _scan_file_worker, [(p, sources[p]) for p in fan_out]
                )
            except (ImportError, OSError, ValueError):
                pool = None
                pending = None

    deferred: List[Tuple[str, str]] = []  # (path, file_key) awaiting pool
    for path in sorted(sources):
        source = sources[path]
        pragmas, pragma_findings = parse_pragmas(source, path)
        findings.extend(pragma_findings)
        cached = per_file_cached.get(path)
        try:
            model = FileModel(path, source)
        except (SyntaxError, ValueError) as e:
            # ValueError: ast.parse refuses NUL bytes — one corrupt file must
            # degrade to a finding, not abort the whole scan
            if cached is not None:
                findings.extend(cached)
                continue
            parse_finding = Finding(
                path=display_path(path),
                line=getattr(e, "lineno", None) or 1,
                rule="GL000",
                message=(
                    f"file does not parse: {getattr(e, 'msg', None) or e}"
                ),
            )
            findings.append(parse_finding)
            if use_cache:
                cache.put(file_keys[path], [parse_finding])
            continue
        by_path[model.path] = (pragmas, model.lines)
        # share the tokenize result with the dataflow pass (GL010 pragma
        # declassification) — one tokenize per file per scan
        model.pragma_lines = pragmas
        models.append(model)
        if cached is not None:
            findings.extend(cached)
            continue
        if pending is not None:
            deferred.append((path, file_keys.get(path, "")))
            continue
        file_findings: List[Finding] = []
        for rule in rules:
            file_findings.extend(rule.check(model))
        findings.extend(file_findings)
        if use_cache:
            cache.put(file_keys[path], file_findings)

    if pending is not None:
        by_worker = dict(pending.get())
        pool.close()
        pool.join()
        for path, fkey in deferred:
            file_findings = by_worker.get(path)
            if file_findings is None:
                # worker saw a parse failure the parent did not (should be
                # impossible — same bytes); degrade to a serial re-run
                file_findings = []
                model = FileModel(path, sources[path])
                for rule in rules:
                    file_findings.extend(rule.check(model))
            findings.extend(file_findings)
            if use_cache:
                cache.put(fkey, file_findings)

    if models and program_rules:
        from autoscaler_tpu_torch.analysis.callgraph import CallGraph

        graph = CallGraph(models)
        # whole-package-quantified rules (GL009) silence themselves on a
        # partial disk scan: "never read anywhere" cannot be proven when
        # the readers may live outside the scanned subtree
        graph.scan_complete = scan_complete
        program_findings: List[Finding] = []
        for prule in program_rules:
            program_findings.extend(prule.check_program(graph))
        findings.extend(program_findings)
        if use_cache and program_key is not None:
            cache.put(program_key, program_findings)
    elif use_cache and program_key is not None:
        cache.put(program_key, [])

    return _apply_suppression(findings, by_path, stats)


def check_source(
    source: str,
    path: str,
    rules: Optional[Sequence] = None,
    program_rules: Optional[Sequence] = None,
) -> List[Finding]:
    """Run every rule (per-file AND whole-program, over a one-file program)
    against one source. Kept as the fixture-test entry point."""
    findings, _ = analyze_sources(
        {path: source}, rules=rules, program_rules=program_rules
    )
    return findings


def iter_python_files(paths: Iterable[str]) -> List[str]:
    """Expand files/directories to a sorted, deduped .py file list
    (``__pycache__`` excluded) — deterministic scan order."""
    out: Set[str] = set()
    for p in paths:
        path = Path(p)
        if path.is_dir():
            for f in path.rglob("*.py"):
                if "__pycache__" not in f.parts:
                    out.add(f.as_posix())
        elif path.suffix == ".py":
            out.add(path.as_posix())
    return sorted(out)


def package_scan_complete(files: Iterable[str]) -> bool:
    """Does the scanned file set cover every .py of each on-disk package
    root it touches? Whole-package rules (GL009) need this: a subtree scan
    cannot prove an option is 'never read anywhere in the package'."""
    scanned = {Path(f).as_posix() for f in files}
    roots: Set[str] = set()
    for f in scanned:
        mod = module_path(f)
        if mod is not None and f.endswith(mod):
            roots.add(f[: -len(mod)])
    for root in roots:
        for disk in Path(root).rglob("*.py"):
            if "__pycache__" not in disk.parts and disk.as_posix() not in scanned:
                return False
    return True


def analyze_paths(
    paths: Iterable[str],
    rules: Optional[Sequence] = None,
    program_rules: Optional[Sequence] = None,
    jobs: int = 1,
) -> Tuple[List[Finding], ScanStats]:
    files = iter_python_files(paths)
    sources = {f: Path(f).read_text(encoding="utf-8") for f in files}
    return analyze_sources(
        sources,
        rules=rules,
        program_rules=program_rules,
        scan_complete=package_scan_complete(files),
        jobs=jobs,
    )


def scan_file(
    path: str,
    rules: Optional[Sequence] = None,
    program_rules: Optional[Sequence] = None,
) -> List[Finding]:
    return analyze_paths([path], rules=rules, program_rules=program_rules)[0]


def scan_paths(
    paths: Iterable[str],
    rules: Optional[Sequence] = None,
    program_rules: Optional[Sequence] = None,
) -> List[Finding]:
    return analyze_paths(paths, rules=rules, program_rules=program_rules)[0]
