"""graftlint rules GL001–GL015 — each derived from an invariant the
codebase already claims. See RULES.md (same directory) for the catalog,
rationale, and suppression etiquette.

Per-file rules (GL001–GL005) are small classes with ``rule_id``, ``title``
and ``check(model: FileModel) -> list[Finding]``; they walk the one shared
AST. Whole-program rules (GL006–GL015) implement
``check_program(graph: CallGraph) -> list[Finding]`` instead and see every
file at once — GL006 capture purity lives here; the kernel contract checker
(GL007), lock-order analysis (GL008), flag wiring (GL009), taint-flow
determinism + surface gating (GL010/GL012, ``dataflow.py``),
thread-escape analysis (GL011, ``escape.py``), the interprocedural
determinism-taint engine (GL013, ``taint.py``) and the device hot-path
purity rules (GL014/GL015, ``purity.py``) live in their own modules.
Nothing here imports beyond the stdlib.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set

from autoscaler_tpu_torch.analysis.callgraph import MODULE_NODE, CallGraph
from autoscaler_tpu_torch.analysis.contracts import KernelContractChecker
from autoscaler_tpu_torch.analysis.dataflow import (
    ENV_READ,
    REPLAY_SCOPES,
    SurfaceGatingChecker,
    TaintFlowChecker,
    classify_source_call,
)
from autoscaler_tpu_torch.analysis.engine import (
    FileModel,
    Finding,
    is_lock_attr as _is_lock_attr,
    self_attr as _self_attr,
    terminal_name as _terminal_name,
)
from autoscaler_tpu_torch.analysis.escape import (
    GL004_THREADED_SCOPES as THREADED_SCOPES,
    ThreadEscapeChecker,
)
from autoscaler_tpu_torch.analysis.flags import FlagWiringChecker
from autoscaler_tpu_torch.analysis.lockgraph import LockOrderChecker
from autoscaler_tpu_torch.analysis.obligations import ObligationChecker
from autoscaler_tpu_torch.analysis.schema import SchemaChecker
from autoscaler_tpu_torch.analysis.purity import (
    HostSyncChecker,
    RecompileHazardChecker,
    _own_region,
    capture_roots,
)
from autoscaler_tpu_torch.analysis.taint import DeterminismTaintChecker

# -- shared helpers -----------------------------------------------------------


def _enclosing_functions(tree: ast.AST) -> Dict[ast.AST, str]:
    """node -> dotted INNERMOST enclosing scope (``Class.method``), for
    stable finding messages that survive line drift."""
    out: Dict[ast.AST, str] = {}

    def walk(node: ast.AST, stack: List[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if stack:
                out[child] = ".".join(stack)
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                walk(child, stack + [child.name])
            else:
                walk(child, stack)

    walk(tree, [])
    return out


# -- GL001: wall clock / ambient randomness in the replay path ----------------

# The banned-call tables (and REPLAY_SCOPES) live in dataflow.py and are
# imported above: GL001's syntactic check, GL010's taint sources, and the
# runtime sanitizer's patch set all judge the same calls — static analysis
# can never drift below what the sanitizer actually traps.
# `time.perf_counter` is deliberately absent from the tables: it is the
# sanctioned wall-measurement clock (tracer wall_s, metrics), never a
# timeline input. A bare *reference* (e.g. `clock: Callable = time.monotonic`
# as an injectable parameter default) is not a Call and never flags — that
# IS the sanctioned seam shape.


class WallClockInReplayPath:
    rule_id = "GL001"
    title = "wall-clock or ambient randomness in a replay-reachable module"

    def check(self, model: FileModel) -> List[Finding]:
        if not model.in_module(*REPLAY_SCOPES):
            return []
        out: List[Finding] = []
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.Call):
                continue
            q = model.qualname(node.func)
            if q is None:
                continue
            # only chains whose head was actually IMPORTED: a parameter
            # named `random`/`time` is an injected seam, not the module
            if not model.is_imported(node.func):
                continue
            # the ONE source classifier — shared with GL010's taint
            # sources and the runtime sanitizer's patch set
            kind = classify_source_call(q)
            if kind == ENV_READ:
                out.append(
                    model.finding(
                        node,
                        self.rule_id,
                        f"{q}() in a replay-reachable module breaks "
                        "byte-identical scenario replay; read the "
                        "environment at startup (config/options) and pass "
                        "the value in as a parameter",
                    )
                )
            elif kind is not None:
                out.append(
                    model.finding(
                        node,
                        self.rule_id,
                        f"{q}() in a replay-reachable module breaks "
                        "byte-identical scenario replay; take a clock/rng "
                        "through an injected parameter or trace.timeline_now()",
                    )
                )
        return out


# -- GL002: span names must come from the FunctionLabel taxonomy --------------

_TAXONOMY_FILE = Path(__file__).resolve().parent.parent / "metrics" / "metrics.py"
_SPAN_CALLEES = {"span", "start_span", "tick"}


def function_label_taxonomy() -> Set[str]:
    """The FunctionLabel vocabulary: module-level UPPERCASE string constants
    of metrics/metrics.py, extracted by AST (never imported/executed) so the
    linter stays runnable anywhere the package source is."""
    try:
        tree = ast.parse(_TAXONOMY_FILE.read_text(encoding="utf-8"))
    except (OSError, SyntaxError):
        return set()
    labels: Set[str] = set()
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not all(
            isinstance(t, ast.Name) and t.id.isupper() for t in node.targets
        ):
            continue
        if isinstance(node.value, ast.Constant) and isinstance(node.value.value, str):
            labels.add(node.value.value)
    return labels


class SpanNameTaxonomy:
    rule_id = "GL002"
    title = "span name literal outside the FunctionLabel taxonomy"

    def __init__(self) -> None:
        self._taxonomy: Optional[Set[str]] = None

    @property
    def taxonomy(self) -> Set[str]:
        if self._taxonomy is None:
            self._taxonomy = function_label_taxonomy()
        return self._taxonomy

    def check(self, model: FileModel) -> List[Finding]:
        if not self.taxonomy:
            return []  # taxonomy source unavailable: cannot judge
        out: List[Finding] = []
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            term = _terminal_name(node.func)
            if term not in _SPAN_CALLEES:
                continue
            # only tracer receivers: `trace.span`, `self.tracer.tick`, or a
            # name imported from the trace package — re.Match.span("group")
            # and friends must not flag
            q = model.qualname(node.func) or ""
            if "trace" not in q.lower():
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Constant) and isinstance(first.value, str)):
                continue  # taxonomy constants arrive as attributes, not literals
            if first.value not in self.taxonomy:
                out.append(
                    model.finding(
                        node,
                        self.rule_id,
                        f'span name "{first.value}" is not a FunctionLabel '
                        "(metrics/metrics.py); traces and "
                        "function_duration_seconds share ONE vocabulary — "
                        "add the label there or reuse an existing one",
                    )
                )
        return out


# -- GL003: kernel dispatch must go through the estimator ladder --------------


# The port's kernels are built and loaded by ``ops/_build.load(name)``, which
# returns the source's ctypes library; a kernel launches as a call on that
# handle (``lib.ffd_scan_swar(...)``, ``getattr(lib, name)(...)``). Both the
# load and the launch belong to ``ops/``.
_KERNEL_LOADER = ("_build", "load")


def _is_kernel_load(model: FileModel, call: ast.AST) -> bool:
    """``_build.load(...)`` under any import spelling of ``ops/_build``."""
    if not isinstance(call, ast.Call):
        return False
    q = model.qualname(call.func)
    return q is not None and tuple(q.split(".")[-2:]) == _KERNEL_LOADER


def kernel_launches(model: FileModel) -> List[ast.Call]:
    """Every kernel load and every call on a loaded handle in the module:
    ``_build.load(...)``, ``_build.load(...).f(...)``, and ``h.f(...)`` or
    ``getattr(h, name)(...)`` where ``h`` is a name bound to a load in the
    same function (or at module level). Under-approximate: a handle passed
    through a parameter or a container is not followed."""
    out: List[ast.Call] = []

    def handle_names(scope: ast.AST) -> Set[str]:
        names: Set[str] = set()
        for node in _own_region(scope):
            if isinstance(node, ast.Assign) and _is_kernel_load(model, node.value):
                names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        return names

    def on_handle(func: ast.AST, handles: Set[str]) -> bool:
        if isinstance(func, ast.Attribute):
            recv = func.value
        elif (
            isinstance(func, ast.Call)
            and isinstance(func.func, ast.Name)
            and func.func.id == "getattr"
            and func.args
        ):
            recv = func.args[0]
        else:
            return False
        if isinstance(recv, ast.Name):
            return recv.id in handles
        return _is_kernel_load(model, recv)

    scopes = [model.tree] + [
        n for n in ast.walk(model.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    for scope in scopes:
        handles = handle_names(scope)
        for node in _own_region(scope):
            if isinstance(node, ast.Call) and (
                _is_kernel_load(model, node) or on_handle(node.func, handles)
            ):
                out.append(node)
    return sorted(out, key=lambda n: (n.lineno, n.col_offset))


class LadderBypass:
    rule_id = "GL003"
    title = "kernel dispatch outside the estimator degradation ladder"

    def check(self, model: FileModel) -> List[Finding]:
        if model.module is None:
            return []
        out: List[Finding] = []
        if not model.in_module("ops/"):
            lines: Set[int] = set()
            for node in kernel_launches(model):
                if node.lineno in lines:
                    continue  # `_build.load(...).f(...)`: one launch, one finding
                lines.add(node.lineno)
                out.append(
                    model.finding(
                        node,
                        self.rule_id,
                        "kernel launch outside ops/ — kernels are loaded "
                        "(ops/_build.load) and launched only in ops/ and "
                        "dispatched only through "
                        "estimator/binpacking._walk_ladder",
                    )
                )
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.Call):
                continue
            term = _terminal_name(node.func)
            if term is None:
                continue
            if term.startswith("ffd_binpack") and not model.in_module(
                "ops/", "estimator/", "native_bridge.py"
            ):
                out.append(
                    model.finding(
                        node,
                        self.rule_id,
                        f"direct kernel dispatch {term}() bypasses the "
                        "circuit-broken ladder "
                        "(estimator/binpacking._walk_ladder); a rung fault "
                        "here would crash the caller instead of degrading",
                    )
                )
        return sorted(out, key=Finding.sort_key)


# -- GL004: lock discipline in threaded modules -------------------------------
# THREADED_SCOPES is imported from escape.py (GL004_THREADED_SCOPES): GL011's
# read-side escape analysis covers the same table, so the two halves of the
# lock contract can never drift apart.


class LockDiscipline:
    rule_id = "GL004"
    title = "write to guarded state outside the instance lock"

    def check(self, model: FileModel) -> List[Finding]:
        if not model.in_module(*THREADED_SCOPES):
            return []
        out: List[Finding] = []
        for cls in ast.walk(model.tree):
            if isinstance(cls, ast.ClassDef):
                out.extend(self._check_class(model, cls))
        return out

    @staticmethod
    def _own_scope_nodes(cls: ast.ClassDef) -> List[ast.AST]:
        """All nodes of the class EXCLUDING nested ClassDef subtrees — a
        nested helper class's ``self._lock`` belongs to the nested class
        and must not make the enclosing class lock-guarded."""
        out: List[ast.AST] = []
        stack: List[ast.AST] = list(cls.body)
        while stack:
            node = stack.pop()
            if isinstance(node, ast.ClassDef):
                continue
            out.append(node)
            stack.extend(ast.iter_child_nodes(node))
        return out

    def _check_class(self, model: FileModel, cls: ast.ClassDef) -> List[Finding]:
        lock_attrs = {
            attr
            for node in self._own_scope_nodes(cls)
            if isinstance(node, (ast.Assign, ast.AnnAssign))
            for tgt in (node.targets if isinstance(node, ast.Assign) else [node.target])
            if (attr := _self_attr(tgt)) is not None and _is_lock_attr(attr)
        }
        if not lock_attrs:
            return []
        out: List[Finding] = []
        lock_name = sorted(lock_attrs)[0]
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # __init__/__new__ run before the object is shared; *_locked is
            # the documented caller-holds-the-lock convention
            if fn.name in ("__init__", "__new__") or fn.name.endswith("_locked"):
                continue
            self._walk_fn(model, cls, fn, fn, lock_attrs, lock_name, False, out)
        return out

    def _walk_fn(
        self,
        model: FileModel,
        cls: ast.ClassDef,
        fn: ast.AST,
        node: ast.AST,
        lock_attrs: Set[str],
        lock_name: str,
        locked: bool,
        out: List[Finding],
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                continue  # a nested class is its own guarded world
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                # a nested def under `with self._lock:` runs LATER, when the
                # lock is no longer held — reset, don't inherit
                self._walk_fn(
                    model, cls, fn, child, lock_attrs, lock_name, False, out
                )
                continue
            child_locked = locked
            if isinstance(child, (ast.With, ast.AsyncWith)):
                for item in child.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None and _is_lock_attr(attr):
                        child_locked = True
            if not child_locked:
                targets: List[ast.AST] = []
                if isinstance(child, ast.Assign):
                    targets = list(child.targets)
                elif isinstance(child, ast.AugAssign):
                    targets = [child.target]
                elif isinstance(child, ast.AnnAssign):
                    # a bare `self._x: int` declares, it does not write
                    if child.value is not None:
                        targets = [child.target]
                elif isinstance(child, ast.Delete):
                    targets = list(child.targets)
                for tgt in targets:
                    attr = _self_attr(tgt)
                    if attr and attr.startswith("_") and not _is_lock_attr(attr):
                        out.append(
                            model.finding(
                                child,
                                self.rule_id,
                                f"{cls.name}.{getattr(fn, 'name', '<lambda>')} "
                                f"writes self.{attr} outside `with "
                                f"self.{lock_name}:` — guarded state in a "
                                "threaded module moves only under the lock "
                                "(or from a *_locked helper)",
                            )
                        )
            self._walk_fn(
                model, cls, fn, child, lock_attrs, lock_name, child_locked, out
            )


# -- GL005: except-Exception boundaries in the run_once path ------------------

RUN_ONCE_SCOPES = ("core/", "main.py")
_ROUTERS = {"to_autoscaler_error", "prefixed"}


class ErrorBoundary:
    rule_id = "GL005"
    title = "except Exception swallowed without typing or re-raise"

    def check(self, model: FileModel) -> List[Finding]:
        if not model.in_module(*RUN_ONCE_SCOPES):
            return []
        owners = _enclosing_functions(model.tree)
        out: List[Finding] = []
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._catches_exception(node.type):
                continue
            if self._routes(node):
                continue
            where = owners.get(node, "<module>")
            out.append(
                model.finding(
                    node,
                    self.rule_id,
                    f"except Exception in {where} neither re-raises nor "
                    "routes through to_autoscaler_error/prefixed — untyped "
                    "swallows hide crash-only loop failures from "
                    "errors_total and the health check",
                )
            )
        return out

    @staticmethod
    def _catches_exception(type_node: Optional[ast.AST]) -> bool:
        names = []
        if type_node is None:
            return True  # bare except is the same hazard
        if isinstance(type_node, ast.Tuple):
            names = [t.id for t in type_node.elts if isinstance(t, ast.Name)]
        elif isinstance(type_node, ast.Name):
            names = [type_node.id]
        return "Exception" in names or "BaseException" in names

    @staticmethod
    def _routes(handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                term = _terminal_name(node.func)
                if term in _ROUTERS:
                    return True
        return False


# -- GL006: purity of CUDA-graph-captured functions ---------------------------

_LOG_METHODS = {"debug", "info", "warning", "error", "exception", "critical", "log"}


class JitPurity:
    """Whole-program GL006: roots are every function a CUDA graph capture
    records (each call between ``capture_begin`` and ``capture_end``, and
    each call in a ``with torch.cuda.graph(...)`` body — the same roots
    GL015 judges); reachability is the TRUE transitive closure over the
    cross-module call graph (import-alias resolved), so a captured step in
    ``ops/`` calling a helper imported from ``snapshot/`` taints that
    helper too. A host side effect there runs once, at capture, and never
    on ``graph.replay()`` — the hazard jit has in the JAX package."""

    rule_id = "GL006"
    title = "host side effect inside a CUDA-graph-captured function"

    def check_program(self, graph: CallGraph) -> List[Finding]:
        roots: Set[str] = set()
        for model in graph.models:
            roots |= capture_roots(graph, model)
        out: List[Finding] = []
        for fq in sorted(graph.reachable(roots)):
            info = graph.defs[fq]
            if info.local == MODULE_NODE:
                continue
            name = info.local.split(".")[-1]
            for node in _own_region(info.node):
                if not isinstance(node, ast.Call):
                    continue
                why = self._banned(info.model, node)
                if why is not None:
                    out.append(
                        info.model.finding(
                            node,
                            self.rule_id,
                            f"{why} inside {name}(), which is reached from a "
                            "CUDA graph capture — a captured function's "
                            "host side effects run once, at capture, and "
                            "never on graph.replay()",
                        )
                    )
        return out

    @staticmethod
    def _banned(model: FileModel, call: ast.Call) -> Optional[str]:
        term = _terminal_name(call.func)
        if term is None:
            return None
        if isinstance(call.func, ast.Name) and term == "print":
            return "print()"
        q = model.qualname(call.func) or term
        parts = q.split(".")
        if "metrics" in parts:
            return f"metrics write {q}()"
        if parts[0] == "trace" or "autoscaler_tpu_torch.trace" in q:
            return f"tracer call {q}()"
        if (
            parts[0] in ("logging", "logger", "log", "klogx")
            and parts[-1] in _LOG_METHODS
        ):
            return f"logging call {q}()"
        return None


# per-file rules: one FileModel in, findings out
ALL_RULES: Sequence = (
    WallClockInReplayPath(),
    SpanNameTaxonomy(),
    LadderBypass(),
    LockDiscipline(),
    ErrorBoundary(),
)

# whole-program rules: the cross-module CallGraph in, findings out
ALL_PROGRAM_RULES: Sequence = (
    JitPurity(),
    KernelContractChecker(),
    LockOrderChecker(),
    FlagWiringChecker(),
    TaintFlowChecker(),
    ThreadEscapeChecker(),
    SurfaceGatingChecker(),
    DeterminismTaintChecker(),
    HostSyncChecker(),
    RecompileHazardChecker(),
    ObligationChecker(),
    SchemaChecker(),
)

RULE_CATALOG = {
    r.rule_id: r.title for r in (*ALL_RULES, *ALL_PROGRAM_RULES)
}
