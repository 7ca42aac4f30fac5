"""GL011 — thread-escape analysis for lock-guarded classes.

GL004 polices one half of the lock contract: *writes* to guarded state
move only under the instance lock. That leaves the read side open — a
field written under ``self._lock`` by the coalescer window thread and
read bare from an RPC servicer method is a data race GL004 cannot see,
and exactly the class of bug the reference autoscaler catches with Go's
``-race`` in CI. GL011 is the static analog: in the threaded modules, a
non-lock ``self._*`` field with a write outside ``__init__`` must have
**every** cross-method access lock-protected, or be provably confined to
one method. Each escape is reported with the two witnessing access paths
(the protected writer and the unprotected reader).

Mechanism, per class binding a ``self._*lock``:

- Every access to a non-lock underscore field is collected with its
  method and lock state (inside a ``with self._*lock:`` region). Methods
  named ``*_locked`` follow the documented caller-holds-the-lock
  convention; ``__init__``/``__new__`` run before the object is shared
  and don't participate.
- **Lock-held propagation**: a private helper (leading underscore, not a
  dunder) whose every intra-class call site sits inside a locked region
  is itself considered locked — ``_find`` called only from ``pin``/``get``
  under the lock inherits their protection. Propagation iterates to a
  fixpoint; public methods never inherit (they are entry points and can
  be called bare).
- **Confinement**: a field whose every post-``__init__`` access lives in
  one single method never crosses threads through this class and is
  skipped; so is a field never written after ``__init__`` (immutable
  after publication — the lock that published the object fences it).
- The finding fires on an **unprotected read** paired with any write in a
  different method. The unprotected-*write* half of the hazard is
  GL004's finding (the two rules partition the contract; a dual-unlocked
  field raises both, each naming its own witness).

Like every fatal-gate rule this under-approximates: attribute access
through aliases (``state = self._items; state.append(x)``) and
cross-object access are invisible; what it does report is a provable
escape with both access paths spelled out.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from autoscaler_tpu_torch.analysis.callgraph import CallGraph
from autoscaler_tpu_torch.analysis.engine import (
    FileModel,
    Finding,
    is_lock_attr,
    self_attr,
)

# THE one table of modules where the control loop races server/watcher/
# window threads. GL004 (rules.py) imports the base tuple — write-side and
# read-side lock enforcement can never drift apart. GL011 additionally
# covers the RPC servicer (handler threads race the window thread through
# the coalescer seam).
GL004_THREADED_SCOPES = (
    "explain/",
    "fleet/",
    "gym/",
    "journal/",
    "metrics/",
    "perf/",
    "slo/",
    "preempt/",
    "snapshot/arena.py",
    "trace/recorder.py",
    "utils/circuit.py",
    "kube/client.py",
)
THREADED_SCOPES = GL004_THREADED_SCOPES + ("rpc/",)


@dataclass(frozen=True)
class Access:
    field: str
    method: str
    line: int
    is_write: bool
    locked: bool       # at the access site (with-region or *_locked/propagated)


def _own_scope_nodes(cls: ast.ClassDef) -> List[ast.AST]:
    """Class nodes excluding nested ClassDef subtrees (a nested helper
    class guards its own state)."""
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(cls.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.ClassDef):
            continue
        out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _class_lock_attrs(cls: ast.ClassDef) -> Set[str]:
    return {
        attr
        for node in _own_scope_nodes(cls)
        if isinstance(node, (ast.Assign, ast.AnnAssign))
        for tgt in (node.targets if isinstance(node, ast.Assign) else [node.target])
        if (attr := self_attr(tgt)) is not None and is_lock_attr(attr)
    }


class _MethodWalk:
    """Collect field accesses + intra-class call sites of one method,
    tracking the with-lock region exactly like GL004 does."""

    def __init__(self, method_name: str):
        self.method = method_name
        self.accesses: List[Tuple[str, int, bool, bool]] = []  # field, line, write, locked
        # callee method name -> was every call site locked?
        self.calls: List[Tuple[str, bool]] = []
        # Attribute nodes that are part of a write target (the Load half of
        # `self._x[k] = v`): seen later in the recursion, must not double-
        # count as reads
        self._write_loads: Set[int] = set()

    def walk(self, node: ast.AST, locked: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # nested defs run later, lock not held (GL004 rule)
            child_locked = locked
            if isinstance(child, (ast.With, ast.AsyncWith)):
                for item in child.items:
                    attr = self_attr(item.context_expr)
                    if attr is not None and is_lock_attr(attr):
                        child_locked = True
            self._note(child, child_locked)
            self.walk(child, child_locked)

    # container-method mutation: `self._items.append(x)` writes through
    # the field just as `self._items[k] = v` does — GL004 can't see these
    # (documented limit there), so GL011 must count them as writes
    _MUTATORS = {
        "append", "appendleft", "add", "update", "extend", "insert",
        "remove", "discard", "pop", "popleft", "popitem", "clear",
        "setdefault", "sort",
    }

    def _note(self, node: ast.AST, locked: bool) -> None:
        if isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr in self._MUTATORS
                and isinstance(func.value, ast.Attribute)
                and isinstance(func.value.value, ast.Name)
                and func.value.value.id == "self"
            ):
                field = func.value.attr
                if field.startswith("_") and not is_lock_attr(field):
                    self.accesses.append((field, node.lineno, True, locked))
                    # the receiver Load is this write, not a read
                    self._write_loads.add(id(func.value))
        write_targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            write_targets = list(node.targets)
        elif isinstance(node, ast.AugAssign):
            write_targets = [node.target]
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            write_targets = [node.target]
        elif isinstance(node, ast.Delete):
            write_targets = list(node.targets)
        for tgt in write_targets:
            attr = self_attr(tgt)
            if attr is not None and attr.startswith("_") and not is_lock_attr(attr):
                self.accesses.append((attr, node.lineno, True, locked))
            for sub in ast.walk(tgt):
                if isinstance(sub, ast.Attribute):
                    self._write_loads.add(id(sub))
        if isinstance(node, ast.Attribute) and id(node) not in self._write_loads:
            if (
                isinstance(node.ctx, ast.Load)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr.startswith("_")
                and not is_lock_attr(node.attr)
            ):
                self.accesses.append((node.attr, node.lineno, False, locked))
        if isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "self"
            ):
                self.calls.append((func.attr, locked))


class ThreadEscapeChecker:
    """GL011 — guarded state must not escape its lock across methods."""

    rule_id = "GL011"
    title = "guarded field read without the lock while written elsewhere"

    def check_program(self, graph: CallGraph) -> List[Finding]:
        out: List[Finding] = []
        for model in graph.models:
            if not model.in_module(*THREADED_SCOPES):
                continue
            for node in ast.walk(model.tree):
                if isinstance(node, ast.ClassDef):
                    out.extend(self._check_class(model, node))
        return out

    def _check_class(self, model: FileModel, cls: ast.ClassDef) -> List[Finding]:
        lock_attrs = _class_lock_attrs(cls)
        if not lock_attrs:
            return []
        lock_name = sorted(lock_attrs)[0]

        walks: Dict[str, _MethodWalk] = {}
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name in ("__init__", "__new__"):
                continue
            w = _MethodWalk(fn.name)
            w.walk(fn, locked=fn.name.endswith("_locked"))
            walks[fn.name] = w

        # lock-held propagation for private helpers: every intra-class
        # call site locked -> the helper body runs under the lock
        held: Set[str] = {m for m in walks if m.endswith("_locked")}
        call_sites: Dict[str, List[Tuple[str, bool]]] = {}
        for caller, w in walks.items():
            for callee, locked in w.calls:
                call_sites.setdefault(callee, []).append((caller, locked))
        for _ in range(len(walks) + 1):
            changed = False
            for m, w in walks.items():
                if m in held or not self._is_private(m):
                    continue
                sites = call_sites.get(m, [])
                if sites and all(
                    locked or caller in held for caller, locked in sites
                ):
                    held.add(m)
                    changed = True
            if not changed:
                break

        def protected(method: str, site_locked: bool) -> bool:
            return site_locked or method in held

        # gather per-field access lists
        by_field: Dict[str, List[Access]] = {}
        for m, w in walks.items():
            for field, line, is_write, locked in w.accesses:
                by_field.setdefault(field, []).append(
                    Access(field, m, line, is_write, protected(m, locked))
                )

        out: List[Finding] = []
        for field in sorted(by_field):
            accesses = by_field[field]
            writes = [a for a in accesses if a.is_write]
            if not writes:
                continue  # never written after __init__: immutable
            methods = {a.method for a in accesses}
            if len(methods) <= 1:
                continue  # confined to one method
            unprotected_reads = [
                a for a in accesses if not a.is_write and not a.locked
            ]
            for read in sorted(
                unprotected_reads, key=lambda a: (a.method, a.line)
            ):
                cross_writes = sorted(
                    (w for w in writes if w.method != read.method),
                    key=lambda a: (a.method, a.line),
                )
                if not cross_writes:
                    continue
                w = cross_writes[0]
                out.append(
                    Finding(
                        path=model.path,
                        line=read.line,
                        rule=self.rule_id,
                        message=(
                            f"{cls.name}.{field} escapes self.{lock_name}: "
                            f"read without the lock in {cls.name}."
                            f"{read.method} while {cls.name}.{w.method} "
                            f"writes it{' under the lock' if w.locked else ''}"
                            " — a racing read sees torn state; hold the "
                            "lock on both sides or confine the field"
                        ),
                    )
                )
                break  # one witness pair per field: the first escape names it
        # dedupe: one finding per (field, reading method)
        seen: Set[Tuple[int, str]] = set()
        deduped: List[Finding] = []
        for f in out:
            k = (f.line, f.message)
            if k not in seen:
                seen.add(k)
                deduped.append(f)
        return deduped

    @staticmethod
    def _is_private(name: str) -> bool:
        return name.startswith("_") and not name.startswith("__")
