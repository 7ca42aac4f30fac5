"""GL008 — cross-file lock-order analysis.

GL004 polices that guarded state moves under the instance lock; this rule
polices what happens *between* locks: if thread 1 holds ``A._lock`` and
calls into something that takes ``B._lock`` while thread 2 does the
reverse, the process deadlocks — and no per-file rule can see it, because
the two acquisition chains live in different modules
(``utils/circuit.py`` calling a metrics write, ``trace/recorder.py``
serving ``/tracez`` while the loop appends, ``kube/`` watchers feeding
``clusterstate/``).

The analysis builds a lock-acquisition graph from the same per-class facts
GL004 extracts:

- A *lock node* is ``(module, Class, _lockattr)`` — any class in the
  threaded scopes that binds ``self._*lock`` (plain assignment or the
  dataclass ``field(default_factory=threading.Lock)`` form). ``RLock``
  construction marks the node reentrant.
- A method *acquires* its class's lock when its body contains
  ``with self._*lock:``. Acquisition is propagated transitively through
  same-scope method calls (resolved by method name; ``self.x()`` stays in
  class), so ``A.f`` → ``B.g`` → ``with self._lock`` still counts.
- An *edge* ``L1 → L2`` is recorded when code textually inside a
  ``with self._L1:`` region calls a method whose (transitive) acquisition
  set contains ``L2``, or nests ``with self._L2:`` directly.
- Any cycle in the resulting graph — including a self-loop onto a
  non-reentrant lock — is a finding (deadlock potential); the finding
  lands on the call site of the cycle's lexicographically first edge and
  its message spells the full cycle.

Known limits (documented in RULES.md): resolution is by method *name*, so
a generic container-method name (``get``/``add``/``append``/…) is excluded
from edge building — a false edge through ``dict.get`` would otherwise
implicate every lock-holding class with a ``get``. Locks aliased to locals
and callbacks invoked under a lock (``self._on_transition(...)``) are
invisible; keep callbacks lock-free, as CircuitBreaker documents.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from autoscaler_tpu_torch.analysis.callgraph import CallGraph
from autoscaler_tpu_torch.analysis.engine import (
    FileModel,
    Finding,
    is_lock_attr,
    self_attr,
    terminal_name,
)

LOCK_ORDER_SCOPES = (
    "metrics/",
    "trace/",
    "utils/circuit.py",
    "kube/",
    "clusterstate/",
)

# method names too generic to resolve by name: stdlib containers define
# them, so an edge through `self._items.get(...)` would be noise
GENERIC_METHOD_NAMES = {
    "get", "set", "add", "append", "appendleft", "pop", "popleft", "popitem",
    "update", "items", "keys", "values", "clear", "remove", "discard",
    "insert", "extend", "index", "count", "copy", "setdefault", "sort",
    "submit", "put", "join", "start", "close", "send", "write", "read",
}


@dataclass(frozen=True)
class LockNode:
    path: str      # module display path
    cls: str
    attr: str      # the _*lock attribute name
    reentrant: bool = False

    @property
    def label(self) -> str:
        return f"{self.cls}.{self.attr} ({self.path})"

    def sort_key(self):
        return (self.path, self.cls, self.attr)


@dataclass
class _ClassInfo:
    model: FileModel
    node: ast.ClassDef
    locks: Dict[str, LockNode] = field(default_factory=dict)  # attr -> node
    # method name -> locks the method body acquires directly
    direct: Dict[str, Set[LockNode]] = field(default_factory=dict)
    # method name -> same-scope method names it calls (self.x() and bare)
    calls: Dict[str, List[Tuple[str, bool]]] = field(default_factory=dict)


def _is_rlock(value: ast.AST) -> bool:
    return any(
        isinstance(n, (ast.Name, ast.Attribute))
        and (getattr(n, "id", None) == "RLock" or getattr(n, "attr", None) == "RLock")
        for n in ast.walk(value)
    )


def _walk_pruning_classes(cls: ast.ClassDef):
    """Yield the class's own descendants, PRUNING nested ClassDefs (their
    whole subtree): ast.walk's flat iteration would otherwise attribute an
    inner class's lock bindings to the outer class (nested classes own
    their locks — GL004 semantics)."""
    stack: List[ast.AST] = [cls]
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if not isinstance(child, ast.ClassDef):
                stack.append(child)


def _class_locks(model: FileModel, cls: ast.ClassDef) -> Dict[str, LockNode]:
    """Lock attributes a class binds: ``self._lock = threading.Lock()`` in
    any method, or the dataclass ``_lock: ... = field(...)`` form."""
    out: Dict[str, LockNode] = {}

    def note(attr: str, value: Optional[ast.AST]) -> None:
        out[attr] = LockNode(
            path=model.path,
            cls=cls.name,
            attr=attr,
            reentrant=value is not None and _is_rlock(value),
        )

    for node in _walk_pruning_classes(cls):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                attr = self_attr(tgt)
                if attr is not None and is_lock_attr(attr):
                    note(attr, node.value)
        elif isinstance(node, ast.AnnAssign):
            attr = self_attr(node.target)
            if attr is None and isinstance(node.target, ast.Name):
                attr = node.target.id  # dataclass field form
            if attr is not None and is_lock_attr(attr):
                note(attr, node.value)
    return out


class LockOrderChecker:
    rule_id = "GL008"
    title = "lock-order cycle across threaded modules (deadlock potential)"

    def check_program(self, graph: CallGraph) -> List[Finding]:
        classes = self._collect_classes(graph)
        if not classes:
            return []
        acquires = self._transitive_acquires(classes)
        edges = self._edges(classes, acquires)
        return self._cycles(edges)

    # -- fact collection ------------------------------------------------------

    def _collect_classes(self, graph: CallGraph) -> List[_ClassInfo]:
        out: List[_ClassInfo] = []
        for model in graph.models:
            if not model.in_module(*LOCK_ORDER_SCOPES):
                continue
            for node in ast.walk(model.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                info = _ClassInfo(model=model, node=node)
                info.locks = _class_locks(model, node)
                for fn in node.body:
                    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        continue
                    direct: Set[LockNode] = set()
                    calls: List[Tuple[str, bool]] = []
                    self._scan_method(info, fn, direct, calls)
                    info.direct[fn.name] = direct
                    info.calls[fn.name] = calls
                out.append(info)
        return out

    def _scan_method(
        self,
        info: _ClassInfo,
        node: ast.AST,
        direct: Set[LockNode],
        calls: List[Tuple[str, bool]],
    ) -> None:
        """Direct acquisitions + same-scope calls of one method body (nested
        defs excluded: they run later, outside the lock — GL004 semantics)."""
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
            ):
                continue
            if isinstance(child, (ast.With, ast.AsyncWith)):
                for item in child.items:
                    attr = self_attr(item.context_expr)
                    if attr and is_lock_attr(attr) and attr in info.locks:
                        direct.add(info.locks[attr])
            if isinstance(child, ast.Call):
                term = terminal_name(child.func)
                if term is not None:
                    is_self = (
                        isinstance(child.func, ast.Attribute)
                        and isinstance(child.func.value, ast.Name)
                        and child.func.value.id == "self"
                    )
                    calls.append((term, is_self))
            self._scan_method(info, child, direct, calls)

    @staticmethod
    def _methods_by_name(classes: List[_ClassInfo]) -> Dict[str, List[_ClassInfo]]:
        by_name: Dict[str, List[_ClassInfo]] = {}
        for info in classes:
            for meth in info.direct:
                by_name.setdefault(meth, []).append(info)
        return by_name

    @staticmethod
    def _call_targets(
        info: _ClassInfo,
        callee: str,
        is_self: bool,
        by_name: Dict[str, List[_ClassInfo]],
    ) -> List[_ClassInfo]:
        """Classes a method call may land in: ``self.x()`` stays in class;
        generic container-method names resolve nowhere (RULES.md limit);
        anything else resolves by name to every OTHER lock-holding class."""
        if is_self:
            return [info] if callee in info.direct else []
        if callee in GENERIC_METHOD_NAMES:
            return []
        return [c for c in by_name.get(callee, []) if c is not info]

    def _transitive_acquires(
        self, classes: List[_ClassInfo]
    ) -> Dict[Tuple[str, str, str], Set[LockNode]]:
        """(path, cls, method) -> all locks the method may acquire, through
        same-scope method calls (fixpoint, name-resolved)."""
        by_name = self._methods_by_name(classes)
        acq: Dict[Tuple[str, str, str], Set[LockNode]] = {
            (i.model.path, i.node.name, m): set(d)
            for i in classes
            for m, d in i.direct.items()
        }
        changed = True
        while changed:
            changed = False
            for info in classes:
                for meth, calls in info.calls.items():
                    key = (info.model.path, info.node.name, meth)
                    cur = acq[key]
                    for callee, is_self in calls:
                        for tgt in self._call_targets(
                            info, callee, is_self, by_name
                        ):
                            extra = acq.get(
                                (tgt.model.path, tgt.node.name, callee), set()
                            )
                            if not extra <= cur:
                                cur |= extra
                                changed = True
        return acq

    # -- edges + cycles -------------------------------------------------------

    def _edges(
        self,
        classes: List[_ClassInfo],
        acquires: Dict[Tuple[str, str, str], Set[LockNode]],
    ) -> Dict[Tuple[LockNode, LockNode], Tuple[str, int, str]]:
        """{(from, to): (path, line, what)} — the first (smallest-location)
        witness per edge."""
        by_name = self._methods_by_name(classes)
        edges: Dict[Tuple[LockNode, LockNode], Tuple[str, int, str]] = {}

        def note(frm: LockNode, to: LockNode, path: str, line: int, what: str):
            key = (frm, to)
            prev = edges.get(key)
            if prev is None or (path, line) < prev[:2]:
                edges[key] = (path, line, what)

        for info in classes:
            for fn in info.node.body:
                if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                self._walk_regions(info, fn, fn, None, acquires, by_name, note)
        return edges

    def _walk_regions(
        self, info, fn, node, held: Optional[LockNode], acquires, by_name, note
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
            ):
                continue  # deferred bodies run without the lock
            child_held = held
            if isinstance(child, (ast.With, ast.AsyncWith)):
                # items acquire LEFT TO RIGHT: `with self._a, self._b:` is
                # the nested form, so successive items edge off the lock
                # acquired just before them (child_held evolves), not only
                # off the lock held outside the statement
                for item in child.items:
                    attr = self_attr(item.context_expr)
                    if attr and is_lock_attr(attr) and attr in info.locks:
                        lock = info.locks[attr]
                        if child_held is not None and lock != child_held:
                            note(
                                child_held, lock, info.model.path,
                                child.lineno,
                                f"{info.node.name}.{fn.name} nests "
                                f"`with self.{attr}:`",
                            )
                        elif (
                            child_held is not None
                            and lock == child_held
                            and not child_held.reentrant
                        ):
                            # direct re-entry of a plain Lock: guaranteed
                            # self-deadlock, recorded as a self-edge so
                            # _cycles' self-loop test sees it
                            note(
                                child_held, lock, info.model.path,
                                child.lineno,
                                f"{info.node.name}.{fn.name} re-enters "
                                f"`with self.{attr}:` while already "
                                "holding it",
                            )
                        child_held = lock
            if held is not None and isinstance(child, ast.Call):
                term = terminal_name(child.func)
                if term is not None:
                    is_self = (
                        isinstance(child.func, ast.Attribute)
                        and isinstance(child.func.value, ast.Name)
                        and child.func.value.id == "self"
                    )
                    for tgt in self._call_targets(info, term, is_self, by_name):
                        for lock in sorted(
                            acquires.get(
                                (tgt.model.path, tgt.node.name, term), set()
                            ),
                            key=LockNode.sort_key,
                        ):
                            if lock == held and held.reentrant:
                                continue
                            note(
                                held, lock, info.model.path, child.lineno,
                                f"{info.node.name}.{fn.name} calls "
                                f"{tgt.node.name}.{term}() under the lock",
                            )
            self._walk_regions(info, fn, child, child_held, acquires, by_name, note)

    def _cycles(
        self, edges: Dict[Tuple[LockNode, LockNode], Tuple[str, int, str]]
    ) -> List[Finding]:
        adj: Dict[LockNode, List[LockNode]] = {}
        for frm, to in sorted(edges, key=lambda e: (e[0].sort_key(), e[1].sort_key())):
            adj.setdefault(frm, []).append(to)
            adj.setdefault(to, [])
        # SCCs via iterative Tarjan over sorted adjacency — deterministic
        index: Dict[LockNode, int] = {}
        low: Dict[LockNode, int] = {}
        on_stack: Set[LockNode] = set()
        stack: List[LockNode] = []
        sccs: List[List[LockNode]] = []
        counter = [0]

        def strongconnect(v: LockNode) -> None:
            work = [(v, iter(adj[v]))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(adj[w])))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    low[work[-1][0]] = min(low[work[-1][0]], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    sccs.append(sorted(comp, key=LockNode.sort_key))

        for v in sorted(adj, key=LockNode.sort_key):
            if v not in index:
                strongconnect(v)

        findings: List[Finding] = []
        for comp in sorted(sccs, key=lambda c: c[0].sort_key()):
            cyclic = len(comp) > 1 or (
                (comp[0], comp[0]) in edges and not comp[0].reentrant
            )
            if not cyclic:
                continue
            comp_set = set(comp)
            cycle_edges = sorted(
                (
                    (frm, to, edges[(frm, to)])
                    for (frm, to) in edges
                    if frm in comp_set and to in comp_set
                ),
                key=lambda e: (e[0].sort_key(), e[1].sort_key()),
            )
            first = cycle_edges[0]
            chain = " → ".join(n.label for n in comp)
            # witnesses name the file but NOT the line: the baseline
            # fingerprints on (path, rule, message), and embedding line
            # numbers would churn grandfathered entries on unrelated line
            # drift (the finding's own `line` still anchors the first edge)
            witnesses = "; ".join(
                f"{frm.cls}.{frm.attr}→{to.cls}.{to.attr} ({what} at {path})"
                for frm, to, (path, _line, what) in cycle_edges
            )
            findings.append(
                Finding(
                    path=first[2][0],
                    line=first[2][1],
                    rule=self.rule_id,
                    message=(
                        f"lock-order cycle: {chain} — two threads taking "
                        f"these locks in opposite order deadlock. "
                        f"Acquisition witnesses: {witnesses}"
                    ),
                )
            )
        return findings
