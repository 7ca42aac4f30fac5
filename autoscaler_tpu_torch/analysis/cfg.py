"""Intra-procedural control-flow graphs for graftlint v3.

The v1/v2 rules walk statements in source order, which is enough for
"does this handler contain a router call" (GL005) but cannot answer the
questions the v3 rules ask: *is this ticket resolved on every path out of
the function, exception edges included?* That needs a real CFG.

One CFG per ``def``, built from the same ``ast`` the FileModel already
parsed and cached on the model (:func:`cfg_for`), so every v3 rule shares
one graph per definition. Shapes covered: ``if``/``else`` branches,
``while``/``for`` loops (back edges, ``else`` clauses, ``break``/
``continue``), ``try``/``except``/``else``/``finally``, ``with``,
``return``/``raise``, and implicit fall-off-the-end returns.

Design notes:

- Nodes are statements (plus a few synthetic nodes: entry/exit/raises,
  per-``try`` except-dispatch, per-``finally`` copies, per-loop break
  joins). Three fixed nodes exist in every graph: ``ENTRY`` (0), ``EXIT``
  (1, normal return) and ``RAISES`` (2, unhandled-exception exit).
- ``finally`` bodies are *duplicated per exit kind* (normal, exception,
  return, break, continue — at most five copies), the classic lowering:
  every abrupt exit that crosses a ``finally`` flows through its own copy
  of the suite and then continues outward. This keeps path-sensitive
  analyses exact: "the release lives in the ``finally``" really does
  discharge every path.
- Exception edges (``kind == "exc"``) are created for every statement
  that *syntactically could* raise: ``raise``, ``assert``, or any
  statement whose own expressions contain a call. Whether a given call
  edge is *live* is a whole-program question (does the resolved callee
  ever raise?), so consumers filter exc edges with their own may-raise
  predicate — the graph stays callgraph-independent and cacheable per
  file. Edges out of synthetic nodes are always live.
- A ``while`` whose test is a truthy constant (``while True``) gets no
  false edge: falling out of an infinite loop is not a real path, and a
  must-release analysis must not report along it.

Everything allocates ids in one deterministic recursive walk: two builds
of the same def produce the same graph.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

ENTRY = 0
EXIT = 1
RAISES = 2

# dangling edge awaiting its destination: (source node id, edge kind)
_Pred = Tuple[int, str]


@dataclass
class Node:
    idx: int
    stmt: Optional[ast.AST]  # the statement (or ExceptHandler); None = synthetic
    label: str               # "stmt" or the synthetic kind
    line: int


@dataclass(frozen=True)
class Edge:
    src: int
    dst: int
    kind: str  # next | true | false | exc | except | back | finally


class CFG:
    """The built graph: nodes, edges, successor/predecessor maps."""

    def __init__(self) -> None:
        self.nodes: List[Node] = []
        self.edges: List[Edge] = []
        self.succ: Dict[int, List[Edge]] = {}
        self.pred: Dict[int, List[Edge]] = {}

    def add_node(self, stmt: Optional[ast.AST], label: str, line: int) -> int:
        idx = len(self.nodes)
        self.nodes.append(Node(idx=idx, stmt=stmt, label=label, line=line))
        return idx

    def add_edge(self, src: int, dst: int, kind: str) -> None:
        e = Edge(src, dst, kind)
        if e in self.succ.get(src, ()):  # identical duplicate: keep one
            return
        self.edges.append(e)
        self.succ.setdefault(src, []).append(e)
        self.pred.setdefault(dst, []).append(e)

    def stmt_nodes(self) -> List[Node]:
        return [n for n in self.nodes if n.stmt is not None]


class _Frame:
    pass


@dataclass
class _LoopFrame(_Frame):
    head: int        # loop test/iter node — `continue` target
    break_join: int  # synthetic join — `break` target


@dataclass
class _TryFrame(_Frame):
    dispatch: int    # synthetic except-dispatch node
    catch_all: bool  # bare except / except (Base)Exception present


@dataclass
class _FinallyFrame(_Frame):
    stmts: List[ast.stmt]
    outer: Tuple[_Frame, ...]  # frame stack outside this finally
    line: int
    copies: Dict[str, int] = field(default_factory=dict)  # exit kind -> entry


def _is_catch_all(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    names = []
    t = handler.type
    if isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    elif isinstance(t, ast.Name):
        names = [t.id]
    return any(n in ("Exception", "BaseException") for n in names)


def _exprs_can_raise(*exprs: Optional[ast.AST]) -> bool:
    """Could evaluating these expressions raise, syntactically? Only calls
    count — attribute/subscript errors are programming bugs outside the
    obligation model, and counting them would drown every path in
    infeasible exception edges."""
    for expr in exprs:
        if expr is None:
            continue
        for n in ast.walk(expr):
            if isinstance(n, ast.Call):
                return True
    return False


def stmt_can_raise(stmt: ast.AST) -> bool:
    """Syntactic may-raise for one statement's OWN expressions (nested
    suites excluded — their statements carry their own edges)."""
    if isinstance(stmt, (ast.Raise, ast.Assert)):
        return True
    if isinstance(stmt, (ast.If, ast.While)):
        return _exprs_can_raise(stmt.test)
    if isinstance(stmt, ast.For):
        return _exprs_can_raise(stmt.iter)
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return _exprs_can_raise(*[item.context_expr for item in stmt.items])
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return False  # definition statements don't run their bodies
    if isinstance(stmt, ast.Try):
        return False  # the suite's statements carry the edges
    return _exprs_can_raise(stmt)


class _CfgAssembly:
    def __init__(self) -> None:
        self.cfg = CFG()
        self.cfg.add_node(None, "entry", 0)
        self.cfg.add_node(None, "exit", 0)
        self.cfg.add_node(None, "raises", 0)

    # -- plumbing -------------------------------------------------------------

    def _connect(self, preds: Sequence[_Pred], dst: int) -> None:
        for src, kind in preds:
            self.cfg.add_edge(src, dst, kind)

    def _synth(self, label: str, line: int) -> int:
        return self.cfg.add_node(None, label, line)

    def _route_event(
        self, src: int, ekind: str, frames: Tuple[_Frame, ...], edge_kind: str
    ) -> None:
        """Route an abrupt-exit event (exc/return/break/continue) from
        ``src`` outward through the frame stack: finallys inline a copy,
        a try with handlers captures exceptions, a loop captures
        break/continue, and whatever escapes reaches EXIT/RAISES."""
        for i in range(len(frames) - 1, -1, -1):
            fr = frames[i]
            if isinstance(fr, _FinallyFrame):
                entry = self._finally_copy(fr, ekind)
                self.cfg.add_edge(src, entry, edge_kind)
                return
            if isinstance(fr, _TryFrame) and ekind == "exc":
                self.cfg.add_edge(src, fr.dispatch, edge_kind)
                return
            if isinstance(fr, _LoopFrame) and ekind in ("break", "continue"):
                dst = fr.break_join if ekind == "break" else fr.head
                self.cfg.add_edge(src, dst, edge_kind)
                return
        self.cfg.add_edge(src, EXIT if ekind == "return" else RAISES, edge_kind)

    def _finally_copy(self, fr: _FinallyFrame, ekind: str) -> int:
        """One copy of the finally suite per pending exit kind; the copy's
        normal completion re-raises the pending event outside this frame."""
        if ekind in fr.copies:
            return fr.copies[ekind]
        entry = self._synth("finally", fr.line)
        fr.copies[ekind] = entry
        outs = self._seq(fr.stmts, [(entry, "finally")], fr.outer)
        for n, k in outs:
            if ekind == "normal":
                # caller threads the normal continuation itself
                fr.copies["normal-outs"] = fr.copies.get("normal-outs", [])  # type: ignore[assignment]
                fr.copies["normal-outs"].append((n, k))  # type: ignore[attr-defined]
            else:
                self._route_event(n, ekind, fr.outer, k)
        return entry

    # -- statement dispatch ---------------------------------------------------

    def _seq(
        self,
        stmts: Sequence[ast.stmt],
        preds: List[_Pred],
        frames: Tuple[_Frame, ...],
    ) -> List[_Pred]:
        for s in stmts:
            if not preds:
                break  # statically unreachable tail (after return/raise)
            preds = self._stmt(s, preds, frames)
        return preds

    def _stmt(
        self, stmt: ast.stmt, preds: List[_Pred], frames: Tuple[_Frame, ...]
    ) -> List[_Pred]:
        node = self.cfg.add_node(stmt, "stmt", getattr(stmt, "lineno", 0))
        self._connect(preds, node)
        if stmt_can_raise(stmt):
            self._route_event(node, "exc", frames, "exc")

        if isinstance(stmt, ast.Return):
            self._route_event(node, "return", frames, "next")
            return []
        if isinstance(stmt, ast.Raise):
            return []  # the exc edge above is the only way out
        if isinstance(stmt, ast.Break):
            self._route_event(node, "break", frames, "next")
            return []
        if isinstance(stmt, ast.Continue):
            self._route_event(node, "continue", frames, "next")
            return []
        if isinstance(stmt, ast.If):
            true_outs = self._seq(stmt.body, [(node, "true")], frames)
            if stmt.orelse:
                false_outs = self._seq(stmt.orelse, [(node, "false")], frames)
            else:
                false_outs = [(node, "false")]
            return true_outs + false_outs
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            return self._loop(stmt, node, frames)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, node, frames)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._seq(stmt.body, [(node, "next")], frames)
        # simple statement (incl. nested def/class, which merely binds)
        return [(node, "next")]

    def _loop(
        self, stmt: ast.stmt, head: int, frames: Tuple[_Frame, ...]
    ) -> List[_Pred]:
        join = self._synth("loop-join", getattr(stmt, "lineno", 0))
        frame = _LoopFrame(head=head, break_join=join)
        body_outs = self._seq(stmt.body, [(head, "true")], frames + (frame,))
        for n, k in body_outs:
            self.cfg.add_edge(n, head, "back")
        outs: List[_Pred] = [(join, "next")]
        infinite = (
            isinstance(stmt, ast.While)
            and isinstance(stmt.test, ast.Constant)
            and bool(stmt.test.value)
        )
        if not infinite:
            exhausted: List[_Pred] = [(head, "false")]
            if stmt.orelse:
                exhausted = self._seq(stmt.orelse, exhausted, frames)
            outs.extend(exhausted)
        return outs

    def _try(
        self, stmt: ast.Try, head: int, frames: Tuple[_Frame, ...]
    ) -> List[_Pred]:
        fin_frame: Optional[_FinallyFrame] = None
        if stmt.finalbody:
            fin_frame = _FinallyFrame(
                stmts=stmt.finalbody, outer=frames, line=stmt.lineno
            )
            frames = frames + (fin_frame,)

        body_frames = frames
        try_frame: Optional[_TryFrame] = None
        if stmt.handlers:
            dispatch = self._synth("except-dispatch", stmt.lineno)
            try_frame = _TryFrame(
                dispatch=dispatch,
                catch_all=any(_is_catch_all(h) for h in stmt.handlers),
            )
            body_frames = frames + (try_frame,)

        outs = self._seq(stmt.body, [(head, "next")], body_frames)
        if stmt.orelse:
            # else runs only after an exception-free body, and its own
            # exceptions are NOT caught by this try's handlers
            outs = self._seq(stmt.orelse, outs, frames)

        if try_frame is not None:
            for h in stmt.handlers:
                hnode = self.cfg.add_node(h, "handler", h.lineno)
                self.cfg.add_edge(try_frame.dispatch, hnode, "except")
                outs.extend(self._seq(h.body, [(hnode, "next")], frames))
            if not try_frame.catch_all:
                # an exception matching no handler keeps propagating
                self._route_event(try_frame.dispatch, "exc", frames, "exc")

        if fin_frame is not None and outs:
            entry = self._finally_copy(fin_frame, "normal")
            self._connect(outs, entry)
            outs = list(fin_frame.copies.get("normal-outs", []))  # type: ignore[arg-type]
        return outs


def build_cfg(func: ast.AST) -> CFG:
    """CFG for one FunctionDef/AsyncFunctionDef body."""
    b = _CfgAssembly()
    outs = b._seq(list(getattr(func, "body", [])), [(ENTRY, "next")], ())
    for n, k in outs:
        b.cfg.add_edge(n, EXIT, k)
    return b.cfg


def cfg_for(model, func: ast.AST) -> CFG:
    """The per-FileModel CFG cache: every v3 rule asking for the same def
    gets the same graph (one build per def per scan)."""
    cache: Dict[int, CFG] = getattr(model, "_graftlint_cfgs", None)
    if cache is None:
        cache = {}
        model._graftlint_cfgs = cache
    key = id(func)
    if key not in cache:
        cache[key] = build_cfg(func)
    return cache[key]
