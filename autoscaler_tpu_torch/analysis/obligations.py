"""GL016 — obligation typestate: every acquire releases on every path.

The lifecycle contracts this codebase runs on were, until now, prose plus
hand-audits: every ``coalescer.submit`` ticket must resolve/fail/abandon
(a hung ticket is the exact bug `_dispatch_batch` hardening fixed by
hand), every ``balancer.pick``/``pick_hedge`` probe slot must reach
``record_response``/``record_failure``/``release`` (the hedge-loser leak
once fixed by hand), every recorder ``begin_tick`` must close with
``end_tick``/``record_tick`` even when the tick crashes, and an arena
lagging-buffer apply must swap or roll back. :data:`OBLIGATION_TABLE`
below is now the machine-readable home of those contracts; this rule
checks them as a path-sensitive must-release property over the per-def
CFG (:mod:`autoscaler_tpu_torch.analysis.cfg`), exception edges included.

Semantics (under-approximate — prove, never guess, the GL007/GL013
posture):

- An obligation attaches where an *acquire* call resolves through the
  PR-19 callgraph to a table entry (``self.coalescer.submit`` resolves
  only when ``self.coalescer = FleetCoalescer(...)`` types the
  attribute). Unresolvable calls attach nothing — a
  ``ThreadPoolExecutor.submit`` can never be mistaken for a fleet
  ticket.
- Value obligations (``ticket = ...submit(r)``) discharge when the value
  is released (a release method called on it, or it is passed to a
  release call), *escapes* (returned, yielded, stored, passed to any
  call — once the value leaves the function, its release is someone
  else's proof), or is proven ``None`` on a branch edge
  (``if t is None: ...``). Receiver obligations (``x.begin_tick()``)
  discharge when the matching close method runs on the same receiver, on
  a matching ``self.*`` store for table entries released by assignment
  (the arena's swap/rollback counters), or via an *interprocedural
  release summary*: a ``self.helper()`` whose every path — exception
  paths included — performs the release discharges the caller.
- Exception edges are live only where the analysis can PROVE a raise:
  an explicit ``raise``, or a call whose resolved callee transitively
  contains an unguarded ``raise`` (guarded = inside that def's own
  catch-all ``try``). Unresolved calls and ``assert`` statements are
  treated as non-raising — missing a real leak is acceptable, inventing
  one is not.
- ``try/finally`` needs no special casing: the CFG duplicates the
  ``finally`` suite onto every exit path, so a release there discharges
  structurally. A ``with`` consuming the acquire expression never binds
  a value, so nothing is tracked — the context manager is the witness.

Findings carry the leaking path as a FlowStep witness chain
(``file:line`` hops), rendered by SARIF as codeFlows and by
``--format github`` as annotation trails.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from autoscaler_tpu_torch.analysis.cfg import (
    ENTRY,
    EXIT,
    RAISES,
    CFG,
    cfg_for,
)
from autoscaler_tpu_torch.analysis.engine import (
    FileModel,
    Finding,
    FlowStep,
    self_attr,
    terminal_name,
)

RULE = "GL016"


@dataclass(frozen=True)
class ObligationSpec:
    """One row of the lifecycle-contract table."""

    key: str                       # short id, stable across releases
    what: str                      # human noun for messages
    mode: str                      # "value" | "receiver"
    acquire: Tuple[str, ...]       # resolved-fq SUFFIX matches
    release_on_value: Tuple[str, ...] = ()  # methods on the value/receiver
    release_as_arg: Tuple[str, ...] = ()    # calls taking the value as arg
    release_attr_stores: Tuple[str, ...] = ()  # self.<attr> stores (receiver)
    release_desc: str = ""         # human description of the discharge set


# THE machine-readable home of the ticket/probe/tick-record/span/arena
# lifecycle contracts (RULES.md documents each row's provenance). Acquire
# entries are fq suffixes so the same contract binds fixtures and the
# real tree; release entries are method names because releases must keep
# discharging even where the receiver's type cannot be resolved
# (over-killing under-reports — the safe direction).
OBLIGATION_TABLE: Tuple[ObligationSpec, ...] = (
    ObligationSpec(
        key="ticket",
        what="fleet ticket",
        mode="value",
        acquire=(".FleetCoalescer.submit",),
        release_on_value=("resolve", "fail", "abandon", "result", "cancel"),
        release_desc="resolve/fail/abandon (result() counts: it raises or returns the outcome)",
    ),
    ObligationSpec(
        key="probe",
        what="balancer probe slot",
        mode="value",
        acquire=(".EndpointBalancer.pick", ".EndpointBalancer.pick_hedge"),
        release_as_arg=(
            "record_response",
            "record_success",
            "record_failure",
            "release",
        ),
        release_desc="record_response/record_success/record_failure/release",
    ),
    ObligationSpec(
        key="tick-record",
        what="open tick record",
        mode="receiver",
        acquire=(
            ".PerfObservatory.begin_tick",
            ".DecisionExplainer.begin_tick",
            ".JournalRecorder.begin_tick",
        ),
        release_on_value=("end_tick", "record_tick"),
        release_desc="end_tick/record_tick on the same recorder",
    ),
    ObligationSpec(
        key="span",
        what="span",
        mode="value",
        acquire=(".Tracer.span", ".Tracer.tick"),
        release_on_value=("__exit__", "end", "finish"),
        release_desc="entering it as a context manager (or an explicit close)",
    ),
    ObligationSpec(
        key="arena-swap",
        what="arena lagging-buffer apply",
        mode="receiver",
        acquire=(".DeviceArena._seed_locked", ".DeviceArena._scatter_locked"),
        release_attr_stores=("_live", "_stats"),
        release_desc="the swap (`self._live = target`) or a rollback accounting store",
    ),
)

# terminal method names worth building a CFG for — cheap pre-filter
_ACQUIRE_NAMES = frozenset(
    suffix.rsplit(".", 1)[-1] for spec in OBLIGATION_TABLE for suffix in spec.acquire
)
_RELEASE_NAMES = frozenset(
    name
    for spec in OBLIGATION_TABLE
    for name in (spec.release_on_value + spec.release_as_arg)
)


@dataclass
class _Obl:
    """One tracked obligation instance inside one def."""

    spec: ObligationSpec
    node: int                 # CFG node of the acquire (ENTRY for summaries)
    line: int
    var: Optional[str]        # value mode: the bound name
    recv: Optional[str]       # receiver mode: source text of the receiver
    call_text: str


_SUITE_FIELDS = {"body", "orelse", "finalbody", "handlers"}


def _own_exprs(stmt: ast.AST) -> List[ast.expr]:
    """Load-side expressions evaluated BY this statement itself (nested
    suites excluded — their statements are their own CFG nodes)."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in stmt.items]
    out: List[ast.expr] = []
    for name, value in ast.iter_fields(stmt):
        if name in _SUITE_FIELDS or name in ("target", "targets"):
            continue
        if isinstance(value, ast.expr):
            out.append(value)
        elif isinstance(value, list):
            out.extend(v for v in value if isinstance(v, ast.expr))
    return out


def _store_targets(stmt: ast.AST) -> List[ast.expr]:
    if isinstance(stmt, ast.Assign):
        return list(stmt.targets)
    if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        return [stmt.target]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.target]
    if isinstance(stmt, ast.Delete):
        return list(stmt.targets)
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.optional_vars for i in stmt.items if i.optional_vars is not None]
    return []


def _names_in(exprs: Sequence[ast.AST]) -> Set[str]:
    out: Set[str] = set()
    for e in exprs:
        for n in ast.walk(e):
            if isinstance(n, ast.Name):
                out.add(n.id)
    return out


def _calls_in(exprs: Sequence[ast.AST]) -> List[ast.Call]:
    out: List[ast.Call] = []
    for e in exprs:
        for n in ast.walk(e):
            if isinstance(n, ast.Call):
                out.append(n)
    return out


def _none_kills(test: ast.expr, branch: str) -> Set[str]:
    """Variables PROVEN None when this branch edge is taken — only the
    simple witness shapes count (`v is None`, `v is not None`, `not v`,
    bare `v`); compound conditions prove nothing."""
    if (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.left, ast.Name)
        and len(test.comparators) == 1
        and isinstance(test.comparators[0], ast.Constant)
        and test.comparators[0].value is None
    ):
        if isinstance(test.ops[0], ast.Is) and branch == "true":
            return {test.left.id}
        if isinstance(test.ops[0], ast.IsNot) and branch == "false":
            return {test.left.id}
        return set()
    if (
        isinstance(test, ast.UnaryOp)
        and isinstance(test.op, ast.Not)
        and isinstance(test.operand, ast.Name)
        and branch == "true"
    ):
        return {test.operand.id}
    if isinstance(test, ast.Name) and branch == "false":
        return {test.id}
    return set()


def _src_snippet(model: FileModel, line: int, limit: int = 72) -> str:
    text = model.lines[line - 1].strip() if 0 < line <= len(model.lines) else ""
    return text if len(text) <= limit else text[: limit - 1] + "…"


class _MayRaise:
    """Which definitions can raise, transitively. A def raises if it has
    an unguarded ``raise`` (guarded = under its own catch-all try), or an
    unguarded call to a def that raises. Unresolved callees are assumed
    non-raising (under-approximation)."""

    def __init__(self, graph) -> None:
        self.graph = graph
        self._raising: Set[str] = set()
        self._local_types: Dict[str, Dict[str, str]] = {}
        self._compute()

    def local_types(self, info) -> Dict[str, str]:
        cached = self._local_types.get(info.fq)
        if cached is None:
            if isinstance(info.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cached = self.graph._local_instance_types(info.model, info.node)
            else:
                cached = {}
            self._local_types[info.fq] = cached
        return cached

    def _catch_all(self, try_stmt: ast.Try) -> bool:
        from autoscaler_tpu_torch.analysis.cfg import _is_catch_all

        return any(_is_catch_all(h) for h in try_stmt.handlers)

    def _compute(self) -> None:
        unprotected_calls: Dict[str, Set[str]] = {}
        for fq in sorted(self.graph.defs):
            info = self.graph.defs[fq]
            if not isinstance(info.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            callees: Set[str] = set()
            ltypes = self.local_types(info)

            def scan(stmts: Sequence[ast.stmt], protected: bool) -> None:
                for s in stmts:
                    if isinstance(
                        s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                    ):
                        continue
                    if isinstance(s, ast.Raise) and not protected:
                        self._raising.add(fq)
                    if not protected:
                        for call in _calls_in(_own_exprs(s)):
                            target = self.graph.resolve(
                                info.model, call.func, info.cls, local_types=ltypes
                            )
                            if target is not None and target != fq:
                                callees.add(target)
                    if isinstance(s, ast.Try):
                        scan(s.body, protected or self._catch_all(s))
                        for h in s.handlers:
                            scan(h.body, protected)
                        scan(s.orelse, protected)
                        scan(s.finalbody, protected)
                    elif isinstance(
                        s, (ast.If, ast.While, ast.For, ast.AsyncFor)
                    ):
                        scan(s.body, protected)
                        scan(s.orelse, protected)
                    elif isinstance(s, (ast.With, ast.AsyncWith)):
                        scan(s.body, protected)

            scan(info.node.body, False)
            if callees:
                unprotected_calls[fq] = callees

        changed = True
        while changed:
            changed = False
            for fq in sorted(unprotected_calls):
                if fq in self._raising:
                    continue
                if unprotected_calls[fq] & self._raising:
                    self._raising.add(fq)
                    changed = True

    def stmt_raises(self, info, ltypes: Dict[str, str], stmt: ast.AST) -> bool:
        """Is this statement's exception edge LIVE? Explicit raise, or an
        own-expression call into transitively-raising code. Asserts are
        invariant checks, not designed exception paths — excluded."""
        if isinstance(stmt, ast.Raise):
            return True
        if isinstance(stmt, ast.Assert):
            return False
        for call in _calls_in(_own_exprs(stmt)):
            target = self.graph.resolve(
                info.model, call.func, info.cls, local_types=ltypes
            )
            if target is not None and target in self._raising:
                return True
        return False


class ObligationChecker:
    """GL016: CFG must-release typestate over :data:`OBLIGATION_TABLE`."""

    rule_id = RULE
    title = "obligation typestate (acquire must release on all paths)"

    def check_program(self, graph) -> List[Finding]:
        may = _MayRaise(graph)
        self._may = may
        self._summaries: Dict[str, FrozenSet[Tuple[str, str]]] = {}
        self._in_progress: Set[str] = set()
        findings: List[Finding] = []
        for model in graph.models:
            for info in graph.defs_in_module(model):
                if not isinstance(
                    info.node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                findings.extend(self._check_def(graph, may, info))
        return findings

    # -- acquisition discovery ------------------------------------------------

    def _acquire_spec(self, graph, info, ltypes, call) -> Optional[ObligationSpec]:
        name = terminal_name(call.func)
        if name not in _ACQUIRE_NAMES:
            return None
        target = graph.resolve(info.model, call.func, info.cls, local_types=ltypes)
        if target is None:
            return None
        for spec in OBLIGATION_TABLE:
            if any(target.endswith(suffix) for suffix in spec.acquire):
                return spec
        return None

    def _find_obligations(
        self, graph, info, ltypes, cfg: CFG
    ) -> Tuple[List[_Obl], List[Finding]]:
        obls: List[_Obl] = []
        discarded: List[Finding] = []
        for node in cfg.stmt_nodes():
            stmt = node.stmt
            if isinstance(stmt, ast.ExceptHandler):
                continue
            for call in _calls_in(_own_exprs(stmt)):
                spec = self._acquire_spec(graph, info, ltypes, call)
                if spec is None:
                    continue
                call_text = ast.unparse(call.func)
                if spec.mode == "receiver":
                    recv = (
                        ast.unparse(call.func.value)
                        if isinstance(call.func, ast.Attribute)
                        else "<module>"
                    )
                    obls.append(
                        _Obl(
                            spec=spec,
                            node=node.idx,
                            line=node.line,
                            var=None,
                            recv=recv,
                            call_text=call_text,
                        )
                    )
                elif (
                    isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.value is call
                ):
                    obls.append(
                        _Obl(
                            spec=spec,
                            node=node.idx,
                            line=node.line,
                            var=stmt.targets[0].id,
                            recv=None,
                            call_text=call_text,
                        )
                    )
                elif isinstance(stmt, ast.Expr) and stmt.value is call:
                    discarded.append(
                        info.model.finding(
                            stmt,
                            RULE,
                            f"{spec.what} from `{call_text}(...)` in "
                            f"{info.local} is discarded — bind the result "
                            f"and discharge it ({spec.release_desc})",
                            flow=(
                                (
                                    info.model.path,
                                    node.line,
                                    f"{spec.what} acquired and dropped: "
                                    f"`{_src_snippet(info.model, node.line)}`",
                                ),
                            ),
                        )
                    )
                # any other shape consumes the value in-expression: it
                # escapes into the surrounding call/return/container and
                # its discharge is the consumer's proof
        return obls, discarded

    # -- transfer functions ---------------------------------------------------

    def _node_kills(
        self, graph, info, ltypes, obls: List[_Obl], stmt: ast.AST
    ) -> Set[int]:
        killed: Set[int] = set()
        exprs = _own_exprs(stmt)
        calls = _calls_in(exprs)
        stores = _store_targets(stmt)
        store_names = _names_in(stores)
        store_attrs = {a for a in (self_attr(t) for t in stores) if a is not None}
        head = isinstance(
            stmt, (ast.If, ast.While, ast.For, ast.AsyncFor)
        )
        summary: Optional[FrozenSet[Tuple[str, str]]] = None
        for call in calls:
            # interprocedural: self.helper() whose every path releases
            if (
                isinstance(call.func, ast.Attribute)
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id == "self"
            ):
                target = graph.resolve(
                    info.model, call.func, info.cls, local_types=ltypes
                )
                if target is not None:
                    got = self._summary(graph, target)
                    if got:
                        summary = (summary or frozenset()) | got

        for i, obl in enumerate(obls):
            if obl.spec.mode == "receiver":
                for call in calls:
                    if (
                        isinstance(call.func, ast.Attribute)
                        and call.func.attr in obl.spec.release_on_value
                        and ast.unparse(call.func.value) == obl.recv
                    ):
                        killed.add(i)
                if obl.spec.release_attr_stores and obl.recv == "self":
                    if store_attrs & set(obl.spec.release_attr_stores):
                        killed.add(i)
                if summary and (obl.spec.key, obl.recv) in summary:
                    killed.add(i)
                continue
            var = obl.var
            if var is None:
                continue
            if var in store_names:
                killed.add(i)  # rebound/deleted: the old binding is gone
                continue
            released = False
            escaped = False
            for call in calls:
                if (
                    isinstance(call.func, ast.Attribute)
                    and isinstance(call.func.value, ast.Name)
                    and call.func.value.id == var
                ):
                    if call.func.attr in obl.spec.release_on_value:
                        released = True
                    else:
                        escaped = True  # some other use — handed off
                    continue
                args = list(call.args) + [kw.value for kw in call.keywords]
                if var in _names_in(args):
                    if terminal_name(call.func) in obl.spec.release_as_arg:
                        released = True
                    else:
                        escaped = True
            if released or escaped:
                killed.add(i)
                continue
            if not head and var in _names_in(exprs):
                # returned / yielded / stored / raised / container-packed:
                # the value left this frame — its discharge is the
                # consumer's obligation now
                killed.add(i)
        return killed

    # -- the dataflow ---------------------------------------------------------

    def _run(
        self,
        graph,
        may: _MayRaise,
        info,
        cfg: CFG,
        obls: List[_Obl],
        inject: FrozenSet[int],
    ) -> Dict[object, FrozenSet[int]]:
        """Forward may-be-outstanding analysis. Returns edge -> state."""
        ltypes = may.local_types(info)
        acquires: Dict[int, Set[int]] = {}
        for i, obl in enumerate(obls):
            if obl.node != ENTRY:
                acquires.setdefault(obl.node, set()).add(i)

        kills_cache: Dict[int, Set[int]] = {}
        raises_cache: Dict[int, bool] = {}

        def node_kills(idx: int) -> Set[int]:
            if idx not in kills_cache:
                node = cfg.nodes[idx]
                if node.stmt is None or isinstance(node.stmt, ast.ExceptHandler):
                    kills_cache[idx] = set()
                else:
                    kills_cache[idx] = self._node_kills(
                        graph, info, ltypes, obls, node.stmt
                    )
            return kills_cache[idx]

        def exc_live(idx: int) -> bool:
            if idx not in raises_cache:
                node = cfg.nodes[idx]
                if node.stmt is None:
                    raises_cache[idx] = True  # synthetic: always live
                elif isinstance(node.stmt, ast.ExceptHandler):
                    raises_cache[idx] = True
                else:
                    raises_cache[idx] = may.stmt_raises(info, ltypes, node.stmt)
            return raises_cache[idx]

        states: Dict[object, FrozenSet[int]] = {}
        empty: FrozenSet[int] = frozenset()
        work = [ENTRY]
        seen_entry_init = inject
        while work:
            idx = work.pop()
            if idx == ENTRY:
                in_state = seen_entry_init
            else:
                in_state = empty
                for e in cfg.pred.get(idx, ()):
                    in_state = in_state | states.get(e, empty)
            node = cfg.nodes[idx]
            out_base = in_state - node_kills(idx) if node.stmt is not None else in_state
            acq = acquires.get(idx, set())
            for e in cfg.succ.get(idx, ()):
                if e.kind == "exc" and not exc_live(idx):
                    continue
                out = out_base | (acq if e.kind != "exc" else set())
                if e.kind in ("true", "false") and node.stmt is not None:
                    test = getattr(node.stmt, "test", None)
                    if test is not None:
                        dead = _none_kills(test, e.kind)
                        if dead:
                            out = frozenset(
                                i
                                for i in out
                                if obls[i].var is None or obls[i].var not in dead
                            )
                out = frozenset(out)
                if states.get(e, None) != out | states.get(e, empty):
                    states[e] = out | states.get(e, empty)
                    work.append(e.dst)
        return states

    # -- release summaries ----------------------------------------------------

    def _summary(self, graph, fq: str) -> FrozenSet[Tuple[str, str]]:
        """(key, receiver) pairs this def releases on EVERY path — normal
        and exception exits both. Only then may a caller discharge on the
        call's every out-edge."""
        if fq in self._summaries:
            return self._summaries[fq]
        if fq in self._in_progress:
            return frozenset()
        self._in_progress.add(fq)
        try:
            result = self._compute_summary(graph, fq)
        finally:
            self._in_progress.discard(fq)
        self._summaries[fq] = result
        return result

    def _compute_summary(self, graph, fq: str) -> FrozenSet[Tuple[str, str]]:
        info = graph.defs.get(fq)
        if info is None or not isinstance(
            info.node, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            return frozenset()
        candidates: List[Tuple[ObligationSpec, str]] = []
        for n in ast.walk(info.node):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
                recv_text = ast.unparse(n.func.value)
                if not recv_text.startswith("self"):
                    continue
                for spec in OBLIGATION_TABLE:
                    if spec.mode == "receiver" and n.func.attr in spec.release_on_value:
                        candidates.append((spec, recv_text))
            elif isinstance(n, (ast.Assign, ast.AugAssign)):
                for t in _store_targets(n):
                    attr = self_attr(t)
                    if attr is None:
                        continue
                    for spec in OBLIGATION_TABLE:
                        if spec.mode == "receiver" and attr in spec.release_attr_stores:
                            candidates.append((spec, "self"))
        if not candidates:
            return frozenset()
        # dedupe, deterministic order
        uniq = sorted({(spec.key, recv) for spec, recv in candidates})
        spec_by_key = {spec.key: spec for spec in OBLIGATION_TABLE}
        may = self._may  # graph-wide instance; a fresh pass per summary would be quadratic
        obls = [
            _Obl(
                spec=spec_by_key[key],
                node=ENTRY,
                line=info.node.lineno,
                var=None,
                recv=recv,
                call_text="<summary>",
            )
            for key, recv in uniq
        ]
        cfg = cfg_for(info.model, info.node)
        states = self._run(
            graph, may, info, cfg, obls, inject=frozenset(range(len(obls)))
        )
        released: Set[Tuple[str, str]] = set()
        empty: FrozenSet[int] = frozenset()
        for i, (key, recv) in enumerate(uniq):
            outstanding = False
            for exit_idx in (EXIT, RAISES):
                for e in cfg.pred.get(exit_idx, ()):
                    if i in states.get(e, empty):
                        outstanding = True
            if not outstanding:
                released.add((key, recv))
        return frozenset(released)

    # -- per-def check --------------------------------------------------------

    def _check_def(self, graph, may: _MayRaise, info) -> List[Finding]:
        # cheap pre-filter: no acquire method name in the body, no CFG
        src_names = {
            n.attr
            for n in ast.walk(info.node)
            if isinstance(n, ast.Attribute)
        }
        if not (src_names & _ACQUIRE_NAMES):
            return []
        ltypes = may.local_types(info)
        cfg = cfg_for(info.model, info.node)
        obls, findings = self._find_obligations(graph, info, ltypes, cfg)
        if not obls:
            return findings
        states = self._run(graph, may, info, cfg, obls, inject=frozenset())
        empty: FrozenSet[int] = frozenset()
        for i, obl in enumerate(obls):
            leaks_at: Optional[int] = None
            for exit_idx in (EXIT, RAISES):
                if any(
                    i in states.get(e, empty)
                    for e in cfg.pred.get(exit_idx, ())
                ):
                    leaks_at = exit_idx
                    break
            if leaks_at is None:
                continue
            flow = self._witness(info.model, cfg, states, obl, i, leaks_at)
            exit_desc = (
                "the function exit" if leaks_at == EXIT else "the exception exit"
            )
            findings.append(
                Finding(
                    path=info.model.path,
                    line=obl.line,
                    rule=RULE,
                    message=(
                        f"{obl.spec.what} acquired by `{obl.call_text}(...)` "
                        f"in {info.local} can reach {exit_desc} without "
                        f"{obl.spec.release_desc} — obligations must "
                        f"discharge on every path (see the witness path; "
                        f"try/finally and releasing handlers both count)"
                    ),
                    flow=flow,
                )
            )
        return findings

    def _witness(
        self,
        model: FileModel,
        cfg: CFG,
        states: Dict[object, FrozenSet[int]],
        obl: _Obl,
        i: int,
        exit_idx: int,
    ) -> Tuple[FlowStep, ...]:
        """Shortest obligation-carrying path acquire -> exit, folded to
        the interesting hops (branches, exception edges, handlers)."""
        empty: FrozenSet[int] = frozenset()
        from collections import deque

        start = obl.node
        prev: Dict[int, Tuple[int, str]] = {}
        q = deque([start])
        seen = {start}
        while q:
            cur = q.popleft()
            if cur == exit_idx:
                break
            for e in cfg.succ.get(cur, ()):
                if i not in states.get(e, empty):
                    continue
                if e.dst in seen:
                    continue
                seen.add(e.dst)
                prev[e.dst] = (cur, e.kind)
                q.append(e.dst)
        steps: List[FlowStep] = [
            (
                model.path,
                obl.line,
                f"{obl.spec.what} acquired: `{_src_snippet(model, obl.line)}`",
            )
        ]
        if exit_idx in prev or exit_idx == start:
            path: List[Tuple[int, int, str]] = []  # (src, dst, kind)
            cur = exit_idx
            while cur != start and cur in prev:
                parent, kind = prev[cur]
                path.append((parent, cur, kind))
                cur = parent
            path.reverse()
            last_line = obl.line
            for src_idx, dst_idx, kind in path:
                src = cfg.nodes[src_idx]
                dst = cfg.nodes[dst_idx]
                if src.line:
                    last_line = src.line
                if kind == "exc":
                    steps.append(
                        (
                            model.path,
                            last_line,
                            "exception path — the release below is skipped: "
                            f"`{_src_snippet(model, last_line)}`",
                        )
                    )
                elif kind in ("true", "false") and src.stmt is not None:
                    steps.append(
                        (
                            model.path,
                            src.line,
                            f"branch `{_src_snippet(model, src.line)}` "
                            f"takes its {kind} edge",
                        )
                    )
                elif kind == "except" and dst.line:
                    steps.append(
                        (
                            model.path,
                            dst.line,
                            f"handler entered: `{_src_snippet(model, dst.line)}`",
                        )
                    )
                if dst.line:
                    last_line = dst.line
            exit_note = (
                "function exit reached with the obligation outstanding"
                if exit_idx == EXIT
                else "exception leaves the function with the obligation outstanding"
            )
            steps.append((model.path, last_line, exit_note))
        if len(steps) > 10:  # keep SARIF codeFlows readable
            steps = steps[:5] + steps[-5:]
        return tuple(steps)
