"""GL013 — interprocedural determinism taint over the call graph.

The one real determinism bug this codebase has shipped (scale-down
planning iterated a ``set`` of empty-node names, so WHICH empty nodes died
depended on PYTHONHASHSEED) was caught *dynamically*, by a cross-process
ledger diff. GL001 could not see it (no banned call), and GL010's
value-flow stops where method dispatch or module boundaries hide the
walk. GL013 proves that bug class statically: an interprocedural taint
pass over the (now instance-typed) ``CallGraph`` whose findings name the
FULL source → sink witness path, ``file:line`` per hop — the path is also
attached to the finding as structured ``flow`` steps so SARIF output can
render it as a ``codeFlow``.

The model (tables below; RULES.md documents each):

- **Sources** — nondeterminism producers:
  iteration order of ``set``/``frozenset`` values *realized into ordered
  output* (``for``, ``list()``, ``join``, f-strings, comprehensions);
  iteration order of dicts *built by walking a set* (``{k: v for k in s}``,
  ``dict.fromkeys(s)``) — a dict keyed in nondeterministic order re-emits
  that order forever; thread-completion order
  (``concurrent.futures.as_completed``/``wait`` — the shape the
  ``parallel``/actuator fan-outs ride); ``id()`` (address-dependent) and
  ``hash()`` of non-int operands (PYTHONHASHSEED-dependent); and every
  ambient clock/rng/env call in the shared GL001 table
  (``classify_source_call`` — one classifier, three rules, zero drift).
- **Sinks** — the ledger chokes: ``record_line``/``stable_json``/
  ``dump_jsonl`` (the perf/explain/journal/gym writer quartet) and
  ``json.dumps``/``json.dump`` — anything emitting schema'd JSONL.
- **Sanitizers** — ``sorted()`` kills order taint at the source (element
  taints survive: ``sorted()`` of wall-clock stamps is still wall clock);
  the order-insensitive reductions (``len``/``min``/``max``/``sum``/
  ``any``/``all``); the injected-clock seam (``timeline_now``); and the
  pragma surface — ``# graftlint: disable=GL013 — reason`` on the source
  line declassifies, on the sink line suppresses (reason mandatory,
  GL000).

Like GL010 the pass under-approximates: unordered-ness must hold on every
branch, unknown calls produce no taint, rebinding kills. Taint trails
merge may-union. Interprocedural reach rides per-function summaries
(return trails, param→return, param→sink step chains) iterated to a
bounded fixpoint in deterministic order over the call graph — including
the constructor / ``self._attr.meth()`` / local-instance edges callgraph
v2 resolves, which is what lets a planner-walk taint cross into the
actuator and down to a ledger writer two modules away.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from autoscaler_tpu_torch.analysis.callgraph import MODULE_NODE, CallGraph, dotted_module
from autoscaler_tpu_torch.analysis.dataflow import (
    SET_ORDER,
    classify_source_call,
    in_replay_scope,
)
from autoscaler_tpu_torch.analysis.engine import (
    FileModel,
    Finding,
    FlowStep,
    parse_pragmas,
    suppressed_at,
    terminal_name,
)

RULE_ID = "GL013"

# -- taint-kind vocabulary (SET_ORDER shared with GL010/the sanitizer) --------
DICT_ORDER = "dict-iteration-order"
THREAD_ORDER = "thread-completion-order"
IDENTITY = "object-identity"

# unordered-collection provenance -> realized taint kind
_ORDER_KIND = {"set": SET_ORDER, "dict": DICT_ORDER, "thread": THREAD_ORDER}

# -- source tables ------------------------------------------------------------
# thread-completion order: the iteration order of as_completed()/the done
# set of wait() is scheduler-dependent — never ledger-stable
THREAD_ORDER_CALLS = {
    "concurrent.futures.as_completed",
    "concurrent.futures.wait",
    "as_completed",
    "wait",
}
# set-returning methods on a set receiver (order stays nondeterministic)
_SET_METHODS = {
    "union", "difference", "intersection", "symmetric_difference", "copy",
}

# -- sink tables --------------------------------------------------------------
# the ledger chokes: every schema'd JSONL byte rides one of these
SINK_NAMES = {"record_line", "stable_json", "dump_jsonl"}
SINK_CALLS = {"json.dumps", "json.dump"}

# -- sanitizer tables ---------------------------------------------------------
ORDER_SANITIZERS = {"sorted", "len", "min", "max", "sum", "any", "all"}
SEAM_CALLS = {"timeline_now"}
_TRANSPARENT = {
    "str", "repr", "format", "int", "float", "bool", "round", "abs",
    "list", "tuple", "dict", "zip", "enumerate", "reversed", "iter",
    "next", "map", "filter",
}
_REALIZERS = {"list", "tuple", "zip", "enumerate", "reversed", "iter", "map", "filter"}
_MUTATORS = {"append", "add", "update", "extend", "insert", "setdefault", "appendleft"}
_READERS = {"get", "copy", "pop", "popitem"}


@dataclass(frozen=True)
class Trail:
    """One taint provenance: kind plus the witness steps walked so far
    (first step = the source site)."""

    kind: str
    steps: Tuple[FlowStep, ...]

    def extended(self, step: FlowStep) -> "Trail":
        if len(self.steps) >= 8 or (self.steps and self.steps[-1] == step):
            return self
        return Trail(self.kind, self.steps + (step,))

    def sort_key(self):
        return (self.kind, self.steps)


@dataclass(frozen=True)
class TVal:
    """Abstract value: taint trails ∪ unordered-collection provenance.
    ``unordered`` ('' | 'set' | 'dict' | 'thread') means *provably* an
    unordered collection on every path; ``born`` is where it was built;
    ``carries`` marks a container provably holding one."""

    trails: FrozenSet[Trail] = frozenset()
    unordered: str = ""
    born: Optional[FlowStep] = None
    carries: bool = False

    def merged(self, other: "TVal") -> "TVal":
        # trails may-union; unordered-ness must-intersect (never guess)
        same = self.unordered if self.unordered == other.unordered else ""
        return TVal(
            self.trails | other.trails,
            same,
            self.born if same else None,
            self.carries and other.carries,
        )


CLEAN = TVal()


def _union_trails(vals: Iterable[TVal]) -> FrozenSet[Trail]:
    out: Set[Trail] = set()
    for v in vals:
        out |= v.trails
    return frozenset(out)


@dataclass
class TSummary:
    """Interprocedural facts for one definition."""

    return_trails: FrozenSet[Trail] = frozenset()
    return_unordered: str = ""
    return_carries: bool = False
    param_to_return: FrozenSet[int] = frozenset()
    # param index -> witness steps from the callee's boundary to the sink
    param_sinks: Tuple[Tuple[int, Tuple[FlowStep, ...]], ...] = ()

    def key(self):
        return (
            self.return_trails, self.return_unordered, self.return_carries,
            self.param_to_return, self.param_sinks,
        )


def _param_names(fn: ast.AST) -> List[str]:
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args)]


class _TaintInterp:
    """One pass of the GL013 abstract interpreter over one definition."""

    def __init__(
        self,
        graph: CallGraph,
        model: FileModel,
        fq: str,
        fn: ast.AST,
        summaries: Dict[str, TSummary],
        pragmas: Dict[int, Set[str]],
        collect: Optional[List[Finding]] = None,
    ):
        self.graph = graph
        self.model = model
        self.fq = fq
        self.fn = fn
        self.summaries = summaries
        self.pragmas = pragmas
        self.collect = collect
        self.env: Dict[str, TVal] = {}
        self.params = _param_names(fn)
        self.param_index = {p: i for i, p in enumerate(self.params)}
        self.param_flows: Dict[str, Set[int]] = {
            p: {i} for p, i in self.param_index.items()
        }
        self.return_val = CLEAN
        self.return_params: Set[int] = set()
        self.param_sinks: Dict[int, Tuple[FlowStep, ...]] = {}
        info = graph.defs.get(fq)
        self.enclosing_class = info.cls if info is not None else None
        self.local_types = (
            graph._local_instance_types(model, fn)
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            else {}
        )
        self.local_name = getattr(fn, "name", MODULE_NODE)

    # -- driving --------------------------------------------------------------

    def run(self) -> TSummary:
        body = getattr(self.fn, "body", [])
        for stmt in body:
            self._stmt(stmt)
        if any(
            v.trails or v.unordered or v.carries for v in self.env.values()
        ):
            for stmt in body:  # loop-carried facts settle on pass two
                self._stmt(stmt)
        return TSummary(
            return_trails=self.return_val.trails,
            return_unordered=self.return_val.unordered,
            return_carries=self.return_val.carries,
            param_to_return=frozenset(self.return_params),
            param_sinks=tuple(sorted(self.param_sinks.items())),
        )

    # -- helpers --------------------------------------------------------------

    def _suppressed(self, line: int) -> bool:
        return suppressed_at(line, {RULE_ID}, self.pragmas, self.model.lines)

    def _step(self, node: ast.AST, note: str) -> FlowStep:
        return (self.model.path, getattr(node, "lineno", 1), note)

    def _source(self, node: ast.AST, kind: str, note: str) -> TVal:
        if not in_replay_scope(self.model) or self._suppressed(
            getattr(node, "lineno", 1)
        ):
            return CLEAN
        return TVal(trails=frozenset({Trail(kind, (self._step(node, note),))}))

    def _realize(self, node: ast.AST, val: TVal, how: str) -> FrozenSet[Trail]:
        """Iterating/rendering an unordered collection realizes its order
        into ordered output — the PR-12 bug class. Returns the trails the
        realized elements carry."""
        if not val.unordered:
            return val.trails
        if not in_replay_scope(self.model) or self._suppressed(
            getattr(node, "lineno", 1)
        ):
            return val.trails
        kind = _ORDER_KIND[val.unordered]
        note = f"{how} realizes {kind}"
        if val.born is not None and val.born != (
            self.model.path, getattr(node, "lineno", 1), note
        ):
            trail = Trail(kind, (val.born, self._step(node, note)))
        else:
            trail = Trail(kind, (self._step(node, note),))
        return val.trails | {trail}

    def _emit(self, node: ast.AST, val: TVal, sink_step: FlowStep) -> None:
        if self.collect is None or self._suppressed(getattr(node, "lineno", 1)):
            return
        trails = set(val.trails)
        if val.unordered:
            # a raw unordered collection handed straight to the ledger
            trails |= self._realize(
                node,
                TVal(frozenset(), val.unordered, val.born),
                "ledger serialization",
            )
        for trail in sorted(trails, key=Trail.sort_key):
            steps = trail.steps + (sink_step,)
            rendered = " -> ".join(f"{n} [{p}:{ln}]" for p, ln, n in steps)
            self.collect.append(
                self.model.finding(
                    node,
                    RULE_ID,
                    f"{trail.kind} reaches a ledger sink: {rendered} — "
                    "sorted() the collection at the source, route scalars "
                    "through an injected seam, or pragma this sink line "
                    "with a reason",
                    flow=steps,
                )
            )

    def _params_of(self, node: ast.AST) -> Set[int]:
        out: Set[int] = set()
        for child in ast.walk(node):
            if isinstance(child, ast.Name) and child.id in self.param_index:
                flows = self.param_flows.get(child.id)
                if flows is not None and self.param_index[child.id] in flows:
                    out.add(self.param_index[child.id])
        return out

    # -- statements -----------------------------------------------------------

    def _stmt(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(node, ast.Assign):
            val = self._eval(node.value)
            for tgt in node.targets:
                self._assign(tgt, val, node.value)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._assign(node.target, self._eval(node.value), node.value)
        elif isinstance(node, ast.AugAssign):
            val = self._eval(node.value)
            if isinstance(node.target, ast.Name):
                cur = self.env.get(node.target.id, CLEAN)
                self.env[node.target.id] = TVal(
                    cur.trails | val.trails,
                    cur.unordered,
                    cur.born,
                    cur.carries or bool(val.unordered) or val.carries,
                )
        elif isinstance(node, ast.Return):
            if node.value is not None:
                val = self._eval(node.value)
                merged_unordered = (
                    val.unordered
                    if not self.return_val.trails
                    and not self.return_val.unordered
                    else (
                        self.return_val.unordered
                        if self.return_val.unordered == val.unordered
                        else ""
                    )
                )
                self.return_val = TVal(
                    self.return_val.trails | val.trails,
                    merged_unordered,
                    val.born if merged_unordered else None,
                    self.return_val.carries or val.carries,
                )
                self.return_params |= self._params_of(node.value)
        elif isinstance(node, ast.Expr):
            self._eval(node.value)
        elif isinstance(node, (ast.If, ast.While)):
            self._eval(node.test)
            before = dict(self.env)
            for stmt in node.body:
                self._stmt(stmt)
            after_body = self.env
            self.env = dict(before)
            for stmt in node.orelse:
                self._stmt(stmt)
            self._merge_env(after_body)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            seq = self._eval(node.iter)
            elem = TVal(
                self._realize(
                    node.iter,
                    seq,
                    f"for-loop over {ast.unparse(node.iter)[:40]!r}",
                )
            )
            self._assign(node.target, elem, node.iter)
            for stmt in node.body:
                self._stmt(stmt)
            for stmt in node.orelse:
                self._stmt(stmt)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                self._eval(item.context_expr)
            for stmt in node.body:
                self._stmt(stmt)
        elif isinstance(node, ast.Try):
            for part in (node.body, *[h.body for h in node.handlers],
                         node.orelse, node.finalbody):
                for stmt in part:
                    self._stmt(stmt)
        elif isinstance(node, (ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self._eval(child)
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self.env.pop(tgt.id, None)

    def _merge_env(self, other: Dict[str, TVal]) -> None:
        merged: Dict[str, TVal] = {}
        for k in set(self.env) | set(other):
            a, b = self.env.get(k), other.get(k)
            if a is None or b is None:
                v = a or b
                merged[k] = TVal(v.trails)  # one-path binding: must facts die
            else:
                merged[k] = a.merged(b)
        self.env = merged

    def _assign(self, target: ast.AST, val: TVal, value_node: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = val
            self.param_flows[target.id] = self._params_of(value_node)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._assign(elt, TVal(val.trails, carries=val.carries), value_node)
        elif isinstance(target, ast.Subscript):
            base = target.value
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Name):
                cur = self.env.get(base.id, CLEAN)
                self.env[base.id] = TVal(
                    cur.trails | val.trails,
                    cur.unordered,
                    cur.born,
                    cur.carries or bool(val.unordered) or val.carries,
                )

    # -- expressions ----------------------------------------------------------

    def _eval(self, node: Optional[ast.AST]) -> TVal:
        if node is None or isinstance(node, (ast.Constant, ast.Lambda)):
            return CLEAN
        if isinstance(node, ast.Name):
            return self.env.get(node.id, CLEAN)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.Set):
            inner = [self._eval(e) for e in node.elts]
            return TVal(
                _union_trails(inner), "set",
                self._step(node, "set literal built"),
            )
        if isinstance(node, ast.SetComp):
            return TVal(
                self._comp(node), "set", self._step(node, "set built")
            )
        if isinstance(node, (ast.List, ast.Tuple)):
            inner = [self._eval(e) for e in node.elts]
            carries = any(bool(v.unordered) or v.carries for v in inner)
            return TVal(_union_trails(inner), carries=carries)
        if isinstance(node, ast.Dict):
            inner = [
                self._eval(v) for v in (*node.keys, *node.values) if v is not None
            ]
            carries = any(bool(v.unordered) or v.carries for v in inner)
            return TVal(_union_trails(inner), carries=carries)
        if isinstance(node, ast.DictComp):
            # a dict COMPREHENDED over an unordered walk is keyed in
            # nondeterministic order: it re-emits that order at every
            # later iteration, so the dict itself becomes the source
            trails: Set[Trail] = set()
            unordered_src = False
            for gen in node.generators:
                seq = self._eval(gen.iter)
                trails |= seq.trails
                if seq.unordered:
                    unordered_src = True
                for cond in gen.ifs:
                    self._eval(cond)
            for part in (node.key, node.value):
                trails |= self._eval(part).trails
            if unordered_src:
                return TVal(
                    frozenset(trails), "dict",
                    self._step(node, "dict built over unordered walk"),
                )
            return TVal(frozenset(trails))
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            return TVal(self._comp(node))
        if isinstance(node, ast.JoinedStr):
            out: Set[Trail] = set()
            for part in node.values:
                if isinstance(part, ast.FormattedValue):
                    v = self._eval(part.value)
                    out |= self._realize(
                        part.value, v,
                        f"f-string renders {ast.unparse(part.value)[:40]!r}",
                    )
            return TVal(frozenset(out))
        if isinstance(node, ast.BinOp):
            l, r = self._eval(node.left), self._eval(node.right)
            same = l.unordered if l.unordered == r.unordered else ""
            return TVal(
                l.trails | r.trails, same, l.born if same else None,
                l.carries or r.carries,
            )
        if isinstance(node, ast.BoolOp):
            vals = [self._eval(v) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                out = out.merged(v)
            return out
        if isinstance(node, ast.UnaryOp):
            return TVal(self._eval(node.operand).trails)
        if isinstance(node, ast.Compare):
            self._eval(node.left)
            for c in node.comparators:
                self._eval(c)
            return CLEAN  # membership/comparison is order-insensitive
        if isinstance(node, ast.IfExp):
            self._eval(node.test)
            return self._eval(node.body).merged(self._eval(node.orelse))
        if isinstance(node, ast.Subscript):
            base = self._eval(node.value)
            return TVal(base.trails, carries=base.carries)
        if isinstance(node, ast.Attribute):
            return TVal(self._eval(node.value).trails)
        if isinstance(node, (ast.Starred, ast.Await)):
            return self._eval(node.value)
        return CLEAN

    def _comp(self, node) -> FrozenSet[Trail]:
        saved: Dict[str, Optional[TVal]] = {}
        trails: Set[Trail] = set()
        for gen in node.generators:
            seq = self._eval(gen.iter)
            trails |= self._realize(
                gen.iter, seq,
                f"comprehension over {ast.unparse(gen.iter)[:40]!r}",
            )
            if isinstance(gen.target, ast.Name):
                name = gen.target.id
                if name not in saved:
                    saved[name] = self.env.get(name)
                self.env[name] = TVal(frozenset(trails))
            for cond in gen.ifs:
                self._eval(cond)
        trails |= self._eval(node.elt).trails
        for name, prior in saved.items():
            if prior is None:
                self.env.pop(name, None)
            else:
                self.env[name] = prior
        return frozenset(trails)

    # -- calls ----------------------------------------------------------------

    def _call(self, node: ast.Call) -> TVal:
        func = node.func
        term = terminal_name(func)
        q = self.model.qualname(func) or (term or "")
        line = getattr(node, "lineno", 1)

        arg_vals = [self._eval(a) for a in node.args]
        kw_vals = {kw.arg: self._eval(kw.value) for kw in node.keywords}
        all_vals = arg_vals + list(kw_vals.values())

        # -- scalar sources ---------------------------------------------------
        if self.model.is_imported(func):
            kind = classify_source_call(q)
            if kind is not None:
                return self._source(node, kind, f"{kind} source {q}()")
            if q in THREAD_ORDER_CALLS or (
                term in ("as_completed", "wait")
                and q.startswith("concurrent.futures")
            ):
                if in_replay_scope(self.model):
                    return TVal(
                        _union_trails(all_vals), "thread",
                        self._step(node, f"{term}() completion order"),
                    )
        if (
            isinstance(func, ast.Name)
            and term in ("id", "hash")
            and term not in self.env
            and term not in self.param_index
        ):
            if term == "hash" and node.args and isinstance(
                node.args[0], ast.Constant
            ) and isinstance(node.args[0].value, (int, bool)):
                return CLEAN  # hash(int) is seed-independent
            why = (
                "id() is address-dependent"
                if term == "id"
                else "hash() is PYTHONHASHSEED-dependent"
            )
            src = self._source(node, IDENTITY, why)
            return TVal(src.trails | _union_trails(all_vals))

        # -- sanitizers -------------------------------------------------------
        if term in SEAM_CALLS:
            return CLEAN
        if isinstance(func, ast.Name) and term in ORDER_SANITIZERS:
            if term == "len":
                return CLEAN
            trails = frozenset(
                t for t in _union_trails(all_vals)
                if t.kind not in (SET_ORDER, DICT_ORDER, THREAD_ORDER)
            )
            return TVal(trails)

        # -- realizing / transparent builtins ---------------------------------
        if isinstance(func, ast.Name) and term in _TRANSPARENT:
            trails = _union_trails(all_vals)
            if term in _REALIZERS and arg_vals and arg_vals[0].unordered:
                trails = trails | self._realize(
                    node, arg_vals[0], f"{term}() over unordered collection"
                )
            if term in ("set", "frozenset"):
                return TVal(trails, "set", self._step(node, f"{term}() built"))
            if term == "dict" and arg_vals and arg_vals[0].unordered:
                return TVal(
                    trails, "dict",
                    self._step(node, "dict built over unordered walk"),
                )
            return TVal(trails)
        if term == "join" and isinstance(func, ast.Attribute) and arg_vals:
            return TVal(
                self._realize(node, arg_vals[0], "str.join over collection")
            )
        if q == "dict.fromkeys" and arg_vals and arg_vals[0].unordered:
            return TVal(
                _union_trails(all_vals), "dict",
                self._step(node, "dict.fromkeys over unordered walk"),
            )

        # -- receiver methods -------------------------------------------------
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id not in ("self", "cls")
        ):
            recv_name = func.value.id
            recv = self.env.get(recv_name, CLEAN)
            if term in _SET_METHODS and recv.unordered:
                return TVal(
                    recv.trails | _union_trails(all_vals),
                    recv.unordered, recv.born,
                )
            if term in ("keys", "values", "items"):
                if recv.unordered == "dict":
                    return TVal(recv.trails, "dict", recv.born)
                return TVal(recv.trails, carries=recv.carries)
            if term in _MUTATORS:
                stored = _union_trails(all_vals)
                stored_un = any(bool(v.unordered) or v.carries for v in all_vals)
                self.env[recv_name] = TVal(
                    recv.trails | stored,
                    recv.unordered,
                    recv.born,
                    recv.carries or stored_un,
                )
                return TVal(recv.trails | stored)
            if term in _READERS:
                return TVal(
                    recv.trails | _union_trails(all_vals),
                    carries=recv.carries,
                )

        # -- sinks ------------------------------------------------------------
        is_sink = (
            term in SINK_NAMES
            or (q in SINK_CALLS and self.model.is_imported(func))
        )
        if is_sink and in_replay_scope(self.model):
            sink_step = self._step(node, f"{term}() ledger sink")
            for v in all_vals:
                if v.trails or v.unordered:
                    self._emit(node, v, sink_step)
            for arg in (*node.args, *(kw.value for kw in node.keywords)):
                for p in self._params_of(arg):
                    self.param_sinks.setdefault(p, (sink_step,))
            return CLEAN

        # -- interprocedural summaries ----------------------------------------
        callee = self.graph.resolve(
            self.model, func, self.enclosing_class, local_types=self.local_types
        )
        if callee is not None:
            summ = self.summaries.get(callee)
            if summ is not None:
                offset = (
                    1
                    if isinstance(func, ast.Attribute)
                    and not (
                        isinstance(func.value, ast.Name)
                        and func.value.id in self.model.imports
                    )
                    and self.graph.defs[callee].cls is not None
                    else 0
                )
                short = callee.split(".")[-1]
                vals_by_param: Dict[int, TVal] = {
                    i + offset: v for i, v in enumerate(arg_vals)
                }
                callee_params = {
                    name: i
                    for i, name in enumerate(
                        _param_names(self.graph.defs[callee].node)
                    )
                }
                for kw_name, v in kw_vals.items():
                    if kw_name is not None and kw_name in callee_params:
                        vals_by_param[callee_params[kw_name]] = v
                call_step = self._step(node, f"call {short}()")
                trails: Set[Trail] = {
                    t.extended(call_step) for t in summ.return_trails
                }
                for i in summ.param_to_return:
                    v = vals_by_param.get(i)
                    if v is not None:
                        trails |= {t.extended(call_step) for t in v.trails}
                for i, sink_steps in summ.param_sinks:
                    v = vals_by_param.get(i)
                    if v is None:
                        continue
                    if (v.trails or v.unordered) and self.collect is not None:
                        for trail in sorted(v.trails, key=Trail.sort_key):
                            self._emit_chain(node, trail, call_step, sink_steps)
                        if v.unordered:
                            realized = self._realize(
                                node, TVal(frozenset(), v.unordered, v.born),
                                f"passed into {short}()",
                            )
                            for trail in sorted(realized, key=Trail.sort_key):
                                self._emit_chain(
                                    node, trail, call_step, sink_steps
                                )
                    # transitive param -> sink through this call
                    for arg_node in (
                        *node.args, *(kw.value for kw in node.keywords)
                    ):
                        for p in self._params_of(arg_node):
                            self.param_sinks.setdefault(
                                p, (call_step,) + sink_steps
                            )
                return TVal(
                    frozenset(trails),
                    summ.return_unordered,
                    call_step if summ.return_unordered else None,
                    summ.return_carries,
                )
        return CLEAN

    def _emit_chain(
        self,
        node: ast.AST,
        trail: Trail,
        call_step: FlowStep,
        sink_steps: Tuple[FlowStep, ...],
    ) -> None:
        if self.collect is None or self._suppressed(getattr(node, "lineno", 1)):
            return
        steps = trail.steps + (call_step,) + sink_steps
        rendered = " -> ".join(f"{n} [{p}:{ln}]" for p, ln, n in steps)
        self.collect.append(
            self.model.finding(
                node,
                RULE_ID,
                f"{trail.kind} reaches a ledger sink: {rendered} — "
                "sorted() the collection at the source, route scalars "
                "through an injected seam, or pragma this sink line "
                "with a reason",
                flow=steps,
            )
        )


# -- the whole-program pass ---------------------------------------------------


def _function_defs(graph: CallGraph):
    for fq in sorted(graph.defs):
        info = graph.defs[fq]
        if info.local == MODULE_NODE:
            continue
        yield fq, info


def _pragma_map(models: Sequence[FileModel]) -> Dict[str, Dict[int, Set[str]]]:
    out: Dict[str, Dict[int, Set[str]]] = {}
    for m in models:
        cached = getattr(m, "pragma_lines", None)
        if cached is None:
            cached, _ = parse_pragmas(m.source, m.path)
        out[m.path] = cached
    return out


def compute_taint_summaries(
    graph: CallGraph, pragma_by_path: Dict[str, Dict[int, Set[str]]]
) -> Dict[str, TSummary]:
    summaries: Dict[str, TSummary] = {}
    for _ in range(4):  # bounded fixpoint, deterministic order
        changed = False
        for fq, info in _function_defs(graph):
            interp = _TaintInterp(
                graph, info.model, fq, info.node, summaries,
                pragma_by_path.get(info.model.path, {}),
            )
            new = interp.run()
            old = summaries.get(fq)
            if old is None or old.key() != new.key():
                summaries[fq] = new
                changed = True
        if not changed:
            break
    return summaries


class DeterminismTaintChecker:
    """GL013 — interprocedural determinism taint must never reach a
    ledger sink; every finding names the full source→sink path."""

    rule_id = RULE_ID
    title = "interprocedural determinism taint reaches a ledger sink"

    def check_program(self, graph: CallGraph) -> List[Finding]:
        pragma_by_path = _pragma_map(graph.models)
        summaries = compute_taint_summaries(graph, pragma_by_path)
        findings: List[Finding] = []
        for fq, info in _function_defs(graph):
            interp = _TaintInterp(
                graph, info.model, fq, info.node, summaries,
                pragma_by_path.get(info.model.path, {}),
                collect=findings,
            )
            interp.run()
        # module-level statements (a module-scope walk into a ledger counts)
        for model in graph.models:
            dm = dotted_module(model)
            if dm is None:
                continue
            fq = f"{dm}.{MODULE_NODE}"
            if fq not in graph.defs:
                continue
            interp = _TaintInterp(
                graph, model, fq, model.tree, summaries,
                pragma_by_path.get(model.path, {}),
                collect=findings,
            )
            for stmt in model.tree.body:
                if not isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                ):
                    interp._stmt(stmt)
        seen: Set[Tuple[str, int, str]] = set()
        out: List[Finding] = []
        for f in sorted(findings, key=Finding.sort_key):
            k = (f.path, f.line, f.message)
            if k not in seen:
                seen.add(k)
                out.append(f)
        return out
