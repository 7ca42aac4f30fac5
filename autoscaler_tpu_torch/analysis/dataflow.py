"""GL010/GL012 — flow-sensitive determinism dataflow over the call graph.

The headline safety claim — loadgen replays and all three JSONL ledgers
(perf, explain, fleet) are **byte-identical** across runs — was enforced
syntactically (GL001 bans ambient clock/rng *calls* in replay modules) and
empirically (``loadgen --sanitize`` replays a scenario under the runtime sanitizer).
Both leave a gap: a nondeterministic *value* that flows through
assignments, containers, returns and f-strings into a ledger line is
invisible to GL001 (the call site may be sanctioned or out of scope), and
invisible to the diff gate unless a canned scenario happens to exercise
the line. GL010 closes the gap the way GL007 closed the kernel-shape gap:
by *proving* the contract at every program point, over the PR-5
``CallGraph``.

The model:

- **Sources** introduce taint: ambient wall clock and RNG (the GL001
  table, shared from here so lint and dataflow can never drift),
  ``os.environ``/``os.getenv`` reads, ``id()``/bare ``hash()`` (address-
  and PYTHONHASHSEED-dependent), and **iteration order of set/frozenset
  values** — ``for x in s``, ``list(s)``, ``",".join(s)`` over a value
  proven set-typed (hash-seed-dependent order across processes).
- **Sinks** are the replay-artifact writers: the ledger choke points
  (``record_line``/``stable_json``/``dump_jsonl``), ``json.dumps`` in
  replay scopes, span attributes (``set_attrs``/``add_event``), metric
  label kwargs, and the *returns of serialization producers*
  (``summarize``/``to_dict``/``build_report``/``digest``/``*_lines``/
  ``*_json`` in replay scopes — their contract is "JSON-ready", whoever
  dumps them).
- **Declassifiers** stop propagation: ``trace.timeline_now()`` (the
  injectable timeline clock), ``sorted()``/``len()``/``min``/``max``/
  ``sum``/``any``/``all`` over set-taints (order-independent
  consumption), injected parameter seams (a call through a parameter is
  unresolvable and deliberately produces no taint), and an explicit
  ``# graftlint: disable=GL010 — reason`` on the source line.

Like the GL007 shape interpreter, the analysis **under-approximates**:
set-typeness must hold on every branch (must-intersect), unknown calls
and attribute state produce no taint, rebinding kills. Taint itself
merges may-union — a flow on one branch is a real flow. Interprocedural
reach rides per-function summaries (return taint, param→return,
param→sink) iterated to a fixpoint in deterministic order; every finding
message renders the full source → hop → sink witness path.

GL012 (same module — it polices the sink side of the same contract):
every gated status-server endpoint branch must read its wired gate flag,
and every ``json.dumps`` in a replay scope must pass ``sort_keys=True``
(the ``record_line``-style choke shape) so no ad-hoc serialization can
escape the byte-diff contract.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from autoscaler_tpu_torch.analysis.callgraph import MODULE_NODE, CallGraph
from autoscaler_tpu_torch.analysis.engine import (
    FileModel,
    Finding,
    parse_pragmas,
    suppressed_at,
    terminal_name,
)

# -- the shared nondeterminism-source model -----------------------------------
# GL001 (rules.py) imports these tables: the syntactic rule, the dataflow
# rule, and the runtime sanitizer all judge the same calls, so "static is
# never less complete than what actually fired" holds by construction.

GL001_BANNED = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.sleep",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.datetime.today",
    "datetime.date.today",
    "os.urandom",
    "uuid.uuid1",
    "uuid.uuid4",
}
# random.Random(seed) builds an *injectable* generator — allowed; every
# module-level `random.*` function rides the shared ambient state — banned.
RANDOM_OK = {"Random"}
# numpy: seeded construction allowed, legacy ambient-state functions banned.
NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "MT19937", "PCG64", "Philox"}

# taint kinds (stable vocabulary — the sanitizer reports the same words)
WALL_CLOCK = "wall-clock"
AMBIENT_RNG = "ambient-rng"
ENV_READ = "environment-read"
OBJECT_IDENTITY = "object-identity"
SET_ORDER = "set-iteration-order"

_ENV_CALLS = {"os.getenv": ENV_READ, "os.environ.get": ENV_READ}
_IDENTITY_BUILTINS = {"id": OBJECT_IDENTITY, "hash": OBJECT_IDENTITY}

REPLAY_SCOPES = (
    "core/",
    "estimator/",
    "explain/",
    "fleet/",
    "gym/",
    "journal/",
    "loadgen/",
    "perf/",
    "slo/",
    "trace/",
    "snapshot/",
    "clusterstate/",
    "expander/",
    "preempt/",
    "debugging.py",
)

# the sanctioned timeline seam: calling it yields a *deterministic* value
# under replay (the loadgen driver injects a synthetic counter)
_DECLASSIFIER_CALLS = {"timeline_now"}

# order-insensitive set consumption: these builtins make iteration order
# irrelevant, so a set-taint dies at the call
_SET_DECLASSIFIER_BUILTINS = {"sorted", "len", "min", "max", "sum", "any", "all"}

# builtins that transparently propagate the taint of their arguments
_TRANSPARENT_BUILTINS = {
    "str", "repr", "format", "int", "float", "bool", "round", "abs",
    "list", "tuple", "dict", "zip", "enumerate", "reversed", "iter",
    "next", "map", "filter",
}
# container mutators: the receiver absorbs the stored value's facts
# (`routes.setdefault(k, {"sigs": set()})` makes `routes` set-carrying)
_CONTAINER_MUTATORS = {"append", "add", "update", "extend", "insert", "setdefault", "appendleft"}
# methods that transparently expose the receiver's contents
_CONTAINER_READERS = {"get", "values", "items", "keys", "copy", "pop", "popitem"}
# of the transparent builtins, these realize iteration order of a set arg
_ORDERING_BUILTINS = {"list", "tuple", "zip", "enumerate", "reversed", "iter", "map", "filter"}

# ledger choke points: args serialized byte-for-byte into replay artifacts
_LEDGER_SINK_NAMES = {"record_line", "stable_json", "dump_jsonl"}
# serialization producers by convention: their returns are JSON-ready
_PRODUCER_NAMES = {"summarize", "summary", "to_dict", "build_report", "digest"}
_PRODUCER_SUFFIXES = ("_lines", "_json", "_report")


def classify_source_call(qualname: str) -> Optional[str]:
    """The one classifier GL001, GL010, and the sanitizer cross-check
    share: fully-qualified (import-resolved) callable → taint kind, or
    None for deterministic calls."""
    if qualname in GL001_BANNED:
        if qualname.startswith(("os.urandom", "uuid.")):
            return AMBIENT_RNG
        return WALL_CLOCK
    if qualname in _ENV_CALLS:
        return ENV_READ
    parts = qualname.split(".")
    if qualname.startswith("random.") and len(parts) == 2 and parts[1] not in RANDOM_OK:
        return AMBIENT_RNG
    if qualname.startswith("numpy.random.") and len(parts) >= 3 and parts[2] not in NP_RANDOM_OK:
        return AMBIENT_RNG
    return None


@dataclass(frozen=True)
class Taint:
    """One tainted provenance: the source site plus the witness hops the
    value took to get wherever it now is."""

    kind: str
    path: str
    line: int
    detail: str
    hops: Tuple[str, ...] = ()

    def site(self) -> str:
        return f"{self.path}:{self.line}"

    def with_hop(self, hop: str) -> "Taint":
        if len(self.hops) >= 6 or (self.hops and self.hops[-1] == hop):
            return self
        return Taint(self.kind, self.path, self.line, self.detail, self.hops + (hop,))

    def render_path(self, sink: str) -> str:
        chain = [f"{self.kind} at {self.site()} ({self.detail})"]
        chain.extend(self.hops)
        chain.append(sink)
        return " -> ".join(chain)


@dataclass(frozen=True)
class Val:
    """Abstract value: taint tags ∪ set-typeness. ``is_set`` means
    *provably* a set/frozenset on every path; ``carries_set`` means a
    container provably holding one."""

    tags: FrozenSet[Taint] = frozenset()
    is_set: bool = False
    carries_set: bool = False

    def merged(self, other: "Val") -> "Val":
        # taints may-union (a flow on either branch is a real flow);
        # set-typeness must-intersect (never guess order sensitivity)
        return Val(
            self.tags | other.tags,
            self.is_set and other.is_set,
            self.carries_set and other.carries_set,
        )


CLEAN = Val()


@dataclass
class Summary:
    """Interprocedural facts for one definition."""

    return_tags: FrozenSet[Taint] = frozenset()
    return_set: bool = False            # returns a provable set
    return_carries_set: bool = False    # returns a container holding one
    param_to_return: FrozenSet[int] = frozenset()
    # param index -> sink description inside the callee (transitive)
    param_sinks: Tuple[Tuple[int, str], ...] = ()

    def key(self) -> Tuple:
        return (
            self.return_tags, self.return_set, self.return_carries_set,
            self.param_to_return, self.param_sinks,
        )


@dataclass(frozen=True)
class SourceSite:
    """One statically-known nondeterminism source occurrence — the
    inventory the runtime sanitizer's findings must be a subset of."""

    path: str
    line: int
    kind: str
    detail: str


def in_replay_scope(model: FileModel) -> bool:
    return model.in_module(*REPLAY_SCOPES)


def _param_names(fn: ast.AST) -> List[str]:
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    a = fn.args
    names = [p.arg for p in (*a.posonlyargs, *a.args)]
    return names


class _FunctionFlow:
    """One pass of the abstract interpreter over one definition body.

    ``collect`` mode emits findings (sink hits) and source sites; summary
    mode only computes the Summary. Parameters carry symbolic indices so
    param→return and param→sink flows surface at call sites."""

    def __init__(
        self,
        graph: CallGraph,
        model: FileModel,
        fq: str,
        fn: ast.AST,
        summaries: Dict[str, Summary],
        pragma_lines: Dict[int, Set[str]],
        collect: Optional[List[Finding]] = None,
        sources_out: Optional[List[SourceSite]] = None,
        rule_id: str = "GL010",
    ):
        self.graph = graph
        self.model = model
        self.fq = fq
        self.fn = fn
        self.summaries = summaries
        self.pragmas = pragma_lines
        self.collect = collect
        self.sources_out = sources_out
        self.rule_id = rule_id
        self.env: Dict[str, Val] = {}
        self.params = _param_names(fn)
        self.param_index = {p: i for i, p in enumerate(self.params)}
        self.param_flows: Dict[str, Set[int]] = {}  # var -> param indices
        self.return_val = CLEAN
        self.return_params: Set[int] = set()
        self.param_sinks: Dict[int, str] = {}
        self.enclosing_class = self._enclosing_class()
        self.local_name = getattr(fn, "name", MODULE_NODE)
        for p in self.params:
            self.param_flows[p] = {self.param_index[p]}

    def _enclosing_class(self) -> Optional[str]:
        info = self.graph.defs.get(self.fq)
        return info.cls if info is not None else None

    # -- driving --------------------------------------------------------------

    def run(self) -> Summary:
        body = getattr(self.fn, "body", [])
        # a second pass over the body reaches the fixpoint on loop-carried
        # facts (a tag born late in a loop body flowing into its head) —
        # but only when the first pass established ANY fact a second pass
        # could propagate; the common all-clean function walks once
        for stmt in body:
            self._stmt(stmt)
        if self._has_facts():
            for stmt in body:
                self._stmt(stmt)
        return Summary(
            return_tags=self.return_val.tags,
            return_set=self.return_val.is_set,
            return_carries_set=self.return_val.carries_set,
            param_to_return=frozenset(self.return_params),
            param_sinks=tuple(sorted(self.param_sinks.items())),
        )

    # -- helpers --------------------------------------------------------------

    def _has_facts(self) -> bool:
        """Did pass one establish anything a second pass could carry into
        a loop head — a tainted/set-typed binding, or a param alias beyond
        the initial parameter identities?"""
        for name, val in self.env.items():
            if val.tags or val.is_set or val.carries_set:
                return True
        for name, idxs in self.param_flows.items():
            if idxs and name not in self.param_index:
                return True
        return False

    def _suppressed_line(self, line: int) -> bool:
        return suppressed_at(
            line, {self.rule_id}, self.pragmas, self.model.lines
        )

    def _note_source(self, node: ast.AST, kind: str, detail: str) -> Val:
        line = getattr(node, "lineno", 1)
        if self.sources_out is not None:
            self.sources_out.append(
                SourceSite(self.model.path, line, kind, detail)
            )
        if self._suppressed_line(line):
            # explicit pragma on the source line is a declassifier: the
            # author asserted the value is replay-stable anyway
            return CLEAN
        return Val(tags=frozenset({Taint(kind, self.model.path, line, detail)}))

    def _emit(self, node: ast.AST, val: Val, sink: str) -> None:
        if self.collect is None:
            return
        for tag in sorted(val.tags, key=lambda t: (t.kind, t.path, t.line, t.hops)):
            self.collect.append(
                self.model.finding(
                    node,
                    self.rule_id,
                    f"nondeterminism reaches a replay artifact: "
                    f"{tag.render_path(sink)} — route the value through an "
                    "injected seam (trace.timeline_now(), parameter "
                    "defaults) or sorted() the set at the source",
                )
            )
        if val.is_set or val.carries_set:
            self.collect.append(
                self.model.finding(
                    node,
                    self.rule_id,
                    f"raw set reaches a replay artifact: {sink} receives a "
                    "set/frozenset (iteration order is hash-seed-dependent "
                    "across processes) — sorted() it at the site or keep "
                    "only order-insensitive reductions (len/min/max/sum)",
                )
            )

    def _sink(self, node: ast.AST, val: Val, sink: str) -> None:
        if self._suppressed_line(getattr(node, "lineno", 1)):
            return
        self._emit(node, val, sink)

    # -- statements -----------------------------------------------------------

    def _stmt(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs are their own graph nodes
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
                self.env[node.target.id] = Val(
                    cur.tags | val.tags,
                    cur.is_set,
                    cur.carries_set or val.is_set or val.carries_set,
                )
        elif isinstance(node, ast.Return):
            if node.value is not None:
                val = self._eval(node.value)
                self.return_val = Val(
                    self.return_val.tags | val.tags,
                    self.return_val.is_set or val.is_set,
                    self.return_val.carries_set or val.carries_set,
                )
                self.return_params |= self._params_of(node.value)
                if self._is_producer() and in_replay_scope(self.model):
                    if val.tags or val.is_set or val.carries_set:
                        self._sink(
                            node,
                            val,
                            f"return of serialization producer "
                            f"{self.local_name}() [{self.model.path}]",
                        )
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
            self._for(node)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                self._eval(item.context_expr)
            for stmt in node.body:
                self._stmt(stmt)
        elif isinstance(node, ast.Try):
            for stmt in node.body:
                self._stmt(stmt)
            for handler in node.handlers:
                for stmt in handler.body:
                    self._stmt(stmt)
            for stmt in node.orelse:
                self._stmt(stmt)
            for stmt in node.finalbody:
                self._stmt(stmt)
        elif isinstance(node, (ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self._eval(child)
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self.env.pop(tgt.id, None)

    def _merge_env(self, other: Dict[str, Val]) -> None:
        keys = set(self.env) | set(other)
        merged: Dict[str, Val] = {}
        for k in keys:
            a = self.env.get(k)
            b = other.get(k)
            if a is None or b is None:
                # bound on one path only: taints survive (may), set-ness
                # does not (must)
                v = a or b
                merged[k] = Val(v.tags, False, False)
            else:
                merged[k] = a.merged(b)
        self.env = merged

    def _assign(self, target: ast.AST, val: Val, value_node: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = val
            self.param_flows[target.id] = self._params_of(value_node)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                # unpack: each element may carry the tuple's taint; a raw
                # set inside stays a container fact, not element set-ness
                self._assign(elt, Val(val.tags, False, val.carries_set), value_node)
        elif isinstance(target, ast.Subscript):
            # d[k] = v — the container absorbs the stored value's facts
            base = target.value
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Name):
                cur = self.env.get(base.id, CLEAN)
                self.env[base.id] = Val(
                    cur.tags | val.tags,
                    cur.is_set,
                    cur.carries_set or val.is_set or val.carries_set,
                )
        # attribute stores (self._x = v) are untracked: cross-method state
        # is GL011's domain; guessing here would break under-approximation

    def _params_of(self, node: ast.AST) -> Set[int]:
        """Which of this def's params (by index) flow into ``node`` —
        name references only, the provable subset."""
        out: Set[int] = set()
        for child in ast.walk(node):
            if isinstance(child, ast.Name) and child.id in self.param_index:
                # only if the name still refers to the parameter binding
                flows = self.param_flows.get(child.id)
                if flows is not None and self.param_index[child.id] in flows:
                    out.add(self.param_index[child.id])
        return out

    def _for(self, node: ast.For) -> None:
        seq = self._eval(node.iter)
        if seq.is_set and in_replay_scope(self.model):
            # scope-gated like every sibling set-order source (list()/
            # join/f-string/comprehension): equivalent spellings must get
            # equivalent verdicts, and source_sites() must only inventory
            # sites the sanitizer could fire on. The elements keep the
            # set's own value taints — a GL010 pragma here declassifies
            # the ORDER, never a wall-clock/env taint the elements carry
            detail = f"for-loop over set {ast.unparse(node.iter)[:40]!r}"
            order = self._note_source(node.iter, SET_ORDER, detail)
            elem = Val(seq.tags | order.tags)
        else:
            # iterating a non-set container is deterministic (lists,
            # dicts); a buried set only taints when itself iterated
            elem = Val(seq.tags)
        self._assign(node.target, elem, node.iter)
        for stmt in node.body:
            self._stmt(stmt)
        for stmt in node.orelse:
            self._stmt(stmt)

    # -- expressions ----------------------------------------------------------

    def _eval(self, node: Optional[ast.AST]) -> Val:
        if node is None:
            return CLEAN
        if isinstance(node, ast.Name):
            return self.env.get(node.id, CLEAN)
        if isinstance(node, ast.Constant):
            return CLEAN
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, (ast.Set,)):
            inner = self._union(node.elts)
            return Val(inner.tags, True, inner.is_set or inner.carries_set)
        if isinstance(node, ast.SetComp):
            inner = self._comp(node)
            return Val(inner.tags, True, inner.carries_set)
        if isinstance(node, (ast.List, ast.Tuple)):
            inner = self._union(node.elts)
            return Val(inner.tags, False, inner.is_set or inner.carries_set)
        if isinstance(node, ast.Dict):
            vals = [v for v in (*node.keys, *node.values) if v is not None]
            inner = self._union(vals)
            return Val(inner.tags, False, inner.is_set or inner.carries_set)
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
            return self._comp(node)
        if isinstance(node, ast.JoinedStr):
            # f-string: formatting a raw set realizes its order
            out = CLEAN
            for part in node.values:
                if isinstance(part, ast.FormattedValue):
                    v = self._eval(part.value)
                    if v.is_set and in_replay_scope(self.model):
                        v = Val(
                            v.tags
                            | self._note_source(
                                part.value, SET_ORDER,
                                f"f-string renders set "
                                f"{ast.unparse(part.value)[:40]!r}",
                            ).tags
                        )
                    out = Val(out.tags | v.tags)
            return out
        if isinstance(node, ast.BinOp):
            l, r = self._eval(node.left), self._eval(node.right)
            return Val(l.tags | r.tags, l.is_set and r.is_set,
                       l.carries_set or r.carries_set)
        if isinstance(node, ast.BoolOp):
            vals = [self._eval(v) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                out = Val(out.tags | v.tags, out.is_set and v.is_set,
                          out.carries_set or v.carries_set)
            return out
        if isinstance(node, ast.UnaryOp):
            return Val(self._eval(node.operand).tags)
        if isinstance(node, ast.Compare):
            # membership / comparison yields a bool — order-insensitive
            self._eval(node.left)
            for c in node.comparators:
                self._eval(c)
            return CLEAN
        if isinstance(node, ast.IfExp):
            t, f = self._eval(node.body), self._eval(node.orelse)
            self._eval(node.test)
            return t.merged(f)
        if isinstance(node, ast.Subscript):
            base = self._eval(node.value)
            # an element of a set-carrying container may BE the set
            return Val(base.tags, False, base.carries_set)
        if isinstance(node, ast.Attribute):
            return self._attribute(node)
        if isinstance(node, ast.Starred):
            return self._eval(node.value)
        if isinstance(node, ast.Await):
            return self._eval(node.value)
        if isinstance(node, ast.Lambda):
            return CLEAN
        return CLEAN

    def _union(self, nodes: Iterable[ast.AST]) -> Val:
        tags: Set[Taint] = set()
        any_set = False
        for n in nodes:
            v = self._eval(n)
            tags |= v.tags
            any_set = any_set or v.is_set or v.carries_set
        return Val(frozenset(tags), any_set, any_set)

    def _comp(self, node) -> Val:
        # comprehension variables do NOT leak in Python 3: bind the
        # targets for the inner evaluation, then restore the enclosing
        # bindings (clobbering them would both fabricate taint on an
        # outer clean name and erase taint on an outer tainted one)
        saved: Dict[str, Optional[Val]] = {}
        tags: Set[Taint] = set()
        for gen in node.generators:
            seq = self._eval(gen.iter)
            tags |= seq.tags
            if seq.is_set and in_replay_scope(self.model):
                tags |= self._note_source(
                    gen.iter, SET_ORDER,
                    f"comprehension over set {ast.unparse(gen.iter)[:40]!r}",
                ).tags
            if isinstance(gen.target, ast.Name):
                name = gen.target.id
                if name not in saved:
                    saved[name] = self.env.get(name)
                self.env[name] = Val(frozenset(tags))
            for cond in gen.ifs:
                self._eval(cond)
        carries = False
        if isinstance(node, ast.DictComp):
            k, v = self._eval(node.key), self._eval(node.value)
            tags |= k.tags | v.tags
            carries = v.is_set or v.carries_set
        else:
            elt = self._eval(node.elt)
            tags |= elt.tags
            carries = elt.is_set or elt.carries_set
        for name, prior in saved.items():
            if prior is None:
                self.env.pop(name, None)
            else:
                self.env[name] = prior
        return Val(frozenset(tags), False, carries)

    def _attribute(self, node: ast.Attribute) -> Val:
        q = self.model.qualname(node)
        if q == "os.environ":
            # bare os.environ: only subscripts/get taint; the mapping
            # itself is not iterated here
            return CLEAN
        return Val(self._eval(node.value).tags)

    def _is_producer(self) -> bool:
        name = self.local_name
        return name in _PRODUCER_NAMES or name.endswith(_PRODUCER_SUFFIXES)

    # -- calls: sources, sinks, declassifiers, summaries ----------------------

    def _call(self, node: ast.Call) -> Val:
        func = node.func
        term = terminal_name(func)
        q = self.model.qualname(func) or (term or "")

        arg_vals = [self._eval(a) for a in node.args]
        kw_vals = {kw.arg: self._eval(kw.value) for kw in node.keywords}
        all_vals = arg_vals + list(kw_vals.values())

        # -- sources ----------------------------------------------------------
        if self.model.is_imported(func):
            kind = classify_source_call(q)
            if kind is not None and in_replay_scope(self.model):
                return self._note_source(node, kind, f"{q}()")
        if (
            isinstance(func, ast.Name)
            and term in _IDENTITY_BUILTINS
            and term not in self.env
            and term not in self.param_index
            and in_replay_scope(self.model)
        ):
            src = self._note_source(node, _IDENTITY_BUILTINS[term], f"{term}()")
            tags = set(src.tags)
            for v in all_vals:
                tags |= v.tags
            return Val(frozenset(tags))

        # -- declassifiers ----------------------------------------------------
        if term in _DECLASSIFIER_CALLS:
            return CLEAN
        if isinstance(func, ast.Name) and term in _SET_DECLASSIFIER_BUILTINS:
            # order-insensitive consumption kills only SET_ORDER taints:
            # sorted/sum/min/max (and the any/all booleans) still EXPOSE
            # the element values — max() of wall-clock stamps IS the
            # wall-clock. len() alone is a pure count and returns clean
            # (element taint does not flow through a length).
            if term == "len":
                return CLEAN
            tags = frozenset().union(*(v.tags for v in all_vals)) if all_vals else frozenset()
            return Val(frozenset(t for t in tags if t.kind != SET_ORDER))

        # -- ordering builtins realize set order ------------------------------
        if isinstance(func, ast.Name) and term in _TRANSPARENT_BUILTINS:
            out = CLEAN
            for v in all_vals:
                out = Val(out.tags | v.tags)
            if (
                term in _ORDERING_BUILTINS
                and arg_vals
                and arg_vals[0].is_set
                and in_replay_scope(self.model)
            ):
                out = Val(
                    out.tags
                    | self._note_source(
                        node, SET_ORDER, f"{term}() over set"
                    ).tags
                )
            if term in ("set", "frozenset"):
                return Val(out.tags, True, False)
            return out
        if term == "join" and isinstance(func, ast.Attribute) and arg_vals:
            v = arg_vals[0]
            tags = set(v.tags)
            if v.is_set and in_replay_scope(self.model):
                tags |= self._note_source(node, SET_ORDER, "str.join over set").tags
            return Val(frozenset(tags))

        # container method modeling on a Name receiver: mutators make the
        # receiver absorb the stored facts; readers expose them. `self`/
        # `cls` receivers are NOT containers — self.update(...) is a bound
        # method call whose resolved summary (below) must apply instead
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id not in ("self", "cls")
        ):
            recv_name = func.value.id
            recv = self.env.get(recv_name, CLEAN)
            if term in _CONTAINER_MUTATORS:
                stored_tags = frozenset().union(*(v.tags for v in all_vals)) if all_vals else frozenset()
                stored_set = any(v.is_set or v.carries_set for v in all_vals)
                self.env[recv_name] = Val(
                    recv.tags | stored_tags,
                    recv.is_set,
                    recv.carries_set or stored_set,
                )
                if term == "setdefault" and len(arg_vals) >= 2:
                    d = arg_vals[1]
                    return Val(recv.tags | d.tags, d.is_set, d.carries_set or recv.carries_set)
                return Val(recv.tags | stored_tags)
            if term in _CONTAINER_READERS:
                return Val(
                    recv.tags
                    | (frozenset().union(*(v.tags for v in all_vals)) if all_vals else frozenset()),
                    False,
                    recv.carries_set,
                )
        if q in ("set", "frozenset"):
            return Val(
                frozenset().union(*(v.tags for v in all_vals)) if all_vals else frozenset(),
                True,
                False,
            )

        # -- sinks ------------------------------------------------------------
        self._check_sink(node, term, q, arg_vals, kw_vals)

        # -- interprocedural summary application ------------------------------
        callee = self.graph.resolve(self.model, func, self.enclosing_class)
        if callee is not None:
            summ = self.summaries.get(callee)
            if summ is not None:
                # a bound call (`self.meth(a)` / `cls.meth(a)`) passes its
                # receiver implicitly: the callee's param 0 is `self`, so
                # positional args map to params shifted by one
                offset = (
                    1
                    if isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)
                    and func.value.id in ("self", "cls")
                    else 0
                )
                short = callee.split(".")[-1]
                # param index -> value at THIS call site: positionals
                # (shifted past the bound receiver) plus keywords matched
                # by the callee's own parameter names
                vals_by_param: Dict[int, Val] = {
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
                hop = (
                    f"return of {short}() [{self.model.path}:"
                    f"{getattr(node, 'lineno', 0)}]"
                )
                tags: Set[Taint] = {t.with_hop(hop) for t in summ.return_tags}
                for i in summ.param_to_return:
                    v = vals_by_param.get(i)
                    if v is not None:
                        tags |= {
                            t.with_hop(
                                f"through {short}(arg {i - offset}) "
                                f"[{self.model.path}:{getattr(node, 'lineno', 0)}]"
                            )
                            for t in v.tags
                        }
                for i, sink_desc in summ.param_sinks:
                    v = vals_by_param.get(i)
                    if (
                        v is not None
                        and not self._suppressed_line(getattr(node, "lineno", 1))
                        and (v.tags or v.is_set or v.carries_set)
                    ):
                        self._emit(
                            node,
                            v,
                            f"{short}(arg {i - offset}) -> {sink_desc}",
                        )
                return Val(frozenset(tags), summ.return_set, summ.return_carries_set)
        # unknown call: never guess
        return CLEAN

    def _check_sink(
        self,
        node: ast.Call,
        term: Optional[str],
        q: str,
        arg_vals: List[Val],
        kw_vals: Dict[Optional[str], Val],
    ) -> None:
        if not in_replay_scope(self.model):
            return
        line = getattr(node, "lineno", 0)
        if term in _LEDGER_SINK_NAMES:
            for v in (*arg_vals, *kw_vals.values()):
                self._sink_val(node, v, f"{term}() ledger write [{self.model.path}:{line}]")
            # record param forwarding: a def whose param reaches the sink
            # (positionally or by keyword)
            for arg in (*node.args, *(kw.value for kw in node.keywords)):
                for p in self._params_of(arg):
                    self.param_sinks.setdefault(
                        p, f"{term}() ledger write [{self.model.path}:{line}]"
                    )
            return
        if q in ("json.dumps", "json.dump"):
            for v in arg_vals[:1]:
                self._sink_val(node, v, f"json.dumps [{self.model.path}:{line}]")
            for i, arg in enumerate(node.args[:1]):
                for p in self._params_of(arg):
                    self.param_sinks.setdefault(
                        p, f"json.dumps [{self.model.path}:{line}]"
                    )
            return
        if term in ("set_attrs", "add_event", "set_wall_attrs") and "trace" in q.lower():
            for name, v in kw_vals.items():
                self._sink_val(
                    node, v,
                    f"span attribute {name}= [{self.model.path}:{line}]",
                )
            return
        if "metrics" in q.split(".") and term in ("inc", "set", "observe", "observe_duration_value"):
            for name, v in kw_vals.items():
                if name is not None:
                    self._sink_val(
                        node, v,
                        f"metric label {name}= [{self.model.path}:{line}]",
                    )

    def _sink_val(self, node: ast.AST, val: Val, sink: str) -> None:
        if self._suppressed_line(getattr(node, "lineno", 1)):
            return
        if val.tags or val.is_set or val.carries_set:
            self._emit(node, val, sink)


# -- the whole-program passes -------------------------------------------------


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
            # standalone use (source_sites, direct checker runs): the
            # engine wasn't involved, tokenize here
            cached, _ = parse_pragmas(m.source, m.path)
        out[m.path] = cached
    return out


def compute_summaries(
    graph: CallGraph, pragma_by_path: Dict[str, Dict[int, Set[str]]]
) -> Dict[str, Summary]:
    summaries: Dict[str, Summary] = {}
    for _ in range(4):  # bounded fixpoint; call chains deeper than this
        changed = False  # settle in later rounds or stay silent (sound)
        for fq, info in _function_defs(graph):
            flow = _FunctionFlow(
                graph, info.model, fq, info.node, summaries,
                pragma_by_path.get(info.model.path, {}),
            )
            new = flow.run()
            old = summaries.get(fq)
            if old is None or old.key() != new.key():
                summaries[fq] = new
                changed = True
        if not changed:
            break
    return summaries


def source_sites(models: Sequence[FileModel]) -> List[SourceSite]:
    """Every statically-known nondeterminism source occurrence in replay
    scopes — the inventory the runtime sanitizer's findings must be a
    subset of (tests/test_sanitizer.py asserts exactly that)."""
    graph = CallGraph(models)
    pragma_by_path = _pragma_map(models)
    sites: List[SourceSite] = []
    summaries = compute_summaries(graph, pragma_by_path)
    for fq, info in _function_defs(graph):
        flow = _FunctionFlow(
            graph, info.model, fq, info.node, summaries,
            pragma_by_path.get(info.model.path, {}),
            sources_out=sites,
        )
        flow.run()
    # module-level code too (rare, but a module-scope time.time() counts)
    for model in graph.models:
        if model.module is None:
            continue
        from autoscaler_tpu_torch.analysis.callgraph import dotted_module

        dm = dotted_module(model)
        if dm is None:
            continue
        fq = f"{dm}.{MODULE_NODE}"
        info = graph.defs.get(fq)
        if info is not None:
            flow = _FunctionFlow(
                graph, model, fq, model.tree, summaries,
                pragma_by_path.get(model.path, {}),
                sources_out=sites,
            )
            for stmt in model.tree.body:
                if not isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                ):
                    flow._stmt(stmt)
    seen: Set[SourceSite] = set()
    out: List[SourceSite] = []
    for s in sorted(sites, key=lambda s: (s.path, s.line, s.kind, s.detail)):
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


class TaintFlowChecker:
    """GL010 — nondeterminism taint must never reach a replay artifact."""

    rule_id = "GL010"
    title = "nondeterministic value flows into a replay ledger/trace sink"

    def check_program(self, graph: CallGraph) -> List[Finding]:
        pragma_by_path = _pragma_map(graph.models)
        summaries = compute_summaries(graph, pragma_by_path)
        findings: List[Finding] = []
        for fq, info in _function_defs(graph):
            flow = _FunctionFlow(
                graph, info.model, fq, info.node, summaries,
                pragma_by_path.get(info.model.path, {}),
                collect=findings,
            )
            flow.run()
        # dedupe identical (path, line, message) triples produced by the
        # two-pass loop fixpoint
        seen: Set[Tuple[str, int, str]] = set()
        out: List[Finding] = []
        for f in sorted(findings, key=Finding.sort_key):
            k = (f.path, f.line, f.message)
            if k not in seen:
                seen.add(k)
                out.append(f)
        return out


# -- GL012: surface gating + serialization choke points -----------------------

# sentinel for "endpoint not registered as any known surface"
_UNKNOWN = object()

# endpoint path prefix -> name that must be read inside the handler branch
# (None = the endpoint is a core ungated surface)
GATED_ENDPOINTS = {
    "/tracez": "tracing_enabled",
    "/perfz": "perf_enabled",
    "/explainz": "explain_enabled",
    "/sloz": "slo_enabled",
    "/journalz": "journal_enabled",
    "/snapshotz": "debugger",
    "/debug/pprof": "profiling",
}
UNGATED_ENDPOINTS = {"/metrics", "/health-check", "/status"}


class SurfaceGatingChecker:
    """GL012 — every status-server endpoint is gated by its wired flag and
    every replay-scope serialization rides the sort_keys choke shape."""

    rule_id = "GL012"
    title = "ungated status endpoint or ad-hoc (unsorted) JSON serialization"

    def check_program(self, graph: CallGraph) -> List[Finding]:
        out: List[Finding] = []
        for model in graph.models:
            if model.in_module("main.py"):
                out.extend(self._check_endpoints(model))
            if in_replay_scope(model):
                out.extend(self._check_dumps(model))
        return out

    # -- endpoint gating ------------------------------------------------------

    def _check_endpoints(self, model: FileModel) -> List[Finding]:
        out: List[Finding] = []
        for fn in ast.walk(model.tree):
            if (
                isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                and fn.name == "do_GET"
            ):
                out.extend(self._check_handler(model, fn))
        return out

    def _check_handler(self, model: FileModel, fn: ast.AST) -> List[Finding]:
        out: List[Finding] = []
        for test_node, branch in self._path_branches(fn):
            # a compound test (`self.path in ("/a", "/b")`) serves several
            # endpoints from one branch: every one must satisfy its gate
            for endpoint in self._endpoints_of(test_node):
                gate = self._gate_for(endpoint)
                if gate is _UNKNOWN:
                    out.append(
                        model.finding(
                            test_node,
                            self.rule_id,
                            f"status endpoint {endpoint!r} is not a known "
                            "surface — new endpoints must be gated by a "
                            "wired flag (GL009) and registered in "
                            "analysis/dataflow.GATED_ENDPOINTS",
                        )
                    )
                    continue
                if gate is None:
                    continue
                if not self._branch_reads(branch, gate):
                    out.append(
                        model.finding(
                            test_node,
                            self.rule_id,
                            f"status endpoint {endpoint!r} is served "
                            f"without consulting its gate ({gate!r}) — the "
                            "handler branch must read the flag and 404 "
                            "when disabled",
                        )
                    )
        return out

    @staticmethod
    def _path_branches(fn: ast.AST):
        """(test, branch_body) for every if/elif arm of the handler that
        compares ``self.path`` against a string literal."""
        for node in ast.walk(fn):
            if isinstance(node, ast.If):
                yield node.test, node.body

    @staticmethod
    def _endpoints_of(test: ast.AST) -> List[str]:
        """Every endpoint literal in a ``self.path == "/x"`` /
        ``self.path.startswith("/x")`` / ``self.path in ("/x", "/y")``
        test. Only the handler's own ``self.path`` counts — inner
        ``url.path`` sub-routing inside an already-gated branch is not a
        new surface."""
        lits: List[str] = []
        involves_path = False
        for n in ast.walk(test):
            if (
                isinstance(n, ast.Attribute)
                and n.attr == "path"
                and isinstance(n.value, ast.Name)
                and n.value.id == "self"
            ):
                involves_path = True
            if isinstance(n, ast.Constant) and isinstance(n.value, str):
                if n.value.startswith("/"):
                    lits.append(n.value)
        return lits if involves_path else []

    @staticmethod
    def _gate_for(endpoint: str):
        # path-boundary matching: "/statusz" must NOT inherit "/status"'s
        # ungated standing — only the exact path or a "/"-separated
        # sub-path counts as the same surface
        for prefix, gate in GATED_ENDPOINTS.items():
            if endpoint == prefix or endpoint.startswith(prefix + "/"):
                return gate
        for known in UNGATED_ENDPOINTS:
            if endpoint == known or endpoint.startswith(known + "/"):
                return None
        return _UNKNOWN

    @staticmethod
    def _branch_reads(branch: Sequence[ast.AST], name: str) -> bool:
        for stmt in branch:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Attribute) and n.attr == name:
                    return True
                if isinstance(n, ast.Name) and n.id == name:
                    return True
                if (
                    isinstance(n, ast.Call)
                    and terminal_name(n.func) == "getattr"
                    and len(n.args) >= 2
                    and isinstance(n.args[1], ast.Constant)
                    and n.args[1].value == name
                ):
                    return True
        return False

    # -- serialization choke shape --------------------------------------------

    def _check_dumps(self, model: FileModel) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.Call):
                continue
            q = model.qualname(node.func)
            if q not in ("json.dumps", "json.dump"):
                continue
            if not model.is_imported(node.func):
                continue
            sorts = any(
                kw.arg == "sort_keys"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in node.keywords
            )
            if not sorts:
                out.append(
                    model.finding(
                        node,
                        self.rule_id,
                        f"{q}(...) in a replay-reachable module without "
                        "sort_keys=True — ledger/trace serialization must "
                        "ride the record_line-style choke shape so key "
                        "order can never fork the byte-diff contract",
                    )
                )
        return out
