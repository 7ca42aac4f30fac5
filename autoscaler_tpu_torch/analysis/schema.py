"""GL017 — ledger-schema drift proofs.

Seven JSONL ledger schemas flow through this codebase (``perf.tick/1``,
``explain.decision/2``, ``fleet.round/3``, ``slo.window/1``,
``gym.generation/1``, ``journal.tick/1``, ``trace.chrome/1``), each with
a producer, a ``validate_*`` twin, and a summarizer that can silently
drift apart — a producer grows a field the validator never checks, a
validator requires a field no producer emits, or the field set changes
without the ``/1``→``/2`` version bump once performed by hand. This
rule AST-extracts all three field sets per schema tag and diffs them
against the tag module's ``SCHEMA_FIELDS`` manifest — the declared,
versioned contract.

What is extracted (under-approximate — prove, never guess):

- **Tags**: module-level ``NAME = "autoscaler_tpu.<...>/<int>"``
  (the wire tags both packages write; ``autoscaler_tpu_torch.<...>`` too)
  constants. The defining module owns the tag; any other module spelling
  the tag as a string literal (docstrings aside) breaks single-sourcing
  and is a finding — import the constant instead.
- **Manifests**: a module-level ``SCHEMA_FIELDS = {TAG: {"required":
  (...), "optional": (...)}}`` dict in the tag's module. The manifest
  sits beside the version tag on purpose: changing the field contract
  forces an edit here, where the version string is staring at you.
- **Producers**: every dict literal carrying a ``"schema"`` key that
  resolves (through the import map) to a tag. Literals whose only
  consumer is ``stable_json`` are *views* (the ``/perfz``-style serving
  docs) and exempt. A literal bound to a local or ``self.*`` carrier
  accumulates constant-key subscript stores — including through
  ``rec = self._tick`` aliases — so the observatory's two-phase tick
  record extracts whole. One dynamic store key makes the producer
  *open*: its field set is unknowable statically, so the coverage
  checks are skipped for it rather than guessed at.
- **Validators/summarizers**: ``validate_*`` / ``summarize*`` defs in
  the tag module. The record variable is recovered from the
  ``for i, rec in enumerate(records)`` loop shape (first parameter as a
  fallback for single-doc validators); checked/read keys come from
  ``rec["k"]``, ``rec.get("k")`` and ``"k" in rec``, following helpers
  that take the whole record (``_check_pods(i, rec, errors)``) but not
  nested-section helpers.

The diffs then enforce: every producer field is declared; every
declared field is validator-checked; every validator-checked or
summarizer-read field is declared; every required field has a closed
producer emitting it. A mismatch message always says the same thing:
update the manifest AND bump the version — that is the machine-enforced
version-bump discipline.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from autoscaler_tpu_torch.analysis.callgraph import dotted_module
from autoscaler_tpu_torch.analysis.engine import FileModel, Finding, terminal_name

RULE = "GL017"

# the port writes the JAX package's wire tags (its ledgers are byte-equal to
# the JAX package's); a tag under the port's own name is a tag too
_TAG_RE = re.compile(r"^autoscaler_tpu(?:_torch)?\.[a-z_][a-z0-9_.]*/\d+$")


@dataclass
class _Tag:
    value: str                    # "autoscaler_tpu.perf.tick/1"
    name: str                     # "SCHEMA"
    const_fq: str                 # "autoscaler_tpu_torch.perf.ledger.SCHEMA"
    model: FileModel
    node: ast.stmt
    required: Optional[Tuple[str, ...]] = None
    optional: Optional[Tuple[str, ...]] = None

    @property
    def declared(self) -> Set[str]:
        return set(self.required or ()) | set(self.optional or ())


@dataclass
class _Producer:
    tag: _Tag
    model: FileModel
    node: ast.AST                 # the dict literal
    where: str                    # enclosing def qualname
    fields: Set[str] = field(default_factory=set)
    open: bool = False            # a dynamic store key was seen


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _str_items(node: ast.AST) -> Optional[Tuple[str, ...]]:
    if not isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return None
    out: List[str] = []
    for el in node.elts:
        s = _const_str(el)
        if s is None:
            return None
        out.append(s)
    return tuple(out)


class SchemaChecker:
    """GL017: producer/validator/summarizer field sets vs SCHEMA_FIELDS."""

    rule_id = RULE
    title = "ledger-schema drift (producer/validator/manifest coherence)"

    def check_program(self, graph) -> List[Finding]:
        findings: List[Finding] = []
        tags = self._collect_tags(graph)
        if not tags:
            return findings
        by_value = {t.value: t for t in tags}
        by_const_fq = {t.const_fq: t for t in tags}
        findings.extend(self._collect_manifests(graph, tags, by_value))

        producers: List[_Producer] = []
        validators: Dict[str, List[Tuple[str, ast.AST, FileModel, Set[str]]]] = {}
        summarizers: Dict[str, List[Tuple[str, ast.AST, FileModel, Set[str]]]] = {}
        for model in graph.models:
            parents = _parent_map(model.tree)
            producers.extend(
                self._producers_in(model, parents, by_value, by_const_fq)
            )
            findings.extend(self._hardcoded_tags(model, parents, by_value))
            for t in tags:
                if t.model is not model:
                    continue
                for name, node, keys in self._consumer_defs(
                    model, ("validate_",)
                ):
                    validators.setdefault(t.value, []).append(
                        (name, node, model, keys)
                    )
                for name, node, keys in self._consumer_defs(
                    model, ("summarize",)
                ):
                    summarizers.setdefault(t.value, []).append(
                        (name, node, model, keys)
                    )

        for t in tags:
            findings.extend(
                self._diff_tag(
                    t,
                    [p for p in producers if p.tag is t],
                    validators.get(t.value, []),
                    summarizers.get(t.value, []),
                )
            )
        return findings

    # -- tag + manifest collection -------------------------------------------

    def _collect_tags(self, graph) -> List[_Tag]:
        tags: List[_Tag] = []
        for model in graph.models:
            dm = dotted_module(model)
            if dm is None:
                continue
            for stmt in model.tree.body:
                if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                    continue
                target = stmt.targets[0]
                value = _const_str(stmt.value)
                if (
                    isinstance(target, ast.Name)
                    and value is not None
                    and _TAG_RE.match(value)
                ):
                    tags.append(
                        _Tag(
                            value=value,
                            name=target.id,
                            const_fq=f"{dm}.{target.id}",
                            model=model,
                            node=stmt,
                        )
                    )
        return tags

    def _collect_manifests(
        self, graph, tags: List[_Tag], by_value: Dict[str, _Tag]
    ) -> List[Finding]:
        findings: List[Finding] = []
        for model in graph.models:
            local_tags = {t.name: t for t in tags if t.model is model}
            for stmt in model.tree.body:
                if (
                    not isinstance(stmt, ast.Assign)
                    or len(stmt.targets) != 1
                    or not isinstance(stmt.targets[0], ast.Name)
                    or stmt.targets[0].id != "SCHEMA_FIELDS"
                    or not isinstance(stmt.value, ast.Dict)
                ):
                    continue
                for key, val in zip(stmt.value.keys, stmt.value.values):
                    tag: Optional[_Tag] = None
                    if isinstance(key, ast.Name):
                        tag = local_tags.get(key.id)
                    else:
                        literal = _const_str(key) if key is not None else None
                        if literal is not None:
                            tag = by_value.get(literal)
                            if tag is not None and tag.model is not model:
                                tag = None  # a manifest only binds its own tag
                    if tag is None:
                        findings.append(
                            model.finding(
                                key if key is not None else stmt,
                                RULE,
                                "SCHEMA_FIELDS declares fields for a key "
                                "that is not a schema tag defined in this "
                                "module",
                            )
                        )
                        continue
                    req: Optional[Tuple[str, ...]] = None
                    opt: Tuple[str, ...] = ()
                    if isinstance(val, ast.Dict):
                        for k2, v2 in zip(val.keys, val.values):
                            ks = _const_str(k2) if k2 is not None else None
                            if ks == "required":
                                req = _str_items(v2)
                            elif ks == "optional":
                                opt = _str_items(v2) or ()
                    if req is None:
                        findings.append(
                            model.finding(
                                val,
                                RULE,
                                f"SCHEMA_FIELDS entry for {tag.value} must "
                                "carry a literal \"required\" tuple of field "
                                "names (plus an optional \"optional\" tuple)",
                            )
                        )
                        continue
                    tag.required = req
                    tag.optional = opt
        for t in tags:
            if t.required is None:
                findings.append(
                    t.model.finding(
                        t.node,
                        RULE,
                        f"schema tag {t.value} has no SCHEMA_FIELDS manifest "
                        "entry in its defining module — the field contract "
                        "must be machine-readable (declare required/optional "
                        "fields beside the version tag)",
                    )
                )
        return findings

    # -- producers ------------------------------------------------------------

    def _resolve_tag(
        self,
        model: FileModel,
        node: ast.AST,
        by_value: Dict[str, _Tag],
        by_const_fq: Dict[str, _Tag],
    ) -> Optional[_Tag]:
        literal = _const_str(node)
        if literal is not None:
            return by_value.get(literal)
        dotted = model.dotted(node, resolve=True)
        if dotted is None:
            return None
        tag = by_const_fq.get(dotted)
        if tag is not None:
            return tag
        # same-module bare reference (`SCHEMA` inside perf/ledger.py)
        dm = dotted_module(model)
        if dm is not None:
            return by_const_fq.get(f"{dm}.{dotted}")
        return None

    def _producers_in(
        self,
        model: FileModel,
        parents: Dict[ast.AST, ast.AST],
        by_value: Dict[str, _Tag],
        by_const_fq: Dict[str, _Tag],
    ) -> List[_Producer]:
        producers: List[_Producer] = []
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.Dict):
                continue
            tag: Optional[_Tag] = None
            lit_fields: Set[str] = set()
            open_literal = False
            for k, v in zip(node.keys, node.values):
                ks = _const_str(k) if k is not None else None
                if ks is None:
                    open_literal = True  # **spread or computed key
                    continue
                if ks == "schema":
                    tag = self._resolve_tag(model, v, by_value, by_const_fq)
                else:
                    lit_fields.add(ks)
            if tag is None:
                continue
            ctx = self._literal_context(model, parents, node)
            if ctx is None:
                continue  # a stable_json view
            where, extra_fields, is_open = ctx
            producers.append(
                _Producer(
                    tag=tag,
                    model=model,
                    node=node,
                    where=where,
                    fields=lit_fields | extra_fields,
                    open=is_open or open_literal,
                )
            )
        return producers

    def _literal_context(
        self,
        model: FileModel,
        parents: Dict[ast.AST, ast.AST],
        literal: ast.Dict,
    ) -> Optional[Tuple[str, Set[str], bool]]:
        """(where, carrier-added fields, open?) — or None for a view."""
        stmt: Optional[ast.stmt] = None
        cur: ast.AST = literal
        while cur in parents:
            parent = parents[cur]
            if (
                isinstance(parent, ast.Call)
                and cur in parent.args
                and terminal_name(parent.func) == "stable_json"
            ):
                return None  # serving view, not a ledger record
            if isinstance(parent, ast.stmt):
                stmt = parent
                break
            cur = parent
        if stmt is None:
            return None
        fn = self._enclosing(parents, stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
        where = self._qual(parents, stmt)
        target: Optional[ast.expr] = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target = stmt.targets[0]
        elif isinstance(stmt, ast.AnnAssign):
            target = stmt.target
        if isinstance(target, ast.Name) and fn is not None:
            return self._var_producer(model, fn, target.id, where)
        if (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            cls = self._enclosing(parents, stmt, (ast.ClassDef,))
            if isinstance(cls, ast.ClassDef):
                return self._carrier_producer(cls, target.attr, where)
        return (where, set(), False)

    def _enclosing(self, parents, node: ast.AST, kinds) -> Optional[ast.AST]:
        cur: ast.AST = node
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, kinds):
                return cur
        return None

    def _qual(self, parents, node: ast.AST) -> str:
        names: List[str] = []
        cur: ast.AST = node
        while cur in parents:
            cur = parents[cur]
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                names.append(cur.name)
        names.reverse()
        return ".".join(names) or "<module>"

    def _subscript_stores(
        self, scope: ast.AST, base_match
    ) -> Tuple[Set[str], bool]:
        """Constant keys stored via subscript on matching bases; True when
        any store key is dynamic."""
        fields: Set[str] = set()
        dynamic = False
        for n in ast.walk(scope):
            targets: List[ast.expr] = []
            if isinstance(n, ast.Assign):
                targets = list(n.targets)
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            for t in targets:
                if isinstance(t, ast.Subscript) and base_match(t.value):
                    key = _const_str(t.slice)
                    if key is None:
                        dynamic = True
                    else:
                        fields.add(key)
        return fields, dynamic

    def _var_producer(
        self, model: FileModel, fn: ast.AST, var: str, where: str
    ) -> Optional[Tuple[str, Set[str], bool]]:
        fields, dynamic = self._subscript_stores(
            fn, lambda b: isinstance(b, ast.Name) and b.id == var
        )
        # view check: every plain load of the var feeds stable_json only
        store_bases: Set[int] = set()
        for n in ast.walk(fn):
            targets = []
            if isinstance(n, ast.Assign):
                targets = list(n.targets)
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            for t in targets:
                if isinstance(t, ast.Subscript) and isinstance(
                    t.value, ast.Name
                ):
                    store_bases.add(id(t.value))
        loads: List[ast.Name] = [
            n
            for n in ast.walk(fn)
            if isinstance(n, ast.Name)
            and n.id == var
            and isinstance(n.ctx, ast.Load)
            and id(n) not in store_bases
        ]
        if loads:
            pm = _parent_map(fn)
            if all(
                isinstance(pm.get(ld), ast.Call)
                and ld in pm[ld].args  # type: ignore[union-attr]
                and terminal_name(pm[ld].func) == "stable_json"  # type: ignore[union-attr]
                for ld in loads
            ):
                return None  # the var only ever becomes a serving view
        return (where, fields, dynamic)

    def _carrier_producer(
        self, cls: ast.ClassDef, attr: str, where: str
    ) -> Tuple[str, Set[str], bool]:
        fields: Set[str] = set()
        dynamic = False

        def is_self_attr(b: ast.AST) -> bool:
            return (
                isinstance(b, ast.Attribute)
                and b.attr == attr
                and isinstance(b.value, ast.Name)
                and b.value.id == "self"
            )

        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            got, dyn = self._subscript_stores(meth, is_self_attr)
            fields |= got
            dynamic = dynamic or dyn
            # aliases: rec = self._tick → stores on rec count too
            aliases = {
                t.id
                for n in ast.walk(meth)
                if isinstance(n, ast.Assign) and is_self_attr(n.value)
                for t in n.targets
                if isinstance(t, ast.Name)
            }
            if aliases:
                got, dyn = self._subscript_stores(
                    meth,
                    lambda b: isinstance(b, ast.Name) and b.id in aliases,
                )
                fields |= got
                dynamic = dynamic or dyn
        return (where, fields, dynamic)

    # -- validators / summarizers ---------------------------------------------

    def _consumer_defs(
        self, model: FileModel, prefixes: Tuple[str, ...]
    ) -> List[Tuple[str, ast.AST, Set[str]]]:
        module_funcs = {
            s.name: s
            for s in model.tree.body
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        out: List[Tuple[str, ast.AST, Set[str]]] = []
        for name in sorted(module_funcs):
            if not any(name.startswith(p) for p in prefixes):
                continue
            fn = module_funcs[name]
            keys = self._record_keys(fn, module_funcs, visited=set())
            out.append((name, fn, keys))
        return out

    def _record_vars(self, fn) -> Set[str]:
        """Names bound to one whole record inside this def."""
        params = [
            a.arg for a in fn.args.args if a.arg not in ("self", "cls")
        ]
        if not params:
            return set()
        rec_vars: Set[str] = set()
        loops: List[Tuple[ast.expr, ast.expr]] = []  # (target, iter)
        for n in ast.walk(fn):
            if isinstance(n, (ast.For, ast.AsyncFor)):
                loops.append((n.target, n.iter))
            elif isinstance(n, ast.comprehension):
                loops.append((n.target, n.iter))
        for target, it in loops:
            src: Optional[ast.expr] = None
            if isinstance(it, ast.Name) and it.id == params[0]:
                src = it
                if isinstance(target, ast.Name):
                    rec_vars.add(target.id)
            elif (
                isinstance(it, ast.Call)
                and terminal_name(it.func) == "enumerate"
                and it.args
                and isinstance(it.args[0], ast.Name)
                and it.args[0].id == params[0]
            ):
                if (
                    isinstance(target, ast.Tuple)
                    and len(target.elts) == 2
                    and isinstance(target.elts[1], ast.Name)
                ):
                    rec_vars.add(target.elts[1].id)
        if not rec_vars:
            rec_vars.add(params[0])  # single-doc validator (chrome)
        return rec_vars

    def _record_keys(
        self, fn, module_funcs: Dict[str, ast.AST], visited: Set[Tuple[str, str]]
    ) -> Set[str]:
        rec_vars = self._record_vars(fn)
        keys: Set[str] = set()
        for var in sorted(rec_vars):
            keys |= self._keys_for(fn, var, module_funcs, visited)
        # whole-sequence element access: records[0].get("k"), records[-1]["k"]
        params = [a.arg for a in fn.args.args if a.arg not in ("self", "cls")]
        if params:
            pm = _parent_map(fn)
            for n in ast.walk(fn):
                if (
                    isinstance(n, ast.Subscript)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == params[0]
                    and isinstance(n.slice, ast.expr)
                    and _const_str(n.slice) is None
                ):
                    parent = pm.get(n)
                    if isinstance(parent, ast.Subscript) and parent.value is n:
                        k = _const_str(parent.slice)
                        if k is not None:
                            keys.add(k)
                    elif (
                        isinstance(parent, ast.Attribute)
                        and parent.attr == "get"
                        and isinstance(pm.get(parent), ast.Call)
                        and pm[parent].args  # type: ignore[union-attr]
                    ):
                        k = _const_str(pm[parent].args[0])  # type: ignore[union-attr]
                        if k is not None:
                            keys.add(k)
        return keys

    def _keys_for(
        self,
        fn,
        var: str,
        module_funcs: Dict[str, ast.AST],
        visited: Set[Tuple[str, str]],
    ) -> Set[str]:
        mark = (getattr(fn, "name", "?"), var)
        if mark in visited:
            return set()
        visited.add(mark)
        keys: Set[str] = set()
        for n in ast.walk(fn):
            if (
                isinstance(n, ast.Subscript)
                and isinstance(n.value, ast.Name)
                and n.value.id == var
            ):
                k = _const_str(n.slice)
                if k is not None:
                    keys.add(k)
            elif (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "get"
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == var
                and n.args
            ):
                k = _const_str(n.args[0])
                if k is not None:
                    keys.add(k)
            elif isinstance(n, ast.Compare) and len(n.ops) == 1:
                if (
                    isinstance(n.ops[0], (ast.In, ast.NotIn))
                    and isinstance(n.comparators[0], ast.Name)
                    and n.comparators[0].id == var
                ):
                    k = _const_str(n.left)
                    if k is not None:
                        keys.add(k)
            elif isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
                helper = module_funcs.get(n.func.id)
                if helper is None:
                    continue
                for pos, arg in enumerate(n.args):
                    if isinstance(arg, ast.Name) and arg.id == var:
                        hargs = [a.arg for a in helper.args.args]
                        if pos < len(hargs):
                            keys |= self._keys_for(
                                helper, hargs[pos], module_funcs, visited
                            )
        return keys

    # -- single-sourcing ------------------------------------------------------

    def _hardcoded_tags(
        self,
        model: FileModel,
        parents: Dict[ast.AST, ast.AST],
        by_value: Dict[str, _Tag],
    ) -> List[Finding]:
        findings: List[Finding] = []
        for n in ast.walk(model.tree):
            value = _const_str(n)
            if value is None:
                continue
            tag = by_value.get(value)
            if tag is None or tag.model is model:
                continue
            parent = parents.get(n)
            if isinstance(parent, ast.Expr):
                continue  # docstring
            findings.append(
                model.finding(
                    n,
                    RULE,
                    f"schema tag {value} is hardcoded outside its defining "
                    f"module — import the tag constant instead "
                    f"(version strings are single-sourced)",
                )
            )
        return findings

    # -- the diff -------------------------------------------------------------

    def _diff_tag(
        self,
        tag: _Tag,
        producers: List[_Producer],
        validators: List[Tuple[str, ast.AST, FileModel, Set[str]]],
        summarizers: List[Tuple[str, ast.AST, FileModel, Set[str]]],
    ) -> List[Finding]:
        findings: List[Finding] = []
        if tag.required is None:
            return findings  # already reported: no manifest, nothing to diff
        declared = tag.declared

        for p in producers:
            if p.open:
                continue  # field set statically unknowable — don't guess
            for k in sorted(p.fields - declared):
                findings.append(
                    p.model.finding(
                        p.node,
                        RULE,
                        f"producer {p.where} emits field {k!r} that the "
                        f"SCHEMA_FIELDS manifest for {tag.value} does not "
                        f"declare — declare it and bump the schema version",
                    )
                )
            for k in sorted(set(tag.required) - p.fields):
                findings.append(
                    p.model.finding(
                        p.node,
                        RULE,
                        f"producer {p.where} never emits required field "
                        f"{k!r} of {tag.value} — emit it, or demote the "
                        f"field and bump the schema version",
                    )
                )

        closed = [p for p in producers if not p.open]
        if closed:
            emitted = set()
            for p in closed:
                emitted |= p.fields
            for k in sorted(set(tag.required) - emitted):
                # per-producer coverage above already names each culprit;
                # this catches required fields with NO producer at all
                if not any(k in p.fields for p in producers):
                    findings.append(
                        tag.model.finding(
                            tag.node,
                            RULE,
                            f"required field {k!r} of {tag.value} is emitted "
                            f"by no producer — dead contract or missing "
                            f"producer code",
                        )
                    )

        if not validators:
            findings.append(
                tag.model.finding(
                    tag.node,
                    RULE,
                    f"schema tag {tag.value} has no validate_* twin in its "
                    f"defining module — every ledger schema ships with a "
                    f"machine validator",
                )
            )
        else:
            checked_union: Set[str] = set()
            for name, node, model, keys in validators:
                checked_union |= keys
                for k in sorted((keys - {"schema"}) - declared):
                    findings.append(
                        model.finding(
                            node,
                            RULE,
                            f"validator {name} checks field {k!r} that the "
                            f"SCHEMA_FIELDS manifest for {tag.value} does "
                            f"not declare — stale check, or an undeclared "
                            f"contract (declare it and bump the version)",
                        )
                    )
            for k in sorted(declared - checked_union):
                name, node, model, _keys = validators[0]
                findings.append(
                    model.finding(
                        node,
                        RULE,
                        f"field {k!r} of {tag.value} is declared but "
                        f"{name} never checks it — producer drift on this "
                        f"field would pass validation silently",
                    )
                )

        for name, node, model, keys in summarizers:
            for k in sorted((keys - {"schema"}) - declared):
                findings.append(
                    model.finding(
                        node,
                        RULE,
                        f"summarizer {name} reads field {k!r} that the "
                        f"SCHEMA_FIELDS manifest for {tag.value} does not "
                        f"declare — it would read a field no validator "
                        f"guards",
                    )
                )
        return findings
