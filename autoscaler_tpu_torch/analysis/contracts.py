"""GL007 — kernel shape/tiling contract checker.

Every kernel entry point in ``ops/`` declares a machine-readable contract in
a module-level ``KERNEL_CONTRACTS`` dict literal (AST-extracted, never
imported — same trick as the GL002 taxonomy). A contract names, per entry:

``args``
    Declared operand dims (symbolic, e.g. ``["P", "R"]``) and dtype. Dim
    symbols tie across operands: ``pod_req: [P, R]`` and ``pod_masks:
    [G, P]`` must agree on ``P`` at every dispatch site where shapes are
    statically known.
``static``
    Constraints on static (Python-int) parameters: ``multiple_of`` (tiling
    alignment, e.g. ``chunk % _STEP_TILE == 0``) and ``min``. Each
    ``multiple_of`` must be backed by a *runtime guard* in the entry
    function (an ``if`` on ``param % tile`` that raises) — the lint proves
    the guard exists; the guard proves the property at run time for the
    shapes the lint cannot see.
``pad``
    Padding rules ``{padded: [base, divisor]}``. Each must be *witnessed*
    by the canonical exact-padding idiom ``padded = base + (-base) % divisor``
    somewhere in the defining module. The witnessed idiom is also the
    divisibility FACT the grid check consumes. Facts are keyed by variable
    name module-wide — the naming convention (``P_pad`` always means the
    chunk-padded pod axis) is part of the contract.
``grid``
    The expected launch grid, each element as an expression string. The
    checker (a) proves each ``A // B`` element exact via the pad facts (a
    grid that doesn't tile its axis silently drops tail elements), and (b)
    verifies the declared grid matches the ``grid=`` keyword of an actual
    launch call in the module, resolving one level of local names (``NC``
    → ``P_pad // chunk``). The port's CUDA entries declare no grid: their
    ctypes launchers take none, and each ``csrc/*.cu`` computes its grid
    in C++, which this checker does not parse (RULES.md, GL007).
``smem``
    The name of the module's function that models the launch's dynamic
    shared memory (``smem_bytes``, ``affinity_smem_bytes``,
    ``rows_smem_bytes``), as the JAX twin named its VMEM model; it must
    be a module-level function of the contract's module.
``pad_value``
    Documentation of the inactive-row sentinel (``"+inf"`` rows sort last
    and fit nowhere); carried into RULES.md, not machine-checked.

The dispatch-site pass then walks every *resolved call site* of a
contracted entry (cross-module, via the call graph): constant static
arguments are checked against the constraints (``chunk=12`` with
``_STEP_TILE = 8`` fails AT LINT TIME, with a dispatch-site→kernel trace in
the message), and an abstract shape interpreter over the calling function
infers operand ranks/dims through the constructors it recognizes
(``np.zeros``/``stack``/``asarray``/``.T``/indexing/``pad``, one hop into
local helper returns) and flags *provable* rank or dim-symbol conflicts.
Unknown shapes stay silent — the rule under-approximates, it never guesses.

``evaluate_contract`` is the same constraint evaluator run on concrete
values; the ``slow``-marked property suite (tests/test_contracts.py) feeds
it randomized shapes and asserts its accept/reject verdict matches actual
CPU acceptance of each entry and, on the card (``chip_smoke.py``), each
launch's success, so the declared contracts cannot drift from what the
kernels enforce. It also proves each padded dim symbol (``P_pad``) a
multiple of its declared divisor.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from autoscaler_tpu_torch.analysis.callgraph import CallGraph, dotted_module
from autoscaler_tpu_torch.analysis.engine import FileModel, Finding

CONTRACT_NAME = "KERNEL_CONTRACTS"
_CONTRACT_KEYS = {"args", "static", "pad", "grid", "pad_value", "smem", "notes"}
_STATIC_KEYS = {"multiple_of", "min", "optional"}

# dtype shorthand -> the dtype name it corresponds to in a coercion of the
# operand as it enters: `asarray(param, np.<name>)` or
# `torch.as_tensor(param, dtype=torch.<name>)`. A derived value
# (`param.to(torch.float32)` for arithmetic, the twin's `.astype`) is not a
# coercion of the operand.
_DTYPE_COERCIONS = {
    "f32": "float32", "f64": "float64", "i32": "int32", "i64": "int64",
    "u8": "uint8", "bool": "bool",
}


def _coercions(fn: ast.AST, arg: str):
    """(call node, dtype name) for every coercion of the parameter ``arg``
    in the entry function, in any of the forms above."""
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        f = node.func
        dtype = None
        if f.attr in ("asarray", "as_tensor") and node.args and (
            isinstance(node.args[0], ast.Name) and node.args[0].id == arg
        ):
            if len(node.args) >= 2:
                dtype = node.args[1]
            else:
                dtype = next((k.value for k in node.keywords if k.arg == "dtype"), None)
        if isinstance(dtype, ast.Attribute):
            yield node, dtype.attr


# -- contract extraction ------------------------------------------------------


@dataclass
class KernelContract:
    fn: str
    module: FileModel
    decl: dict
    line: int

    @property
    def args(self) -> dict:
        return self.decl.get("args", {})

    @property
    def static(self) -> dict:
        return self.decl.get("static", {})

    @property
    def pad(self) -> dict:
        return self.decl.get("pad", {})

    @property
    def grid(self) -> list:
        return self.decl.get("grid", [])


def extract_contracts(
    model: FileModel,
) -> Tuple[Dict[str, KernelContract], List[Finding]]:
    """Pull ``KERNEL_CONTRACTS`` out of one module by AST. Malformed
    declarations are findings, not crashes."""
    out: Dict[str, KernelContract] = {}
    findings: List[Finding] = []
    for node in model.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == CONTRACT_NAME for t in node.targets
        ):
            continue
        try:
            decl = ast.literal_eval(node.value)
        except (ValueError, SyntaxError):
            findings.append(
                model.finding(
                    node,
                    "GL007",
                    f"{CONTRACT_NAME} must be a pure literal dict "
                    "(AST-extracted, never imported)",
                )
            )
            continue
        if not isinstance(decl, dict):
            findings.append(
                model.finding(
                    node, "GL007", f"{CONTRACT_NAME} must be a dict of contracts"
                )
            )
            continue
        for fn_name in sorted(decl):
            body = decl[fn_name]
            bad_keys = sorted(set(body) - _CONTRACT_KEYS)
            if bad_keys:
                findings.append(
                    model.finding(
                        node,
                        "GL007",
                        f"contract for {fn_name}() has unknown keys "
                        f"{bad_keys} (allowed: {sorted(_CONTRACT_KEYS)})",
                    )
                )
            out[fn_name] = KernelContract(
                fn=fn_name, module=model, decl=body, line=node.lineno
            )
    return out, findings


# -- module facts -------------------------------------------------------------


def _unparse(node: ast.AST) -> str:
    return ast.unparse(node)


def pad_idioms(model: FileModel) -> Dict[str, Tuple[str, str]]:
    """``{padded_name: (base_expr, divisor_expr)}`` from every occurrence of
    the exact-padding idiom ``X = Y + (-Y) % K`` in the module. Each entry
    is both a witness (the padding exists) and a divisibility fact
    (``X % K == 0`` holds by construction)."""
    out: Dict[str, Tuple[str, str]] = {}
    for node in ast.walk(model.tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        v = node.value
        if not (isinstance(v, ast.BinOp) and isinstance(v.op, ast.Add)):
            continue
        mod = v.right
        if not (isinstance(mod, ast.BinOp) and isinstance(mod.op, ast.Mod)):
            continue
        neg = mod.left
        if not (isinstance(neg, ast.UnaryOp) and isinstance(neg.op, ast.USub)):
            continue
        if _unparse(neg.operand) != _unparse(v.left):
            continue
        out[tgt.id] = (_unparse(v.left), _unparse(mod.right))
    return out


def module_int_constants(model: FileModel) -> Dict[str, int]:
    """Module-level ``NAME = <int>`` bindings (``_STEP_TILE = 8``)."""
    out: Dict[str, int] = {}
    for node in model.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if (
                isinstance(tgt, ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)
                and not isinstance(node.value.value, bool)
            ):
                out[tgt.id] = node.value.value
    return out


def name_assignments(model: FileModel) -> Dict[str, List[ast.AST]]:
    """Every ``name = expr`` in the module (any scope), for one-level grid
    name resolution (``NC`` → ``P_pad // chunk``)."""
    out: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                out.setdefault(tgt.id, []).append(node.value)
    return out


def _fn_params(fn: ast.AST) -> List[str]:
    a = fn.args
    return [p.arg for p in [*a.posonlyargs, *a.args, *a.kwonlyargs]]


def _binding_names(stmt: ast.AST) -> List[str]:
    """Names bound by constructs other than a simple single-target Assign
    (loop targets, ``with ... as``, augmented/annotated/walrus/unpacking
    assignments): ShapeEnv poisons these — their value is path-dependent."""
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)  # multi-target or unpacking form
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        targets = [i.optional_vars for i in stmt.items if i.optional_vars]
    out: List[str] = []
    for tgt in targets:
        for node in ast.walk(tgt):
            if isinstance(node, ast.Name):
                out.append(node.id)
    return out


def _has_mod_guard(
    fn: ast.AST,
    param: str,
    divisor,
    constants: Dict[str, int],
) -> bool:
    """Does the entry function raise on ``param % tile != 0`` with the
    CONTRACT's tile? The guard's modulus divisor must match the declared
    ``multiple_of`` textually or by resolved int value — a guard on the
    wrong tile (``chunk % 2``) is drift, not a witness."""

    def divisor_matches(node: ast.AST) -> bool:
        if _unparse(node) == str(divisor):
            return True
        want = divisor if isinstance(divisor, int) else constants.get(str(divisor))
        if want is None:
            return False
        if isinstance(node, ast.Constant) and node.value == want:
            return True
        return isinstance(node, ast.Name) and constants.get(node.id) == want

    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        has_mod = any(
            isinstance(t, ast.BinOp)
            and isinstance(t.op, ast.Mod)
            and isinstance(t.left, ast.Name)
            and t.left.id == param
            and divisor_matches(t.right)
            for t in ast.walk(node.test)
        )
        if has_mod and any(isinstance(b, ast.Raise) for b in ast.walk(node)):
            return True
    return False


# -- abstract shapes ----------------------------------------------------------

Dim = object  # int | str (symbol) | None (unknown)

_CONSTRUCTORS = {"zeros", "ones", "empty", "full"}
_PRESERVING = {
    "asarray", "ascontiguousarray", "array", "abs", "copy",
    "tensor", "as_tensor", "from_numpy",
}


class ShapeEnv:
    """Tiny abstract interpreter over one function body: tracks the shapes
    of local names through the constructors/reshapes it recognizes. Dims
    are ints, symbol strings (the ``ast.unparse`` of the dim expression),
    or None (unknown). Anything unrecognized evaluates to None — the
    checker only acts on what is provable."""

    def __init__(self, graph: Optional[CallGraph], model: FileModel):
        self.graph = graph
        self.model = model
        self.env: Dict[str, Optional[Tuple]] = {}
        self.lines: Dict[str, int] = {}  # name -> line of its one binding
        self._inlining: Set[str] = set()
        self._query_line: Optional[int] = None

    def run(self, fn: ast.AST) -> None:
        # Flow-sensitivity by under-approximation: a name rebound anywhere
        # in the function (second Assign, AugAssign, loop target, with-as,
        # walrus, or shadowing a parameter) is never bound — its shape at
        # any given site depends on the path taken, and this checker only
        # acts on what is provable. Single bindings are applied in source
        # order and remember their line so shape_at() can refuse lookups
        # lexically before the binding.
        poisoned: Set[str] = set(
            _fn_params(fn)
        ) if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) else set()
        counts: Dict[str, int] = {}
        assigns: List[ast.Assign] = []
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and (
                isinstance(stmt.targets[0], ast.Name)
            ):
                counts[stmt.targets[0].id] = counts.get(stmt.targets[0].id, 0) + 1
                assigns.append(stmt)
                continue
            for tgt in _binding_names(stmt):
                poisoned.add(tgt)
        poisoned |= {name for name, n in counts.items() if n > 1}
        for stmt in sorted(assigns, key=lambda s: (s.lineno, s.col_offset)):
            name = stmt.targets[0].id
            if name in poisoned:
                continue
            self.env[name] = self.shape_of(stmt.value)
            self.lines[name] = stmt.lineno

    def shape_at(self, expr: ast.AST, line: int) -> Optional[Tuple]:
        """shape_of, but Name lookups bound lexically after ``line`` (the
        dispatch site) resolve to unknown instead of their later shape."""
        prev = self._query_line
        self._query_line = line
        try:
            return self.shape_of(expr)
        finally:
            self._query_line = prev

    def shape_of(self, expr: ast.AST) -> Optional[Tuple]:
        if isinstance(expr, ast.Name):
            if (
                self._query_line is not None
                and self.lines.get(expr.id, -1) > self._query_line
            ):
                return None
            return self.env.get(expr.id)
        if isinstance(expr, ast.Constant):
            return () if isinstance(expr.value, (int, float, bool)) else None
        if isinstance(expr, ast.Attribute):
            if expr.attr == "T":
                base = self.shape_of(expr.value)
                return tuple(reversed(base)) if base is not None else None
            return None
        if isinstance(expr, ast.Subscript):
            return self._subscript(expr)
        if isinstance(expr, ast.Call):
            return self._call(expr)
        return None

    def _dim(self, node: ast.AST) -> Dim:
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        try:
            return _unparse(node)
        except Exception:  # pragma: no cover - unparse is total on parsed ASTs
            return None

    def _call(self, call: ast.Call) -> Optional[Tuple]:
        fname = call.func.attr if isinstance(call.func, ast.Attribute) else (
            call.func.id if isinstance(call.func, ast.Name) else None
        )
        if fname is None:
            return None
        if fname in _CONSTRUCTORS and call.args:
            shp = call.args[0]
            if isinstance(shp, (ast.Tuple, ast.List)):
                return tuple(self._dim(e) for e in shp.elts)
            return (self._dim(shp),)
        if fname == "arange" and len(call.args) == 1 and not call.keywords:
            # only arange(stop): with start/step the length is stop-start
            # (/step), not the first argument
            return (self._dim(call.args[0]),)
        if fname in _PRESERVING and call.args:
            return self.shape_of(call.args[0])
        if fname == "stack" and call.args:
            # only the default axis=0 stacking is modeled; an explicit
            # non-zero axis would transpose the dims we'd infer
            axis_kw = next(
                (kw for kw in call.keywords if kw.arg == "axis"), None
            )
            if axis_kw is not None and not (
                isinstance(axis_kw.value, ast.Constant)
                and axis_kw.value.value == 0
            ):
                return None
            seq = call.args[0]
            if isinstance(seq, (ast.Tuple, ast.List)) and seq.elts:
                inner = self.shape_of(seq.elts[0])
                if inner is not None:
                    return (len(seq.elts), *inner)
            return None
        if fname == "pad" and call.args:
            inner = self.shape_of(call.args[0])
            return tuple(None for _ in inner) if inner is not None else None
        # one-hop inlining of a local helper's returned constructor shape
        return self._inline(call)

    def _inline(self, call: ast.Call) -> Optional[Tuple]:
        if self.graph is None or not isinstance(call.func, ast.Name):
            return None
        fq = self.graph.resolve(self.model, call.func, None)
        if fq is None or fq in self._inlining:
            return None
        info = self.graph.defs.get(fq)
        if info is None or not isinstance(
            info.node, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            return None
        params = _fn_params(info.node)
        # bind caller argument expressions to callee parameter names
        binding: Dict[str, Dim] = {}
        for i, arg in enumerate(call.args):
            if i < len(params):
                binding[params[i]] = self._dim(arg)
        for kw in call.keywords:
            if kw.arg is not None:
                binding[kw.arg] = self._dim(kw.value)
        self._inlining.add(fq)
        try:
            sub = ShapeEnv(self.graph, info.model)
            sub._inlining = set(self._inlining)
            sub.run(info.node)
            ret = None
            for node in ast.walk(info.node):
                if isinstance(node, ast.Return) and node.value is not None:
                    ret = sub.shape_of(node.value)
                    break  # first return only — deterministic
            if ret is None:
                return None
            return tuple(
                binding.get(d, d) if isinstance(d, str) else d for d in ret
            )
        finally:
            self._inlining.discard(fq)

    def _subscript(self, expr: ast.Subscript) -> Optional[Tuple]:
        base = self.shape_of(expr.value)
        if base is None:
            return None
        idx = expr.slice
        items = list(idx.elts) if isinstance(idx, ast.Tuple) else [idx]
        out: List[Dim] = []
        pos = 0
        for item in items:
            if isinstance(item, ast.Constant) and item.value is Ellipsis:
                # `x[..., 0]`: the axes the ellipsis spans depend on the
                # rank, so left-to-right position mapping breaks — unknown
                return None
            if isinstance(item, ast.Constant) and item.value is None:
                out.append(1)  # x[None, ...] inserts an axis
            elif isinstance(item, ast.Slice):
                if pos < len(base):
                    full = (
                        item.lower is None
                        and item.upper is None
                        and item.step is None  # x[::2] halves the axis
                    )
                    out.append(base[pos] if full else None)
                pos += 1
            else:
                pos += 1  # integer/array index drops the axis
        out.extend(base[pos:] if pos <= len(base) else [])
        return tuple(out)


# -- the rule -----------------------------------------------------------------


@dataclass
class _Resolved:
    """One contract with its environment resolved for checking."""

    contract: KernelContract
    fn_node: Optional[ast.AST]
    constants: Dict[str, int]
    idioms: Dict[str, Tuple[str, str]]
    assigns: Dict[str, List[ast.AST]]


class KernelContractChecker:
    rule_id = "GL007"
    title = "kernel shape/tiling contract violation"

    def check_program(self, graph: CallGraph) -> List[Finding]:
        out: List[Finding] = []
        resolved: Dict[str, _Resolved] = {}  # fq -> resolved contract
        by_arg: Dict[str, List[Tuple[str, dict]]] = {}
        ops_models = [
            m for m in graph.models if m.module and m.module.startswith("ops/")
        ]
        for model in ops_models:
            contracts, errs = extract_contracts(model)
            out.extend(errs)
            if not contracts:
                continue
            constants = self._constants(graph, model)
            idioms = pad_idioms(model)
            assigns = name_assignments(model)
            dm = dotted_module(model)
            for fn_name in sorted(contracts):
                c = contracts[fn_name]
                fq = f"{dm}.{fn_name}"
                info = graph.defs.get(fq)
                if info is None or info.model.path != model.path:
                    out.append(
                        Finding(
                            path=model.path,
                            line=c.line,
                            rule=self.rule_id,
                            message=(
                                f"contract names {fn_name}() but no such "
                                "module-level function exists here"
                            ),
                        )
                    )
                    continue
                r = _Resolved(c, info.node, constants, idioms, assigns)
                resolved[fq] = r
                out.extend(self._check_declaration(model, r))
                for arg, spec in sorted(c.args.items()):
                    by_arg.setdefault(arg, []).append((model.path, spec))

        out.extend(self._check_cross_twin(by_arg, resolved))
        for fq in sorted(resolved):
            out.extend(self._check_dispatch_sites(graph, fq, resolved[fq]))
        return out

    # -- declaration-side checks ---------------------------------------------

    @staticmethod
    def _constants(graph: CallGraph, model: FileModel) -> Dict[str, int]:
        """Local int constants plus imported ones (``STEP_BLOCK`` imported
        from ffd_scan resolves to its value there)."""
        consts = module_int_constants(model)
        by_module = {
            dotted_module(m): m for m in graph.models if dotted_module(m)
        }
        for local, origin in sorted(model.imports.items()):
            if local in consts or "." not in origin:
                continue
            mod_name, attr = origin.rsplit(".", 1)
            other = by_module.get(mod_name)
            if other is not None:
                val = module_int_constants(other).get(attr)
                if val is not None:
                    consts[local] = val
        return consts

    def _divisor_value(self, r: _Resolved, div) -> Optional[int]:
        if isinstance(div, int):
            return div
        return r.constants.get(str(div))

    def _check_declaration(
        self, model: FileModel, r: _Resolved
    ) -> List[Finding]:
        out: List[Finding] = []
        c = r.contract
        params = set(_fn_params(r.fn_node))
        for arg in sorted(c.args):
            if arg not in params:
                out.append(
                    Finding(
                        path=model.path, line=c.line, rule=self.rule_id,
                        message=(
                            f"contract for {c.fn}() declares arg {arg!r} "
                            "that is not a parameter of the function"
                        ),
                    )
                )
        for param in sorted(c.static):
            spec = c.static[param]
            if param not in params:
                out.append(
                    Finding(
                        path=model.path, line=c.line, rule=self.rule_id,
                        message=(
                            f"contract for {c.fn}() constrains {param!r} "
                            "which is not a parameter of the function"
                        ),
                    )
                )
                continue
            bad_keys = sorted(set(spec) - _STATIC_KEYS)
            if bad_keys:
                out.append(
                    Finding(
                        path=model.path, line=c.line, rule=self.rule_id,
                        message=(
                            f"contract for {c.fn}() static {param!r} has "
                            f"unknown constraint keys {bad_keys}"
                        ),
                    )
                )
            if "multiple_of" in spec:
                div = self._divisor_value(r, spec["multiple_of"])
                if div is None:
                    out.append(
                        Finding(
                            path=model.path, line=c.line, rule=self.rule_id,
                            message=(
                                f"contract for {c.fn}(): multiple_of "
                                f"{spec['multiple_of']!r} does not resolve "
                                "to a module int constant"
                            ),
                        )
                    )
                if not _has_mod_guard(
                    r.fn_node, param, spec["multiple_of"], r.constants
                ):
                    out.append(
                        Finding(
                            path=model.path, line=c.line, rule=self.rule_id,
                            message=(
                                f"{c.fn}() declares {param} % "
                                f"{spec['multiple_of']} == 0 but has no "
                                "runtime guard (if-with-raise on the "
                                "modulus) enforcing it — the contract and "
                                "the kernel would drift apart"
                            ),
                        )
                    )
        # declared dtype vs the entry's own coercion: an f32-declared
        # operand the body repacks with `torch.as_tensor(x, dtype=torch.int32)`
        # is exactly the twin-drift bug class this rule exists for
        for arg in sorted(c.args):
            declared = c.args[arg].get("dtype")
            want = _DTYPE_COERCIONS.get(declared)
            if want is None:
                continue
            for node, got in _coercions(r.fn_node, arg):
                if got != want:
                    out.append(
                        Finding(
                            path=model.path, line=node.lineno, rule=self.rule_id,
                            message=(
                                f"{c.fn}() declares {arg} as {declared} but "
                                f"coerces it to {got} — the "
                                "contract and the kernel disagree on the "
                                "operand dtype"
                            ),
                        )
                    )
        # pad witnesses
        for padded in sorted(c.pad):
            base, div = c.pad[padded]
            witness = r.idioms.get(padded)
            # a name mismatch between the declared divisor and the idiom's
            # is only excused when BOTH resolve to the same module int
            # constant — two unresolvable symbols (e.g. distinct function
            # params) comparing None == None is drift, not agreement
            dv = self._divisor_value(r, div) if witness is not None else None
            wv = (
                self._divisor_value(r, witness[1])
                if witness is not None else None
            )
            if witness is None or witness[0] != str(base) or (
                witness[1] != str(div)
                and (dv is None or wv is None or dv != wv)
            ):
                out.append(
                    Finding(
                        path=model.path, line=c.line, rule=self.rule_id,
                        message=(
                            f"{c.fn}() declares padding {padded} = "
                            f"pad({base}, {div}) but the module has no "
                            f"witnessing idiom `{padded} = {base} + "
                            f"(-{base}) % {div}` — unwitnessed padding "
                            "means a truncating // is possible"
                        ),
                    )
                )
        smem = c.decl.get("smem")
        if smem is not None and not any(
            isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == smem
            for n in model.tree.body
        ):
            out.append(
                Finding(
                    path=model.path, line=c.line, rule=self.rule_id,
                    message=(
                        f"contract for {c.fn}() names shared-memory model "
                        f"{smem!r}, which is not a module-level function here"
                    ),
                )
            )
        out.extend(self._check_grid(model, r))
        return out

    def _grid_facts(self, r: _Resolved) -> Set[Tuple[str, str]]:
        """(dividend, divisor) pairs proven exact by the pad idioms, with
        the divisor also in resolved-constant form when available."""
        facts: Set[Tuple[str, str]] = set()
        for padded, (_, div) in r.idioms.items():
            facts.add((padded, div))
            dv = self._divisor_value(r, div)
            if dv is not None:
                facts.add((padded, str(dv)))
        return facts

    def _element_exact(
        self, el: ast.AST, r: _Resolved, facts: Set[Tuple[str, str]], depth=0
    ) -> bool:
        if isinstance(el, ast.Constant) and isinstance(el.value, int):
            return True
        if (
            isinstance(el, ast.BinOp)
            and isinstance(el.op, ast.FloorDiv)
        ):
            return (_unparse(el.left), _unparse(el.right)) in facts
        if isinstance(el, ast.Name) and depth < 2:
            exprs = r.assigns.get(el.id, [])
            return bool(exprs) and all(
                self._element_exact(e, r, facts, depth + 1) for e in exprs
            )
        return False

    def _check_grid(self, model: FileModel, r: _Resolved) -> List[Finding]:
        c = r.contract
        if not c.grid:
            return []
        out: List[Finding] = []
        facts = self._grid_facts(r)
        declared: List[str] = []
        for el_text in c.grid:
            try:
                el = ast.parse(str(el_text), mode="eval").body
            except SyntaxError:
                out.append(
                    Finding(
                        path=model.path, line=c.line, rule=self.rule_id,
                        message=(
                            f"{c.fn}() grid element {el_text!r} does not "
                            "parse as an expression"
                        ),
                    )
                )
                continue
            declared.append(_unparse(el))
            if not self._element_exact(el, r, facts):
                out.append(
                    Finding(
                        path=model.path, line=c.line, rule=self.rule_id,
                        message=(
                            f"{c.fn}() grid element {el_text!r} is not "
                            "provably exact: no pad fact proves the "
                            "dividend is a multiple of the divisor, so the "
                            "grid would silently drop a partial tile"
                        ),
                    )
                )
        # the declared grid must correspond to a real launch's grid
        actual_grids: List[List[str]] = []
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if kw.arg != "grid":
                    continue
                gv = kw.value
                if isinstance(gv, ast.Name):
                    # grid built as a local first (`grid = (...)` then
                    # `launch(..., grid=grid)`) — one level, single
                    # assignment only, same as _resolve_text
                    exprs = r.assigns.get(gv.id, [])
                    if len(exprs) == 1 and isinstance(exprs[0], ast.Tuple):
                        gv = exprs[0]
                if isinstance(gv, ast.Tuple):
                    actual_grids.append(
                        [self._resolve_text(e, r) for e in gv.elts]
                    )
        if actual_grids and declared and declared not in actual_grids:
            out.append(
                Finding(
                    path=model.path, line=c.line, rule=self.rule_id,
                    message=(
                        f"{c.fn}() declares grid {declared} but no "
                        f"launch in the module uses it (found: "
                        f"{sorted(map(tuple, actual_grids))})"
                    ),
                )
            )
        return out

    def _resolve_text(self, el: ast.AST, r: _Resolved) -> str:
        """One-level name resolution for grid matching (``NC`` →
        ``P_pad // chunk``) — only when the name has exactly one assignment."""
        if isinstance(el, ast.Name):
            exprs = r.assigns.get(el.id, [])
            if len(exprs) == 1:
                return _unparse(exprs[0])
        return _unparse(el)

    # -- cross-twin consistency ----------------------------------------------

    def _check_cross_twin(
        self,
        by_arg: Dict[str, List[Tuple[str, dict]]],
        resolved: Dict[str, _Resolved],
    ) -> List[Finding]:
        """Operands sharing a name across kernel twins must agree on rank
        and dtype — the f32/i32 repack mismatch class of bug. (Axis
        *symbols* may differ: the run-compressed twins legitimately rename
        the pod axis P to the run axis U.)"""
        out: List[Finding] = []

        def sig(spec: dict):
            dims = spec.get("dims")
            return (len(dims) if dims is not None else None, spec.get("dtype"))

        for arg in sorted(by_arg):
            decls = by_arg[arg]
            first_path, first = decls[0]
            for path, spec in decls[1:]:
                if sig(spec) != sig(first):
                    out.append(
                        Finding(
                            path=path,
                            line=1,
                            rule=self.rule_id,
                            message=(
                                f"operand {arg!r} declared as "
                                f"dims={spec.get('dims')} "
                                f"dtype={spec.get('dtype')} here but "
                                f"dims={first.get('dims')} "
                                f"dtype={first.get('dtype')} in "
                                f"{first_path} — twin kernels must agree "
                                "on shared operand rank and dtype"
                            ),
                        )
                    )
        return out

    # -- dispatch-site checks -------------------------------------------------

    def _check_dispatch_sites(
        self, graph: CallGraph, fq: str, r: _Resolved
    ) -> List[Finding]:
        out: List[Finding] = []
        c = r.contract
        kernel_loc = f"{c.module.path}:{c.fn}"
        params = _fn_params(r.fn_node)
        env_cache: Dict[str, ShapeEnv] = {}
        for site in graph.call_sites(fq):
            if site.model.path == c.module.path:
                continue  # internal wrappers live under the module's facts
            bound: Dict[str, ast.AST] = {}
            for i, arg in enumerate(site.call.args):
                if i < len(params):
                    bound[params[i]] = arg
            for kw in site.call.keywords:
                if kw.arg is not None:
                    bound[kw.arg] = kw.value
            trace = f"dispatch {site.caller_fq} → {kernel_loc}"
            out.extend(
                self._check_site_statics(site, r, bound, trace)
            )
            out.extend(
                self._check_site_shapes(graph, site, r, bound, trace, env_cache)
            )
        return out

    def _check_site_statics(self, site, r: _Resolved, bound, trace):
        out: List[Finding] = []
        c = r.contract
        for param in sorted(c.static):
            spec = c.static[param]
            expr = bound.get(param)
            if not (
                isinstance(expr, ast.Constant) and isinstance(expr.value, int)
            ):
                continue  # None / dynamic / omitted: the runtime guard owns it
            val = expr.value
            div = (
                self._divisor_value(r, spec["multiple_of"])
                if "multiple_of" in spec
                else None
            )
            if div and val % div != 0:
                out.append(
                    site.model.finding(
                        site.call,
                        self.rule_id,
                        f"{trace}: {param}={val} violates {param} % "
                        f"{spec['multiple_of']}(={div}) == 0 — the kernel "
                        "walks this axis in aligned tiles and would reject "
                        "or truncate the dispatch",
                    )
                )
            if "min" in spec and val < spec["min"]:
                out.append(
                    site.model.finding(
                        site.call,
                        self.rule_id,
                        f"{trace}: {param}={val} violates {param} >= "
                        f"{spec['min']}",
                    )
                )
        return out

    def _check_site_shapes(self, graph, site, r: _Resolved, bound, trace, cache):
        out: List[Finding] = []
        c = r.contract
        caller = graph.defs.get(site.caller_fq)
        if caller is None or not isinstance(
            caller.node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)
        ):
            return out
        env = cache.get(site.caller_fq)
        if env is None:
            env = ShapeEnv(graph, site.model)
            env.run(caller.node)
            cache[site.caller_fq] = env
        symbols: Dict[str, Tuple[int, str]] = {}  # symbol -> (value, from arg)
        for arg in sorted(c.args):
            spec = c.args[arg]
            dims = spec.get("dims")
            expr = bound.get(arg)
            if dims is None or expr is None:
                continue
            shape = env.shape_at(expr, site.call.lineno)
            if shape is None:
                continue
            if len(shape) != len(dims):
                out.append(
                    site.model.finding(
                        site.call,
                        self.rule_id,
                        f"{trace}: operand {arg} has rank {len(shape)} "
                        f"but the contract declares dims {dims}",
                    )
                )
                continue
            for got, want in zip(shape, dims):
                if not isinstance(got, int):
                    continue
                if isinstance(want, int):
                    if got != want:
                        out.append(
                            site.model.finding(
                                site.call,
                                self.rule_id,
                                f"{trace}: operand {arg} dim {want} is "
                                f"{got} at this site",
                            )
                        )
                    continue
                prev = symbols.get(want)
                if prev is not None and prev[0] != got:
                    out.append(
                        site.model.finding(
                            site.call,
                            self.rule_id,
                            f"{trace}: dim symbol {want} is {got} via "
                            f"operand {arg} but {prev[0]} via operand "
                            f"{prev[1]} — the operands cannot be "
                            "consistently shaped",
                        )
                    )
                else:
                    symbols[want] = (got, arg)
        return out


# -- concrete verdicts (ground-truth property suite) --------------------------


def evaluate_contract(
    contract: dict,
    shapes: Dict[str, Tuple[int, ...]],
    statics: Optional[Dict[str, Optional[int]]] = None,
    constants: Optional[Dict[str, int]] = None,
) -> Tuple[bool, str]:
    """Run the SAME constraint set the static pass proves, on concrete
    values: declared ranks, dim-symbol consistency across operands, and
    static multiple_of/min constraints, and each padded dim symbol
    (a ``pad`` key bound by an operand's dims) a multiple of its divisor.
    → (accept, reason). The tests assert this verdict matches each entry's
    acceptance on the CPU, and ``chip_smoke.py`` each launch's success on
    the card, so the declarations cannot drift from the code."""
    statics = statics or {}
    constants = constants or {}
    symbols: Dict[str, Tuple[int, str]] = {}
    args = contract.get("args", {})
    for arg in sorted(args):
        dims = args[arg].get("dims")
        shape = shapes.get(arg)
        if dims is None or shape is None:
            continue
        if len(shape) != len(dims):
            return False, (
                f"operand {arg} has rank {len(shape)}, contract declares "
                f"{len(dims)} dims {dims}"
            )
        for got, want in zip(shape, dims):
            if isinstance(want, int):
                if got != want:
                    return False, f"operand {arg} dim must be {want}, got {got}"
                continue
            prev = symbols.get(want)
            if prev is not None and prev[0] != got:
                return False, (
                    f"dim symbol {want} is {got} via {arg} but {prev[0]} "
                    f"via {prev[1]}"
                )
            symbols[want] = (got, arg)
    for param in sorted(contract.get("static", {})):
        spec = contract["static"][param]
        val = statics.get(param)
        if val is None:
            continue  # omitted/auto: the kernel derives a conforming value
        if "multiple_of" in spec:
            div = spec["multiple_of"]
            div = div if isinstance(div, int) else constants.get(str(div))
            if div and val % div != 0:
                return False, f"{param}={val} not a multiple of {div}"
        if "min" in spec and val < spec["min"]:
            return False, f"{param}={val} below minimum {spec['min']}"
    for padded in sorted(contract.get("pad", {})):
        bound = symbols.get(padded)
        if bound is None:
            continue
        div = contract["pad"][padded][1]
        div = div if isinstance(div, int) else constants.get(str(div))
        if div and bound[0] % div != 0:
            return False, (
                f"{padded}={bound[0]} (via {bound[1]}) not a multiple of {div}"
            )
    return True, "ok"


def load_module_contracts(path: str) -> Tuple[Dict[str, dict], Dict[str, int]]:
    """(contracts, int constants) of one real ops module on disk — the
    property-suite loader (AST only; the module is never imported)."""
    from pathlib import Path as _P

    model = FileModel(path, _P(path).read_text(encoding="utf-8"))
    contracts, _ = extract_contracts(model)
    return (
        {name: c.decl for name, c in contracts.items()},
        module_int_constants(model),
    )
