"""GL014/GL015 — device hot-path purity for the tick/estimator/arena path.

The decision loop's latency story assumes ``run_once`` stays async with
respect to the card: kernels are launched on the current stream, tensors
flow through the estimator, and nothing forces a host round-trip until the
perf/telemetry seam explicitly reads results out. One stray ``.item()``
(or ``.cpu()``, or ``float()`` of a tensor, or ``np.asarray`` of one)
blocks the host on the stream in the middle of the tick — invisible in
unit tests, a latency cliff under load. Separately, the greedy loop and
the preemption pass record a chunk of steps as one CUDA graph
(``ops/schedule.py``, ``ops/preempt.py``): a step that branches in Python
on a tensor value, or loops a parameter-dependent number of times, is
frozen into the graph at capture and replays that one path for every
later chunk (and the branch's read syncs during capture).

**GL014 — host-sync leak.** Roots are every ``run_once`` definition; the
reachable set is the true transitive closure over the call graph
(instance-typed edges included). Inside that set, within REPLAY/ARENA
scopes plus ``ops/`` and outside the telemetry seams (``perf/``,
``metrics/``, ``trace/``), these force a sync and are flagged:
``.item()``, ``.cpu()``, ``.numpy()``, ``.synchronize()``
(``torch.cuda.synchronize()``, ``Stream.synchronize()``), and
``.tolist()``/``float()``/``int()``/``bool()``/``np.asarray()``/
``np.array()`` applied to a value the local pass can prove is a tensor
(built by a ``torch.*`` call or flowing from one). Findings carry the
``run_once`` call chain as flow steps — the fix is usually "move the read
behind the perf seam", and the chain shows where.

**GL015 — recompile hazard.** The roots are the functions a CUDA graph
capture records: every call made between ``g.capture_begin(...)`` and
``g.capture_end()`` in one definition, and every call in the body of
``with torch.cuda.graph(g):`` (the ``JIT_SCOPES`` modules only). Each
root's own region is scanned for: (a) a Python ``if``/``while`` on a
tensor value (a ``torch.*`` result, a name bound from one, a parameter
annotated ``torch.Tensor``, or a method result of any of these;
``.shape``/``.ndim``/``.dtype`` projections and ``is None`` checks are
host values and exempt) — the branch is taken once, at capture, and
syncs while capturing; (b) ``for ... in range(...)`` over a parameter or
a parameter's shape — the loop unrolls into the graph for the value seen
at capture. The JAX twin's third leg (an unhashable literal passed to a
``static_argnames`` parameter) has no torch form: a capture has no static
arguments, so that leg has no roots and no code here. :func:`certify_kernels`
cross-checks KERNEL_CONTRACTS: a contract-listed kernel entry is
*certified* when no GL015 hazard exists in any definition reachable from
it (captured steps reached through it included) — the tests hold every
listed entry to that bar.

Both rules under-approximate: unknown values are assumed host-side;
only provable syncs and hazards are reported.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from autoscaler_tpu_torch.analysis.callgraph import (
    MODULE_NODE,
    CallGraph,
    DefInfo,
    dotted_module,
)
from autoscaler_tpu_torch.analysis.contracts import extract_contracts
from autoscaler_tpu_torch.analysis.dataflow import in_replay_scope
from autoscaler_tpu_torch.analysis.engine import (
    FileModel,
    Finding,
    FlowStep,
    terminal_name,
)

HOT_ROOT = "run_once"
# the sanctioned host-read seams: telemetry modules read device values out
# by design, at tick boundaries, not inside the decision path
TELEMETRY_SEAMS = ("perf/", "metrics/", "trace/")
# GL015's blast radius: the captured device code lives here
JIT_SCOPES = ("ops/", "estimator/")

# `g.capture_begin(...)` ... `g.capture_end()` brackets a recording
_CAPTURE_BEGIN, _CAPTURE_END = "capture_begin", "capture_end"
_SHAPE_PROJECTIONS = {"shape", "ndim", "dtype", "size", "device"}
# tensor methods that read the value to the host, whatever the receiver
_SYNC_METHODS = {"item", "cpu", "numpy"}
# ...and one that does only on a provable tensor (numpy arrays have it too)
_TENSOR_SYNC_METHODS = {"tolist"}
_HOST_COERCIONS = {"float", "int", "bool"}
_NP_MATERIALIZERS = {"asarray", "array"}


def _own_region(fn: ast.AST):
    """The def's body excluding nested defs (their own graph nodes)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _is_torch_qual(q: Optional[str]) -> bool:
    return q is not None and (q == "torch" or q.startswith("torch."))


# torch calls that return host objects, not tensors: devices, streams,
# dtypes' info, flags and the profiler
_TORCH_HOST_PREFIXES = (
    "torch.cuda.", "torch.backends.", "torch.utils.", "torch.profiler.",
    "torch.autograd.", "torch.distributed.", "torch.device", "torch.is_",
    "torch.get_", "torch.set_", "torch.finfo", "torch.iinfo", "torch.Size",
    "torch.manual_seed", "torch.Generator",
)


def _makes_tensor(model: FileModel, func: ast.AST) -> bool:
    """A ``torch.*`` call that returns a tensor (imported ``torch``)."""
    q = model.qualname(func)
    return (
        _is_torch_qual(q)
        and model.is_imported(func)
        and not q.startswith(_TORCH_HOST_PREFIXES)
    )


def _is_tensor_annotation(model: FileModel, ann: Optional[ast.AST]) -> bool:
    """``torch.Tensor`` (any import spelling), or a string of it."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split(".")[-1] == "Tensor"
    return model.qualname(ann) == "torch.Tensor"


def _param_names(fn: ast.AST) -> List[str]:
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


def _tensor_params(model: FileModel, fn: ast.AST) -> Set[str]:
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return set()
    a = fn.args
    return {
        p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)
        if _is_tensor_annotation(model, p.annotation)
    }


def _is_graph_context(model: FileModel, expr: ast.AST) -> bool:
    """``torch.cuda.graph(g)`` as a ``with`` item."""
    return (
        isinstance(expr, ast.Call)
        and model.qualname(expr.func) == "torch.cuda.graph"
    )


def capture_calls(model: FileModel, fn: ast.AST) -> List[ast.Call]:
    """The calls one definition's own region makes while a CUDA graph
    records: those on a line strictly between a ``capture_begin`` call and
    the first ``capture_end`` after it, and those in the body of a
    ``with torch.cuda.graph(...)``. Sorted by position."""
    region = list(_own_region(fn))
    calls = [n for n in region if isinstance(n, ast.Call)]
    out: Dict[int, ast.Call] = {}
    begins = sorted(
        c.lineno for c in calls if terminal_name(c.func) == _CAPTURE_BEGIN
    )
    ends = sorted(
        c.lineno for c in calls if terminal_name(c.func) == _CAPTURE_END
    )
    for b in begins:
        e = next((x for x in ends if x > b), None)
        if e is None:
            continue
        for c in calls:
            if b < c.lineno < e:
                out[id(c)] = c
    for node in region:
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
            _is_graph_context(model, item.context_expr) for item in node.items
        ):
            for stmt in node.body:
                for c in ast.walk(stmt):
                    if isinstance(c, ast.Call):
                        out[id(c)] = c
    return sorted(out.values(), key=lambda c: (c.lineno, c.col_offset))


def capture_roots(graph: CallGraph, model: FileModel) -> Set[str]:
    """Every definition a CUDA graph capture in this module records."""
    roots: Set[str] = set()
    for info in graph.defs_in_module(model):
        for call in capture_calls(model, info.node):
            fq = graph.target_of(call)
            if fq is not None and fq in graph.defs:
                roots.add(fq)
    return roots


# -- GL014: host-sync leaks on the run_once hot path --------------------------


class HostSyncChecker:
    """GL014 — a device value must not be forced to host inside the
    run_once-reachable decision path outside the telemetry seams."""

    rule_id = "GL014"
    title = "host-device sync on the run_once hot path"

    def check_program(self, graph: CallGraph) -> List[Finding]:
        roots = sorted(
            fq
            for fq, info in graph.defs.items()
            if info.local.split(".")[-1] == HOT_ROOT
        )
        if not roots:
            return []
        # BFS with parent pointers: each finding renders its call chain
        parent: Dict[str, Optional[str]] = {r: None for r in roots}
        order: List[str] = list(roots)
        i = 0
        while i < len(order):
            fq = order[i]
            i += 1
            info = graph.defs[fq]
            for nxt in sorted(set(info.callees) | set(info.contains)):
                if nxt in graph.defs and nxt not in parent:
                    parent[nxt] = fq
                    order.append(nxt)
        out: List[Finding] = []
        for fq in sorted(parent):
            info = graph.defs[fq]
            if info.local == MODULE_NODE:
                continue
            m = info.model
            if not (in_replay_scope(m) or m.in_module("ops/")):
                continue
            if m.in_module(*TELEMETRY_SEAMS):
                continue
            out.extend(self._scan_def(graph, fq, info, parent))
        return sorted(out, key=Finding.sort_key)

    # -- per-def scan ---------------------------------------------------------

    def _chain(self, fq: str, parent: Dict[str, Optional[str]]) -> List[str]:
        chain = [fq]
        while parent.get(chain[0]) is not None:
            chain.insert(0, parent[chain[0]])
        return chain

    def _scan_def(
        self,
        graph: CallGraph,
        fq: str,
        info: DefInfo,
        parent: Dict[str, Optional[str]],
    ) -> List[Finding]:
        model = info.model
        device = self._device_names(model, info.node)
        out: List[Finding] = []
        for node in _own_region(info.node):
            if not isinstance(node, ast.Call):
                continue
            why = self._sync_reason(model, node, device)
            if why is None:
                continue
            chain = self._chain(fq, parent)
            flow: List[FlowStep] = [
                (
                    d.model.path,
                    getattr(d.node, "lineno", 1),
                    f"{d.local.split('.')[-1]}()",
                )
                for d in (graph.defs[hop] for hop in chain)
            ]
            flow.append((model.path, node.lineno, why))
            rendered = " -> ".join(c.split(".")[-1] for c in chain)
            out.append(
                model.finding(
                    node,
                    self.rule_id,
                    f"{why} inside {info.local.split('.')[-1]}(), reached "
                    f"from run_once ({rendered}) — device values must stay "
                    "on device in the decision path; read them out behind "
                    "the perf/telemetry seam instead",
                    flow=flow,
                )
            )
        return out

    def _sync_reason(
        self, model: FileModel, call: ast.Call, device: Set[str]
    ) -> Optional[str]:
        func = call.func
        term = terminal_name(func)
        if isinstance(func, ast.Attribute):
            if term in _SYNC_METHODS and not call.args and not call.keywords:
                return f".{term}() host-device sync"
            if term == "synchronize" and not call.args:
                q = model.qualname(func)
                if _is_torch_qual(q):
                    return f"{q}() host-device sync"
                return ".synchronize() host-device sync"
            if (
                term in _TENSOR_SYNC_METHODS
                and not call.args
                and self._device_expr(model, func.value, device)
            ):
                return f".{term}() of a tensor forces a sync"
            q = model.qualname(func)
            if (
                term in _NP_MATERIALIZERS
                and q is not None
                and q.startswith("numpy.")
                and call.args
                and self._device_expr(model, call.args[0], device)
            ):
                return f"np.{term}() of a tensor"
        elif isinstance(func, ast.Name):
            if (
                term in _HOST_COERCIONS
                and call.args
                and self._device_expr(model, call.args[0], device)
            ):
                return f"{term}() of a tensor forces a sync"
        return None

    def _device_names(self, model: FileModel, fn: ast.AST) -> Set[str]:
        """Names provably bound to device values in this def's own region
        (forward pass, source order)."""
        device: Set[str] = set()
        assigns = sorted(
            (
                n
                for n in _own_region(fn)
                if isinstance(n, ast.Assign)
            ),
            key=lambda n: (n.lineno, n.col_offset),
        )
        for node in assigns:
            is_dev = self._device_expr(model, node.value, device)
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    if is_dev:
                        device.add(tgt.id)
                    else:
                        device.discard(tgt.id)  # rebinding kills
        return device

    def _device_expr(
        self, model: FileModel, expr: ast.AST, device: Set[str]
    ) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in device
        if isinstance(expr, ast.Call):
            if _makes_tensor(model, expr.func):
                return True
            # x.sum() of a tensor is still a tensor; x.item()/.cpu()/
            # .tolist() are host values (flagged themselves)
            if isinstance(expr.func, ast.Attribute):
                if expr.func.attr in _SYNC_METHODS | _TENSOR_SYNC_METHODS:
                    return False
                return self._device_expr(model, expr.func.value, device)
            return False
        if isinstance(expr, ast.Attribute):
            if expr.attr in _SHAPE_PROJECTIONS:
                return False  # static under tracing, host-side ints
            return self._device_expr(model, expr.value, device)
        if isinstance(expr, ast.Subscript):
            return self._device_expr(model, expr.value, device)
        if isinstance(expr, ast.BinOp):
            return self._device_expr(
                model, expr.left, device
            ) or self._device_expr(model, expr.right, device)
        if isinstance(expr, ast.UnaryOp):
            return self._device_expr(model, expr.operand, device)
        return False


# -- GL015: recompile hazards in captured bodies ------------------------------


class RecompileHazardChecker:
    """GL015 — a captured body must not branch on a tensor value or loop a
    parameter-dependent number of times (both freeze at capture). The JAX
    twin's static-argument leg has no roots here: a capture takes no static
    arguments."""

    rule_id = "GL015"
    title = "recompile hazard inside a CUDA-graph-captured body"

    def __init__(self):
        # def fq -> its body hazards (certify_kernels reads this after
        # check_program)
        self.hazards_by_def: Dict[str, List[Finding]] = {}

    def check_program(self, graph: CallGraph) -> List[Finding]:
        self.hazards_by_def = {}
        out: List[Finding] = []
        roots: Set[str] = set()
        for model in graph.models:
            if model.in_module(*JIT_SCOPES):
                roots |= capture_roots(graph, model)
        for fq in sorted(roots):
            found = self._check_body(graph.defs[fq])
            if found:
                self.hazards_by_def[fq] = found
            out.extend(found)
        return sorted(out, key=Finding.sort_key)

    # -- body hazards ---------------------------------------------------------

    def _check_body(self, info: DefInfo) -> List[Finding]:
        model = info.model
        fn = info.node
        name = info.local.split(".")[-1]
        params = {p for p in _param_names(fn) if p not in ("self", "cls")}
        tracers = _tensor_params(model, fn)
        # names bound from torch results (or from tensors) are tensors too
        for node in sorted(
            (n for n in _own_region(fn) if isinstance(n, ast.Assign)),
            key=lambda n: (n.lineno, n.col_offset),
        ):
            if self._tracer_use(model, node.value, tracers) is not None:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        tracers.add(tgt.id)
        out: List[Finding] = []
        for node in _own_region(fn):
            if isinstance(node, (ast.If, ast.While)):
                use = self._tracer_use(model, node.test, tracers)
                if use is not None:
                    out.append(
                        model.finding(
                            node,
                            self.rule_id,
                            f"Python {type(node).__name__.lower()} on "
                            f"tensor value {use} inside captured "
                            f"{name}() — the branch is taken once, at "
                            "capture, and every replay repeats it (the "
                            "read also syncs while capturing); use "
                            "torch.where or masked ops",
                        )
                    )
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                hazard = self._loop_hazard(model, node.iter, params)
                if hazard is not None:
                    out.append(
                        model.finding(
                            node,
                            self.rule_id,
                            f"parameter-dependent Python loop over {hazard} "
                            f"inside captured {name}() — the loop unrolls "
                            "into the graph for the value seen at capture "
                            "and every replay repeats that count; loop to "
                            "a fixed bound or mask the tail",
                        )
                    )
        return out

    def _tracer_use(
        self, model: FileModel, expr: ast.AST, tracers: Set[str]
    ) -> Optional[str]:
        """Does a tracer flow into this test as a VALUE (shape/dtype
        projections and identity-vs-None checks are trace-static)?"""
        if isinstance(expr, ast.Name):
            return f"{expr.id!r}" if expr.id in tracers else None
        if isinstance(expr, ast.Attribute):
            if expr.attr in _SHAPE_PROJECTIONS:
                return None
            return self._tracer_use(model, expr.value, tracers)
        if isinstance(expr, ast.Subscript):
            # x.shape[0] stays static; x[0] of a tracer is a tracer
            return self._tracer_use(model, expr.value, tracers)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
                return None  # `x is None` retraces once per arity, by design
            for part in (expr.left, *expr.comparators):
                use = self._tracer_use(model, part, tracers)
                if use is not None:
                    return use
            return None
        if isinstance(expr, ast.BoolOp):
            for part in expr.values:
                use = self._tracer_use(model, part, tracers)
                if use is not None:
                    return use
            return None
        if isinstance(expr, (ast.BinOp, ast.UnaryOp)):
            parts = (
                (expr.left, expr.right)
                if isinstance(expr, ast.BinOp)
                else (expr.operand,)
            )
            for part in parts:
                use = self._tracer_use(model, part, tracers)
                if use is not None:
                    return use
            return None
        if isinstance(expr, ast.Call):
            q = model.qualname(expr.func)
            if _makes_tensor(model, expr.func):
                return f"{q}(...) result"
            if isinstance(expr.func, ast.Attribute):
                # x.sum() of a tracer is a tracer; helper(x) is NOT
                # assumed one — the helper may branch on static metadata
                # only, and this rule proves hazards, it never guesses
                return self._tracer_use(model, expr.func.value, tracers)
            return None
        return None

    def _loop_hazard(
        self, model: FileModel, it: ast.AST, tracers: Set[str]
    ) -> Optional[str]:
        """``range(n)``/``range(x.shape[0])`` with n a parameter of the
        captured function (or its shape) unrolls for the captured value."""
        if not (
            isinstance(it, ast.Call)
            and isinstance(it.func, ast.Name)
            and it.func.id == "range"
        ):
            return None
        for arg in it.args:
            for node in ast.walk(arg):
                if isinstance(node, ast.Name) and node.id in tracers:
                    # range(x.shape[0]) is shape-dependent; range(x) is
                    # value-dependent — both retrace, name them distinctly
                    parent_is_shape = any(
                        isinstance(p, ast.Attribute)
                        and p.attr in _SHAPE_PROJECTIONS
                        for p in ast.walk(arg)
                    )
                    what = (
                        f"parameter {node.id!r}'s shape"
                        if parent_is_shape
                        else f"parameter {node.id!r}"
                    )
                    return what
        return None


# -- KERNEL_CONTRACTS cross-check ---------------------------------------------


def certify_kernels(
    graph: CallGraph,
) -> Dict[str, Tuple[str, List[Finding]]]:
    """For every KERNEL_CONTRACTS-listed kernel entry: ``certified`` when
    no GL015 hazard exists in any definition reachable from it (captured
    steps included),
    ``hazardous`` with the violating findings otherwise, ``unknown`` when
    the contracted name has no definition (GL007 reports that case)."""
    checker = RecompileHazardChecker()
    checker.check_program(graph)
    out: Dict[str, Tuple[str, List[Finding]]] = {}
    for model in graph.models:
        if not (model.module and model.module.startswith("ops/")):
            continue
        contracts, _ = extract_contracts(model)
        if not contracts:
            continue
        dm = dotted_module(model)
        for fn_name in sorted(contracts):
            fq = f"{dm}.{fn_name}"
            if fq not in graph.defs:
                out[fn_name] = ("unknown", [])
                continue
            # a captured step is an ordinary callee of the def that
            # captures it, so the closure already holds every reached step
            reach = set(graph.reachable([fq]))
            hazards = [
                f
                for d in sorted(reach)
                for f in checker.hazards_by_def.get(d, [])
            ]
            out[fn_name] = (
                ("certified", []) if not hazards else ("hazardous", hazards)
            )
    return out
