"""Cross-module call graph over the one-parse-per-file ``FileModel``s.

graftlint's per-file rules (GL001–GL005) judge each file in isolation; the
whole-program rules (GL006 capture purity, GL007 kernel contracts) need to know
*who calls whom across modules*: a captured step in ``ops/`` calling a
helper imported from ``snapshot/`` taints that helper too, and a kernel
contract must be checked at every dispatch site in ``estimator/``, not just
inside ``ops/``.

The graph is deliberately modest — and deterministic:

- Nodes are *definitions*: module-level functions, class methods, and
  nested ``def``s, keyed by fully qualified dotted name
  (``autoscaler_tpu_torch.ops.binpack.ffd_binpack``,
  ``autoscaler_tpu_torch.estimator.binpacking.BinpackingNodeEstimator.estimate``).
  Each module also gets a ``<module>`` pseudo-node for module-level code.
- Edges come from ``Call`` sites, resolved through each file's import-alias
  map (``from autoscaler_tpu_torch.ops.binpack import ffd_binpack as f`` still
  resolves), relative imports included. ``self.meth()`` resolves to the
  enclosing class's own method. Beyond that, three *instance-typed* forms
  resolve (added for the GL013–GL015 interprocedural rules):
  ``Cls(...)`` edges to ``Cls.__init__`` (class names resolve through the
  same import map, so ``planner.ScaleDownPlanner(...)`` works through a
  module alias); ``self._attr.meth()`` resolves when the class assigns
  ``self._attr = Cls(...)`` with exactly ONE class over the whole class
  body (conflicting assignments drop the attribute — never guess); and
  ``var.meth()`` resolves within one function when that function assigns
  ``var = Cls(...)`` unambiguously. Anything else (call results, dynamic
  dispatch, reassigned receivers) still resolves to None — the graph
  under-approximates, it never guesses.
- A nested ``def`` is linked from its parent by a *containment* edge: when
  the parent is reached, the nested body is considered reached too (it runs
  under the same transformation once called, and the per-file GL006 this
  replaces walked the whole parent body — behavior preserved).

Everything iterates in sorted order; two runs over the same tree produce
the same graph, the same reachability sets, and the same finding order.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from autoscaler_tpu_torch.analysis.engine import PACKAGE_DIR_NAME, FileModel

MODULE_NODE = "<module>"


def dotted_module(model: FileModel) -> Optional[str]:
    """``ops/binpack.py`` → ``autoscaler_tpu_torch.ops.binpack``;
    ``ops/__init__.py`` → ``autoscaler_tpu_torch.ops``. None outside the package
    (fixture paths always sit under a virtual ``autoscaler_tpu_torch/``)."""
    if model.module is None:
        return None
    parts = model.module[: -len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([PACKAGE_DIR_NAME, *parts]) if parts else PACKAGE_DIR_NAME


def _is_package(model: FileModel) -> bool:
    """Is this file a package ``__init__.py`` (its dotted name IS a
    package, so its level-1 relative imports resolve against itself)?"""
    return model.module is not None and model.module.endswith("__init__.py")


def _package_of(dotted: str) -> str:
    """The package a plain module's relative imports resolve against."""
    return dotted.rsplit(".", 1)[0] if "." in dotted else dotted


def resolve_relative(dotted_mod: str, target: str, is_package: bool = False) -> str:
    """Resolve a leading-dot import origin (``..ladder.Klass``) against the
    importing module's dotted name. Absolute targets pass through. For a
    package ``__init__.py`` (``is_package=True``) level-1 imports resolve
    against the package itself, not its parent (``from .binpack import f``
    in ``ops/__init__.py`` is ``autoscaler_tpu_torch.ops.binpack.f``)."""
    if not target.startswith("."):
        return target
    level = len(target) - len(target.lstrip("."))
    rest = target.lstrip(".")
    anchor = dotted_mod if is_package else _package_of(dotted_mod)
    base_parts = anchor.split(".")
    # level 1 = current package, each extra dot ascends one package
    base_parts = base_parts[: len(base_parts) - (level - 1)]
    return ".".join([p for p in [".".join(base_parts), rest] if p])


@dataclass
class DefInfo:
    """One definition node."""

    fq: str                      # dotted fully qualified name
    model: FileModel
    node: ast.AST                # FunctionDef/AsyncFunctionDef, or Module
    local: str                   # name within the module ("Cls.meth")
    cls: Optional[str] = None    # enclosing class name, if a method
    callees: List[str] = field(default_factory=list)        # resolved fqs
    contains: List[str] = field(default_factory=list)       # nested defs


@dataclass(frozen=True)
class CallSite:
    """One resolved call of a target definition."""

    model: FileModel
    call: ast.Call
    caller_fq: str               # innermost enclosing definition


class CallGraph:
    """Whole-program call graph; build once, query many rules."""

    def __init__(self, models: Sequence[FileModel]):
        self.models = sorted(
            (m for m in models if m.module is not None), key=lambda m: m.path
        )
        self.defs: Dict[str, DefInfo] = {}
        # per-module: bare terminal name -> sorted fq list (for the
        # within-module name matching the per-file GL006 used)
        self._by_name: Dict[str, Dict[str, List[str]]] = {}
        self._module_of: Dict[str, str] = {}  # dotted module -> model path
        self._sites: Dict[str, List[CallSite]] = {}
        self.classes: Dict[str, str] = {}  # class fq -> defining model path
        # class fq -> attr name -> class fq of the instance stored there
        # (None = conflicting assignments: resolution must not guess)
        self._attr_types: Dict[str, Dict[str, Optional[str]]] = {}
        for model in self.models:
            self._index(model)
        for model in self.models:
            self._collect_attr_types(model)
        for model in self.models:
            self._link(model)
        for info in self.defs.values():
            info.callees = sorted(set(info.callees))
            info.contains = sorted(set(info.contains))
        # id(Call node) -> the definition it resolved to (every linked site)
        self._target: Dict[int, str] = {
            id(site.call): fq
            for fq, sites in self._sites.items()
            for site in sites
        }

    # -- construction ---------------------------------------------------------

    def _index(self, model: FileModel) -> None:
        dm = dotted_module(model)
        if dm is None:
            return
        self._module_of[dm] = model.path
        names: Dict[str, List[str]] = self._by_name.setdefault(dm, {})

        def register(fq: str, node: ast.AST, local: str, cls: Optional[str]):
            self.defs[fq] = DefInfo(fq=fq, model=model, node=node, local=local, cls=cls)
            bare = local.split(".")[-1]
            names.setdefault(bare, []).append(fq)

        register(f"{dm}.{MODULE_NODE}", model.tree, MODULE_NODE, None)

        def walk(node: ast.AST, stack: List[str], cls: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    local = ".".join(stack + [child.name])
                    register(f"{dm}.{local}", child, local, cls)
                    walk(child, stack + [child.name], cls)
                elif isinstance(child, ast.ClassDef):
                    self.classes[f"{dm}." + ".".join(stack + [child.name])] = (
                        model.path
                    )
                    walk(child, stack + [child.name], child.name)
                else:
                    walk(child, stack, cls)

        walk(model.tree, [], None)
        for name_map in names.values():
            name_map.sort()

    def _collect_attr_types(self, model: FileModel) -> None:
        """``self._attr = Cls(...)`` anywhere in a class body types the
        attribute — but only if every such assignment across the whole
        class agrees on ONE resolvable class (else the attr is dropped)."""
        dm = dotted_module(model)
        if dm is None:
            return

        def walk(node: ast.AST, stack: List[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, stack + [child.name])
                    continue
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    walk(child, stack)
                    continue
                if stack and isinstance(child, ast.Assign):
                    for tgt in child.targets:
                        if (
                            isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                        ):
                            cls_fq = f"{dm}." + ".".join(stack)
                            attrs = self._attr_types.setdefault(cls_fq, {})
                            typed = (
                                self.resolve_class(model, child.value.func)
                                if isinstance(child.value, ast.Call)
                                else None
                            )
                            if tgt.attr in attrs and attrs[tgt.attr] != typed:
                                attrs[tgt.attr] = None  # conflict: never guess
                            else:
                                attrs[tgt.attr] = typed
                walk(child, stack)

        walk(model.tree, [])

    def _local_instance_types(self, model: FileModel, fn: ast.AST) -> Dict[str, str]:
        """var -> class fq for ``var = Cls(...)`` assignments in ONE
        function's own body (nested defs excluded — they rebind their own
        scope). A variable assigned twice with disagreeing (or unresolvable)
        classes is dropped."""
        out: Dict[str, Optional[str]] = {}
        stack = list(getattr(fn, "body", []))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    typed = (
                        self.resolve_class(model, node.value.func)
                        if isinstance(node.value, ast.Call)
                        else None
                    )
                    if tgt.id in out and out[tgt.id] != typed:
                        out[tgt.id] = None
                    else:
                        out[tgt.id] = typed
            stack.extend(ast.iter_child_nodes(node))
        return {k: v for k, v in out.items() if v is not None}

    def _link(self, model: FileModel) -> None:
        dm = dotted_module(model)
        if dm is None:
            return

        def walk(
            node: ast.AST,
            stack: List[str],
            cls: Optional[str],
            owner_fq: str,
            local_types: Dict[str, str],
        ) -> None:
            """Attribute every Call to its innermost enclosing definition
            (``owner_fq``); record containment for nested defs."""
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    child_fq = f"{dm}." + ".".join(stack + [child.name])
                    child_types = self._local_instance_types(model, child)
                    if child_fq in self.defs:
                        self.defs[owner_fq].contains.append(child_fq)
                        walk(child, stack + [child.name], cls, child_fq, child_types)
                    else:
                        walk(child, stack + [child.name], cls, owner_fq, child_types)
                elif isinstance(child, ast.ClassDef):
                    walk(child, stack + [child.name], child.name, owner_fq, {})
                else:
                    if isinstance(child, ast.Call):
                        target = self.resolve(
                            model, child.func, cls, local_types=local_types
                        )
                        if target is not None:
                            self.defs[owner_fq].callees.append(target)
                            self._sites.setdefault(target, []).append(
                                CallSite(
                                    model=model, call=child, caller_fq=owner_fq
                                )
                            )
                    walk(child, stack, cls, owner_fq, local_types)

        walk(model.tree, [], None, f"{dm}.{MODULE_NODE}", {})

    # -- queries --------------------------------------------------------------

    def resolve_class(self, model: FileModel, node: ast.AST) -> Optional[str]:
        """Resolve a Name/Attribute naming a class to its class fq — local
        classes, imported classes, and module-alias chains
        (``planner.ScaleDownPlanner``) all resolve; None otherwise."""
        dm = dotted_module(model)
        if dm is None:
            return None
        if isinstance(node, ast.Name):
            fq = f"{dm}.{node.id}"
            if fq in self.classes:
                return fq
            origin = model.imports.get(node.id)
            if origin is not None:
                fq = resolve_relative(dm, origin, is_package=_is_package(model))
                return fq if fq in self.classes else None
            return None
        if isinstance(node, ast.Attribute):
            dotted = model.dotted(node, resolve=True)
            if dotted is None:
                return None
            fq = resolve_relative(dm, dotted, is_package=_is_package(model))
            return fq if fq in self.classes else None
        return None

    def method_on(self, class_fq: Optional[str], meth: str) -> Optional[str]:
        """``Cls.meth`` if that method is a known definition."""
        if class_fq is None:
            return None
        fq = f"{class_fq}.{meth}"
        return fq if fq in self.defs else None

    def resolve(
        self,
        model: FileModel,
        func: ast.AST,
        enclosing_class: Optional[str] = None,
        local_types: Optional[Dict[str, str]] = None,
    ) -> Optional[str]:
        """Resolve a call target expression to a definition fq, or None.
        ``local_types`` (var -> class fq, from ``_local_instance_types``)
        enables ``var.meth()`` resolution inside one function."""
        dm = dotted_module(model)
        if dm is None:
            return None
        names = self._by_name.get(dm, {})
        if (
            enclosing_class is not None
            and isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
        ):
            # self.meth() -> the enclosing class's own method
            fq = f"{dm}.{enclosing_class}.{func.attr}"
            return fq if fq in self.defs else None
        if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
            # var.meth() through a function-local `var = Cls(...)` binding
            if local_types is not None and func.value.id in local_types:
                hit = self.method_on(local_types[func.value.id], func.attr)
                if hit is not None:
                    return hit
        if (
            enclosing_class is not None
            and isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Attribute)
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id == "self"
        ):
            # self._attr.meth() through the class's typed attributes
            attrs = self._attr_types.get(f"{dm}.{enclosing_class}", {})
            hit = self.method_on(attrs.get(func.value.attr), func.attr)
            if hit is not None:
                return hit
        if isinstance(func, ast.Name):
            # same-module MODULE-LEVEL definition by bare name, before
            # imported names. Class methods and function-local nested defs
            # are excluded: a bare call can reach neither from elsewhere,
            # and letting them match would shadow an imported name of the
            # same spelling (nested defs stay reachable through their
            # parent's containment edge)
            local = [
                fq for fq in names.get(func.id, ())
                if self.defs[fq].cls is None and "." not in self.defs[fq].local
            ]
            if local:
                return local[0]
            origin = model.imports.get(func.id)
            if origin is not None:
                fq = resolve_relative(dm, origin, is_package=_is_package(model))
                if fq in self.defs:
                    return fq
            # Cls(...) -> Cls.__init__ (constructor edge)
            return self.method_on(self.resolve_class(model, func), "__init__")
        if isinstance(func, ast.Attribute):
            dotted = model.dotted(func, resolve=True)
            if dotted is None:
                return None
            fq = resolve_relative(dm, dotted, is_package=_is_package(model))
            if fq in self.defs:
                return fq
            # mod.Cls(...) -> Cls.__init__ through a module alias
            return self.method_on(self.resolve_class(model, func), "__init__")
        return None

    def reachable(self, roots: Iterable[str]) -> Set[str]:
        """Transitive closure over call + containment edges."""
        seen: Set[str] = set()
        work = sorted(set(r for r in roots if r in self.defs))
        while work:
            fq = work.pop()
            if fq in seen:
                continue
            seen.add(fq)
            info = self.defs[fq]
            for nxt in sorted(set(info.callees) | set(info.contains)):
                if nxt not in seen and nxt in self.defs:
                    work.append(nxt)
        return seen

    def target_of(self, call: ast.Call) -> Optional[str]:
        """The definition a linked ``Call`` node resolved to, or None."""
        return self._target.get(id(call))

    def call_sites(self, target_fq: str) -> List[CallSite]:
        """All resolved call sites of a definition, sorted by location."""
        sites = self._sites.get(target_fq, [])
        return sorted(
            sites, key=lambda s: (s.model.path, getattr(s.call, "lineno", 0))
        )

    def defs_in_module(self, model: FileModel) -> List[DefInfo]:
        dm = dotted_module(model)
        if dm is None:
            return []
        prefix = dm + "."
        return [
            self.defs[fq]
            for fq in sorted(self.defs)
            if fq.startswith(prefix) and self.defs[fq].model.path == model.path
        ]
