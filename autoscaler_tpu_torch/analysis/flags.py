"""GL009 — flag/option wiring.

The configuration surface is a contract with operators: a flag that parses
but never reaches the code it claims to configure is worse than a missing
flag — `--max-bulk-soft-taint-time=1` silently does nothing and the
operator believes it took. The same goes for an ``AutoscalingOptions``
field nothing ever reads (cf. "Priority Matters": a constraint-packing
knob that never reaches the packer changes nothing but the operator's
mental model).

Checks, whole-program:

- **Option fields**: every ``AnnAssign`` field of ``AutoscalingOptions``
  (``config/options.py``) must be *read* — an ``obj.field`` attribute load
  with that name, anywhere in the package (reads inside ``options.py``'s
  own methods count; the field declaration and constructor keywords are
  writes, not reads).
- **CLI flags**: every ``add_argument("--flag", ...)`` in ``main.py`` must
  have its dest consumed — ``args.<dest>`` (or ``getattr(args, "<dest>")``)
  read somewhere. A flag whose value never leaves the parser is an orphan.

Reads are matched by attribute *name* package-wide rather than through the
call graph: an over-approximation that can miss an orphan whose name
collides with an unrelated attribute, but can never false-positive on live
wiring — the right trade for a fatal CI gate. Reachability pruning is the
call graph's job where resolution is sound; attribute dispatch is not.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from autoscaler_tpu_torch.analysis.callgraph import CallGraph
from autoscaler_tpu_torch.analysis.engine import FileModel, Finding, terminal_name

OPTIONS_MODULE = "config/options.py"
OPTIONS_CLASS = "AutoscalingOptions"
FLAG_MODULES = ("main.py",)


def _option_fields(model: FileModel) -> List[Tuple[str, int]]:
    for node in model.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == OPTIONS_CLASS:
            return [
                (st.target.id, st.lineno)
                for st in node.body
                if isinstance(st, ast.AnnAssign)
                and isinstance(st.target, ast.Name)
            ]
    return []


def _flag_dests(model: FileModel) -> List[Tuple[str, str, int]]:
    """(dest, flag spelling, line) for every ``add_argument`` call."""
    out: List[Tuple[str, str, int]] = []
    for node in ast.walk(model.tree):
        if not (
            isinstance(node, ast.Call)
            and terminal_name(node.func) == "add_argument"
        ):
            continue
        names = [
            a.value
            for a in node.args
            if isinstance(a, ast.Constant)
            and isinstance(a.value, str)
            and a.value.startswith("--")
        ]
        dest: Optional[str] = None
        for kw in node.keywords:
            if kw.arg == "dest" and isinstance(kw.value, ast.Constant):
                dest = str(kw.value.value)
        if dest is None and names:
            dest = names[0].lstrip("-").replace("-", "_")
        if dest is not None:
            out.append((dest, names[0] if names else dest, node.lineno))
    return out


def _attribute_reads(graph: CallGraph) -> Set[str]:
    """Every attribute name read (Load context) anywhere in the program,
    plus string literals passed to getattr()."""
    reads: Set[str] = set()
    for model in graph.models:
        for node in ast.walk(model.tree):
            if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
                reads.add(node.attr)
            elif (
                isinstance(node, ast.Call)
                and terminal_name(node.func) == "getattr"
                and len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)
            ):
                reads.add(node.args[1].value)
    return reads


class FlagWiringChecker:
    rule_id = "GL009"
    title = "config option or CLI flag parsed but never read (orphan)"

    def check_program(self, graph: CallGraph) -> List[Finding]:
        if not getattr(graph, "scan_complete", True):
            # "never read anywhere in the package" quantifies over the
            # whole package: on a partial disk scan (one file, one
            # subtree) the readers may live outside the scanned set, so
            # the rule stays silent rather than false-positive the gate
            return []
        options_model = next(
            (m for m in graph.models if m.module == OPTIONS_MODULE), None
        )
        flag_models = [m for m in graph.models if m.in_module(*FLAG_MODULES)]
        if options_model is None and not flag_models:
            return []
        reads = _attribute_reads(graph)
        out: List[Finding] = []
        if options_model is not None:
            for fieldname, line in _option_fields(options_model):
                if fieldname not in reads:
                    out.append(
                        Finding(
                            path=options_model.path,
                            line=line,
                            rule=self.rule_id,
                            message=(
                                f"{OPTIONS_CLASS}.{fieldname} is declared "
                                "but never read anywhere in the package — "
                                "an option that cannot affect behavior; "
                                "wire it to its consumer or delete it"
                            ),
                        )
                    )
        for model in flag_models:
            for dest, flag, line in _flag_dests(model):
                if dest not in reads:
                    out.append(
                        Finding(
                            path=model.path,
                            line=line,
                            rule=self.rule_id,
                            message=(
                                f"CLI flag {flag} parses into args.{dest} "
                                "but nothing ever reads it — the flag is "
                                "accepted and silently ignored"
                            ),
                        )
                    )
        return out
