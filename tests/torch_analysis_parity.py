"""The JAX package's graftlint suites, run on the port's analysis package.

``AnalysisRebound(module)`` is ``torch_parity.Rebound`` for the analysis
suites: besides pointing a test module's globals and imports at the port,
it renames the package in every string the tests hold (fixture sources,
virtual paths such as ``autoscaler_tpu/loadgen/fixture.py``, ``-m``
arguments, expected messages) and in module-level ``Path`` globals, on a
word boundary, so ``autoscaler_tpu_torch`` is never renamed twice. The
suites' label constants are left alone (the analysis has none).

``case_params(module, skip)`` lists a module's test functions (and their
fixtures) for one parametrised test; ``run_case`` calls one with the
fixtures pytest gave the parametrised test.
"""
from __future__ import annotations

import inspect
import re
import types
from pathlib import Path

from torch_parity import Rebound, _port_name

_WORD = re.compile(r"\bautoscaler_tpu\b")


def port_text(text: str) -> str:
    """``autoscaler_tpu`` → ``autoscaler_tpu_torch`` on a word boundary."""
    return _WORD.sub("autoscaler_tpu_torch", text)


def _port_const(c):
    """A code constant with the package renamed: strings, and the tuples
    and frozensets of them a dict or set literal compiles to."""
    if isinstance(c, types.CodeType):
        return _analysis_code(c)
    if isinstance(c, str):
        return port_text(c)
    if isinstance(c, (tuple, frozenset)):
        return type(c)(_port_const(x) for x in c)
    return c


def _analysis_code(code):
    consts = tuple(_port_const(c) for c in code.co_consts)
    names = tuple(_port_name(n) if "." in n or n == "autoscaler_tpu" else n
                  for n in code.co_names)
    return code.replace(co_consts=consts, co_names=names)


class AnalysisRebound(Rebound):
    """``Rebound`` with the package renamed in strings and paths too."""

    def _port(self, value):
        if isinstance(value, str):
            return port_text(value)
        if isinstance(value, Path):
            return Path(port_text(str(value)))
        return super()._port(value)

    def function(self, fn):
        defaults = fn.__defaults__ and tuple(self._port_default(d) for d in fn.__defaults__)
        new = types.FunctionType(_analysis_code(fn.__code__), self.globals, fn.__name__,
                                 defaults, fn.__closure__)
        new.__kwdefaults__ = fn.__kwdefaults__
        return new

    def _port_default(self, value):
        if isinstance(value, (str, Path)):
            return self._port(value)
        return super()._port_default(value)


FIXTURES = ("tmp_path", "monkeypatch", "capsys")


def case_params(module, skip=()) -> list:
    """The module's ``test_*`` functions, less ``skip``, in source order."""
    names = [
        name for name, fn in vars(module).items()
        if name.startswith("test_") and isinstance(fn, types.FunctionType)
        and name not in skip
    ]
    return sorted(names, key=lambda n: vars(module)[n].__code__.co_firstlineno)


def run_case(rebound: AnalysisRebound, name: str, request) -> None:
    """Call the rebound case ``name`` with the fixtures it asks for."""
    fn = rebound.case(name)
    wanted = inspect.signature(rebound.module.__dict__[name]).parameters
    kwargs = {p: request.getfixturevalue(p) for p in wanted}
    fn(**kwargs)
