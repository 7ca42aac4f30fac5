"""Runtime determinism sanitizer — the dynamic counterpart of GL010.

The reference autoscaler backs its static checks with Go's ``-race``
detector in the tests: static analysis proves what it can, the runtime
monitor catches what actually fired. This is the Python analog for the
*determinism* contract: while a loadgen replay (or a pytest run) executes,
every ambient wall-clock, RNG and environment read that occurs **inside a
replay-scoped frame** is trapped, attributed to its ``file:line``, and
reported — a nondeterministic call that static resolution missed (dynamic
dispatch, getattr tricks, a dependency calling back) still cannot slip
into a byte-diffed artifact unnoticed.

Mechanism:

- **Patch-based interception** of the shared source tables
  (``dataflow.GL001_BANNED`` et al — the same model GL001 and GL010
  judge, so "static is never less complete than runtime" holds by
  construction; ``tests/test_sanitizer.py`` asserts the subset property
  against :func:`dataflow.source_sites`): ``time.time``/``monotonic``/
  ``sleep``…, ``os.urandom``/``getenv``, ``uuid.uuid1/4``, and the
  module-level ``random.*`` functions riding the shared ambient state.
  ``time.perf_counter`` is deliberately untouched — it is the sanctioned
  wall-measurement clock and never a replay artifact input.
  (``datetime.datetime.now`` lives on an immutable C type and cannot be
  patched; it stays static-only coverage — documented limit.)
- **Audit hook** (``sys.addaudithook``) for the events the interpreter
  exposes: ``os.putenv``/``os.unsetenv`` — environment *mutation* during
  a replay is as unreproducible as a read. Audit hooks are permanent for
  the process, so one module-level hook is registered lazily and armed
  per-installation.
- **Frame attribution**: on each trapped call the stack is walked outward
  and the innermost frame whose file sits in a replay scope
  (``dataflow.REPLAY_SCOPES``) names the event; calls with no
  replay-scoped frame (test harnesses, the loadgen driver itself, worker
  threads of the HTTP server) are ignored — ambient time is legal
  outside the replay path.
- **Pragma declassification**: a trapped line carrying
  ``# graftlint: disable=GL001`` (or GL010) is the author-sanctioned seam
  fallback (e.g. ``trace.timeline_now``'s no-active-trace branch) and is
  skipped — the runtime monitor honors exactly the seams the static
  rules honor.

Wiring: ``python -m autoscaler_tpu_torch.loadgen run … --sanitize`` wraps the
replay and exits 1 on any event (``chip_smoke.py`` replays an in-code
twin of the JAX package's ``kernel_fault_ladder`` scenario this way). The
JAX package's session-wide pytest hook (``AUTOSCALER_TPU_SANITIZE=1``) has
no counterpart here.
"""
from __future__ import annotations

import os
import random
import sys
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from autoscaler_tpu_torch.analysis.dataflow import (
    AMBIENT_RNG,
    ENV_READ,
    REPLAY_SCOPES,
    WALL_CLOCK,
)
from autoscaler_tpu_torch.analysis.engine import (
    display_path,
    module_path,
    parse_pragmas,
    suppressed_at,
)

# rules whose inline pragma also declassifies the runtime event
_PRAGMA_RULES = {"GL001", "GL010"}

# this module's own filename — frame attribution skips exactly these frames
_OWN_FILE = __file__


@dataclass(frozen=True)
class SanitizerEvent:
    """One trapped nondeterministic call attributed to a replay frame."""

    kind: str          # wall-clock | ambient-rng | environment-read | environment-write
    func: str          # e.g. "time.time", "random.random", "os.putenv"
    path: str          # display path of the attributed replay frame
    line: int

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.kind} {self.func}() during replay"


# (module object, attribute, qualified name, kind)
def _patch_table() -> List[Tuple[object, str, str, str]]:
    table: List[Tuple[object, str, str, str]] = [
        (time, "time", "time.time", WALL_CLOCK),
        (time, "time_ns", "time.time_ns", WALL_CLOCK),
        (time, "monotonic", "time.monotonic", WALL_CLOCK),
        (time, "monotonic_ns", "time.monotonic_ns", WALL_CLOCK),
        (time, "sleep", "time.sleep", WALL_CLOCK),
        (os, "urandom", "os.urandom", AMBIENT_RNG),
        (os, "getenv", "os.getenv", ENV_READ),
        (uuid, "uuid1", "uuid.uuid1", AMBIENT_RNG),
        (uuid, "uuid4", "uuid.uuid4", AMBIENT_RNG),
    ]
    for name in (
        "random", "randint", "randrange", "choice", "choices", "shuffle",
        "sample", "uniform", "getrandbits", "seed", "betavariate", "gauss",
    ):
        if hasattr(random, name):
            table.append((random, name, f"random.{name}", AMBIENT_RNG))
    return table


# -- the one (permanent) audit hook -------------------------------------------
# sys.addaudithook registrations cannot be removed; a single module-level
# hook is registered on first install and consults the armed instance.

_AUDIT_EVENTS = {
    "os.putenv": "environment-write",
    "os.unsetenv": "environment-write",
}
_audit_installed = False
# installation stack: sanitizers nest LIFO (a per-test sanitizer inside the
# session-wide one); only the INNERMOST records events —
# an outer session monitor must not absorb a nested fixture's intentional
# violations as its own
_stack: List["DeterminismSanitizer"] = []
_arm_lock = threading.Lock()


def _armed_sanitizer() -> Optional["DeterminismSanitizer"]:
    return _stack[-1] if _stack else None


def _audit_hook(event: str, args) -> None:
    active = _armed_sanitizer()
    if active is None:
        return
    kind = _AUDIT_EVENTS.get(event)
    if kind is not None:
        active._note(kind, event)


class DeterminismSanitizer:
    """Installable determinism monitor. Use as a context manager::

        with DeterminismSanitizer() as san:
            run_replay()
        assert not san.events, san.report()
    """

    def __init__(self, scopes: Sequence[str] = REPLAY_SCOPES):
        self.scopes = tuple(scopes)
        self.events: List[SanitizerEvent] = []
        self._seen: Set[SanitizerEvent] = set()
        self._saved: List[Tuple[object, str, object]] = []
        self._lock = threading.Lock()
        self._installed = False
        # filename -> (pragma map, source lines) for declassification
        self._pragma_cache: Dict[str, Tuple[Dict[int, Set[str]], List[str]]] = {}

    # -- lifecycle ------------------------------------------------------------

    def install(self) -> "DeterminismSanitizer":
        """Install the patches and become the recording sanitizer.
        Installations NEST (LIFO): a per-test sanitizer under the session
        one silences the outer until it uninstalls — each monitor sees
        only the events of its own innermost window."""
        global _audit_installed
        with _arm_lock:
            if self._installed:
                return self
            for mod, attr, qual, kind in _patch_table():
                original = getattr(mod, attr)
                self._saved.append((mod, attr, original))
                setattr(mod, attr, self._wrap(original, qual, kind))
            if not _audit_installed:
                sys.addaudithook(_audit_hook)
                _audit_installed = True
            _stack.append(self)
            self._installed = True
        return self

    def uninstall(self) -> None:
        with _arm_lock:
            if not self._installed:
                return
            if not _stack or _stack[-1] is not self:
                # restoring out of order would resurrect a dead wrapper
                raise RuntimeError(
                    "DeterminismSanitizer.uninstall out of LIFO order"
                )
            for mod, attr, original in reversed(self._saved):
                setattr(mod, attr, original)
            self._saved.clear()
            _stack.pop()
            self._installed = False

    def __enter__(self) -> "DeterminismSanitizer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- interception ---------------------------------------------------------

    def _wrap(self, original: Callable, qual: str, kind: str) -> Callable:
        def wrapped(*args, **kwargs):
            self._note(kind, qual)
            return original(*args, **kwargs)

        wrapped.__name__ = getattr(original, "__name__", qual.split(".")[-1])
        wrapped.__qualname__ = wrapped.__name__
        wrapped.__sanitizer_original__ = original
        return wrapped

    def _note(self, kind: str, qual: str) -> None:
        if _armed_sanitizer() is not self:
            # nested installation: an outer sanitizer's wrapper still runs
            # (the inner one wraps it) but only the innermost records
            return
        site = self._replay_frame()
        if site is None:
            return
        path, filename, line = site
        if self._pragma_declassified(path, filename, line):
            return
        event = SanitizerEvent(kind=kind, func=qual, path=path, line=line)
        with self._lock:
            if event not in self._seen:
                self._seen.add(event)
                self.events.append(event)

    def _replay_frame(self) -> Optional[Tuple[str, str, int]]:
        """The DIRECT caller frame when it sits in a replay scope →
        (display path, line), else None.

        Direct-caller attribution is the deliberate under-approximation:
        a library (torch dispatch, urllib, the HTTP server) reading the
        clock internally below a replay frame is *its* implementation
        detail — those values never enter replay artifacts, and trapping
        them would drown the signal. What the sanitizer polices is replay
        code itself invoking an ambient source, which is exactly the call
        shape GL001/GL010 prove absent statically."""
        frame = sys._getframe(2)
        # skip interception machinery frames (nested wrappers, audit
        # hook) — THIS module's frames exactly, not any *sanitizer.py
        while frame is not None and frame.f_code.co_filename == _OWN_FILE:
            frame = frame.f_back
        if frame is None:
            return None
        filename = frame.f_code.co_filename
        mod = module_path(filename)
        if mod is not None and self._in_scopes(mod):
            return display_path(filename), filename, frame.f_lineno
        return None

    def _in_scopes(self, mod: str) -> bool:
        return any(
            mod.startswith(p) if p.endswith("/") else mod == p
            for p in self.scopes
        )

    def _pragma_declassified(self, path: str, filename: str, line: int) -> bool:
        """Honor EXACTLY the seams the static rules honor
        (engine._suppressed semantics): the pragma on the trapped line
        itself, or on a COMMENT-ONLY line directly above — a pragma
        trailing unrelated code must not disable runtime detection for
        the line below it."""
        cached = self._pragma_cache.get(filename)
        if cached is None:
            pragmas: Dict[int, Set[str]] = {}
            lines: List[str] = []
            try:
                source = self._read_source(path, filename)
                if source is not None:
                    pragmas, _ = parse_pragmas(source, path)
                    lines = source.splitlines()
            except (OSError, UnicodeDecodeError):
                pragmas, lines = {}, []
            cached = (pragmas, lines)
            self._pragma_cache[filename] = cached
        pragmas, lines = cached
        return suppressed_at(line, _PRAGMA_RULES, pragmas, lines)

    @staticmethod
    def _read_source(display: str, filename: str) -> Optional[str]:
        # the frame's own filename first (absolute, tmp trees included),
        # then the display path resolved against the importable package
        if os.path.isfile(filename):
            with open(filename, encoding="utf-8") as f:
                return f.read()
        import autoscaler_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(autoscaler_tpu_torch.__file__)
        ))
        candidate = os.path.join(pkg_root, display)
        if os.path.isfile(candidate):
            with open(candidate, encoding="utf-8") as f:
                return f.read()
        return None

    # -- reporting ------------------------------------------------------------

    def report(self) -> str:
        lines = [e.render() for e in sorted(
            self.events, key=lambda e: (e.path, e.line, e.kind, e.func)
        )]
        return "\n".join(lines)

    def sorted_events(self) -> List[SanitizerEvent]:
        return sorted(
            self.events, key=lambda e: (e.path, e.line, e.kind, e.func)
        )
