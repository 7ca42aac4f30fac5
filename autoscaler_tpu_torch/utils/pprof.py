"""In-process profiling endpoints — the `/debug/pprof` analog.

The reference exposes Go's net/http/pprof behind `--profiling`
(main.go:518-520).  Python has no built-in pprof server, so this module
provides the same three capabilities with stdlib-only machinery:

- ``SamplingProfiler``: a wall-clock sampling profiler over ALL threads
  (polls ``sys._current_frames()``), emitting collapsed-stack lines
  (``a;b;c count``) directly consumable by flamegraph tooling — the
  analog of ``/debug/pprof/profile?seconds=N``.
- ``heap_profile``: tracemalloc-backed allocation snapshot grouped by
  source line — the analog of ``/debug/pprof/heap``.
- ``thread_dump``: current stacks of every live thread — the analog of
  ``/debug/pprof/goroutine?debug=2``.

Sampling keeps overhead bounded (default 100 Hz; each sample is a dict
copy of frame pointers, no tracing hooks), so it is safe to run against
a live control loop the same way Go's pprof is.

The port's copy of ``autoscaler_tpu/utils/pprof.py``.
"""
from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import Counter


# Serializes /debug/pprof/profile requests, like Go's net/http/pprof CPU
# profile (a second concurrent request is rejected): N parallel 100 Hz
# samplers would multiply overhead on the live control loop.
PROFILE_LOCK = threading.Lock()

# thread ids currently running a SamplingProfiler: concurrent profile
# requests must not sample each other's profiling loops
_ACTIVE_PROFILER_THREADS: set = set()


class SamplingProfiler:
    """Collapsed-stack sampling profiler across all threads."""

    def __init__(self, hz: float = 100.0):
        self.hz = hz
        self._samples: Counter = Counter()
        self._count = 0

    def _take_sample(self, skip: set) -> None:
        for tid, frame in sys._current_frames().items():
            if tid in skip:
                continue
            parts = []
            f = frame
            while f is not None:
                code = f.f_code
                parts.append(f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_name}")
                f = f.f_back
            self._samples[";".join(reversed(parts))] += 1
        self._count += 1

    def run(self, seconds: float) -> str:
        """Sample for ``seconds``, then render collapsed stacks."""
        interval = 1.0 / self.hz
        deadline = time.monotonic() + seconds
        me = threading.get_ident()
        _ACTIVE_PROFILER_THREADS.add(me)
        try:
            while time.monotonic() < deadline:
                self._take_sample(skip=_ACTIVE_PROFILER_THREADS)
                time.sleep(interval)
        finally:
            _ACTIVE_PROFILER_THREADS.discard(me)
        return self.render()

    def render(self) -> str:
        lines = [
            f"# wall-clock samples: {self._count} @ {self.hz:g} Hz",
        ]
        for stack, n in self._samples.most_common():
            lines.append(f"{stack} {n}")
        return "\n".join(lines) + "\n"


def heap_profile(limit: int = 50) -> str:
    """tracemalloc snapshot grouped by line (``/debug/pprof/heap`` analog).

    Requires tracemalloc to have been started (done by the observability
    server when profiling is enabled); reports an explanatory line if not.
    """
    import tracemalloc

    if not tracemalloc.is_tracing():
        return "# tracemalloc not tracing; start with --profiling\n"
    try:
        snap = tracemalloc.take_snapshot()
    except RuntimeError:
        # races server stop(): tracing ended between the check and snapshot
        return "# tracemalloc not tracing; start with --profiling\n"
    stats = snap.statistics("lineno")
    total = sum(s.size for s in stats)
    lines = [f"# heap: {total / 1024:.1f} KiB tracked in {len(stats)} sites"]
    for s in stats[:limit]:
        frame = s.traceback[0]
        lines.append(
            f"{frame.filename.rsplit('/', 1)[-1]}:{frame.lineno} "
            f"size={s.size} count={s.count}"
        )
    return "\n".join(lines) + "\n"


def thread_dump() -> str:
    """All live thread stacks (``/debug/pprof/goroutine?debug=2`` analog)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {tid} ({names.get(tid, '?')}) ---")
        out.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(out) + "\n"


class LoopWatchdog:
    """Soft-deadline watchdog for the control loop's ticks.

    ``arm()`` before each ``run_once``, ``disarm()`` after. If a tick is
    still running when the soft deadline lapses, the watchdog thread dumps
    every live thread's stack (``thread_dump``) exactly once for that tick
    — so a wedged iteration (device hang, stuck HTTP read, deadlock)
    leaves evidence of WHERE it was stuck before the liveness probe's
    max-inactivity deadline has the process killed and restarted.

    The watchdog never unwedges anything itself (crash-only discipline:
    recovery is the supervisor's restart); it only observes.
    """

    def __init__(self, soft_deadline_s: float, emit=None):
        import sys as _sys

        self.soft_deadline_s = soft_deadline_s
        self._emit = emit or (lambda text: print(text, file=_sys.stderr))
        self._cond = threading.Condition()
        self._deadline: float = 0.0   # 0 = disarmed
        self._fired = False
        self.fired_count = 0          # observability for tests/metrics
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name="loop-watchdog", daemon=True
        )
        self._thread.start()

    def arm(self) -> None:
        with self._cond:
            self._deadline = time.monotonic() + self.soft_deadline_s
            self._fired = False
            self._cond.notify()

    def disarm(self) -> None:
        with self._cond:
            self._deadline = 0.0
            self._cond.notify()

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                if self._stopped:
                    return
                if self._deadline == 0.0 or self._fired:
                    self._cond.wait()
                    continue
                wait = self._deadline - time.monotonic()
                if wait > 0:
                    self._cond.wait(timeout=wait)
                    continue
                self._fired = True
                self.fired_count += 1
                deadline_s = self.soft_deadline_s
            # dump OUTSIDE the lock: thread_dump walks every frame and must
            # not block arm/disarm from the control loop
            self._emit(
                f"watchdog: run_once exceeded its {deadline_s:.0f}s soft "
                f"deadline; all-thread stack dump:\n{thread_dump()}"
            )


PPROF_INDEX = """\
/debug/pprof/ — profiling index (Go net/http/pprof analog)
  /debug/pprof/profile?seconds=N   collapsed-stack wall profile (default 5s)
  /debug/pprof/heap                tracemalloc allocation snapshot
  /debug/pprof/threadz             live thread stack dump
"""
