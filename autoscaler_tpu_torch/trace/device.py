"""Device-timing correlation: optional torch.profiler hooks.

Host spans tell you a kernel dispatch took 80ms; they cannot tell you
whether the card spent it executing, or idle behind a transfer or the
host's launches. These helpers bridge the host trace to the device
timeline:

- :func:`device_annotation` wraps a dispatch in
  ``torch.profiler.record_function`` so the host span's name shows up on
  the device timeline when a profiler session is active (no-op when the
  profiler is unavailable);
- :func:`step_annotation` marks one tick as a profiler step, named as
  torch names its steps (``ProfilerStep#<tick>``);
- :func:`start_profiler_session` / :func:`stop_profiler_session` capture a
  ``torch.profiler.profile`` session (CPU activity, and CUDA activity when a
  card is present) and export it as a Chrome trace into
  ``<dir>/tick_<id>/trace.json``, so a device profile is keyed by the same
  tick id as the host trace in the flight recorder (the
  ``--jax-profiler-dir`` flag, named as in the JAX package).

The port of ``autoscaler_tpu/trace/device.py``. Kept separate from
tracer.py so the core tracing package stays dependency-free.
"""
from __future__ import annotations

import logging
import os
from contextlib import nullcontext
from typing import Any, Optional, Tuple

logger = logging.getLogger("trace")

# independent failure domains: a broken IMPORT disables everything, but a
# failed SESSION start (unwritable dir, another profiler already active)
# disables sessions only — annotations keep working
_profiler_broken = False   # torch.profiler itself unusable: warn once, no-op
_sessions_broken = False   # a session failed to start once: sessions off
# the running tick session and the directory it exports into
_session: Optional[Tuple[Any, str]] = None

TRACE_FILE = "trace.json"


def _profiler() -> Optional[Any]:
    global _profiler_broken
    if _profiler_broken:
        return None
    try:
        import torch.profiler as prof

        return prof
    except Exception:  # noqa: BLE001 — a broken install: trace without it
        _profiler_broken = True
        logger.warning("torch.profiler unavailable; device annotations disabled")
        return None


def device_annotation(name: str):
    """Context manager tagging device activity with ``name`` — visible in a
    captured profiler session (Perfetto, chrome://tracing). Near free when
    no profiler runs."""
    prof = _profiler()
    if prof is None:
        return nullcontext()
    try:
        return prof.record_function(name)
    except Exception:  # noqa: BLE001
        return nullcontext()


def step_annotation(name: str, step: int):
    """Marks one tick as a profiler step, ``ProfilerStep#<step>`` as torch
    names the steps of ``profile.step()``, so profiler UIs group per-tick
    device activity; ``name`` rides as the range's argument."""
    prof = _profiler()
    if prof is None:
        return nullcontext()
    try:
        return prof.record_function(f"ProfilerStep#{step}", name)
    except Exception:  # noqa: BLE001
        return nullcontext()


def session_dir(base_dir: str, tick_id: int) -> str:
    """The directory a tick's session exports into."""
    return os.path.join(base_dir, f"tick_{tick_id:06d}")


def start_profiler_session(base_dir: str, tick_id: int) -> bool:
    """Begin a torch.profiler capture keyed by tick id. Returns True when a
    session actually started (the caller must stop it)."""
    global _sessions_broken, _session
    if _sessions_broken:
        return False
    prof = _profiler()
    if prof is None:
        return False
    path = session_dir(base_dir, tick_id)
    try:
        import torch

        if torch.autograd.profiler._is_profiler_enabled:
            # one profiler a process: a second start would silently end the
            # one that runs (a probe's own session)
            raise RuntimeError("another torch profiler session is active")
        os.makedirs(path, exist_ok=True)
        activities = [prof.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(prof.ProfilerActivity.CUDA)
        session = prof.profile(activities=activities)
        session.start()
        _session = (session, path)
        return True
    except Exception:  # noqa: BLE001 — an already-active or unsupported
        # profiler must not take down the control loop; annotations keep
        # working (only sessions are disabled)
        _sessions_broken = True
        logger.warning(
            "torch profiler session failed to start (dir=%s); disabling "
            "per-tick sessions", path, exc_info=True,
        )
        return False


def stop_profiler_session() -> None:
    """Stop the running session and export its Chrome trace."""
    global _session
    if _session is None:
        return
    session, path = _session
    _session = None
    try:
        session.stop()
        session.export_chrome_trace(os.path.join(path, TRACE_FILE))
    except Exception:  # noqa: BLE001
        logger.warning("torch profiler session failed to stop", exc_info=True)
