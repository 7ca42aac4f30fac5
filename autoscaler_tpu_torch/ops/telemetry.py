"""Kernel dispatch-boundary observation seam.

The perf observatory (autoscaler_tpu_torch/perf) needs the concrete call —
kernel function, tensors, statics — of every device dispatch to derive
shape signatures, operand footprints and the cost model. The estimator
does not rewrite its kernel call sites to thread that through:
``ffd_binpack_groups(...)`` stays a direct call.

Instead, each ``ops/`` kernel entry is wrapped with :func:`observed` (host
Python around the entry), and the estimator installs an ambient observer
around each ladder rung via :func:`kernel_observer`. The observer is a
contextvar, not a module global: concurrently running autoscalers each
see only their own observatory, and the seam is free when nobody is
observing.

Dependency-free: stdlib only. The port's copy of
``autoscaler_tpu/ops/telemetry.py``.
"""
from __future__ import annotations

import contextvars
import functools
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Optional

# the ambient observer for THIS context: called (fn, args, kwargs) just
# before every observed kernel entry runs; fn is the unwrapped entry
_OBSERVER: contextvars.ContextVar[
    Optional[Callable[[Any, tuple, dict], None]]
] = contextvars.ContextVar("autoscaler_tpu_torch_kernel_observer", default=None)


@contextmanager
def kernel_observer(
    observer: Optional[Callable[[Any, tuple, dict], None]],
) -> Iterator[None]:
    """Install ``observer`` as the ambient kernel observer for the dynamic
    extent of the block (None = explicitly nothing, shadowing any outer
    observer). The estimator wraps each ladder-rung dispatch in this."""
    token = _OBSERVER.set(observer)
    try:
        yield
    finally:
        _OBSERVER.reset(token)


def observed(fn: Any) -> Any:
    """Wrap a kernel entry point so the ambient observer (when installed)
    sees every call's (fn, args, kwargs) before dispatch. With no observer
    installed it costs one contextvar read. The wrapped entry is exposed
    as ``__wrapped__`` (functools.wraps); the observer receives it."""

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        observer = _OBSERVER.get()
        if observer is not None:
            observer(fn, args, kwargs)
        return fn(*args, **kwargs)

    return wrapper
