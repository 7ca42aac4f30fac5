"""Typed autoscaler errors.

Reference: cluster-autoscaler/utils/errors/ (AutoscalerError with error
types: ApiCallError, InternalError, TransientError, ConfigurationError,
NodeGroupDoesNotExistError) — the type drives retry/backoff decisions and
metrics labels.

The port's copy of ``autoscaler_tpu/utils/errors.py``.
"""
from __future__ import annotations

import enum
from typing import Optional


class ErrorType(enum.Enum):
    API_CALL = "apiCallError"
    INTERNAL = "internalError"
    TRANSIENT = "transientError"
    CONFIGURATION = "configurationError"
    NODE_GROUP_DOES_NOT_EXIST = "nodeGroupDoesNotExistError"


class AutoscalerError(Exception):
    def __init__(self, error_type: ErrorType, message: str):
        super().__init__(message)
        self.error_type = error_type

    @property
    def retriable(self) -> bool:
        return self.error_type in (ErrorType.TRANSIENT, ErrorType.API_CALL)

    def prefixed(self, prefix: str) -> "AutoscalerError":
        # chain the original so logging the wrapper (exc_info) still shows
        # the real traceback — the crash-only loop relies on this
        new = AutoscalerError(self.error_type, f"{prefix}{self}")
        new.__cause__ = self
        return new


def to_autoscaler_error(err: Exception) -> AutoscalerError:
    """Wrap any exception as a typed AutoscalerError, preserving the
    original as ``__cause__`` so the crash-only control loop's logs keep
    the real traceback instead of a stringified tail."""
    if isinstance(err, AutoscalerError):
        return err
    wrapped = AutoscalerError(ErrorType.INTERNAL, str(err) or type(err).__name__)
    wrapped.__cause__ = err
    return wrapped
