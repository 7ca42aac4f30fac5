"""Shared stdlib JSON-over-HTTP request helper for the REST transports
(kube/client.py and cloudprovider/gce_rest.py) so the request/auth/error
pattern cannot drift between them.

Error mapping is the caller's via `on_error(status, detail) -> Exception`:
HTTP errors pass their status code; transport-level failures (DNS, refused,
timeout, non-JSON 2xx body) pass status 0.

The port's copy of ``autoscaler_tpu/utils/http.py``.
"""
from __future__ import annotations

import json
import random
import ssl
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


@dataclass
class RetryPolicy:
    """Bounded, jittered exponential retry for IDEMPOTENT requests.

    Only transient outcomes retry: transport-level failures (DNS, refused,
    timeout) and HTTP 429/5xx. A 429/503 ``Retry-After`` header (seconds
    form) is honored, capped at ``max_sleep_s``. Jitter (0.5-1.0x) keeps a
    fleet of restarted control loops from synchronizing their retries
    against a recovering API server. Non-idempotent writes must NOT pass a
    policy — the caller cannot know whether the server applied the mutation.
    """

    attempts: int = 3                 # total tries, including the first
    base_sleep_s: float = 0.25
    max_sleep_s: float = 5.0
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)
    rng: Callable[[], float] = field(default=random.random, repr=False)

    def backoff_s(self, attempt: int, retry_after_s: Optional[float]) -> float:
        """Delay before retry number ``attempt`` (1-based)."""
        if retry_after_s is not None:
            return min(max(retry_after_s, 0.0), self.max_sleep_s)
        exp = min(self.base_sleep_s * (2 ** (attempt - 1)), self.max_sleep_s)
        return exp * (0.5 + 0.5 * self.rng())


def _trace_retry(attempt: int, **attrs) -> None:
    """Stamp a retry on the enclosing request's trace span (no-op outside a
    tick trace): a backoff storm must be attributable to the phase that
    issued the request, not just a counter somewhere."""
    from autoscaler_tpu_torch import trace

    trace.add_event("http.retry", attempt=attempt, **attrs)


def _retry_after_seconds(headers) -> Optional[float]:
    try:
        value = headers.get("Retry-After") if headers is not None else None
    except AttributeError:
        return None
    if not value:
        return None
    try:
        return float(value)
    except ValueError:
        return None  # HTTP-date form: fall back to exponential pacing


def json_request(
    url: str,
    method: str = "GET",
    body: Optional[dict] = None,
    headers: Optional[Dict[str, str]] = None,
    timeout_s: float = 30.0,
    context: Optional[ssl.SSLContext] = None,
    on_error: Callable[[int, str], Exception] = lambda s, d: RuntimeError(
        f"HTTP {s}: {d}"
    ),
    stream: bool = False,
    retry: Optional[RetryPolicy] = None,
):
    """One JSON request. Returns the decoded dict ({} on empty body), or the
    raw response object when stream=True (caller closes it). ``retry``
    (idempotent callers only) retries transient failures — 429/5xx honoring
    Retry-After, plus transport errors — with jittered bounded backoff."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Accept", "application/json")
    if data is not None and not any(
        k.lower() == "content-type" for k in (headers or {})
    ):
        req.add_header("Content-Type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    attempts = retry.attempts if retry is not None else 1
    attempt = 0
    while True:
        attempt += 1
        try:
            resp = urllib.request.urlopen(
                req, timeout=timeout_s, context=context
            )
            break
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:512]
            transient = e.code == 429 or e.code >= 500
            if retry is not None and transient and attempt < attempts:
                _trace_retry(attempt, status=e.code)
                retry.sleep(
                    retry.backoff_s(attempt, _retry_after_seconds(e.headers))
                )
                continue
            raise on_error(e.code, detail) from None
        except urllib.error.URLError as e:
            # full socket timeouts are NOT retried: each one already
            # consumed timeout_s, so re-sending would stall a control-loop
            # tick for attempts x timeout_s — past the watchdog's soft
            # deadline — for a server that is wedged, not flaking. Only
            # fast transport errors (refused, DNS, reset) retry.
            timed_out = isinstance(e.reason, TimeoutError)
            if retry is not None and attempt < attempts and not timed_out:
                _trace_retry(attempt, error=type(e.reason).__name__)
                retry.sleep(retry.backoff_s(attempt, None))
                continue
            raise on_error(0, str(e.reason)) from None
        except OSError as e:  # bare socket errors
            if (
                retry is not None
                and attempt < attempts
                and not isinstance(e, TimeoutError)
            ):
                _trace_retry(attempt, error=type(e).__name__)
                retry.sleep(retry.backoff_s(attempt, None))
                continue
            raise on_error(0, str(e)) from None
    if stream:
        return resp
    payload = resp.read()
    resp.close()
    if not payload:
        return {}
    try:
        return json.loads(payload)
    except json.JSONDecodeError as e:
        # a proxy/LB returning HTML-with-200 must surface through the same
        # error contract as any other transport failure
        raise on_error(0, f"non-JSON response ({e})") from None
