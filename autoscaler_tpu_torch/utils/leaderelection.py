"""Single-leader election (active/passive HA).

Reference: cluster-autoscaler/main.go:525-573 (leaderelection.RunOrDie over a
Kubernetes Lease: 15s lease, 10s renew deadline, 2s retry). The framework is
control-plane-agnostic, so the lease backend is pluggable: the built-in
FileLease works on any shared filesystem; a Kubernetes-Lease or cloud-lock
backend implements the same two methods. The autoscaler is stateless
(snapshot rebuilt every loop, static_autoscaler.go:250) so failover needs no
state handover — the new leader just starts reconciling.

The port's copy of ``autoscaler_tpu/utils/leaderelection.py``.
"""
from __future__ import annotations

import json
import os
import socket
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Optional, Protocol


class Lease(Protocol):
    def try_acquire(self, holder: str, now_ts: float) -> bool: ...

    def release(self, holder: str) -> None: ...


@dataclass
class FileLease:
    """Advisory lease in a file: atomic create-or-steal with TTL expiry."""

    path: str
    ttl_s: float = 15.0

    def try_acquire(self, holder: str, now_ts: float) -> bool:
        record = {"holder": holder, "renewed": now_ts}
        try:
            current = self._read()
            if (
                current is not None
                and current["holder"] != holder
                and now_ts - current["renewed"] < self.ttl_s
            ):
                return False
            tmp = f"{self.path}.{uuid.uuid4().hex}.tmp"
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, self.path)  # atomic on POSIX
            return True
        except OSError:
            return False

    def release(self, holder: str) -> None:
        current = self._read()
        if current is not None and current["holder"] == holder:
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def _read(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None


class LeaderElector:
    """run() blocks until leadership, then invokes the loop callback while
    renewing; on lost leadership it returns (the process should exit and let
    the orchestrator restart it — main.go:568's OnStoppedLeading fatal)."""

    def __init__(
        self,
        lease: Lease,
        identity: Optional[str] = None,
        renew_period_s: float = 2.0,
        renew_deadline_s: float = 10.0,
        clock: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.lease = lease
        self.identity = identity or f"{socket.gethostname()}-{uuid.uuid4().hex[:8]}"
        self.renew_period_s = renew_period_s
        self.renew_deadline_s = renew_deadline_s
        self.clock = clock
        self.sleep = sleep

    def run(self, on_started_leading: Callable[[Callable[[], bool]], None]) -> None:
        """on_started_leading receives a `still_leader()` callback it must
        consult between loop iterations.

        While leading, the lease is renewed on a BACKGROUND thread every
        renew_period_s (the reference's 2s renew goroutine) — a long loop
        iteration can't let the lease expire mid-iteration and split-brain
        a second replica in. Renewal failures are tolerated for
        renew_deadline_s (reference: 10s) before leadership is considered
        lost, so one transient apiserver error doesn't dethrone a healthy
        leader."""
        while not self.lease.try_acquire(self.identity, self.clock()):
            self.sleep(self.renew_period_s)

        import threading

        stop = threading.Event()
        state = {"leading": True, "last_renew": self.clock()}

        def renewer() -> None:
            while not stop.wait(self.renew_period_s):
                ok = False
                try:
                    ok = self.lease.try_acquire(self.identity, self.clock())
                except Exception:  # noqa: BLE001 — network lease errors count
                    ok = False     # toward the renew deadline, not a crash
                now = self.clock()
                if ok:
                    state["last_renew"] = now
                elif now - state["last_renew"] > self.renew_deadline_s:
                    state["leading"] = False
                    return

        renew_thread = threading.Thread(target=renewer, daemon=True)
        renew_thread.start()

        def still_leader() -> bool:
            # freshness matters as much as the flag: a renewal hung in a
            # blackholed request must not keep an expired leader active
            return (
                state["leading"]
                and self.clock() - state["last_renew"] <= self.renew_deadline_s
            )

        try:
            on_started_leading(still_leader)
        finally:
            stop.set()
            renew_thread.join(timeout=self.renew_period_s * 2)
            if renew_thread.is_alive():
                # a renewal is still in flight; releasing now could race its
                # completing PUT and re-create the lease under our dead
                # identity — let the TTL expire it instead
                pass
            else:
                self.lease.release(self.identity)
