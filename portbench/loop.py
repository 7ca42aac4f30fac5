"""The closed loop: one client, one cluster's autoscaler, sends its next
estimate when the last answer is on the host. It cycles through the pool
of worlds; a request's latency runs from its send to its answer on the
host. Requests sent before the window's seconds are up are all answered
and counted; the window ends with the last answer.

A sample of the answers, drawn from the seed, is kept for the check
(reservoir sampling: every answered request is as likely to be kept).
"""
from __future__ import annotations

import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np

from portbench.trace import annotate


class Client:
    """The timed path of one request through an entry; with ``traced``,
    ranges for the profiler and CUDA events around the upload and the
    fetch."""

    def __init__(self, entry, device, traced: bool = False):
        self.entry = entry
        self.device = device
        self.traced = traced
        self.events: List[tuple] = []   # per request: (upload start, end, fetch start, end)

    def _event(self):
        import torch

        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def send(self, world):
        timed = self.traced and str(self.device).startswith("cuda")
        with annotate("portbench.request", self.traced):
            e0 = self._event() if timed else None
            with annotate("portbench.upload", self.traced):
                operands = self.entry.upload(world, self.device)
            e1 = self._event() if timed else None
            with annotate("portbench.estimate", self.traced):
                result = self.entry.estimate(operands, world)
            e2 = self._event() if timed else None
            with annotate("portbench.fetch", self.traced):
                answer = self.entry.fetch(result)
            if timed:
                self.events.append((e0, e1, e2, self._event()))
        return answer

    def transfer_ms(self) -> Optional[List[float]]:
        """Each request's upload and fetch, ms on the card's clock."""
        if not self.events:
            return None
        return [u0.elapsed_time(u1) + f0.elapsed_time(f1) for u0, u1, f0, f1 in self.events]


class Window(NamedTuple):
    seconds: float                 # first send to last answer
    latencies_s: List[float]       # answered requests, in order
    worlds: List[int]              # each request's world in the pool
    done: List[int]                # each answered request's world
    failed: int
    sample: List[tuple]            # (request index, world, answer)


def closed_loop(send, pool, seconds: float, keep: int, rng: np.random.Generator) -> Window:
    latencies, worlds, done, sample = [], [], [], []
    failed = 0
    start = end = time.perf_counter()
    deadline = start + seconds
    i = answered = 0
    while time.perf_counter() < deadline:
        w = i % len(pool)
        t0 = time.perf_counter()
        try:
            answer = send(pool[w])
        except Exception as e:  # noqa: BLE001 - a failed request is counted, the loop goes on
            failed += 1
            print(f"portbench: request {i} on {pool[w].name} failed: {e!r}", file=sys.stderr)
            answer = None
        end = time.perf_counter()
        worlds.append(w)
        if answer is not None:
            latencies.append(end - t0)
            done.append(w)
            if answered < keep:
                sample.append((i, w, answer))
            else:
                j = int(rng.integers(0, answered + 1))
                if j < keep:
                    sample[j] = (i, w, answer)
            answered += 1
        i += 1
    return Window(end - start, latencies, worlds, done, failed, sample)
