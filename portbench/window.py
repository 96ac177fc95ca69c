"""The measured window: a closed loop of requests, one client.

Each request is issued, waited for (it ends in a device synchronize) and
timed by the host clock, issue to completion; the next is issued after.
The loop runs until `seconds` have passed, and the window ends with the
last request's completion. Its rate is taken over all of the window's
time and all of its requests, and its tail over every request's latency.
One request's output is kept, drawn uniformly from the window's by a
seeded reservoir, for the check.
"""

from __future__ import annotations

import math
import random
import time


class Window:
    def __init__(self, seconds: float, seed: int, clock=time.perf_counter):
        self.seconds, self.clock = seconds, clock
        self.latencies = []
        self.kept = None
        self.kept_index = None
        self.start = self.end = None
        self._draw = random.Random(seed)

    def run(self, request, stop=None):
        """Issue request() until the window's time has passed (or, with
        `stop`, until stop(elapsed) says so, asked after each request)."""
        self.start = self.clock()
        while True:
            t0 = self.clock()
            out = request()
            t1 = self.clock()
            self.add(t1 - t0, out)
            elapsed = t1 - self.start
            done = stop(elapsed) if stop is not None else (
                elapsed >= self.seconds)
            if done:
                self.end = t1
                return self

    def add(self, latency: float, out=None):
        self.latencies.append(latency)
        n = len(self.latencies)
        if self._draw.random() * n < 1.0:  # reservoir of one
            self.kept, self.kept_index = out, n - 1

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def mean_ms(self) -> float:
        """The window's length over the requests it completed, in ms."""
        return self.window_s * 1e3 / len(self.latencies)

    def p95_ms(self) -> float:
        return percentile(self.latencies, 95) * 1e3


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q % of the values at or below it."""
    xs = sorted(values)
    k = max(1, math.ceil(q / 100 * len(xs)))
    return xs[k - 1]
