"""Host spans of the benchmark's own calls into the program's layers.

A span is (name, start_ns, end_ns, depth) on the host's
`time.perf_counter_ns` clock, kept in memory. `wrap` puts a span around
every call of a function; the harness wraps the program's stage functions
with it only in a traced run.
"""
from __future__ import annotations

import functools
import time
from contextlib import contextmanager


class Spans:
    def __init__(self):
        self.rows = []
        self._depth = 0

    @contextmanager
    def span(self, name: str):
        start = time.perf_counter_ns()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            self.rows.append((name, start, time.perf_counter_ns(),
                              self._depth))

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return inner

    def seconds(self, name: str) -> float:
        return sum(e - s for n, s, e, _ in self.rows if n == name) / 1e9

    def innermost(self, t_ns: int) -> str:
        """The name of the deepest span open at host time t_ns, or
        "outside" where none is."""
        best, depth = "outside", -1
        for name, s, e, d in self.rows:
            if s <= t_ns < e and d > depth:
                best, depth = name, d
        return best
