"""Scoped wall-clock profiler — parity with reference hmr_profiler.c
(PROFILER_RESET/ACCUMULATE/PRINT, hmr_profiler.h:29-41).

For device-side profiling use jax.profiler traces; this covers the host
pipeline stages (analysis dispatch, fetch, SAO decide, serialization)."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class Profiler:
    """Totals and counts by scope name. The slot threads of a mesh
    (parallel/mesh.py) enter scopes at once: each update is a
    read-modify-write, so it runs under the profiler's lock (a scope
    open in several threads adds each thread's time)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()

    def report(self) -> str:
        with self._lock:
            totals, counts = dict(self.totals), dict(self.counts)
        lines = []
        for name in sorted(totals, key=totals.get, reverse=True):
            t, c = totals[name], counts[name]
            lines.append(f"{name}: {t*1000:.1f} ms total, {c} calls, "
                         f"{t/c*1000:.2f} ms/call")
        return "\n".join(lines)


PROFILER = Profiler()
