"""Scoped wall-clock profiler — parity with reference hmr_profiler.c
(PROFILER_RESET/ACCUMULATE/PRINT, hmr_profiler.h:29-41).

For device-side profiling use jax.profiler traces; this covers the host
pipeline stages (analysis dispatch, fetch, SAO decide, serialization)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Profiler:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t*1000:.1f} ms total, {c} calls, "
                         f"{t/c*1000:.2f} ms/call")
        return "\n".join(lines)


PROFILER = Profiler()
