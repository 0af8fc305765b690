"""The port's one tracer: named stage scopes per thread, counters and frame
lifecycle stamps. For the host stages it keeps parity with the
reference's hmr_profiler.c (PROFILER_RESET / ACCUMULATE / PRINT,
hmr_profiler.h:29-41): `report()` is the PROFILER_PRINT analog that the
CLI's `-profile` and `tools/measure_rd.py -profile` print.

Off by default. While off, `scope(name)` is one flag check that returns
a shared no-op context (no clock read, no lock), `count` returns at once,
and the pipeline gives its frames no FrameTrace (EncodedFrame.trace is
None). `enable()` turns on, `disable()` off; while on:

- each scope adds to its total, its self time (the total less its child
  scopes on the same thread) and its calls, keyed by (thread role, name).
  The roles: `main`, `fetch` (the all-intra batch's background fetch,
  engine/pipeline._AsyncFetch) and `slot<k>` (the slots of
  parallel/mesh.py); any other thread goes by its name;
- with a sink (`enable(sink)`: anything with `append`), each finished
  scope is also appended to it as a Span on `time.perf_counter`;
- while a torch profiler runs (torch.profiler.profile, or
  torch.autograd.profiler.emit_nvtx under nsys), each scope also opens a
  record-function range of its name, so the ranges share the device
  trace's clock and the profiler ties each kernel to the range that
  launched it. The range is of function scope (torch's
  `_RecordFunctionFast`, the one its compiled graphs open): a user-scope
  range (torch.profiler.record_function) would also get a twin on the
  card's timeline, which a trace reader counting the card's events would
  take for work;
- `count(name, n)` adds to a counter: `d2h_bytes` (every device->host
  copy the program makes: the wire's meta buffer, the full planes of a
  frame whose wire overflowed, DevicePlane reads), `wire_overflows`,
  the frames the device programs were launched for, `intra.frames`
  and `inter.frames`, and the path each dispatch of the CU16 intra
  program took (engine/intra_encoder.TorchIntraEncoder._launch):
  `intra.eager`, `intra.graph_captures` or `intra.graph_replays`; and
  `scene.cuts`, the cuts the pipeline's scene-change detector declares
  (its span is `scene.detect`), whether or not a GOP reinit acts on them;
- the pipeline stamps each frame it is pushed (FrameTrace).

Scope names form one dotted hierarchy, a child named under its parent
(`intra.fetch.d2h` inside `intra.fetch`); PERF.md section 3 lists them.
The kernels themselves are the device trace's (torch.profiler); this
covers the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch
from torch.autograd import profiler as _torch_profiler

clock = time.perf_counter
_OFF = contextlib.nullcontext()
_RANGE = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    """One finished scope: its thread role, name, start and end (s) and its
    self time (s)."""
    role: str
    name: str
    t0: float
    t1: float
    self_s: float


class Stat(NamedTuple):
    total: float
    self_s: float
    calls: int


@dataclasses.dataclass(slots=True)
class FrameTrace:
    """A frame's lifecycle on `time.perf_counter` (s): pushed into
    TorchPipeline.push; its program launched (`dispatch`; on a host
    program, the start of its analysis); its result's fetch started
    (`fetch`; the end of a host analysis); the result on the host
    (`fetched`: after the fetch returns or the background fetch is
    joined); `_emit` returned (`emit`). d2h_bytes: the frame's share of
    its batch's device->host wire bytes plus its own full-plane fallback
    (the d2h_bytes a device fetch gives its FrameDesc while on)."""
    push: float
    dispatch: float | None = None
    fetch: float | None = None
    fetched: float | None = None
    emit: float | None = None
    d2h_bytes: int = 0


class _Scope:
    __slots__ = ("prof", "name", "t0", "child", "outer", "rf")

    def __init__(self, prof, name):
        self.prof, self.name = prof, name

    def __enter__(self):
        tls = self.prof._tls
        self.outer = getattr(tls, "scope", None)
        tls.scope = self
        self.child = 0.0
        self.rf = None
        if _torch_profiler._is_profiler_enabled:
            self.rf = _RANGE(self.name)
            self.rf.__enter__()
        self.t0 = clock()
        return self

    def __exit__(self, *exc):
        t1 = clock()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.prof._tls.scope = self.outer
        dt = t1 - self.t0
        if self.outer is not None:
            self.outer.child += dt
        self.prof._done(self.name, self.t0, t1, dt, dt - self.child)
        return False


class Profiler:
    """Scopes, counters and frame stamps while on (the module's docstring).
    Slot and fetch threads enter scopes and count at once: every update is
    a read-modify-write under the profiler's lock."""

    def __init__(self):
        self.on = False
        self.sink = None
        self._stats: dict[tuple[str, str], list] = {}
        self._counters: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._tls = threading.local()

    def enable(self, sink=None) -> None:
        self.sink = sink
        self.on = True

    def disable(self) -> None:
        self.on = False
        self.sink = None

    @contextlib.contextmanager
    def enabled(self, sink=None):
        """On, with `sink`, for the block; then as before."""
        was = self.on, self.sink
        self.enable(sink)
        try:
            yield self
        finally:
            self.on, self.sink = was

    def scope(self, name: str):
        if not self.on:
            return _OFF
        return _Scope(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if not self.on:
            return
        with self._lock:
            self._counters[name] += n

    def set_role(self, role: str) -> None:
        """Name the calling thread's role in the stats and spans."""
        self._tls.role = role

    def _role(self) -> str:
        r = getattr(self._tls, "role", None)
        if r is None:
            t = threading.current_thread()
            r = "main" if t is threading.main_thread() else t.name
            self._tls.role = r
        return r

    def frame_trace(self):
        """A new frame's FrameTrace, pushed now; None while off."""
        return FrameTrace(clock()) if self.on else None

    @staticmethod
    def stamp(frames, *stages) -> None:
        """Stamp `stages` with the time now on each of `frames` that
        carries a FrameTrace (`trace`: a frame pushed while on)."""
        t = None
        for fr in frames:
            tr = getattr(fr, "trace", None)
            if tr is None:
                continue
            if t is None:
                t = clock()
            for s in stages:
                setattr(tr, s, t)

    def _done(self, name, t0, t1, dt, self_s) -> None:
        role = self._role()
        with self._lock:
            st = self._stats.get((role, name))
            if st is None:
                st = self._stats[(role, name)] = [0.0, 0.0, 0]
            st[0] += dt
            st[1] += self_s
            st[2] += 1
        sink = self.sink
        if sink is not None:
            sink.append(Span(role, name, t0, t1, self_s))

    def stats(self) -> dict[tuple[str, str], Stat]:
        """{(role, name): Stat(total, self_s, calls)}."""
        with self._lock:
            return {k: Stat(*v) for k, v in self._stats.items()}

    @property
    def totals(self) -> dict[str, float]:
        """Seconds by scope name, summed over the thread roles."""
        out = defaultdict(float)
        for (_, name), st in self.stats().items():
            out[name] += st.total
        return out

    @property
    def counts(self) -> dict[str, int]:
        """Calls by scope name, summed over the thread roles."""
        out = defaultdict(int)
        for (_, name), st in self.stats().items():
            out[name] += st.calls
        return out

    @property
    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._counters.clear()

    def report(self) -> str:
        """One line per (role, scope), most total time first, then the
        counters and the hand-written kernels' launches."""
        from homerhevc_tpu_torch.device import LAUNCHES
        stats = self.stats()
        lines = []
        for (role, name), st in sorted(stats.items(),
                                       key=lambda kv: -kv[1].total):
            lines.append(f"{role} {name}: {st.total * 1e3:.1f} ms total, "
                         f"{st.self_s * 1e3:.1f} ms self, {st.calls} calls, "
                         f"{st.total / st.calls * 1e3:.2f} ms/call")
        for name, n in sorted({**self.counters, **{
                f"launches.{k}": v for k, v in LAUNCHES.items()}}.items()):
            lines.append(f"{name}: {n}")
        return "\n".join(lines)


PROFILER = Profiler()
