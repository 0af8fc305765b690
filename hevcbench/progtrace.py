"""What the program's own tracer (homerhevc_tpu_torch/utils/profiler.py)
records, for the per-layer metrics that read it.

`install(sp)`, called by each such metric's install hook (it acts once a
run), turns the tracer on for the traced run and off at uninstall, with a
sink that keeps the spans the program finishes while the window records
(`sp.recording`). It also wraps `devtrace.profile`: the DeviceTrace it
returns is the one devtrace builds, untouched; beside it the wrapper
keeps the profiled sub-window's program ranges. The profiler records the
host events of the thread that started it alone (the main thread), and
ties each kernel to the host event that launched it: each kernel's device
time goes to the innermost program range open around that event. What no
range claims (the background fetch thread's copies, launches outside any
range) is kept as `unattributed_s`. The idle time of the profiled span
is split by the main thread's innermost program range (`idle_s`) and
logged with the attribution.

Where the program has no tracer (a commit before it), install does
nothing and the readers return None.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

PREFIX = "hevcbench."      # the benchmark's own spans (spans.py)


@dataclasses.dataclass
class Range:
    name: str
    start_us: float
    end_us: float
    device_s: float = 0.0   # kernels launched inside it and no inner range


@dataclasses.dataclass
class Program:
    spans: list              # profiler.Span of the window
    ranges: list = dataclasses.field(default_factory=list)  # of the profile
    kernel_s: float = 0.0    # device time of every kernel of the profile
    unattributed_s: float = 0.0
    counters: dict = dataclasses.field(default_factory=dict)  # profile's
    idle_s: dict = dataclasses.field(default_factory=dict)  # by range
    span_us: tuple = (0.0, 0.0)   # the profile's host events, first to last


class _WindowSink:
    def __init__(self, sp, spans):
        self.sp, self.spans = sp, spans

    def append(self, span):
        if self.sp.recording:
            self.spans.append(span)


def install(sp) -> None:
    if "program" in sp.records:
        return
    try:
        from homerhevc_tpu_torch.utils.profiler import PROFILER
    except ImportError:
        return
    if not hasattr(PROFILER, "enable"):
        return
    from hevcbench import devtrace
    prog = sp.records["program"] = Program([])
    PROFILER.reset()
    # what PROFILER.enable(sink) sets; uninstall puts back the state
    # before, the tracer off
    sp.patch(PROFILER, "sink", _WindowSink(sp, prog.spans))
    sp.patch(PROFILER, "on", True)
    sp.patch(devtrace, "profile", _keeping_ranges(devtrace.profile, prog,
                                                  PROFILER))


def of(t) -> Program | None:
    """The Program record of a traced run, or None."""
    return t.records.get("program")


def frame_traces(t):
    """The FrameTrace of each frame of the window, or None where a frame
    has none (the tracer was off, or the program has none)."""
    trs = [getattr(f.ef, "trace", None) for f in t.window]
    if not trs or any(tr is None for tr in trs):
        return None
    return trs


def mean_stage_ms(t, start: str, end: str):
    """Mean over the window's frames of trace.end - trace.start, in ms."""
    trs = frame_traces(t)
    if trs is None:
        return None
    return sum(getattr(tr, end) - getattr(tr, start) for tr in trs) \
        / len(trs) * 1e3


def _keeping_ranges(profile, prog, tracer):
    @functools.wraps(profile)
    def wrapped(fn):
        import torch.profiler as tp
        kept = []
        base = tp.profile

        class Kept(base):
            def __exit__(self, *exc):
                out = super().__exit__(*exc)
                kept.append(self)
                return out
        before = tracer.counters
        tp.profile = Kept
        try:
            trace = profile(fn)
        finally:
            tp.profile = base
        after = tracer.counters
        prog.counters = {k: v - before.get(k, 0) for k, v in after.items()}
        names = {name for _, name in tracer.stats()}
        _read(prog, kept[0].events(), names)
        prog.idle_s = idle_by_range(trace.kernels, prog.ranges,
                                    prog.span_us)
        log_profile(prog)
        return trace
    return wrapped


def _on_card(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _read(prog, events, names) -> None:
    """The program's ranges among the profiler's events, each with the
    device time of the kernels launched inside it and no inner range. The
    profiler lists a kernel under each host event that carries the
    correlation id of its launch; where several carry one id (a range and
    the op inside it), the id's kernels count once."""
    ranges = {}
    by_id: dict[int, list] = {}
    total = 0.0
    for e in events:
        if _on_card(e):
            if not e.name.startswith(PREFIX):
                total += e.time_range.end - e.time_range.start
            continue
        if e.name in names:
            ranges[id(e)] = Range(e.name, e.time_range.start,
                                  e.time_range.end)
        if e.kernels:
            by_id.setdefault(e.id, []).append(e)
    claimed = 0.0
    for evs in by_id.values():
        us = sum(k.duration for k in evs[0].kernels
                 if not k.name.startswith(PREFIX))
        for e in evs:
            while e is not None and id(e) not in ranges:
                e = e.cpu_parent
            if e is not None:
                ranges[id(e)].device_s += us * 1e-6
                claimed += us
                break
    prog.ranges = sorted(ranges.values(), key=lambda r: r.start_us)
    prog.kernel_s = total * 1e-6
    prog.unattributed_s = (total - claimed) * 1e-6
    host = [e.time_range for e in events if not _on_card(e)]
    prog.span_us = (min(t.start for t in host), max(t.end for t in host))


def idle_by_range(kernels, ranges, span_us) -> dict:
    """Seconds of the profiled span (host events' first start to last
    end) in which no kernel ran, each gap by the innermost program range
    open across its middle, "none" where none is."""
    t0, t1 = span_us
    out: dict[str, float] = {}
    end = t0
    ks = sorted((k.start_us, k.end_us) for k in kernels)
    for a, b in ks + [(t1, t1)]:
        if a > end:
            mid = 0.5 * (a + end)
            open_ = [(r.end_us - r.start_us, r.name) for r in ranges
                     if r.start_us <= mid <= r.end_us]
            label = min(open_)[1] if open_ else "none"
            out[label] = out.get(label, 0.0) + (a - end) * 1e-6
        end = max(end, b)
    return out


def log_profile(prog) -> None:
    attributed = prog.kernel_s - prog.unattributed_s
    share = 100.0 * attributed / prog.kernel_s if prog.kernel_s else 0.0
    by: dict[str, float] = {}
    for r in prog.ranges:
        by[r.name] = by.get(r.name, 0.0) + r.device_s
    print(f"[progtrace] kernels in program ranges: {attributed:.6f} of "
          f"{prog.kernel_s:.6f} s ({share:.2f} %); by range "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(
              by.items(), key=lambda kv: -kv[1])),
          file=sys.stderr, flush=True)
    print("[progtrace] idle by the main thread's innermost program range: "
          + ", ".join(f"{k} {v:.6f} s" for k, v in sorted(
              prog.idle_s.items(), key=lambda kv: -kv[1])),
          file=sys.stderr, flush=True)
