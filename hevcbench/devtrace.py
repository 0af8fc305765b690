"""The device trace of a sub-window of whole frames.

The busy arithmetic is a frozen copy of `profile_window` in chip_smoke.py
(lines 2209-2231): torch.profiler with CPU and CUDA activities around work
that ends in `torch.cuda.synchronize()`, the kernels being the events whose
device type is CUDA, the device busy time their device time, against the
wall time of the profiled work. Two changes: busy time is the union of the
kernels' intervals (kernels that overlap on two streams count once), and
the kernels come back with their intervals, so the benchmark can name the
longest idle gaps by the host span open across them (the spans'
record_function ranges share the trace's clock).
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Kernel:
    name: str
    start_us: float
    end_us: float


@dataclasses.dataclass
class DeviceTrace:
    kernels: list[Kernel]
    ranges: list[tuple[str, float, float]]   # (span layer, start, end)
    wall_s: float

    @property
    def busy_s(self) -> float:
        return union_seconds([(k.start_us, k.end_us) for k in self.kernels])


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start_us, end_us) intervals."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total * 1e-6


def profile(fn) -> DeviceTrace:
    """fn() under torch.profiler; the card synchronised before and after."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels, ranges = [], []
    for e in prof.events():
        tr = e.time_range
        on_card = str(getattr(e, "device_type", "")).endswith("CUDA")
        if e.name.startswith("hevcbench."):
            # a span's range; its twin on the card's timeline is no work
            if not on_card:
                ranges.append((e.name[len("hevcbench."):], tr.start,
                               tr.end))
        elif on_card:
            kernels.append(Kernel(e.name, tr.start, tr.end))
    return DeviceTrace(kernels, ranges, wall)


def top_kernels(trace: DeviceTrace, n: int = 10):
    """[[kernel name, seconds]] of the n names with most device time."""
    tot: dict[str, float] = {}
    for k in trace.kernels:
        tot[k.name] = tot.get(k.name, 0.0) + (k.end_us - k.start_us) * 1e-6
    return [[name[:120], s] for name, s in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: DeviceTrace, n: int = 10):
    """[[label, seconds]] of the n longest gaps between kernels, each
    labelled by the innermost benchmark span open across its middle (on
    any thread), "harness" where none is."""
    ks = sorted((k.start_us, k.end_us) for k in trace.kernels)
    gaps, end = [], None
    for a, b in ks:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    gaps.sort(reverse=True)
    out = []
    for dur, a, b in gaps[:n]:
        mid = 0.5 * (a + b)
        open_ = [(b_ - a_, name) for name, a_, b_ in trace.ranges
                 if a_ <= mid <= b_]
        label = min(open_)[1] if open_ else "harness"
        out.append([label, dur * 1e-6])
    return out
