"""Device time of the I-frame programs: the kernels the profiler ties to
launches inside the program's `intra.dispatch` ranges in the profiled
sub-window, per frame those dispatches launched (the program's
`intra.frames` counter over the same sub-window; progtrace.py)."""

from hevcbench import progtrace


def install(sp):
    progtrace.install(sp)


def read(t):
    prog = progtrace.of(t)
    if prog is None or t.trace is None:
        return None
    n = prog.counters.get("intra.frames", 0)
    if not n:
        return None
    s = sum(r.device_s for r in prog.ranges if r.name == "intra.dispatch")
    return s / n * 1e3
