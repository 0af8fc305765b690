"""Host time the main thread spends launching the I-frame programs: the
self time of the program's `intra.dispatch` spans on the main thread in
the window, per I frame emitted in the window (the program's tracer,
progtrace.py)."""

from hevcbench import progtrace


def install(sp):
    progtrace.install(sp)


def read(t):
    prog = progtrace.of(t)
    n = sum(f.ftype == "I" for f in t.window)
    if prog is None or not n:
        return None
    s = sum(x.self_s for x in prog.spans
            if x.role == "main" and x.name == "intra.dispatch")
    return s / n * 1e3
