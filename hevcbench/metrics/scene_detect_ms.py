"""Host time the main thread spends in the pipeline's scene-change
detector: the self time of the program's `scene.detect` spans on the main
thread in the window, per frame emitted in the window (the program's
tracer, progtrace.py). A program without that span reads nothing."""

from hevcbench import progtrace


def install(sp):
    progtrace.install(sp)


def read(t):
    prog = progtrace.of(t)
    if prog is None or not t.window:
        return None
    spans = [x for x in prog.spans
             if x.role == "main" and x.name == "scene.detect"]
    if not spans:
        return None
    return sum(x.self_s for x in spans) / len(t.window) * 1e3
