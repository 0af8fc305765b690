"""Device-to-host bytes a frame costs on the wire, in kB (1000 bytes):
the mean over the window's frames of the program's FrameTrace.d2h_bytes
(its share of its batch's meta buffer plus its own full-plane fallback
where the wire overflowed; progtrace.py)."""

from hevcbench import progtrace


def install(sp):
    progtrace.install(sp)


def read(t):
    trs = progtrace.frame_traces(t)
    if trs is None:
        return None
    return sum(tr.d2h_bytes for tr in trs) / len(trs) / 1e3
