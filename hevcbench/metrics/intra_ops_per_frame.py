"""Aten operations the main thread issues inside the I-frame layer over
the op-count frames, per I frame emitted over them (on the card most that
are not views launch one kernel)."""

from hevcbench.metrics.intra_ms import SPANS  # noqa: F401  (the same layer)


def read(t):
    n = t.ops_frames.get("I", 0)
    if not n or not t.ops.get("intra"):
        return None
    return t.ops["intra"] / n
