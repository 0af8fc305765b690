"""Aten operations the main thread issues inside the P-frame layer over
the op-count frames, per P frame emitted over them."""

from hevcbench.metrics.inter_ms import SPANS  # noqa: F401  (the same layer)


def read(t):
    n = t.ops_frames.get("P", 0)
    if not n or not t.ops.get("inter"):
        return None
    return t.ops["inter"] / n
