"""Share of the CU16 I-frame program's dispatches that replayed its CUDA
graph in the profiled sub-window: 100 x `intra.graph_replays` over the
dispatches of every path (`intra.eager` + `intra.graph_captures` +
`intra.graph_replays`), the program's counters over the same sub-window
(progtrace.py). A program without these counters reads nothing."""

from hevcbench import progtrace

PATHS = ("intra.eager", "intra.graph_captures", "intra.graph_replays")


def install(sp):
    progtrace.install(sp)


def read(t):
    prog = progtrace.of(t)
    if prog is None:
        return None
    n = sum(prog.counters.get(k, 0) for k in PATHS)
    if not n:
        return None
    return 100.0 * prog.counters.get("intra.graph_replays", 0) / n
