"""Share of the P/B-frame programs' dispatches that replayed their CUDA
graphs in the profiled sub-window: 100 x `inter.graph_replays` over the
dispatches of every path (`inter.eager` + `inter.graph_captures` +
`inter.graph_replays`), the program's counters over the same sub-window
(progtrace.py). A program without these counters reads nothing."""

from hevcbench import progtrace

PATHS = ("inter.eager", "inter.graph_captures", "inter.graph_replays")


def install(sp):
    progtrace.install(sp)


def read(t):
    prog = progtrace.of(t)
    if prog is None:
        return None
    n = sum(prog.counters.get(k, 0) for k in PATHS)
    if not n:
        return None
    return 100.0 * prog.counters.get("inter.graph_replays", 0) / n
