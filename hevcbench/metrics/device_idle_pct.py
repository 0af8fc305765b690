"""Share of the profiled sub-window (whole frames after the window) in
which no kernel ran on the card, in %: 100 x (wall - busy) / wall, busy
being the union of the kernels' intervals."""


def read(t):
    if t.trace is None or t.trace.wall_s <= 0:
        return None
    return 100.0 * (t.trace.wall_s - t.trace.busy_s) / t.trace.wall_s
