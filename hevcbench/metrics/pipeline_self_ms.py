"""Self time of the pipeline layer (api.Encoder -> engine/pipeline:
queueing, the scene-change detector, rate control, host SAO decisions,
emission) per frame of the window: the client's encode spans on the main
thread less the spans of every layer the cell's metrics installed."""

from hevcbench.spans import self_time


def read(t):
    if not t.window:
        return None
    s = self_time(t.spans, "pipeline", set(t.layers) - {"pipeline"})
    return s / len(t.window) * 1e3
