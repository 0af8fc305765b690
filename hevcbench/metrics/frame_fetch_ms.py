"""A frame's fetch, from its start to the result on the host (for a batch,
until the main thread has joined the background fetch).

The mean over the window's frames of FrameTrace.fetched - FrameTrace.fetch,
in ms; the four frame_* metrics sum to the mean of emit - push
(progtrace.py)."""

from hevcbench import progtrace


def install(sp):
    progtrace.install(sp)


def read(t):
    return progtrace.mean_stage_ms(t, "fetch", "fetched")
