"""A frame's wait after its launch, from the launch of its program to the
start of its result's fetch (a batch stays parked until the next batch
is dispatched).

The mean over the window's frames of FrameTrace.fetch - FrameTrace.dispatch,
in ms; the four frame_* metrics sum to the mean of emit - push
(progtrace.py)."""

from hevcbench import progtrace


def install(sp):
    progtrace.install(sp)


def read(t):
    return progtrace.mean_stage_ms(t, "dispatch", "fetch")
