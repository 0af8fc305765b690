"""A frame's wait for its emission, from its result on the host to the
return of TorchPipeline._emit (the frames of its batch before it first,
then its own SAO and CABAC).

The mean over the window's frames of FrameTrace.emit - FrameTrace.fetched,
in ms; the four frame_* metrics sum to the mean of emit - push
(progtrace.py)."""

from hevcbench import progtrace


def install(sp):
    progtrace.install(sp)


def read(t):
    return progtrace.mean_stage_ms(t, "fetched", "emit")
