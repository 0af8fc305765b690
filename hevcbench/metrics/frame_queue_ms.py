"""A frame's wait in the pipeline's queue, from TorchPipeline.push to the
launch of its program (for a batch, until the batch has filled).

The mean over the window's frames of FrameTrace.dispatch - FrameTrace.push,
in ms; the four frame_* metrics sum to the mean of emit - push
(progtrace.py)."""

from hevcbench import progtrace


def install(sp):
    progtrace.install(sp)


def read(t):
    return progtrace.mean_stage_ms(t, "push", "dispatch")
