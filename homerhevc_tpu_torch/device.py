"""Device resolution, numeric pins, kernel launch counters and the CUDA
graph of a frame program.

The port's entry points run on the card unless the caller asks for the
CPU: there is no "cuda if present, else cpu" fallback, and asking for
"cuda" without a card raises. Importing this module pins TF32 off for
both cuBLAS matmuls and cuDNN: the intra predictor's float32 contraction
(ops/intra.py predict_all_modes) is exact only in full fp32.
"""

from __future__ import annotations

import gc
import threading

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# launches of each hand-written kernel; a wrapper adds one where it
# launches its kernel and nowhere else (the plain CPU version never counts)
# (the sweep's 8-bit and wide-source entry points count apart); the slot
# threads of a mesh (parallel/mesh.py) launch at once, so every change
# goes through count_launch / reset_launches under one lock
LAUNCHES: dict[str, int] = {"coarse_sweep_sads": 0,
                            "coarse_sweep_sads_wide": 0}
_LAUNCHES_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """Add one to LAUNCHES[name] (a read-modify-write: under the lock)."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def resolve_device(device) -> torch.device:
    """Explicit torch.device from a device or its name ("cpu", "cuda",
    "cuda:1"). A bare "cuda" resolves to the current CUDA device."""
    if device is None:
        raise ValueError("name the device explicitly (e.g. 'cuda' or 'cpu')")
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but CUDA is unavailable")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}")
    return d


class FrameGraph:
    """One CUDA graph of a frame program, captured over static copies of
    its inputs (the intra program's packed batch, frame QPs and QP maps
    where given; a part of an inter program, engine/inter_encoder).
    replay() copies a batch's inputs in, replays the graph and returns
    copies of its outputs, enqueued on the same stream: every replay
    writes the graph's own buffers, and a batch's outputs are read after
    the next batch is dispatched (the pipeline's background fetch,
    reconstructions kept as DevicePlanes).

    `shared`, an earlier graph of the same encoder, lends this one its
    memory pool and capture stream: replays run one at a time on the
    card's current stream and their outputs are copied at once, so one
    graph's scratch may hold another's outputs.

    The garbage collector is held off while the graph captures: a dead
    reference cycle that holds another graph (a dropped encoder's), were
    it collected then, would free that graph with calls a capture
    refuses, and the capture would fail."""

    def __init__(self, program, inputs, shared=None):
        self.device = inputs[0].device
        self.inputs = [torch.empty_like(t) for t in inputs]
        self.graph = torch.cuda.CUDAGraph()
        self.stream = (shared.stream if shared
                       else torch.cuda.Stream(self.device))
        # on the inputs' card, whichever card is current (ops on its
        # tensors go to its own current stream: captured there, or the
        # graph is empty); thread_local: only this thread's calls are
        # checked while it captures (the pipeline's fetch thread copies)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(
                    self.graph, pool=shared.graph.pool() if shared else None,
                    stream=self.stream, capture_error_mode="thread_local"):
                self.outputs = program(*self.inputs)
        finally:
            if collecting:
                gc.enable()

    def replay(self, *inputs):
        with torch.cuda.device(self.device):
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src)
            self.graph.replay()
            return tuple(t.clone() for t in self.outputs)
