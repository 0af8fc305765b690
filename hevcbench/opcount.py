"""Aten operations by layer.

Frozen copy of `OpCounter` in homerhevc_tpu_torch/tools/p_frame_ops.py
(lines 36-49): a TorchDispatchMode that counts every aten operation under
its current `stage`, all of them and those that are not views. On a CUDA
device most operations that are not views launch one kernel, so the count
stands for the launches a layer issues. A dispatch mode sees the thread
that entered it; here the stage follows the benchmark's spans on that
thread (spans.Spans.on_layer).
"""

from __future__ import annotations

from collections import Counter

from torch.utils._python_dispatch import TorchDispatchMode


class OpCounter(TorchDispatchMode):
    """Counts aten operations under `stage` (all, and those not views)."""

    def __init__(self):
        super().__init__()
        self.stage = "other"
        self.ops = Counter()
        self.compute = Counter()

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops[self.stage] += 1
        if not func.is_view:
            self.compute[self.stage] += 1
        return func(*args, **(kwargs or {}))
