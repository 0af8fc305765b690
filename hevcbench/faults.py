"""Faults planted under the timed path, and the lower-precision control.

Never used by a benchmark run: the tests under tests/ and control.py
plant one, drive a run, and expect `correct` to come out false. Each is
planted where the program produces its answer (TorchPipeline._emit, the
frame it hands the caller) or, for the control, in the arithmetic the
program runs.

- `stale`: every frame after the first carries the previous frame's
  stream and reconstruction: a step that returns its state unchanged.
- `half`: the second half of each batch (every other frame where frames
  are not batched) carries the first half's output: half the batch left
  out.
- `altered`: one bit of each slice NAL's payload flipped: a token altered
  where it is produced.
- `bf16`: the control. The port's float32 matrix products (the CU16 intra
  predictor's 35-mode contraction) computed in bfloat16, the precision
  below float32 that a later change would be tempted by.
- `tf32`: TF32 allowed for those products (the port pins it off): the
  precision the rule names first below float32 with TF32 off.
"""

from __future__ import annotations

import contextlib

FAULTS = ("stale", "half", "altered", "bf16", "tf32")


@contextlib.contextmanager
def planted(name: str, batch: int = 1):
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    import torch
    if name in ("bf16", "tf32"):
        import homerhevc_tpu_torch.device  # noqa: F401  (pins TF32 off)
        saved = (torch.matmul, torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        if name == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        else:
            orig = torch.matmul

            def matmul(a, b, *args, **kw):
                if a.dtype == torch.float32 and b.dtype == torch.float32:
                    return orig(a.to(torch.bfloat16), b.to(torch.bfloat16),
                                *args, **kw).to(torch.float32)
                return orig(a, b, *args, **kw)
            torch.matmul = matmul
        try:
            yield
        finally:
            (torch.matmul, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
        return
    from homerhevc_tpu_torch.api import EncodedFrame
    from homerhevc_tpu_torch.engine.pipeline import TorchPipeline
    orig_emit = TorchPipeline._emit
    seen: dict[int, EncodedFrame] = {}

    def emit(pipe, *a, **k):
        ef = orig_emit(pipe, *a, **k)
        seen[ef.poc] = ef
        if name == "altered":
            nals = list(ef.nals)
            s = bytearray(nals[-1])
            s[len(s) // 2] ^= 0x10
            nals[-1] = bytes(s)
            return EncodedFrame(ef.poc, ef.frame_type, nals, ef._recon,
                                ef.avg_qp)
        if name == "stale":
            src = seen.get(ef.poc - 1)
        else:
            half = max(1, batch // 2)
            src = (seen.get(ef.poc - half)
                   if ef.poc % (2 * half) >= half else None)
        if src is None:
            return ef
        return EncodedFrame(ef.poc, ef.frame_type, src.nals, src._recon,
                            ef.avg_qp)
    TorchPipeline._emit = emit
    try:
        yield
    finally:
        TorchPipeline._emit = orig_emit
