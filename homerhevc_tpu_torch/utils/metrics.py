"""Quality metrics — parity with reference hmr_metics.c (homer_psnr :53).

PSNR per plane + running averages, plus a per-frame trace line equivalent to
the reference's DBG_TRACE_RESULTS output (hmr_encoder_lib.c:3337)."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, max_val: int = 255) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_val * max_val / mse)


class PsnrTracker:
    """Running Y/U/V PSNR (reference homer_psnr semantics)."""

    def __init__(self):
        self.n = 0
        self.acc = np.zeros(3)

    def add(self, src_planes, recon_planes) -> tuple:
        vals = tuple(psnr(s, r) for s, r in zip(src_planes, recon_planes))
        self.acc += np.minimum(vals, 100.0)
        self.n += 1
        return vals

    @property
    def average(self) -> tuple:
        if self.n == 0:
            return (0.0, 0.0, 0.0)
        return tuple(self.acc / self.n)


def frame_trace(ef, vbv_fullness: float = 0.0) -> str:
    """Per-frame result line (reference DBG_TRACE_RESULTS format)."""
    return (f"POC:{ef.poc}, {ef.frame_type}, bits:{ef.bits}, "
            f"vbv: {vbv_fullness:.2f}, qp: {ef.avg_qp}")
