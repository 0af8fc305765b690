"""Picture quality against the source.

Frozen copy of `psnr` in homerhevc_tpu_torch/utils/metrics.py (lines
10-15), taken from the MSE so that the check reads the same number, with
the per-frame cap of 100 dB that its PsnrTracker applies (line 29), so a
frame coded without loss does not read infinite.
"""

from __future__ import annotations

import numpy as np

PSNR_CAP_DB = 100.0


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))


def capped_psnr_of_mse(m: float, max_val: int = 255) -> float:
    if m == 0:
        return PSNR_CAP_DB
    return min(10.0 * np.log10(max_val * max_val / m), PSNR_CAP_DB)
