# Frozen copy of homerhevc_tpu_torch/hevc/interp.py, lines 1-143, for the
# benchmark's plain reference decoder: later changes to the program
# do not move it. Imports point at the other copies beside it.
"""Host (numpy) motion-compensation interpolation (spec 8.5.4.2): the port's
copy of homerhevc_tpu/golden/interp.py for its host inter programs
(hevc/inter_frame.py). The device P programs keep their batched torch
twins in ops/interp.py.

8-tap luma and 4-tap chroma fractional-sample filters with edge clamping
(reference picture padding semantics). Parity with reference:
hmr_motion_inter.c interpolation (coeffs :240-258, filters :316/:381).
"""

from __future__ import annotations

import numpy as np

# luma 8-tap (quarter-pel) — spec Table 8-10
LUMA_FILT = {
    0: (0, 0, 0, 64, 0, 0, 0, 0),
    1: (-1, 4, -10, 58, 17, -5, 1, 0),
    2: (-1, 4, -11, 40, 40, -11, 4, -1),
    3: (0, 1, -5, 17, 58, -10, 4, -1),
}
# chroma 4-tap (eighth-pel) — spec Table 8-32
CHROMA_FILT = {
    0: (0, 64, 0, 0),
    1: (-2, 58, 10, -2),
    2: (-4, 54, 16, -2),
    3: (-6, 46, 28, -4),
    4: (-4, 36, 36, -4),
    5: (-4, 28, 46, -6),
    6: (-2, 16, 54, -4),
    7: (-2, 10, 58, -2),
}


def _fetch(ref: np.ndarray, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """Fetch a w x h patch at (x0, y0) with edge clamping."""
    H, W = ref.shape
    ys = np.clip(np.arange(y0, y0 + h), 0, H - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, W - 1)
    return ref[np.ix_(ys, xs)].astype(np.int32)


def mc_luma(ref: np.ndarray, x0: int, y0: int, n: int, mv_x: int, mv_y: int,
            bit_depth: int = 8) -> np.ndarray:
    """Motion-compensated n x n luma block; MV in quarter-pel units."""
    ix, iy = mv_x >> 2, mv_y >> 2
    fx, fy = mv_x & 3, mv_y & 3
    if fx == 0 and fy == 0:
        return _fetch(ref, x0 + ix, y0 + iy, n, n)
    shift1 = bit_depth - 8
    # fetch with 3 left/top, 4 right/bottom margin
    patch = _fetch(ref, x0 + ix - 3, y0 + iy - 3, n + 7, n + 7).astype(np.int64)
    if fx:
        f = np.array(LUMA_FILT[fx], np.int64)
        h = sum(f[k] * patch[:, k:k + n] for k in range(8)) >> shift1
    else:
        h = (patch[:, 3:3 + n] * 64) >> shift1
    if fy:
        f = np.array(LUMA_FILT[fy], np.int64)
        v = sum(f[k] * h[k:k + n, :] for k in range(8)) >> 6
    else:
        v = h[3:3 + n, :]
    # weighted-sample rounding to pixel domain
    out = np.clip((v + 32) >> 6, 0, (1 << bit_depth) - 1)
    return out.astype(np.int32)


def mc_luma_14(ref: np.ndarray, x0: int, y0: int, n: int, mv_x: int,
               mv_y: int) -> np.ndarray:
    """14-bit intermediate luma MC (spec 8.5.4.2.2.1 predSamplesLX, 8-bit
    video): the un-rounded filter output used by bi-prediction. Full-pel
    positions return ref << 6."""
    ix, iy = mv_x >> 2, mv_y >> 2
    fx, fy = mv_x & 3, mv_y & 3
    if fx == 0 and fy == 0:
        return _fetch(ref, x0 + ix, y0 + iy, n, n).astype(np.int64) << 6
    patch = _fetch(ref, x0 + ix - 3, y0 + iy - 3, n + 7, n + 7) \
        .astype(np.int64)
    if fx:
        f = np.array(LUMA_FILT[fx], np.int64)
        h = sum(f[k] * patch[:, k:k + n] for k in range(8))
    else:
        h = patch[:, 3:3 + n] * 64
    if fy:
        f = np.array(LUMA_FILT[fy], np.int64)
        v = sum(f[k] * h[k:k + n, :] for k in range(8)) >> 6
    else:
        v = h[3:3 + n, :]
    return v


def mc_chroma_14(ref: np.ndarray, x0: int, y0: int, n: int, mv_x: int,
                 mv_y: int) -> np.ndarray:
    """14-bit intermediate chroma MC (bi-prediction input); MV in
    EIGHTH-pel chroma units."""
    ix, iy = mv_x >> 3, mv_y >> 3
    fx, fy = mv_x & 7, mv_y & 7
    if fx == 0 and fy == 0:
        return _fetch(ref, x0 + ix, y0 + iy, n, n).astype(np.int64) << 6
    patch = _fetch(ref, x0 + ix - 1, y0 + iy - 1, n + 3, n + 3) \
        .astype(np.int64)
    if fx:
        f = np.array(CHROMA_FILT[fx], np.int64)
        h = sum(f[k] * patch[:, k:k + n] for k in range(4))
    else:
        h = patch[:, 1:1 + n] * 64
    if fy:
        f = np.array(CHROMA_FILT[fy], np.int64)
        v = sum(f[k] * h[k:k + n, :] for k in range(4)) >> 6
    else:
        v = h[1:1 + n, :]
    return v


def bi_average(v0: np.ndarray, v1: np.ndarray,
               bit_depth: int = 8) -> np.ndarray:
    """Default bi-predictive weighted sample combination (8.5.4.2.3.2):
    Clip(((pred14_L0 + pred14_L1 + 64) >> 7))."""
    return np.clip((v0 + v1 + 64) >> 7, 0, (1 << bit_depth) - 1) \
        .astype(np.int32)


def mc_chroma(ref: np.ndarray, x0: int, y0: int, n: int, mv_x: int, mv_y: int,
              bit_depth: int = 8) -> np.ndarray:
    """n x n chroma block; MV in EIGHTH-pel chroma units (= luma qpel value)."""
    ix, iy = mv_x >> 3, mv_y >> 3
    fx, fy = mv_x & 7, mv_y & 7
    if fx == 0 and fy == 0:
        return _fetch(ref, x0 + ix, y0 + iy, n, n)
    shift1 = bit_depth - 8
    patch = _fetch(ref, x0 + ix - 1, y0 + iy - 1, n + 3, n + 3).astype(np.int64)
    if fx:
        f = np.array(CHROMA_FILT[fx], np.int64)
        h = sum(f[k] * patch[:, k:k + n] for k in range(4)) >> shift1
    else:
        h = patch[:, 1:1 + n] * 64 >> shift1
    if fy:
        f = np.array(CHROMA_FILT[fy], np.int64)
        v = sum(f[k] * h[k:k + n, :] for k in range(4)) >> 6
    else:
        v = h[1:1 + n, :]
    out = np.clip((v + 32) >> 6, 0, (1 << bit_depth) - 1)
    return out.astype(np.int32)
