# Frozen copy of homerhevc_tpu_torch/hevc/intra_pred.py, lines 1-231, for the
# benchmark's plain reference decoder: later changes to the program
# do not move it. Imports point at the other copies beside it.
"""Host (numpy) intra prediction: reference-sample construction and
filtering and all 35 HEVC intra modes (spec 8.4.4.2), with decoder-exact
neighbour availability (spec 6.4.1 z-scan rule). The port's copy of
homerhevc_tpu/golden/intra_pred.py: its device path reads the angle tables
and the availability rule, its host intra programs (hevc/intra_frame.py,
hevc/intra_tree.py) the rest.

Parity with reference: hmr_motion_intra.c (fill_reference_samples :246,
planar :408, DC :442, angular :482) — vectorized numpy from spec formulas.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# intraPredAngle for modes 2..34 (spec Table 8-5)
PRED_ANGLE = np.array([
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32,
], np.int32)

# invAngle for modes 11..25 (spec Table 8-6)
INV_ANGLE = np.array([
    -4096, -1638, -910, -630, -482, -390, -315, -256,
    -315, -390, -482, -630, -910, -1638, -4096,
], np.int32)

# reference-sample filter thresholds per size (HM m_aucIntraFilter)
_FILTER_THRESH = {4: 10, 8: 7, 16: 1, 32: 0}


@lru_cache(maxsize=None)
def _zorder_table(log2_ctu: int, log2_unit: int) -> np.ndarray:
    """z-scan address of each unit within a CTU: table[uy, ux] -> z index."""
    n = 1 << (log2_ctu - log2_unit)
    tab = np.zeros((n, n), np.int32)
    for uy in range(n):
        for ux in range(n):
            z = 0
            for b in range(16):
                z |= ((ux >> b) & 1) << (2 * b)
                z |= ((uy >> b) & 1) << (2 * b + 1)
            tab[uy, ux] = z
    return tab


class Availability:
    """Decoder-exact z-scan availability of a neighbour sample position
    relative to the block being predicted (spec 6.4.1; single slice/tile).

    Unit granularity is the minimum TU (4x4)."""

    def __init__(self, pic_w: int, pic_h: int, ctu_size: int):
        self.w, self.h = pic_w, pic_h
        self.ctu = ctu_size
        self.log2_ctu = ctu_size.bit_length() - 1
        self.z = _zorder_table(self.log2_ctu, 2)

    def available(self, x_cur: int, y_cur: int, x_n: int, y_n: int) -> bool:
        if x_n < 0 or y_n < 0 or x_n >= self.w or y_n >= self.h:
            return False
        ctu_cur = (y_cur // self.ctu) * ((self.w + self.ctu - 1) // self.ctu) \
            + (x_cur // self.ctu)
        ctu_n = (y_n // self.ctu) * ((self.w + self.ctu - 1) // self.ctu) \
            + (x_n // self.ctu)
        if ctu_n < ctu_cur:
            return True
        if ctu_n > ctu_cur:
            return False
        zc = self.z[(y_cur % self.ctu) // 4, (x_cur % self.ctu) // 4]
        zn = self.z[(y_n % self.ctu) // 4, (x_n % self.ctu) // 4]
        return zn < zc


def build_reference_samples(recon: np.ndarray, x0: int, y0: int, size: int,
                            avail: Availability, comp_shift: int = 0,
                            bit_depth: int = 8):
    """Construct (top[2n+1], left[2n+1]) reference arrays with substitution
    (spec 8.4.4.2.2). `recon` is the component plane (luma or chroma);
    x0/y0/size in component coordinates. `avail` works in LUMA coordinates:
    comp_shift=1 for 4:2:0 chroma.

    Layout: top[0]=left[0]=corner p[-1][-1]; top[1+i]=p[i][-1];
    left[1+j]=p[-1][j], i,j in 0..2n-1.
    """
    h, w = recon.shape
    n2 = 2 * size
    cs = comp_shift
    xl, yl = x0 << cs, y0 << cs  # luma coords for availability

    # availability per 4-sample segment (min TU is 4 even for chroma in 4:2:0
    # since the luma granularity 4 maps to chroma 2; use per-sample-group of
    # the *luma* min unit: step of 4 luma samples = 4>>cs component samples)
    seg = max(1, 4 >> cs)

    vals = np.full(2 * n2 + 1, -1, np.int64)  # [left bottom..top, corner, top row]
    # left column, bottom to top: component y from y0+2n-1 down to y0
    for j in range(n2 - 1, -1, -1):
        yy = y0 + j
        ok = yy < h and avail.available(xl, yl, (x0 - 1) << cs, (y0 + j) << cs)
        vals[n2 - 1 - j] = recon[yy, x0 - 1] if ok else -1
    # corner
    ok = avail.available(xl, yl, (x0 - 1) << cs, (y0 - 1) << cs)
    vals[n2] = recon[y0 - 1, x0 - 1] if ok else -1
    # top row, left to right
    for i in range(n2):
        xx = x0 + i
        ok = xx < w and avail.available(xl, yl, (x0 + i) << cs, (y0 - 1) << cs)
        vals[n2 + 1 + i] = recon[y0 - 1, xx] if ok else -1

    if np.all(vals < 0):
        fill = 1 << (bit_depth - 1)
        t = np.full(n2 + 1, fill, np.int32)
        l = np.full(n2 + 1, fill, np.int32)
        return t, l
    # substitution: propagate from index 0 upward; if index 0 missing, take
    # the first available in scan order
    if vals[0] < 0:
        vals[0] = vals[np.argmax(vals >= 0)]
    for i in range(1, vals.size):
        if vals[i] < 0:
            vals[i] = vals[i - 1]
    left = vals[:n2][::-1]
    corner = vals[n2]
    top_row = vals[n2 + 1:]
    t = np.concatenate([[corner], top_row]).astype(np.int32)
    l = np.concatenate([[corner], left]).astype(np.int32)
    return t, l


def filter_reference_samples(top: np.ndarray, left: np.ndarray, size: int,
                             mode: int, is_luma: bool,
                             strong_smoothing: bool = False,
                             bit_depth: int = 8):
    """[1 2 1] smoothing (spec 8.4.4.2.3). Planar uses the same distance rule
    as angular modes (dist 10), DC and chroma are never filtered."""
    if not is_luma or mode == 1 or size not in _FILTER_THRESH:
        return top, left
    dist = min(abs(mode - 26), abs(mode - 10)) if mode != 0 else 10
    if dist <= _FILTER_THRESH[size]:
        return top, left
    n2 = 2 * size
    ft = top.copy()
    fl = left.copy()
    ft[0] = (left[1] + 2 * top[0] + top[1] + 2) >> 2
    fl[0] = ft[0]
    ft[1:n2] = (top[:n2 - 1] + 2 * top[1:n2] + top[2:n2 + 1] + 2) >> 2
    fl[1:n2] = (left[:n2 - 1] + 2 * left[1:n2] + left[2:n2 + 1] + 2) >> 2
    ft[n2] = top[n2]
    fl[n2] = left[n2]
    return ft, fl


def predict_planar(top: np.ndarray, left: np.ndarray, size: int) -> np.ndarray:
    """spec 8.4.4.2.4."""
    n = size
    log2n = n.bit_length() - 1
    x = np.arange(n)
    y = np.arange(n)[:, None]
    t = top[1:n + 1].astype(np.int64)       # p[x][-1]
    l = left[1:n + 1].astype(np.int64)[:, None]  # p[-1][y]
    tr = int(top[n + 1])                    # p[N][-1]
    bl = int(left[n + 1])                   # p[-1][N]
    pred = ((n - 1 - x) * l + (x + 1) * tr + (n - 1 - y) * t[None, :]
            + (y + 1) * bl + n) >> (log2n + 1)
    return pred.astype(np.int32)


def predict_dc(top: np.ndarray, left: np.ndarray, size: int,
               is_luma: bool) -> np.ndarray:
    n = size
    log2n = n.bit_length() - 1
    t = top[1:n + 1].astype(np.int64)
    l = left[1:n + 1].astype(np.int64)
    dc = int((t.sum() + l.sum() + n) >> (log2n + 1))
    pred = np.full((n, n), dc, np.int64)
    if is_luma and n < 32:
        pred[0, 0] = (l[0] + 2 * dc + t[0] + 2) >> 2
        pred[0, 1:] = (t[1:] + 3 * dc + 2) >> 2
        pred[1:, 0] = (l[1:] + 3 * dc + 2) >> 2
    return pred.astype(np.int32)


def predict_angular(top: np.ndarray, left: np.ndarray, size: int, mode: int,
                    is_luma: bool, bit_depth: int = 8) -> np.ndarray:
    """spec 8.4.4.2.6 for modes 2..34."""
    n = size
    angle = int(PRED_ANGLE[mode - 2])
    vertical = mode >= 18
    main = (top if vertical else left).astype(np.int64)
    side = (left if vertical else top).astype(np.int64)
    ref = np.zeros(3 * n + 1, np.int64)
    if angle < 0:
        ref[n:n + n + 1] = main[:n + 1]
        inv = int(INV_ANGLE[mode - 11])
        lim = (n * angle) >> 5
        if lim < -1:  # spec: extend only when (nTbS*angle)>>5 < -1
            for xx in range(-1, lim - 1, -1):
                ref[n + xx] = side[(xx * inv + 128) >> 8]
    else:
        ref[n:n + 2 * n + 1] = main[:2 * n + 1]
    pos = np.arange(1, n + 1) * angle
    i_idx = pos >> 5
    frac = pos & 31
    cols = np.arange(n)
    base = n + 1 + i_idx[:, None] + cols[None, :]
    a = ref[base]
    b = ref[np.minimum(base + 1, ref.size - 1)]
    pr = ((32 - frac[:, None]) * a + frac[:, None] * b + 16) >> 5
    if not vertical:
        pr = pr.T.copy()
    maxv = (1 << bit_depth) - 1
    if is_luma and n < 32:
        if mode == 26:
            delta = (left[1:n + 1].astype(np.int64) - int(top[0])) >> 1
            pr[:, 0] = np.clip(int(top[1]) + delta, 0, maxv)
        elif mode == 10:
            delta = (top[1:n + 1].astype(np.int64) - int(top[0])) >> 1
            pr[0, :] = np.clip(int(left[1]) + delta, 0, maxv)
    return pr.astype(np.int32)


def predict(top: np.ndarray, left: np.ndarray, size: int, mode: int,
            is_luma: bool, bit_depth: int = 8) -> np.ndarray:
    if mode == 0:
        return predict_planar(top, left, size)
    if mode == 1:
        return predict_dc(top, left, size, is_luma)
    return predict_angular(top, left, size, mode, is_luma, bit_depth)
