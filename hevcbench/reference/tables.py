# Frozen copy of homerhevc_tpu_torch/hevc/tables.py, lines 1-359, for the
# benchmark's plain reference decoder: later changes to the program
# do not move it. Imports point at the other copies beside it.
"""H.265 normative constant tables and scan-order generation.

All values are ITU-T H.265 spec constants (also present in the reference's
hmr_tables.c / hmr_transform.c / hmr_cabac_tables.h, which derive from the
HM reference software). Scan orders are generated algorithmically from
spec clauses 6.5.3/6.5.4 instead of the reference's iterative zigzag builder
(hmr_tables.c:62).
"""

from __future__ import annotations

import numpy as np
from functools import lru_cache

# --- Quantization (spec 8.6.3; reference hmr_tables.c:221-253) -------------

QUANT_SCALE = np.array([26214, 23302, 20560, 18396, 16384, 14564], np.int64)
INV_QUANT_SCALE = np.array([40, 45, 51, 57, 64, 72], np.int64)
QUANT_SHIFT = 14
QUANT_IQUANT_SHIFT = 20
MAX_TR_DYNAMIC_RANGE = 15
SBH_THRESHOLD = 4  # sign-bit-hiding: min scan distance first..last in a CG

# Default scaling lists (spec Table 7-5/7-6). Used when
# scaling_list_enabled_flag=1 with no explicit lists (the reference default,
# hmr_encoder_lib.c:1584). Flat (all 16) when scaling lists are off.
SCALING_LIST_4x4 = np.full((4, 4), 16, np.int64)

_DEF_INTRA_8x8 = [
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115,
]
_DEF_INTER_8x8 = [
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91,
]
SCALING_LIST_INTRA_8x8 = np.array(_DEF_INTRA_8x8, np.int64).reshape(8, 8)
SCALING_LIST_INTER_8x8 = np.array(_DEF_INTER_8x8, np.int64).reshape(8, 8)


@lru_cache(maxsize=None)
def scaling_list(size: int, is_intra: bool, flat: bool = False) -> np.ndarray:
    """Per-coefficient scaling list for a size x size TU (spec 7.4.5).

    16x16/32x32 lists are the 8x8 list upsampled 2x/4x with DC forced to 16.
    """
    if flat or size == 4:
        return np.full((size, size), 16, np.int64)
    base = SCALING_LIST_INTRA_8x8 if is_intra else SCALING_LIST_INTER_8x8
    if size == 8:
        return base.copy()
    r = size // 8
    m = np.repeat(np.repeat(base, r, axis=0), r, axis=1)
    m[0, 0] = 16
    return m


# --- Chroma QP mapping (spec Table 8-10) ------------------------------------

_CHROMA_QP_TAB = [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]


def chroma_qp(qp_y_plus_offset: int) -> int:
    q = max(0, min(57, qp_y_plus_offset))
    if q < 30:
        return q
    if q > 43:
        return q - 6
    return _CHROMA_QP_TAB[q - 30]


# Lookup-table twins for traced (device-input) QP: indexing these with a
# traced scalar replaces the Python branches above inside jit.
CHROMA_QP_MAP = np.asarray([chroma_qp(q) for q in range(58)], np.int32)


# --- RD lambda (HM-style; reference hmr_tables.c:315-374) -------------------

def rd_lambda(qp: int, slice_type: str = "I") -> float:
    qp_factor = 0.57 if slice_type == "I" else 0.68
    return qp_factor * (2.0 ** ((qp - 12) / 3.0))


def lambda_int(qp: int, slice_type: str = "I") -> int:
    """SSD-domain lambda rounded to int, shared by the golden and device
    intra-tree RDO so their integer cost arithmetic is bit-identical."""
    return int(rd_lambda(qp, slice_type) + 0.5)


def intra_mode_bits(qp: int) -> tuple[int, int]:
    """(mpm, non-mpm) integer mode-cost addends in the SAD domain for the
    intra mode decision (sqrt-lambda scaled, as the wavefront encoder's
    _BITS_MPM/_BITS_REM tables)."""
    import math
    s = math.sqrt(rd_lambda(qp, "I"))
    return int(s * 2), int(s * 6)


def lambda_me_x16(qp: int) -> int:
    """Motion-search lambda in the SAD domain (sqrt of the SSD-domain
    lambda, HM-style), as a x16 fixed-point integer so golden (numpy) and
    device (jax int32) cost arithmetic are bit-identical."""
    import math
    return int(math.sqrt(rd_lambda(qp, "P")) * 16.0 + 0.5)


def _mvd_bits_one(v: int) -> int:
    """Exact CABAC bin count of one mvd component (syntax.py mvd writer:
    greater0 + greater1 + EG1(v-2) + sign)."""
    v = abs(v)
    if v == 0:
        return 1
    if v == 1:
        return 3  # g0=1, g1=0, sign
    u, k, bits = v - 2, 1, 2  # g0, g1
    while u >= (1 << k):
        u -= 1 << k
        k += 1
        bits += 1
    return bits + 1 + k + 1  # prefix stop + suffix + sign


# mvd rate table (quarter-pel units). Indexed by |mvd| clamped to the end.
MVD_BITS = np.asarray([_mvd_bits_one(v) for v in range(2048)], np.int32)

# per-QP lambda tables for traced-QP device programs (index with qp 0..51)
LAMBDA_ME_X16_TAB = np.asarray([lambda_me_x16(q) for q in range(52)],
                               np.int32)
RD_LAMBDA_P_TAB = np.asarray([rd_lambda(q, "P") for q in range(52)],
                             np.float32)
RD_LAMBDA_I_TAB = np.asarray([rd_lambda(q, "I") for q in range(52)],
                             np.float32)


# --- Scan orders (spec 6.5.3 up-right diagonal, 6.5.4 hor/ver) --------------

SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2


def _diag_scan(n: int) -> list[tuple[int, int]]:
    """Up-right diagonal scan of an n x n block, list of (x, y)."""
    out = []
    x = y = 0
    while len(out) < n * n:
        while y >= 0:
            if x < n and y < n:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return out


def _hor_scan(n: int) -> list[tuple[int, int]]:
    return [(x, y) for y in range(n) for x in range(n)]


def _ver_scan(n: int) -> list[tuple[int, int]]:
    return [(x, y) for x in range(n) for y in range(n)]


_SCAN_FNS = {SCAN_DIAG: _diag_scan, SCAN_HOR: _hor_scan, SCAN_VER: _ver_scan}


@lru_cache(maxsize=None)
def coeff_scan(log2_size: int, scan_idx: int) -> np.ndarray:
    """Full coefficient scan for a TU: array of raster positions in scan order.

    Coefficients are grouped in 4x4 coefficient groups (CGs); CGs are scanned
    in `scan_idx` order and coefficients within each CG in the same order
    (matching HM g_scanOrder / spec residual_coding semantics).
    """
    size = 1 << log2_size
    if size == 4:
        pos = _SCAN_FNS[scan_idx](4)
        return np.array([y * 4 + x for x, y in pos], np.int32)
    ncg = size // 4
    cg_pos = _SCAN_FNS[scan_idx](ncg)
    inner = _SCAN_FNS[scan_idx](4)
    out = []
    for cgx, cgy in cg_pos:
        for ix, iy in inner:
            x, y = cgx * 4 + ix, cgy * 4 + iy
            out.append(y * size + x)
    return np.array(out, np.int32)


@lru_cache(maxsize=None)
def cg_scan(log2_size: int, scan_idx: int) -> np.ndarray:
    """Scan order of 4x4 coefficient groups: raster CG indices in scan order."""
    ncg = max(1, (1 << log2_size) // 4)
    pos = _SCAN_FNS[scan_idx](ncg)
    return np.array([y * ncg + x for x, y in pos], np.int32)


def intra_scan_idx(pred_mode: int, log2_size: int, is_luma: bool) -> int:
    """Scan selection for intra TUs (spec 7.4.9.11).

    Mode-dependent scan applies to 4x4/8x8 luma, but for 4:2:0 chroma only
    to 4x4 chroma TUs (log2 == 2).
    """
    if log2_size == 2 or (log2_size == 3 and is_luma):
        if 6 <= pred_mode <= 14:
            return SCAN_VER
        if 22 <= pred_mode <= 30:
            return SCAN_HOR
    return SCAN_DIAG


# --- CABAC engine tables (spec 9.3.4.3, Tables 9-46/9-47) -------------------

# rangeTabLps[pStateIdx][qRangeIdx]
LPS_TABLE = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9],
    [2, 2, 2, 2],
], np.uint32)

# renormTable[lps >> 3] = number of renormalization shifts
RENORM_TABLE = np.array(
    [6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], np.uint32)

# transIdxLps (spec Table 9-47); MPS transition is min(pStateIdx + 1, 62).
TRANS_IDX_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
], np.uint32)


def _build_combined_state_tables():
    """Combined 128-entry state tables over s = (pStateIdx << 1) | valMps."""
    nxt_mps = np.zeros(128, np.uint8)
    nxt_lps = np.zeros(128, np.uint8)
    for s in range(128):
        idx, mps = s >> 1, s & 1
        n_mps = min(idx + 1, 62)
        nxt_mps[s] = (n_mps << 1) | mps
        if idx == 0:  # LPS at state 0 flips MPS
            nxt_lps[s] = (0 << 1) | (1 - mps)
        else:
            nxt_lps[s] = (int(TRANS_IDX_LPS[idx]) << 1) | mps
    return nxt_mps, nxt_lps


NEXT_STATE_MPS, NEXT_STATE_LPS = _build_combined_state_tables()

# Fractional-bit costs (15-bit fixed point) per combined state for a bin equal
# to MPS(entry 2k) / LPS(entry 2k+1) — HM's entropyBits table used by the RDO
# bit counter (reference hmr_binary_encoding.c:280 under FAST_BIT_EST).
ENTROPY_BITS = np.array([
    0x07b23, 0x085f9, 0x074a0, 0x08cbc, 0x06ee4, 0x09354, 0x067f4, 0x09c1b,
    0x060b0, 0x0a62a, 0x05a9c, 0x0af5b, 0x0548d, 0x0b955, 0x04f56, 0x0c2a9,
    0x04a87, 0x0cbf7, 0x045d6, 0x0d5c3, 0x04144, 0x0e01b, 0x03d88, 0x0e937,
    0x039e0, 0x0f2cd, 0x03663, 0x0fc9e, 0x03347, 0x10600, 0x03050, 0x10f95,
    0x02d4d, 0x11a02, 0x02ad3, 0x12333, 0x0286e, 0x12cad, 0x02604, 0x136df,
    0x02425, 0x13f48, 0x021f4, 0x149c4, 0x0203e, 0x1527b, 0x01e4d, 0x15d00,
    0x01c99, 0x166de, 0x01b18, 0x17017, 0x019a5, 0x17988, 0x01841, 0x18327,
    0x016df, 0x18d50, 0x015d9, 0x19547, 0x0147c, 0x1a083, 0x0138e, 0x1a8a3,
    0x01251, 0x1b418, 0x01166, 0x1bd27, 0x01068, 0x1c77b, 0x00f7f, 0x1d18e,
    0x00eda, 0x1d91a, 0x00e19, 0x1e254, 0x00d4f, 0x1ec9a, 0x00c90, 0x1f6e0,
    0x00c01, 0x1fef8, 0x00b5f, 0x208b1, 0x00ab6, 0x21362, 0x00a15, 0x21e46,
    0x00988, 0x2285d, 0x00934, 0x22ea8, 0x008a8, 0x239b2, 0x0081d, 0x24577,
    0x007c9, 0x24ce6, 0x00763, 0x25663, 0x00710, 0x25e8f, 0x006a0, 0x26a26,
    0x00672, 0x26f23, 0x005e8, 0x27ef8, 0x005ba, 0x284b5, 0x0055e, 0x29057,
    0x0050c, 0x29bab, 0x004c1, 0x2a674, 0x004a7, 0x2aa5e, 0x0046f, 0x2b32f,
    0x0041f, 0x2c0ad, 0x003e7, 0x2ca8d, 0x003ba, 0x2d323, 0x0010c, 0x3bfbb,
], np.int64)


# --- Transform matrices (spec 8.6.4; reference hmr_transform.c:54-128) -------

# Canonical H.265 transform coefficients (spec 8.6.4.2). DCT_N[k][j].
DCT4 = np.array([
    [64, 64, 64, 64],
    [83, 36, -36, -83],
    [64, -64, -64, 64],
    [36, -83, 83, -36],
], np.int32)

DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29],
], np.int32)

_DCT32_FIRST_COL = [
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4,
]


def _build_dct32() -> np.ndarray:
    """Build the 32-point HEVC DCT from its cosine structure.

    The spec matrix approximates 64*sqrt(2)*cos((2j+1)*k*pi/64) with values
    drawn from the canonical 31-value set (first column of the matrix); the
    approximation is not plain rounding (e.g. 83 where rounding gives 84), so
    each analytic value is snapped to the *nearest canonical* magnitude —
    which reproduces the spec constants exactly (asserted below against
    independently-known rows).
    """
    canon = np.array(sorted({abs(v) for v in _DCT32_FIRST_COL}), np.float64)
    t = np.zeros((32, 32), np.int32)
    scale = 64.0 * np.sqrt(2.0)
    for k in range(32):
        for j in range(32):
            v = scale * np.cos((2 * j + 1) * k * np.pi / 64)
            if k == 0:
                t[k, j] = 64
                continue
            a = np.abs(v)
            snap = canon[np.argmin(np.abs(canon - a))]
            t[k, j] = int(np.sign(v) * snap) if a > 1e-9 else 0
    return t


DCT32 = _build_dct32()
DCT16 = DCT32[::2, :16].copy()
DCT8 = DCT32[::4, :8].copy()
assert np.array_equal(DCT8[1], np.array([89, 75, 50, 18, -18, -50, -75, -89]))
assert np.array_equal(DCT4, DCT32[::8, :4])

DCT = {4: DCT4, 8: DCT8, 16: DCT16, 32: DCT32}
