# Frozen copy of homerhevc_tpu_torch/hevc/transform.py, lines 1-60, for the
# benchmark's plain reference decoder: later changes to the program
# do not move it. Imports point at the other copies beside it.
"""Host (numpy) integer transforms: HEVC DCT 4/8/16/32 + DST 4x4, the
port's copy of homerhevc_tpu/golden/transform.py for its host intra
programs (hevc/intra_frame.py, hevc/intra_tree.py); the device tier keeps
ops/transform.py.

Bit-exact integer semantics per spec 8.6.4 (inverse is normative; forward is
the HM pairing used by every encoder). Parity with reference:
hmr_transform.c (forward :172/:221/:293/:391, inverse :196/:258/:343/:451,
dispatchers :514/:553) — matrix formulation instead of partial butterflies.
"""

from __future__ import annotations

import numpy as np

from hevcbench.reference.tables import DCT, DST4


def _fwd_pass(mat: np.ndarray, src: np.ndarray, shift: int) -> np.ndarray:
    """dst = (mat @ src + round) >> shift, int64 intermediate."""
    add = 1 << (shift - 1)
    return (mat.astype(np.int64) @ src.astype(np.int64) + add) >> shift


def _inv_pass(mat: np.ndarray, src: np.ndarray, shift: int) -> np.ndarray:
    add = 1 << (shift - 1)
    out = (mat.T.astype(np.int64) @ src.astype(np.int64) + add) >> shift
    return np.clip(out, -32768, 32767)


def forward_transform(residual: np.ndarray, is_intra_luma_4x4: bool = False,
                      bit_depth: int = 8) -> np.ndarray:
    """NxN residual (int) -> NxN coefficients (int32).

    Two 1-D passes: columns then rows, shifts log2N-1+(bd-8) and log2N+6.
    """
    n = residual.shape[0]
    log2n = n.bit_length() - 1
    mat = DST4 if (is_intra_luma_4x4 and n == 4) else DCT[n]
    shift1 = log2n - 1 + bit_depth - 8
    shift2 = log2n + 6
    # pass 1 transforms columns (operate on X), pass 2 transforms rows
    tmp = _fwd_pass(mat, residual.astype(np.int64).T, shift1)  # (N freq, N cols)^T layout
    coef = _fwd_pass(mat, tmp.T, shift2)
    return coef.astype(np.int32)


def inverse_transform(coef: np.ndarray, is_intra_luma_4x4: bool = False,
                      bit_depth: int = 8) -> np.ndarray:
    """NxN coefficients -> NxN residual, exactly as a conformant decoder
    (spec 8.6.4.2: stage shifts 7 and 20-bd, 16-bit clamp between stages)."""
    n = coef.shape[0]
    mat = DST4 if (is_intra_luma_4x4 and n == 4) else DCT[n]
    shift1 = 7
    shift2 = 20 - bit_depth
    # spec staging: vertical (columns) first, then horizontal (rows); the
    # inter-stage rounding+clip makes the order observable.
    tmp = _inv_pass(mat, coef, shift1)          # T^T @ C
    res = _inv_pass(mat, tmp.T, shift2).T       # tmp @ T
    return res.astype(np.int32)
