# Frozen copy of the data model and context rules of
# homerhevc_tpu_torch/hevc/syntax.py (lines 1-177 without
# derive_chroma_syntax_mode, and SliceDataEncoder._sig_ctx, lines 826-851), for the benchmark's
# plain reference decoder: later changes to the program do not move it.
# The encoder itself is not copied.
"""The slice data's model and context rules that the parser shares.

FrameDesc holds what a slice codes as flat maps at their natural
resolution, which the parser fills and the decoder walks; mpm_candidates
(8.4.2) and sig_ctx (9.3.4.2.5) are the derivations the parser needs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from hevcbench.reference import tables as T

INTRA_PLANAR, INTRA_DC = 0, 1
MODE_INTER, MODE_INTRA = 0, 1

# sig_coeff_flag context map for 4x4 TUs (spec 9.3.4.2.5)
CTX_IND_MAP_4x4 = np.array([
    0, 1, 4, 5,
    2, 3, 4, 5,
    6, 6, 8, 8,
    7, 7, 8, 8,
], np.int32)


@dataclasses.dataclass
class FrameDesc:
    """Frame coding description produced by the analysis stage.

    Maps are indexed [y, x] at the stated granularity:
      cu_depth     (H/8, W/8)  uint8 — quadtree depth of the CU covering the unit
      pred_mode    (H/8, W/8)  uint8 — MODE_INTRA / MODE_INTER
      part_nxn     (H/8, W/8)  bool  — intra 8x8 CU uses NxN partitioning
      luma_mode    (H/4, W/4)  uint8 — intra luma mode per 4x4
      chroma_mode  (H/8, W/8)  uint8 — intra chroma mode (actual, 0..34)
      tr_depth     (H/8, W/8)  uint8 — TU split depth relative to the CU
      coef_y       (H, W)      int16 — quantized coefficients at pixel position
      coef_u/v     (H/2, W/2)  int16
      qp_map       (H/8, W/8)  int8  — per-CU QP (for cu_qp_delta; optional)
    """
    width: int
    height: int
    cu_depth: np.ndarray
    pred_mode: np.ndarray
    part_nxn: np.ndarray
    luma_mode: np.ndarray
    chroma_mode: np.ndarray
    tr_depth: np.ndarray
    coef_y: np.ndarray
    coef_u: np.ndarray
    coef_v: np.ndarray
    qp_map: Optional[np.ndarray] = None
    # inter fields (valid where pred_mode == MODE_INTER)
    skip: Optional[np.ndarray] = None        # (h8,w8) u8: coded cu_skip_flag
    inter_mode: Optional[np.ndarray] = None  # 0=skip, 1=merge, 2=amvp
    merge_idx: Optional[np.ndarray] = None
    mvp_flag: Optional[np.ndarray] = None
    mv: Optional[np.ndarray] = None          # (h8,w8,2) quarter-pel (L0)
    root_cbf: Optional[np.ndarray] = None
    # multi-reference L0: per-unit ref_idx (0..N-1); None = all ref 0
    ref_idx: Optional[np.ndarray] = None
    # B slices: list-1 motion + mvp flag
    mv_l1: Optional[np.ndarray] = None       # (h8,w8,2) quarter-pel (L1)
    mvp_flag_l1: Optional[np.ndarray] = None
    # per-unit prediction direction bitmask (1=L0, 2=L1, 3=BI); None means
    # all-BI when mv_l1 is present, else all-L0 (backward compatible)
    inter_dir: Optional[np.ndarray] = None
    # inter CU partition per 8x8 unit: 0=2Nx2N, 1=2NxN, 2=Nx2N (uniform
    # within a CU; per-PU motion rides the unit-granular maps). None =
    # all 2Nx2N (backward compatible)
    inter_part: Optional[np.ndarray] = None
    # analysis side-channel: exact per-row luma SSD vs source (int32),
    # computed on device so the host never pulls recon just for the
    # avg_dist zero-forcing feedback
    row_ssd_y: Optional[np.ndarray] = None
    # device-decided SAO params (ops/sao_dev.py): the recon planes are
    # already filtered on device; the host only writes the syntax
    sao_params: Optional[object] = None
    # device CG wire (ops/pack.py pack_sparse_cg): when set, coef_y/u/v
    # may be None — the native serializer codes residuals straight off
    # the wire; python consumers call densify() first. Tuple:
    # (cg_bitmap u8, masks16 i16, codes u8, esc_idx i32, esc_val i16,
    #  count, esc_count, cg_count, shapes [(h,w)]x3)
    cg_wire: Optional[tuple] = None

    def densify(self) -> "FrameDesc":
        """The parser fills dense planes; a wire-only desc has no place here
        (the copy drops the original's native unpacking)."""
        if self.coef_y is None:
            raise ValueError("a FrameDesc without dense coefficient planes")
        return self

    @classmethod
    def alloc(cls, width: int, height: int) -> "FrameDesc":
        h8, w8 = height // 8, width // 8
        return cls(
            width=width, height=height,
            cu_depth=np.zeros((h8, w8), np.uint8),
            pred_mode=np.full((h8, w8), MODE_INTRA, np.uint8),
            part_nxn=np.zeros((h8, w8), bool),
            luma_mode=np.full((height // 4, width // 4), INTRA_DC, np.uint8),
            chroma_mode=np.full((h8, w8), INTRA_DC, np.uint8),
            tr_depth=np.zeros((h8, w8), np.uint8),
            coef_y=np.zeros((height, width), np.int16),
            coef_u=np.zeros((height // 2, width // 2), np.int16),
            coef_v=np.zeros((height // 2, width // 2), np.int16),
            skip=np.zeros((h8, w8), np.uint8),
            inter_mode=np.zeros((h8, w8), np.uint8),
            merge_idx=np.zeros((h8, w8), np.uint8),
            mvp_flag=np.zeros((h8, w8), np.uint8),
            mv=np.zeros((h8, w8, 2), np.int32),
            root_cbf=np.zeros((h8, w8), np.uint8),
        )


def mpm_candidates(left_mode: int, above_mode: int) -> list[int]:
    """spec 8.4.2.2 candModeList derivation. Pass INTRA_DC for unavailable."""
    a, b = left_mode, above_mode
    if a == b:
        if a < 2:
            return [INTRA_PLANAR, INTRA_DC, 26]
        return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
    lst = [a, b]
    if INTRA_PLANAR not in lst:
        lst.append(INTRA_PLANAR)
    elif INTRA_DC not in lst:
        lst.append(INTRA_DC)
    else:
        lst.append(26)
    return lst


def sig_ctx(px: int, py: int, log2_size: int, c_idx: int, scan_idx: int,
            prev_csbf: int) -> int:
    """spec 9.3.4.2.5 sig_coeff_flag ctxIncrement (before luma/chroma base)."""
    if log2_size == 2:
        return int(CTX_IND_MAP_4x4[4 * py + px])
    if px == 0 and py == 0:
        return 0
    x_in, y_in = px & 3, py & 3
    if prev_csbf == 0:
        cnt = 2 if (x_in + y_in == 0) else (1 if x_in + y_in <= 2 else 0)
        # note: <=2 means positions with x+y in {1,2} get 1
    elif prev_csbf == 1:
        cnt = 2 if y_in == 0 else (1 if y_in == 1 else 0)
    elif prev_csbf == 2:
        cnt = 2 if x_in == 0 else (1 if x_in == 1 else 0)
    else:
        cnt = 2
    if log2_size == 3:
        offset = 9 if scan_idx == T.SCAN_DIAG else 15
        if c_idx:
            offset = 9
    else:
        offset = 21 if c_idx == 0 else 12
    extra = 3 if (c_idx == 0 and ((px >> 2) + (py >> 2)) > 0) else 0
    return offset + extra + cnt
