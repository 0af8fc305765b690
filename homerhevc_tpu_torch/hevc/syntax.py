"""HEVC slice-data syntax serialization (CTU quadtree, CUs, transform trees,
residual coding) driven by data-oriented frame description tensors.

The analysis stage (device) emits per-frame maps (CU depth, intra modes,
coefficient planes); this module walks them in coding order and drives a
CABAC engine. Parity with reference: hmr_arithmetic_encoding.c
(ee_encode_ctu :2039, ee_encode_coding_unit :1787, transform_tree :1561,
encode_residual :1087, intra mode coding :838/:907, MPM :545) —
re-implemented from spec clauses 7.3.8/9.3.

Data model (FrameDesc): everything is a flat map at its natural resolution;
the serializer re-derives the quadtree from the depth maps. This keeps the
device side free of tree structures (tensors only) and makes the host
serializer stateless and parallelizable per WPP row.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from homerhevc_tpu_torch.hevc import tables as T
from homerhevc_tpu_torch.hevc.cabac import CabacEncoder
from homerhevc_tpu_torch.hevc.ctx_tables import OFF
from homerhevc_tpu_torch.hevc.headers import ParamSets, SLICE_I

INTRA_PLANAR, INTRA_DC = 0, 1
PART_2Nx2N, PART_NxN = 0, 3  # spec part_mode values
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
        """Materialize dense coefficient planes from cg_wire (no-op when
        already dense). Python serializer / tooling entry point."""
        if self.coef_y is not None or self.cg_wire is None:
            return self
        bm, mk, cd, ei, ev, cnt, ec, cc, shapes = self.cg_wire
        n = sum(h * w for h, w in shapes)
        from homerhevc_tpu_torch.native import unpack_sparse_cg_native
        buf = np.empty(n, np.int16)
        if unpack_sparse_cg_native(bm, mk, cd, cnt, cc, ei, ev, n, buf,
                                   shapes):
            planes, off = [], 0
            for h, w in shapes:
                planes.append(buf[off:off + h * w].reshape(h, w))
                off += h * w
        else:
            from homerhevc_tpu_torch.ops.pack import unpack_sparse_cg
            planes = unpack_sparse_cg(bm, mk, cd, cnt, cc, ei, ev, shapes)
        self.coef_y, self.coef_u, self.coef_v = planes
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


def derive_chroma_syntax_mode(chroma_mode: int, luma_mode: int) -> int:
    """Map actual chroma mode -> intra_chroma_pred_mode syntax value 0..4.

    Table in spec 8.4.3: candidates {planar, vertical(26), horizontal(10),
    DC}, replaced by 34 when equal to luma; syntax 4 = DM (same as luma).
    """
    if chroma_mode == luma_mode:
        return 4
    cands = [INTRA_PLANAR, 26, 10, INTRA_DC]
    for i, c in enumerate(cands):
        if c == luma_mode:
            cands[i] = 34
    return cands.index(chroma_mode)


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


class SliceDataEncoder:
    """Serializes one slice's CTU data. One instance per slice (or per WPP
    row substream, with context forking handled by the caller)."""

    def __init__(self, ps: ParamSets, desc: FrameDesc, enc: CabacEncoder,
                 slice_type: int = SLICE_I, slice_qp: int = 32,
                 sao_params=None, ref_dists=(1, 1), ref_dists_l0=None):
        self.ps = ps
        self.d = desc.densify()    # python path reads dense coef planes
        self.e = enc
        self.slice_type = slice_type
        self.slice_qp = slice_qp
        self.sao = sao_params  # SaoFrameParams (slice sao flags on) or None
        self.ctu_size = ps.ctu_size
        self.min_cb = 1 << ps.log2_min_cb
        # POC distances (cur - ref) of the first entry of each list; feeds
        # the AMVP spatial-scaling branch (spec 8.5.3.2.6)
        self.ref_dists = tuple(ref_dists)
        # multi-reference L0: POC distance per L0 ref index (ref_idx_l0
        # coding is active when more than one entry is given)
        self.ref_dists_l0 = (tuple(ref_dists_l0) if ref_dists_l0 is not None
                             else (self.ref_dists[0],))
        # cu_qp_delta state
        self.qp_pred = slice_qp
        self.cu_qp_delta_coded = False
        # motion field (final MVs) for AMVP derivation in P slices
        self.motion_field = None
        if slice_type != SLICE_I and desc.mv is not None:
            from homerhevc_tpu_torch.hevc.inter import MotionField
            mf = MotionField(*desc.pred_mode.shape)
            mf.mv = desc.mv
            inter = desc.pred_mode == MODE_INTER
            dirs = desc.inter_dir
            if dirs is None:
                dirs = np.full(desc.pred_mode.shape,
                               3 if desc.mv_l1 is not None else 1, np.uint8)
            self.dirs = dirs
            r0 = (desc.ref_idx.astype(np.int32)
                  if desc.ref_idx is not None else 0)
            mf.ref = np.where(inter & ((dirs & 1) != 0), r0, -1)
            if desc.mv_l1 is not None:
                mf.mv1 = desc.mv_l1
                mf.ref1 = np.where(inter & ((dirs & 2) != 0), 0, -1)
            self.motion_field = mf

    # ---- neighbor helpers --------------------------------------------------

    def _depth_at(self, x: int, y: int) -> int:
        return int(self.d.cu_depth[y // 8, x // 8])

    def _is_intra_at(self, x: int, y: int) -> bool:
        return self.d.pred_mode[y // 8, x // 8] == MODE_INTRA

    def _luma_mode_at(self, x: int, y: int) -> int:
        return int(self.d.luma_mode[y // 4, x // 4])

    # ---- CTU / coding quadtree ----------------------------------------------

    def encode_ctu(self, ctu_x: int, ctu_y: int) -> None:
        x0 = ctu_x * self.ctu_size
        y0 = ctu_y * self.ctu_size
        # quantization group = CTB (diff_cu_qp_delta_depth 0): the delta
        # coded state resets per CTB (spec 7.3.8.8 IsCuQpDeltaCoded)
        self.cu_qp_delta_coded = False
        if self.sao is not None:
            self._encode_sao_ctu(ctu_x, ctu_y)
        self._coding_quadtree(x0, y0, self.ps.log2_ctu, 0)

    def encode_ctu_end(self, end_of_slice: bool) -> None:
        self.e.encode_terminate(int(end_of_slice))

    def _coding_quadtree(self, x0: int, y0: int, log2_size: int, depth: int) -> None:
        size = 1 << log2_size
        w, h = self.d.width, self.d.height
        inside = (x0 + size <= w) and (y0 + size <= h)
        cur_depth = self._depth_at(x0, y0)
        if inside and log2_size > self.ps.log2_min_cb:
            # split_cu_flag with neighbor-depth context
            ctx = 0
            if x0 > 0 and self._depth_at(x0 - 1, y0) > depth:
                ctx += 1
            if y0 > 0 and self._depth_at(x0, y0 - 1) > depth:
                ctx += 1
            split = int(cur_depth > depth)
            self.e.encode_bin(OFF["split_flag"] + ctx, split)
        else:
            split = int(log2_size > self.ps.log2_min_cb and cur_depth > depth)
            if not inside:
                split = int(log2_size > self.ps.log2_min_cb)
        if split:
            half = size >> 1
            for (dy, dx) in ((0, 0), (0, half), (half, 0), (half, half)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < w and y1 < h:
                    self._coding_quadtree(x1, y1, log2_size - 1, depth + 1)
        else:
            self._coding_unit(x0, y0, log2_size)

    # ---- coding unit ---------------------------------------------------------

    def _coding_unit(self, x0: int, y0: int, log2_size: int) -> None:
        ps, e, d = self.ps, self.e, self.d
        if self.slice_type != SLICE_I:
            is_intra = self._is_intra_at(x0, y0)
            skip = bool(d.skip[y0 // 8, x0 // 8])
            self._encode_cu_skip(x0, y0, int(skip))
            if skip:
                self._encode_merge_idx(int(d.merge_idx[y0 // 8, x0 // 8]))
                return
            if not is_intra:
                e.encode_bin(OFF["pred_mode"], 0)
                self._inter_cu(x0, y0, log2_size)
                return
            e.encode_bin(OFF["pred_mode"], 1)  # pred_mode_flag = intra
        nxn = bool(d.part_nxn[y0 // 8, x0 // 8])
        if log2_size == ps.log2_min_cb:
            # part_mode: intra binarization, 1 = 2Nx2N
            e.encode_bin(OFF["part_size"], 0 if nxn else 1)
        n_pu = 4 if nxn else 1
        pu = size = 1 << log2_size
        if nxn:
            pu = size >> 1
        # gather modes + MPM decisions first (prev flags are coded grouped)
        pu_info = []
        for i in range(n_pu):
            px = x0 + (i & 1) * pu
            py = y0 + (i >> 1) * pu
            mode = self._luma_mode_at(px, py)
            left = INTRA_DC
            if px > 0 and self._is_intra_at(px - 1, py):
                left = self._luma_mode_at(px - 1, py)
            above = INTRA_DC
            if py > 0 and (py % self.ctu_size) != 0 and self._is_intra_at(px, py - 1):
                above = self._luma_mode_at(px, py - 1)
            mpm = mpm_candidates(left, above)
            pu_info.append((mode, mpm))
        for mode, mpm in pu_info:
            e.encode_bin(OFF["intra_pred_mode"], int(mode in mpm))
        for mode, mpm in pu_info:
            if mode in mpm:
                idx = mpm.index(mode)
                e.encode_bypass(int(idx != 0))
                if idx != 0:
                    e.encode_bypass(idx - 1)
            else:
                srt = sorted(mpm)
                rem = mode
                for c in reversed(srt):
                    if mode > c:
                        rem -= 1
                e.encode_bypass_bins(rem, 5)
        # chroma mode (single for 4:2:0)
        cmode = int(d.chroma_mode[y0 // 8, x0 // 8])
        lmode = pu_info[0][0]
        syn = derive_chroma_syntax_mode(cmode, lmode)
        if syn == 4:
            e.encode_bin(OFF["chroma_pred_mode"], 0)
        else:
            e.encode_bin(OFF["chroma_pred_mode"], 1)
            e.encode_bypass_bins(syn, 2)
        # transform tree
        intra_split = nxn
        max_depth = ps.max_tr_depth_intra + (1 if intra_split else 0)
        self._transform_tree(x0, y0, x0, y0, log2_size, 0, 0,
                             intra_split, max_depth, True, True)

    def _encode_cu_skip(self, x0: int, y0: int, skip: int) -> None:
        d = self.d
        ctx = 0
        if x0 > 0 and d.skip[y0 // 8, (x0 - 1) // 8]:
            ctx += 1
        if y0 > 0 and d.skip[(y0 - 1) // 8, x0 // 8]:
            ctx += 1
        self.e.encode_bin(OFF["skip_flag"] + ctx, skip)

    def _encode_ref_idx(self, r: int, num_ref: int) -> None:
        """ref_idx_l0 (spec 9.3.3: TR cMax = num_ref-1; ctxInc 0, 1, then
        bypass — Table 9-41)."""
        e = self.e
        e.encode_bin(OFF["ref_pic"], int(r > 0))
        if r > 0 and num_ref > 2:
            for i in range(1, min(r, num_ref - 1)):
                if i == 1:
                    e.encode_bin(OFF["ref_pic"] + 1, 1)
                else:
                    e.encode_bypass(1)
            if r < num_ref - 1:
                if r == 1:
                    e.encode_bin(OFF["ref_pic"] + 1, 0)
                else:
                    e.encode_bypass(0)

    def _encode_merge_idx(self, idx: int, max_cand: int = 5) -> None:
        """merge_idx: TR cMax = max_cand-1; bin0 ctx, rest bypass."""
        e = self.e
        if max_cand <= 1:
            return
        e.encode_bin(OFF["merge_idx"], int(idx > 0))
        if idx > 0:
            for i in range(1, idx):
                e.encode_bypass(1)
            if idx < max_cand - 1:
                e.encode_bypass(0)

    def _encode_mvd(self, mvd_x: int, mvd_y: int) -> None:
        """mvd_coding (spec 7.3.8.9 / 9.3.3.9)."""
        e = self.e
        ax, ay = abs(mvd_x), abs(mvd_y)
        e.encode_bin(OFF["mvd"], int(ax > 0))
        e.encode_bin(OFF["mvd"], int(ay > 0))
        if ax > 0:
            e.encode_bin(OFF["mvd"] + 1, int(ax > 1))
        if ay > 0:
            e.encode_bin(OFF["mvd"] + 1, int(ay > 1))
        for a, v in ((ax, mvd_x), (ay, mvd_y)):
            if a > 0:
                if a > 1:
                    self._encode_eg_bypass(a - 2, 1)
                e.encode_bypass(int(v < 0))

    def _encode_eg_bypass(self, value: int, k: int) -> None:
        """Exp-Golomb order-k bypass (HM xWriteEpExGolomb)."""
        e = self.e
        while value >= (1 << k):
            e.encode_bypass(1)
            value -= 1 << k
            k += 1
        e.encode_bypass(0)
        while k:
            k -= 1
            e.encode_bypass((value >> k) & 1)

    def _inter_cu(self, x0: int, y0: int, log2_size: int) -> None:
        """Inter CU: 2Nx2N, or rectangular 2NxN/Nx2N (desc.inter_part;
        P slices), single reference per list (B: L0-uni)."""
        from homerhevc_tpu_torch.hevc.headers import SLICE_B
        ps, e, d = self.ps, self.e, self.d
        ux, uy = x0 // 8, y0 // 8
        part = (int(d.inter_part[uy, ux])
                if d.inter_part is not None else 0)
        if part:
            self._inter_cu_rect(x0, y0, log2_size, part)
            return
        e.encode_bin(OFF["part_size"], 1)  # PART_2Nx2N
        mode = int(d.inter_mode[uy, ux])   # 1=merge, 2=amvp
        e.encode_bin(OFF["merge_flag"], int(mode == 1))
        if mode == 1:
            self._encode_merge_idx(int(d.merge_idx[uy, ux]))
        else:
            from homerhevc_tpu_torch.hevc.inter import (amvp_candidates,
                                                  amvp_candidates_2,
                                                  amvp_candidates_mref)
            n = 1 << log2_size
            if self.slice_type == SLICE_B and d.mv_l1 is not None:
                cdir = int(self.dirs[uy, ux])
            else:
                cdir = 1
            if self.slice_type == SLICE_B:
                # inter_pred_idc (9.3.3.7): bin0 = BI (ctx by CU depth);
                # uni adds bin1 = L1 (ctx 4)
                depth = int(d.cu_depth[uy, ux])
                e.encode_bin(OFF["inter_dir"] + depth, int(cdir == 3))
                if cdir != 3:
                    e.encode_bin(OFF["inter_dir"] + 4, int(cdir == 2))
            num_ref = len(self.ref_dists_l0)
            cur_ref = (int(d.ref_idx[uy, ux])
                       if d.ref_idx is not None else 0)
            if num_ref > 1 and (cdir & 1):
                self._encode_ref_idx(cur_ref, num_ref)
            if self.slice_type == SLICE_B and d.mv_l1 is not None:
                # mixed-direction neighbours: per-list AMVP with the
                # spec 8.5.3.2.6 POC-distance scaling branch
                def mvp_list(lx):
                    return amvp_candidates_2(
                        self.motion_field, x0, y0, n, ps.ctu_size,
                        d.width, d.height, lx, self.ref_dists)
            elif num_ref > 1:
                def mvp_list(lx):
                    return amvp_candidates_mref(
                        self.motion_field, x0, y0, n, ps.ctu_size,
                        d.width, d.height, cur_ref, self.ref_dists_l0)
            else:
                def mvp_list(lx):
                    return amvp_candidates(self.motion_field, x0, y0, n,
                                           ps.ctu_size, d.width, d.height)
            if cdir & 1:
                mvp = mvp_list(0)
                f = int(d.mvp_flag[uy, ux])
                self._encode_mvd(int(d.mv[uy, ux, 0]) - mvp[f][0],
                                 int(d.mv[uy, ux, 1]) - mvp[f][1])
                e.encode_bin(OFF["mvp_idx"], f)
            if cdir & 2:
                mvp1 = mvp_list(1)
                f1 = int(d.mvp_flag_l1[uy, ux])
                self._encode_mvd(int(d.mv_l1[uy, ux, 0]) - mvp1[f1][0],
                                 int(d.mv_l1[uy, ux, 1]) - mvp1[f1][1])
                e.encode_bin(OFF["mvp_idx"], f1)
        rcbf = int(d.root_cbf[uy, ux])
        if mode != 1:  # merge 2Nx2N: rqt_root_cbf inferred 1
            e.encode_bin(OFF["qt_root_cbf"], rcbf)
        if rcbf:
            self._transform_tree(x0, y0, x0, y0, log2_size, 0, 0,
                                 False, ps.max_tr_depth_inter, True, True)

    def _inter_cu_rect(self, x0: int, y0: int, log2_size: int,
                       part: int) -> None:
        """Rectangular inter CU (2NxN part=1 / Nx2N part=2), two PUs with
        per-PU merge/AMVP motion (spec 7.3.8.6; part_mode binarization
        9.3.3.7 AMP-off; reference PU writer
        hmr_arithmetic_encoding.c:777)."""
        from homerhevc_tpu_torch.hevc.inter import (amvp_candidates_rect,
                                              merge_candidates_rect)
        ps, e, d = self.ps, self.e, self.d
        size = 1 << log2_size
        half = size // 2
        # part_mode: "01" = 2NxN; Nx2N is "001" unless at min CB > 8
        # where a third bin distinguishes Nx2N from NxN
        e.encode_bin(OFF["part_size"], 0)
        e.encode_bin(OFF["part_size"] + 1, 1 if part == 1 else 0)
        if part == 2 and log2_size == ps.log2_min_cb and log2_size > 3:
            e.encode_bin(OFF["part_size"] + 2, 1)
        if part == 1:
            pus = [(x0, y0, size, half), (x0, y0 + half, size, half)]
            pname = "2NxN"
        else:
            pus = [(x0, y0, half, size), (x0 + half, y0, half, size)]
            pname = "Nx2N"
        for i, (px, py, pw, ph) in enumerate(pus):
            pux, puy = px // 8, py // 8
            mode = int(d.inter_mode[puy, pux])
            e.encode_bin(OFF["merge_flag"], int(mode == 1))
            if mode == 1:
                self._encode_merge_idx(int(d.merge_idx[puy, pux]))
                continue
            if self.slice_type == 0:   # SLICE_B: uni-L0 rect PUs only
                # inter_pred_idc (9.3.3.7): 16x8/8x16 PUs code the full
                # 2-bin form (nPbW+nPbH > 12)
                depth = int(d.cu_depth[puy, pux])
                e.encode_bin(OFF["inter_dir"] + depth, 0)   # not BI
                e.encode_bin(OFF["inter_dir"] + 4, 0)       # list 0
            mvp = amvp_candidates_rect(self.motion_field, px, py, pw, ph,
                                       ps.ctu_size, d.width, d.height,
                                       part=pname, pu_idx=i)
            f = int(d.mvp_flag[puy, pux])
            self._encode_mvd(int(d.mv[puy, pux, 0]) - mvp[f][0],
                             int(d.mv[puy, pux, 1]) - mvp[f][1])
            e.encode_bin(OFF["mvp_idx"], f)
        ux, uy = x0 // 8, y0 // 8
        rcbf = int(d.root_cbf[uy, ux])
        e.encode_bin(OFF["qt_root_cbf"], rcbf)
        if rcbf:
            forced = ps.max_tr_depth_inter == 0
            self._transform_tree(x0, y0, x0, y0, log2_size, 0, 0,
                                 forced,
                                 ps.max_tr_depth_inter + (1 if forced
                                                          else 0),
                                 True, True)

    # ---- transform tree -------------------------------------------------------

    def _region_cbf(self, plane: np.ndarray, x: int, y: int, size: int) -> bool:
        return bool(np.any(plane[y:y + size, x:x + size]))

    def _transform_tree(self, x0, y0, x_base, y_base, log2_size, depth, blk_idx,
                        intra_split, max_depth, parent_cbf_cb, parent_cbf_cr) -> None:
        ps, e, d = self.ps, self.e, self.d
        size = 1 << log2_size
        tr_depth_target = int(d.tr_depth[y0 // 8, x0 // 8])
        split = tr_depth_target > depth
        # explicit split flag conditions (spec 7.3.8.8)
        if (log2_size <= ps.log2_max_tb and log2_size > ps.log2_min_tb
                and depth < max_depth and not (intra_split and depth == 0)):
            e.encode_bin(OFF["trans_subdiv"] + (5 - log2_size), int(split))
        else:
            # inferred
            if log2_size > ps.log2_max_tb or (intra_split and depth == 0):
                split = True
            elif log2_size == ps.log2_min_tb or depth >= max_depth:
                split = False
        # chroma CBFs at this level
        cx, cy = x0 // 2, y0 // 2
        csize = size // 2
        if log2_size > 2:
            cbf_cb = self._region_cbf(d.coef_u, cx, cy, csize)
            cbf_cr = self._region_cbf(d.coef_v, cx, cy, csize)
            if parent_cbf_cb:
                e.encode_bin(OFF["qt_cbf"] + 4 + depth, int(cbf_cb))
            if parent_cbf_cr:
                e.encode_bin(OFF["qt_cbf"] + 4 + depth, int(cbf_cr))
        else:
            cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if split:
            half = size >> 1
            for i, (dy, dx) in enumerate(((0, 0), (0, half), (half, 0), (half, half))):
                self._transform_tree(x0 + dx, y0 + dy, x0, y0, log2_size - 1,
                                     depth + 1, i, intra_split, max_depth,
                                     cbf_cb, cbf_cr)
            return
        # leaf: cbf_luma then transform_unit
        cbf_luma = self._region_cbf(d.coef_y, x0, y0, size)
        # coded unless inter at depth 0 with no chroma cbf (then inferred 1)
        if self._is_intra_at(x0, y0) or depth != 0 or cbf_cb or cbf_cr:
            e.encode_bin(OFF["qt_cbf"] + (1 if depth == 0 else 0), int(cbf_luma))
        else:
            assert cbf_luma, "inter root with all-zero cbf must use rqt_root_cbf=0"
        self._transform_unit(x0, y0, x_base, y_base, log2_size, depth, blk_idx,
                             cbf_luma, cbf_cb, cbf_cr)

    def _transform_unit(self, x0, y0, x_base, y_base, log2_size, depth, blk_idx,
                        cbf_luma, cbf_cb, cbf_cr) -> None:
        d = self.d
        if log2_size == 2:
            # chroma cbf refers to the parent 8x8 node (4x4 chroma block)
            cbf_cb = cbf_cb and self._region_cbf(d.coef_u, x_base // 2, y_base // 2, 4)
            cbf_cr = cbf_cr and self._region_cbf(d.coef_v, x_base // 2, y_base // 2, 4)
        cbf_any_chroma = cbf_cb or cbf_cr
        if not (cbf_luma or cbf_any_chroma):
            return
        if self.ps.cu_qp_delta_enabled and not self.cu_qp_delta_coded:
            self._encode_cu_qp_delta(x0, y0)
            self.cu_qp_delta_coded = True
        if cbf_luma:
            mode = self._luma_mode_at(x0, y0)
            scan = T.intra_scan_idx(mode, log2_size, True) \
                if self._is_intra_at(x0, y0) else T.SCAN_DIAG
            block = d.coef_y[y0:y0 + (1 << log2_size), x0:x0 + (1 << log2_size)]
            self._residual_coding(block, log2_size, 0, scan)
        if log2_size > 2 or blk_idx == 3:
            if log2_size > 2:
                cx, cy, clog2 = x0 // 2, y0 // 2, log2_size - 1
                cmode_src_x, cmode_src_y = x0, y0
            else:
                cx, cy, clog2 = x_base // 2, y_base // 2, 2
                cmode_src_x, cmode_src_y = x_base, y_base
            cmode = int(d.chroma_mode[cmode_src_y // 8, cmode_src_x // 8])
            cscan = T.intra_scan_idx(cmode, clog2, False) \
                if self._is_intra_at(cmode_src_x, cmode_src_y) else T.SCAN_DIAG
            if cbf_cb:
                blk = d.coef_u[cy:cy + (1 << clog2), cx:cx + (1 << clog2)]
                self._residual_coding(blk, clog2, 1, cscan)
            if cbf_cr:
                blk = d.coef_v[cy:cy + (1 << clog2), cx:cx + (1 << clog2)]
                self._residual_coding(blk, clog2, 2, cscan)

    def _encode_cu_qp_delta(self, x0: int, y0: int) -> None:
        """cu_qp_delta_abs/sign (spec 7.3.8.10, 9.3.3.8): TU to cMax 5 with
        ctx {dqp+0 for bin0, dqp+1 after}, then EG0 bypass, then sign."""
        qp = int(self.d.qp_map[y0 // 8, x0 // 8]) if self.d.qp_map is not None \
            else self.slice_qp
        delta = qp - self.qp_pred
        e = self.e
        abs_d = abs(delta)
        tu_val = min(abs_d, 5)
        e.encode_bin(OFF["dqp"] + 0, int(tu_val > 0))
        if tu_val > 0:
            for i in range(1, tu_val):
                e.encode_bin(OFF["dqp"] + 1, 1)
            if tu_val < 5:
                e.encode_bin(OFF["dqp"] + 1, 0)
            if abs_d >= 5:
                # EG0 bypass of (abs_d - 5)
                v = abs_d - 5 + 1
                nbits = v.bit_length()
                e.encode_bypass_bins((1 << (nbits - 1)) - 1 << 1, nbits)  # prefix: (nbits-1) ones + 0
                e.encode_bypass_bins(v - (1 << (nbits - 1)), nbits - 1)
            e.encode_bypass(int(delta < 0))
        self.qp_pred = qp

    # ---- residual coding -------------------------------------------------------

    def _residual_coding(self, block: np.ndarray, log2_size: int, c_idx: int,
                         scan_idx: int) -> None:
        e = self.e
        size = 1 << log2_size
        coefs = np.asarray(block, np.int32).reshape(size * size)
        scan = T.coeff_scan(log2_size, scan_idx)
        scoefs = coefs[scan]
        nz = np.nonzero(scoefs)[0]
        assert nz.size > 0, "residual_coding called with all-zero block"
        last_pos = int(nz[-1])
        last_raster = int(scan[last_pos])
        last_x, last_y = last_raster % size, last_raster // size
        if scan_idx == T.SCAN_VER:
            last_x, last_y = last_y, last_x
        self._encode_last_xy(last_x, last_y, log2_size, c_idx)

        ncg = max(1, size // 4)
        num_cg = (last_pos >> 4) + 1
        cg_order = T.cg_scan(log2_size, scan_idx)
        # coded_sub_block_flag values per CG (scan order)
        cg_nz = np.zeros(ncg * ncg, bool)
        for ci in range(num_cg):
            cg_nz[ci] = bool(np.any(scoefs[ci * 16:(ci + 1) * 16]))

        # per-CG right/below flags need raster geometry
        def cg_right_below(ci_scan: int) -> int:
            r = int(cg_order[ci_scan])
            cgx, cgy = r % ncg, r // ncg
            res = 0
            if cgx + 1 < ncg:
                ri = np.where(cg_order == r + 1)[0][0]
                if cg_nz[ri]:
                    res |= 1
            if cgy + 1 < ncg:
                bi = np.where(cg_order == r + ncg)[0][0]
                if cg_nz[bi]:
                    res |= 2
            return res

        c1 = 1
        for ci in range(num_cg - 1, -1, -1):
            cg_start = ci * 16
            in_last_cg = ci == num_cg - 1
            prev_csbf = cg_right_below(ci)
            infer_sb_dc = False
            if in_last_cg or ci == 0:
                coded_sb = True
            else:
                coded_sb = bool(cg_nz[ci])
                ctx = OFF["sig_cg"] + (2 if c_idx else 0) + (1 if prev_csbf else 0)
                e.encode_bin(ctx, int(coded_sb))
                infer_sb_dc = True
            if not coded_sb:
                continue
            # significance map
            start_n = min(15, last_pos - cg_start) if in_last_cg else 15
            sig_positions = []
            num_sig_found = 0
            for n in range(start_n, -1, -1):
                pos = cg_start + n
                sig = int(scoefs[pos] != 0)
                if in_last_cg and pos == last_pos:
                    sig_positions.append(pos)
                    num_sig_found += 1
                    continue
                if n == 0 and infer_sb_dc and num_sig_found == 0:
                    # DC of an explicitly-coded CG with no other sig coeff:
                    # inferred significant, not coded (spec 9.3.4.2.5)
                    assert sig, "csbf=1 CG must contain a nonzero coeff"
                    sig_positions.append(pos)
                    continue
                raster = int(scan[pos])
                px, py = raster % size, raster // size
                ctx_inc = self._sig_ctx(px, py, log2_size, c_idx, scan_idx,
                                        prev_csbf)
                base = OFF["sig"] + (27 if c_idx else 0)
                e.encode_bin(base + ctx_inc, sig)
                if sig:
                    sig_positions.append(pos)
                    num_sig_found += 1
            # sig_positions are in reverse scan order (coding order)
            n_nz = len(sig_positions)
            if n_nz == 0:
                continue
            abs_vals = [abs(int(scoefs[p])) for p in sig_positions]
            signs = [int(scoefs[p] < 0) for p in sig_positions]
            first_nz_scan = sig_positions[-1] - cg_start
            last_nz_scan = sig_positions[0] - cg_start
            hide_sign = (self.ps.sign_hiding
                         and (last_nz_scan - first_nz_scan) >= T.SBH_THRESHOLD)
            # greater-1 flags (first 8 coeffs), context set per spec 9.3.4.2.6
            ctx_set = 2 if (ci > 0 and c_idx == 0) else 0
            if c1 == 0:
                ctx_set += 1
            c1 = 1
            base_one = OFF["one"] + (16 if c_idx else 0) + 4 * ctx_set
            num_g1 = min(n_nz, 8)
            first_g1_idx = -1
            for i in range(num_g1):
                g1 = int(abs_vals[i] > 1)
                e.encode_bin(base_one + c1, g1)
                if g1:
                    c1 = 0
                    if first_g1_idx < 0:
                        first_g1_idx = i
                elif 0 < c1 < 3:
                    c1 += 1
            # greater-2 flag for the first >1 coefficient
            if first_g1_idx >= 0:
                g2 = int(abs_vals[first_g1_idx] > 2)
                e.encode_bin(OFF["abs"] + (4 if c_idx else 0) + ctx_set, g2)
            # signs (bypass); hidden sign = lowest scan pos = last in list
            n_signs = n_nz - 1 if hide_sign else n_nz
            for i in range(n_signs):
                e.encode_bypass(signs[i])
            # remaining absolute levels (Golomb-Rice)
            if c1 == 0 or n_nz > 8:
                go_rice = 0
                first_coeff2 = 1
                for i in range(n_nz):
                    base_level = (2 + first_coeff2) if i < 8 else 1
                    if abs_vals[i] >= base_level:
                        self._encode_remaining(abs_vals[i] - base_level, go_rice)
                        if abs_vals[i] > (3 << go_rice):
                            go_rice = min(go_rice + 1, 4)
                    if abs_vals[i] >= 2:
                        first_coeff2 = 0

    def _encode_remaining(self, value: int, r_param: int) -> None:
        e = self.e
        if value < (3 << r_param):
            length = value >> r_param
            e.encode_bypass_bins((1 << (length + 1)) - 2, length + 1)
            if r_param:
                e.encode_bypass_bins(value & ((1 << r_param) - 1), r_param)
        else:
            length = r_param
            value -= 3 << r_param
            while value >= (1 << length):
                value -= 1 << length
                length += 1
            e.encode_bypass_bins((1 << (3 + length + 1 - r_param)) - 2,
                                 3 + length + 1 - r_param)
            if length:
                e.encode_bypass_bins(value, length)

    def _encode_last_xy(self, last_x: int, last_y: int, log2_size: int,
                        c_idx: int) -> None:
        e = self.e
        if c_idx == 0:
            ctx_offset = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
            ctx_shift = (log2_size + 1) >> 2
        else:
            ctx_offset = 15  # chroma contexts start at 15 within the element
            ctx_shift = log2_size - 2
        base_x, base_y = OFF["last_x"], OFF["last_y"]
        g_max = (log2_size << 1) - 1
        for (val, base) in ((last_x, base_x), (last_y, base_y)):
            prefix = self._last_prefix(val)
            for i in range(prefix):
                e.encode_bin(base + ctx_offset + (i >> ctx_shift), 1)
            if prefix < g_max:
                e.encode_bin(base + ctx_offset + (prefix >> ctx_shift), 0)
        for (val,) in ((last_x,), (last_y,)):
            prefix = self._last_prefix(val)
            if prefix > 3:
                suffix_len = (prefix >> 1) - 1
                suffix = val - ((2 + (prefix & 1)) << suffix_len)
                e.encode_bypass_bins(suffix, suffix_len)

    @staticmethod
    def _last_prefix(val: int) -> int:
        """last_sig_coeff prefix (group index) for a coordinate value."""
        if val < 4:
            return val
        # groups: 4-5 -> 4, 6-7 -> 5, 8-11 -> 6, 12-15 -> 7, 16-23 -> 8, 24-31 -> 9
        return 2 * ((val.bit_length()) - 1) + ((val >> (val.bit_length() - 2)) & 1)

    @staticmethod
    def _sig_ctx(px: int, py: int, log2_size: int, c_idx: int, scan_idx: int,
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

    # ---- SAO syntax (spec 7.3.8.3) ----------------------------------------------

    def _encode_sao_ctu(self, cx: int, cy: int) -> None:
        e, sp = self.e, self.sao
        if cx > 0:
            e.encode_bin(OFF["sao_merge"], int(sp.merge_left[cy, cx]))
        if cy > 0 and not (cx > 0 and sp.merge_left[cy, cx]):
            e.encode_bin(OFF["sao_merge"], int(sp.merge_up[cy, cx]))
        if (cx > 0 and sp.merge_left[cy, cx]) or sp.merge_up[cy, cx]:
            return
        for c_idx in range(3):
            if c_idx == 0:
                t = int(sp.type_luma[cy, cx])
            elif c_idx == 1:
                t = int(sp.type_chroma[cy, cx])
            else:
                t = int(sp.type_chroma[cy, cx])  # inherited, nothing coded
            if c_idx < 2:
                e.encode_bin(OFF["sao_type"], int(t != 0))
                if t != 0:
                    e.encode_bypass(int(t == 2))
            if t == 0:
                continue
            off = sp.offsets[cy, cx, c_idx]
            for i in range(4):
                v = abs(int(off[i]))
                # TR cMax=7 bypass
                for _ in range(v):
                    e.encode_bypass(1)
                if v < 7:
                    e.encode_bypass(0)
            if t == 1:  # band
                for i in range(4):
                    if off[i] != 0:
                        e.encode_bypass(int(off[i] < 0))
                e.encode_bypass_bins(int(sp.band_pos[cy, cx, c_idx]), 5)
            else:  # edge: offsets signs inferred; class coded for luma/cb
                if c_idx == 0:
                    e.encode_bypass_bins(int(sp.eo_class_luma[cy, cx]), 2)
                elif c_idx == 1:
                    e.encode_bypass_bins(int(sp.eo_class_chroma[cy, cx]), 2)
