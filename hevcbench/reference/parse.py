# Frozen copy of homerhevc_tpu_torch/hevc/parse.py, lines 1-1039, for the
# benchmark's plain reference decoder: later changes to the program
# do not move it. Imports point at the other copies beside it; the slice
# header is read with the ParamSets of the stream's own parameter sets.
"""Slice-data parser: decoder twin of the port's SliceDataEncoder (the port's
copy of homerhevc_tpu/hevc/parse.py; its AMVP lists come from the port's
hevc/inter.py, which derives the spec's two-list list at the left picture
edge).

Parses intra slice data back into a FrameDesc (modes + coefficient planes).
Used as (a) a self-consistency oracle for the serializer, (b) a parser for
third-party conformant streams (e.g. the reference encoder's) to validate
our context/syntax assumptions, and (c) with golden prediction, a full YUV
bit-exact decoder for conformance tests (chroma included — the cv2/FFmpeg
oracle only exposes luma exactly).
"""

from __future__ import annotations

import numpy as np

from hevcbench.reference import tables as T
from hevcbench.reference.cabac_dec import CabacDecoder
from hevcbench.reference.ctx_tables import OFF
from hevcbench.reference.headers import ParamSets, SLICE_B, SLICE_I
from hevcbench.reference.syntax import (
    FrameDesc, INTRA_DC, mpm_candidates, sig_ctx,
)


class SliceDataParser:
    def __init__(self, ps: ParamSets, width: int, height: int,
                 dec: CabacDecoder, slice_type: int = SLICE_I,
                 slice_qp: int = 32, trace: bool = False,
                 sao_enabled: bool = False, mvd_l1_zero: bool = False,
                 ref_dists=(1, 1), ref_dists_l0=None):
        self.ps = ps
        self.d = FrameDesc.alloc(width, height)
        # POC distances of each list's first ref (AMVP scaling, B slices)
        self.ref_dists = tuple(ref_dists)
        # multi-reference L0: POC distance per ref index (> 1 entry
        # activates ref_idx_l0 parsing — twin of the encoder's coding)
        self.ref_dists_l0 = (tuple(ref_dists_l0)
                             if ref_dists_l0 is not None
                             else (self.ref_dists[0],))
        if len(self.ref_dists_l0) > 1:
            self.d.ref_idx = np.zeros(self.d.pred_mode.shape, np.int8)
        if slice_type == SLICE_B:
            self.d.mv_l1 = np.zeros_like(self.d.mv)
            self.d.mvp_flag_l1 = np.zeros_like(self.d.mvp_flag)
            self.d.inter_dir = np.zeros(self.d.pred_mode.shape, np.uint8)
        self.e = dec
        self.slice_type = slice_type
        self.slice_qp = slice_qp
        self.ctu_size = ps.ctu_size
        self.trace = trace
        self.log = []
        self.sao = None
        if sao_enabled:
            from hevcbench.reference.sao import SaoFrameParams
            self.sao = SaoFrameParams.alloc(
                -(-height // ps.ctu_size), -(-width // ps.ctu_size))
        self._coded_mask = np.zeros((height // 8, width // 8), bool)
        self.mvd_l1_zero = mvd_l1_zero
        self.max_merge = 5
        # cu_qp_delta state (QG = CTB): decoder-view per-8x8 QP map for
        # dequant + deblock; flat slice QP when the PPS flag is off
        self.qp_pred = slice_qp
        self.cu_qp_delta_coded = False
        self._ctb_origin = (0, 0)
        if ps.cu_qp_delta_enabled:
            self.d.qp_map = np.full((height // 8, width // 8), slice_qp,
                                    np.int8)
        self.part_stats: dict = {}
        self.pu_stats = {"l0": 0, "l1": 0, "bi": 0}

    def _t(self, *args):
        if self.trace:
            self.log.append(args)

    def _depth_at(self, x, y):
        return int(self.d.cu_depth[y // 8, x // 8])

    def _is_intra_at(self, x, y):
        from hevcbench.reference.syntax import MODE_INTRA
        return self.d.pred_mode[y // 8, x // 8] == MODE_INTRA

    def _luma_mode_at(self, x, y):
        return int(self.d.luma_mode[y // 4, x // 4])

    # ---- CTU ---------------------------------------------------------------

    def parse_ctu(self, ctu_x: int, ctu_y: int) -> None:
        x0 = ctu_x * self.ctu_size
        y0 = ctu_y * self.ctu_size
        # quantization group = CTB: reset the delta-coded flag; the QG's
        # inferred QP starts at the predictor and jumps to the signalled
        # value when a cu_qp_delta is decoded (spec 8.6.1)
        self.cu_qp_delta_coded = False
        self._qg_qp = self.qp_pred
        if self.sao is not None:
            self._parse_sao_ctu(ctu_x, ctu_y)
        self._coding_quadtree(x0, y0, self.ps.log2_ctu, 0)
        # qPY_PREV for the next QG = QP of this QG's last coding unit
        self.qp_pred = self._qg_qp

    def _parse_sao_ctu(self, cx: int, cy: int) -> None:
        e, sp = self.e, self.sao
        merge_left = merge_up = False
        if cx > 0:
            merge_left = bool(e.decode_bin(OFF["sao_merge"]))
        if cy > 0 and not merge_left:
            merge_up = bool(e.decode_bin(OFF["sao_merge"]))
        sp.merge_left[cy, cx] = merge_left
        sp.merge_up[cy, cx] = merge_up
        if merge_left:
            sp.copy_from(cy, cx - 1, cy, cx)
            return
        if merge_up:
            sp.copy_from(cy - 1, cx, cy, cx)
            return
        for c_idx in range(3):
            if c_idx == 0:
                t = 0
                if e.decode_bin(OFF["sao_type"]):
                    t = 2 if e.decode_bypass() else 1
                sp.type_luma[cy, cx] = t
            elif c_idx == 1:
                t = 0
                if e.decode_bin(OFF["sao_type"]):
                    t = 2 if e.decode_bypass() else 1
                sp.type_chroma[cy, cx] = t
            else:
                t = int(sp.type_chroma[cy, cx])
            if t == 0:
                continue
            offs = []
            for i in range(4):
                v = 0
                while v < 7 and e.decode_bypass():
                    v += 1
                offs.append(v)
            if t == 1:
                for i in range(4):
                    if offs[i] and e.decode_bypass():
                        offs[i] = -offs[i]
                sp.band_pos[cy, cx, c_idx] = e.decode_bypass_bins(5)
            else:
                if c_idx == 0:
                    sp.eo_class_luma[cy, cx] = e.decode_bypass_bins(2)
                elif c_idx == 1:
                    sp.eo_class_chroma[cy, cx] = e.decode_bypass_bins(2)
            sp.offsets[cy, cx, c_idx] = offs

    def parse_ctu_end(self) -> int:
        return self.e.decode_terminate()

    def _coding_quadtree(self, x0, y0, log2_size, depth):
        size = 1 << log2_size
        w, h = self.d.width, self.d.height
        inside = (x0 + size <= w) and (y0 + size <= h)
        if inside and log2_size > self.ps.log2_min_cb:
            ctx = 0
            if x0 > 0 and self._depth_at(x0 - 1, y0) > depth:
                ctx += 1
            if y0 > 0 and self._depth_at(x0, y0 - 1) > depth:
                ctx += 1
            split = self.e.decode_bin(OFF["split_flag"] + ctx)
            self._t("split", x0, y0, depth, split)
        else:
            split = 1 if (not inside and log2_size > self.ps.log2_min_cb) else 0
        if split:
            half = size >> 1
            # record depth for the whole region first (serializer's neighbor
            # ctx uses final depths; parser must fill as it goes)
            for (dy, dx) in ((0, 0), (0, half), (half, 0), (half, half)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < w and y1 < h:
                    self._coding_quadtree(x1, y1, log2_size - 1, depth + 1)
        else:
            self.d.cu_depth[y0 // 8:(y0 + size) // 8,
                            x0 // 8:(x0 + size) // 8] = depth
            self._coding_unit(x0, y0, log2_size)
            if self.d.qp_map is not None:
                # decoder-view QP of this CU: the QG's inferred QP (jumps
                # to the signalled value once a delta is decoded, so CUs
                # before the first-residual CU keep the predictor's QP)
                self.d.qp_map[y0 // 8:(y0 + size) // 8,
                              x0 // 8:(x0 + size) // 8] = self._qg_qp

    def _coding_unit(self, x0, y0, log2_size):
        ps, e, d = self.ps, self.e, self.d
        if self.slice_type != SLICE_I:
            ux, uy = x0 // 8, y0 // 8
            size8 = (1 << log2_size) // 8
            sl8 = (slice(uy, uy + size8), slice(ux, ux + size8))
            ctx = 0
            if x0 > 0 and d.skip[uy, ux - 1]:
                ctx += 1
            if y0 > 0 and d.skip[uy - 1, ux]:
                ctx += 1
            skip = e.decode_bin(OFF["skip_flag"] + ctx)
            from hevcbench.reference.syntax import MODE_INTER
            if skip:
                d.skip[sl8] = 1
                d.pred_mode[sl8] = MODE_INTER
                idx = self._parse_merge_idx()
                self._apply_merge(x0, y0, 1 << log2_size, idx, sl8)
                d.inter_mode[sl8] = 0
                d.root_cbf[sl8] = 0
                return
            if e.decode_bin(OFF["pred_mode"]) == 0:
                d.pred_mode[sl8] = MODE_INTER
                self._inter_cu(x0, y0, log2_size, sl8)
                return
        nxn = False
        if log2_size == ps.log2_min_cb:
            nxn = e.decode_bin(OFF["part_size"]) == 0
        d.part_nxn[y0 // 8, x0 // 8] = nxn
        n_pu = 4 if nxn else 1
        size = 1 << log2_size
        pu = size >> 1 if nxn else size
        prev_flags = [e.decode_bin(OFF["intra_pred_mode"]) for _ in range(n_pu)]
        modes = []
        for i in range(n_pu):
            px = x0 + (i & 1) * pu
            py = y0 + (i >> 1) * pu
            left = INTRA_DC
            if px > 0:
                left = self._luma_mode_at(px - 1, py)
            above = INTRA_DC
            if py > 0 and (py % self.ctu_size) != 0:
                above = self._luma_mode_at(px, py - 1)
            mpm = mpm_candidates(left, above)
            if prev_flags[i]:
                idx = 0
                if e.decode_bypass():
                    idx = 1 + e.decode_bypass()
                mode = mpm[idx]
            else:
                rem = e.decode_bypass_bins(5)
                for c in sorted(mpm):
                    if rem >= c:
                        rem += 1
                mode = rem
            modes.append(mode)
            d.luma_mode[py // 4:(py + pu) // 4, px // 4:(px + pu) // 4] = mode
            self._t("luma_mode", px, py, mode)
        # chroma
        if e.decode_bin(OFF["chroma_pred_mode"]) == 0:
            cmode = modes[0]
        else:
            syn = e.decode_bypass_bins(2)
            cands = [0, 26, 10, 1]
            for i, c in enumerate(cands):
                if c == modes[0]:
                    cands[i] = 34
            cmode = cands[syn]
        d.chroma_mode[y0 // 8:(y0 + size) // 8, x0 // 8:(x0 + size) // 8] = cmode
        self._t("chroma_mode", x0, y0, cmode)
        intra_split = nxn
        max_depth = ps.max_tr_depth_intra + (1 if intra_split else 0)
        self._transform_tree(x0, y0, x0, y0, log2_size, 0, 0,
                             intra_split, max_depth, True, True)

    def _parse_merge_idx(self, max_cand: int | None = None) -> int:
        e = self.e
        if max_cand is None:
            max_cand = self.max_merge
        if max_cand <= 1:
            return 0
        if not e.decode_bin(OFF["merge_idx"]):
            return 0
        idx = 1
        while idx < max_cand - 1 and e.decode_bypass():
            idx += 1
        return idx

    def _motion_field(self):
        from hevcbench.reference.inter import MotionField
        from hevcbench.reference.syntax import MODE_INTER
        import numpy as np
        mf = MotionField(*self.d.pred_mode.shape)
        mf.mv = self.d.mv
        coded_inter = (self.d.pred_mode == MODE_INTER) & self._coded_mask
        if self.d.inter_dir is not None:
            mf.ref = np.where(coded_inter & ((self.d.inter_dir & 1) != 0),
                              0, -1)
            mf.mv1 = self.d.mv_l1
            mf.ref1 = np.where(coded_inter & ((self.d.inter_dir & 2) != 0),
                               0, -1)
        else:
            r0 = (self.d.ref_idx.astype(np.int32)
                  if self.d.ref_idx is not None else 0)
            mf.ref = np.where(coded_inter, r0, -1)
        return mf

    def _apply_merge(self, x0, y0, size, idx, sl8, pw=None, ph=None,
                     part="2Nx2N", pu_idx=0):
        from hevcbench.reference.inter import (merge_candidates,
                                                    merge_candidates_b,
                                                    merge_candidates_rect)
        mf = self._motion_field()
        self.d.merge_idx[sl8] = idx
        if pw is not None and pw != ph:
            # rect PU merge: rect positions + exclusions (uni-L0 fields:
            # the spatial part coincides with the decoder's B list)
            cands, _ = merge_candidates_rect(
                mf, x0, y0, pw, ph, part, pu_idx, self.ps.ctu_size,
                self.d.width, self.d.height)
            mv = cands[idx]
            self.d.mv[sl8[0], sl8[1], 0] = mv[0]
            self.d.mv[sl8[0], sl8[1], 1] = mv[1]
            if self.d.ref_idx is not None:
                self.d.ref_idx[sl8] = mv[2]
            if self.d.inter_dir is not None:
                self.d.inter_dir[sl8] = 1
            self._mark_coded(sl8)
            return
        if self.slice_type == SLICE_B and self.d.inter_dir is not None:
            cands = merge_candidates_b(mf, x0, y0, size, self.ps.ctu_size,
                                       self.d.width, self.d.height,
                                       self.ref_dists)
            cdir, m0, m1 = cands[idx]
            self.d.inter_dir[sl8] = cdir
            if cdir & 1:
                self.d.mv[sl8[0], sl8[1], 0] = m0[0]
                self.d.mv[sl8[0], sl8[1], 1] = m0[1]
            if cdir & 2:
                self.d.mv_l1[sl8[0], sl8[1], 0] = m1[0]
                self.d.mv_l1[sl8[0], sl8[1], 1] = m1[1]
            self._mark_coded(sl8)
            return
        cands, _ = merge_candidates(mf, x0, y0, size, self.ps.ctu_size,
                                    self.d.width, self.d.height)
        mv = cands[idx]
        self.d.mv[sl8[0], sl8[1], 0] = mv[0]
        self.d.mv[sl8[0], sl8[1], 1] = mv[1]
        if self.d.ref_idx is not None:
            self.d.ref_idx[sl8] = mv[2]    # merge inherits the neighbour ref
        if self.d.inter_dir is not None:
            self.d.inter_dir[sl8] = 1
        self._mark_coded(sl8)

    def _mark_coded(self, sl8):
        self._coded_mask[sl8] = True

    def _parse_mvd(self):
        e = self.e
        g0x = e.decode_bin(OFF["mvd"])
        g0y = e.decode_bin(OFF["mvd"])
        g1x = e.decode_bin(OFF["mvd"] + 1) if g0x else 0
        g1y = e.decode_bin(OFF["mvd"] + 1) if g0y else 0
        out = []
        for g0, g1 in ((g0x, g1x), (g0y, g1y)):
            if not g0:
                out.append(0)
                continue
            v = 1
            if g1:
                v = 2 + self._parse_eg_bypass(1)
            if e.decode_bypass():
                v = -v
            out.append(v)
        return out[0], out[1]

    def _parse_ref_idx(self, num_ref: int) -> int:
        """Decoder twin of SliceDataEncoder._encode_ref_idx (TR cMax
        num_ref-1; ctxInc 0, 1, bypass)."""
        e = self.e
        if not e.decode_bin(OFF["ref_pic"]):
            return 0
        r = 1
        while r < num_ref - 1:
            b = (e.decode_bin(OFF["ref_pic"] + 1) if r == 1
                 else e.decode_bypass())
            if not b:
                break
            r += 1
        return r

    def _parse_cu_qp_delta(self) -> None:
        """Decoder twin of SliceDataEncoder._encode_cu_qp_delta (spec
        7.3.8.10/9.3.3.8: TU cMax 5 with ctx {dqp+0, dqp+1}, EG0, sign)."""
        e = self.e
        abs_d = 0
        if e.decode_bin(OFF["dqp"] + 0):
            abs_d = 1
            while abs_d < 5 and e.decode_bin(OFF["dqp"] + 1):
                abs_d += 1
            if abs_d == 5:
                abs_d = 5 + self._parse_eg_bypass(0)
            if e.decode_bypass():
                abs_d = -abs_d
        self._qg_qp = (self.qp_pred + abs_d + 52) % 52
        self._t("cu_qp_delta", abs_d)

    def _parse_eg_bypass(self, k: int) -> int:
        e = self.e
        v = 0
        while e.decode_bypass():
            v += 1 << k
            k += 1
        suffix = 0
        for _ in range(k):
            suffix = (suffix << 1) | e.decode_bypass()
        return v + suffix

    def _parse_inter_part(self, log2_size) -> str:
        """Inverse of part_mode binarization for inter CUs, AMP off
        (spec 9.3.3.7; reference writer hmr_arithmetic_encoding.c:436)."""
        e = self.e
        if e.decode_bin(OFF["part_size"]):
            return "2Nx2N"
        if e.decode_bin(OFF["part_size"] + 1):
            return "2NxN"
        if log2_size == self.ps.log2_min_cb and log2_size > 3:
            if e.decode_bin(OFF["part_size"] + 2):
                return "Nx2N"
            return "NxN"
        return "Nx2N"

    def _parse_pu_motion(self, x0, y0, pw, ph, depth, sl8, pu_idx, n_pu,
                         part="2Nx2N"):
        """Motion info for one PU (merge or AMVP; B adds inter_pred_idc —
        reference hmr_arithmetic_encoding.c:643,785)."""
        ps, e, d = self.ps, self.e, self.d
        merge = e.decode_bin(OFF["merge_flag"])
        if merge:
            idx = self._parse_merge_idx()
            self._apply_merge(x0, y0, max(pw, ph), idx, sl8, pw=pw, ph=ph,
                              part=part, pu_idx=pu_idx)
            d.inter_mode[sl8] = 1
            return True
        bi = False
        lst = 0
        if self.slice_type == SLICE_B:
            if n_pu == 1 or max(pw, ph) != 8:
                bi = bool(e.decode_bin(OFF["inter_dir"] + depth))
            if not bi:
                lst = e.decode_bin(OFF["inter_dir"] + 4)
        self.pu_stats["bi" if bi else ("l1" if lst else "l0")] += 1
        from hevcbench.reference.inter import (amvp_candidates,
                                                    amvp_candidates_2,
                                                    amvp_candidates_mref,
                                                    amvp_candidates_rect)
        two_list = d.inter_dir is not None and self.slice_type == SLICE_B
        num_ref = len(self.ref_dists_l0)
        cur_ref = 0
        if num_ref > 1 and (bi or not lst):
            cur_ref = self._parse_ref_idx(num_ref)
            if d.ref_idx is not None:
                d.ref_idx[sl8] = cur_ref
        cdir = 3 if bi else (2 if lst else 1)
        mv = None
        for ref_list in ((0, 1) if bi else (lst,)):
            if bi and ref_list == 1 and self.mvd_l1_zero:
                mvd_x = mvd_y = 0
            else:
                mvd_x, mvd_y = self._parse_mvd()
            f = e.decode_bin(OFF["mvp_idx"])
            if pw != ph:
                # rect PUs sample rect positions + same-CB exclusions;
                # emitted only uni-L0, so the single-list derivation is
                # the decoder's list-0 result
                mvp = amvp_candidates_rect(self._motion_field(), x0, y0,
                                           pw, ph, ps.ctu_size, d.width,
                                           d.height, part=part,
                                           pu_idx=pu_idx)
            elif two_list:
                mvp = amvp_candidates_2(self._motion_field(), x0, y0,
                                        max(pw, ph), ps.ctu_size, d.width,
                                        d.height, ref_list, self.ref_dists)
            elif num_ref > 1:
                mvp = amvp_candidates_mref(self._motion_field(), x0, y0,
                                           max(pw, ph), ps.ctu_size,
                                           d.width, d.height, cur_ref,
                                           self.ref_dists_l0)
            else:
                mvp = amvp_candidates(self._motion_field(), x0, y0,
                                      max(pw, ph), ps.ctu_size, d.width,
                                      d.height)
            mvv = (mvp[f][0] + mvd_x, mvp[f][1] + mvd_y)
            if two_list and ref_list == 1:
                d.mv_l1[sl8[0], sl8[1], 0] = mvv[0]
                d.mv_l1[sl8[0], sl8[1], 1] = mvv[1]
                d.mvp_flag_l1[sl8] = f
            elif mv is None:
                mv = mvv
                d.mvp_flag[sl8] = f
        if mv is not None:
            d.mv[sl8[0], sl8[1], 0] = mv[0]
            d.mv[sl8[0], sl8[1], 1] = mv[1]
        if d.inter_dir is not None:
            d.inter_dir[sl8] = cdir if self.slice_type == SLICE_B else 1
        d.inter_mode[sl8] = 2
        self._mark_coded(sl8)
        return False

    def _inter_cu(self, x0, y0, log2_size, sl8):
        ps, e, d = self.ps, self.e, self.d
        size = 1 << log2_size
        depth = ps.log2_ctu - log2_size
        part = self._parse_inter_part(log2_size)
        self.part_stats[part] = self.part_stats.get(part, 0) + 1
        if part == "2Nx2N":
            pus = [(x0, y0, size, size)]
        elif part == "2NxN":
            pus = [(x0, y0, size, size // 2),
                   (x0, y0 + size // 2, size, size // 2)]
        elif part == "Nx2N":
            pus = [(x0, y0, size // 2, size),
                   (x0 + size // 2, y0, size // 2, size)]
        else:
            h = size // 2
            pus = [(x0, y0, h, h), (x0 + h, y0, h, h),
                   (x0, y0 + h, h, h), (x0 + h, y0 + h, h, h)]
        if part in ("2NxN", "Nx2N"):
            if self.d.inter_part is None:
                self.d.inter_part = np.zeros(self.d.pred_mode.shape,
                                             np.uint8)
            self.d.inter_part[sl8] = 1 if part == "2NxN" else 2
        all_merge = True
        for i, (px, py, pw, ph) in enumerate(pus):
            psl8 = (slice(py // 8, (py + ph) // 8 or py // 8 + 1),
                    slice(px // 8, (px + pw) // 8 or px // 8 + 1))
            m = self._parse_pu_motion(px, py, pw, ph, depth, psl8,
                                      i, len(pus), part)
            all_merge = all_merge and m
        if part == "2Nx2N" and all_merge:
            rcbf = 1  # inferred for merge 2Nx2N
        else:
            rcbf = e.decode_bin(OFF["qt_root_cbf"])
        d.root_cbf[sl8] = rcbf
        if rcbf:
            # interSplitFlag: max_tr_depth_inter==0 with a non-square
            # partition forces one split (spec 7.4.9.8)
            forced = (ps.max_tr_depth_inter == 0 and part != "2Nx2N")
            self._transform_tree(x0, y0, x0, y0, log2_size, 0, 0,
                                 forced, ps.max_tr_depth_inter
                                 + (1 if forced else 0), True, True)

    def _transform_tree(self, x0, y0, x_base, y_base, log2_size, depth, blk_idx,
                        intra_split, max_depth, parent_cbf_cb, parent_cbf_cr):
        ps, e, d = self.ps, self.e, self.d
        size = 1 << log2_size
        if (log2_size <= ps.log2_max_tb and log2_size > ps.log2_min_tb
                and depth < max_depth and not (intra_split and depth == 0)):
            split = e.decode_bin(OFF["trans_subdiv"] + (5 - log2_size))
        else:
            split = 1 if (log2_size > ps.log2_max_tb
                          or (intra_split and depth == 0)) else 0
        self._t("tr_split", x0, y0, depth, split)
        cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if log2_size > 2:
            if parent_cbf_cb:
                cbf_cb = e.decode_bin(OFF["qt_cbf"] + 4 + depth)
            else:
                cbf_cb = 0
            if parent_cbf_cr:
                cbf_cr = e.decode_bin(OFF["qt_cbf"] + 4 + depth)
            else:
                cbf_cr = 0
            self._t("cbf_chroma", x0, y0, depth, cbf_cb, cbf_cr)
        if split:
            half = size >> 1
            self.d.tr_depth[y0 // 8:(y0 + size) // 8,
                            x0 // 8:(x0 + size) // 8] = depth + 1
            for i, (dy, dx) in enumerate(((0, 0), (0, half), (half, 0), (half, half))):
                self._transform_tree(x0 + dx, y0 + dy, x0, y0, log2_size - 1,
                                     depth + 1, i, intra_split, max_depth,
                                     cbf_cb, cbf_cr)
            return
        if self._is_intra_at(x0, y0) or depth != 0 or cbf_cb or cbf_cr:
            cbf_luma = e.decode_bin(OFF["qt_cbf"] + (1 if depth == 0 else 0))
        else:
            cbf_luma = 1  # inter root with no chroma cbf: inferred
        self._t("cbf_luma", x0, y0, depth, cbf_luma)
        self._transform_unit(x0, y0, x_base, y_base, log2_size, depth, blk_idx,
                             cbf_luma, cbf_cb, cbf_cr)

    def _transform_unit(self, x0, y0, x_base, y_base, log2_size, depth, blk_idx,
                        cbf_luma, cbf_cb, cbf_cr):
        d = self.d
        if log2_size == 2 and blk_idx != 3:
            # chroma handled at blk 3; presence check uses parent cbfs
            if not cbf_luma:
                return
            cbf_cb = cbf_cr = 0
        if log2_size == 2 and blk_idx == 3:
            pass  # cbf_cb/cr from parent level apply to the joint 4x4 chroma
        if not (cbf_luma or cbf_cb or cbf_cr):
            return
        if self.ps.cu_qp_delta_enabled and not self.cu_qp_delta_coded:
            self._parse_cu_qp_delta()
            self.cu_qp_delta_coded = True
        size = 1 << log2_size
        if cbf_luma:
            mode = self._luma_mode_at(x0, y0)
            scan = T.intra_scan_idx(mode, log2_size, True) \
                if self._is_intra_at(x0, y0) else T.SCAN_DIAG
            blk = self._residual_coding(log2_size, 0, scan)
            d.coef_y[y0:y0 + size, x0:x0 + size] = blk
        if log2_size > 2 or blk_idx == 3:
            if log2_size > 2:
                cx, cy, clog2 = x0 // 2, y0 // 2, log2_size - 1
                cmx, cmy = x0, y0
            else:
                cx, cy, clog2 = x_base // 2, y_base // 2, 2
                cmx, cmy = x_base, y_base
            cmode = int(d.chroma_mode[cmy // 8, cmx // 8])
            cscan = T.intra_scan_idx(cmode, clog2, False) \
                if self._is_intra_at(cmx, cmy) else T.SCAN_DIAG
            csz = 1 << clog2
            if cbf_cb:
                d.coef_u[cy:cy + csz, cx:cx + csz] = \
                    self._residual_coding(clog2, 1, cscan)
            if cbf_cr:
                d.coef_v[cy:cy + csz, cx:cx + csz] = \
                    self._residual_coding(clog2, 2, cscan)

    # ---- residual ------------------------------------------------------------

    def _residual_coding(self, log2_size, c_idx, scan_idx) -> np.ndarray:
        e = self.e
        size = 1 << log2_size
        scan = T.coeff_scan(log2_size, scan_idx)
        scoefs = np.zeros(size * size, np.int64)
        last_x = self._decode_last_component(log2_size, c_idx, OFF["last_x"])
        last_y = self._decode_last_component(log2_size, c_idx, OFF["last_y"])
        # suffixes come interleaved after both prefixes in spec order:
        # x_prefix, y_prefix, x_suffix, y_suffix — handled in caller order
        last_x = self._decode_last_suffix(last_x)
        last_y = self._decode_last_suffix(last_y)
        if scan_idx == T.SCAN_VER:
            last_x, last_y = last_y, last_x
        # find last scan pos
        raster = last_y * size + last_x
        last_pos = int(np.where(scan == raster)[0][0])
        self._t("last", c_idx, last_x, last_y)

        ncg = max(1, size // 4)
        num_cg = (last_pos >> 4) + 1
        cg_order = T.cg_scan(log2_size, scan_idx)
        cg_nz = np.zeros(ncg * ncg, bool)

        def cg_right_below(ci_scan):
            r = int(cg_order[ci_scan])
            cgx, cgy = r % ncg, r // ncg
            res = 0
            if cgx + 1 < ncg and cg_nz[np.where(cg_order == r + 1)[0][0]]:
                res |= 1
            if cgy + 1 < ncg and cg_nz[np.where(cg_order == r + ncg)[0][0]]:
                res |= 2
            return res

        c1 = 1
        for ci in range(num_cg - 1, -1, -1):
            cg_start = ci * 16
            in_last_cg = ci == num_cg - 1
            prev_csbf = cg_right_below(ci)
            infer_sb_dc = False
            if in_last_cg or ci == 0:
                coded_sb = 1
            else:
                ctx = OFF["sig_cg"] + (2 if c_idx else 0) + (1 if prev_csbf else 0)
                coded_sb = e.decode_bin(ctx)
                infer_sb_dc = True
            cg_nz[ci] = bool(coded_sb)
            if not coded_sb:
                continue
            start_n = min(15, last_pos - cg_start) if in_last_cg else 15
            sig_positions = []
            num_sig_found = 0
            for n in range(start_n, -1, -1):
                pos = cg_start + n
                if in_last_cg and pos == last_pos:
                    sig_positions.append(pos)
                    num_sig_found += 1
                    continue
                if n == 0 and infer_sb_dc and num_sig_found == 0:
                    sig_positions.append(pos)
                    continue
                r = int(scan[pos])
                px, py = r % size, r // size
                ctx_inc = sig_ctx(px, py, log2_size, c_idx, scan_idx,
                                  prev_csbf)
                sig = e.decode_bin(OFF["sig"] + (27 if c_idx else 0) + ctx_inc)
                if sig:
                    sig_positions.append(pos)
                    num_sig_found += 1
            n_nz = len(sig_positions)
            if n_nz == 0:
                continue
            first_nz_scan = sig_positions[-1] - cg_start
            last_nz_scan = sig_positions[0] - cg_start
            hide_sign = (self.ps.sign_hiding
                         and (last_nz_scan - first_nz_scan) >= T.SBH_THRESHOLD)
            ctx_set = 2 if (ci > 0 and c_idx == 0) else 0
            if c1 == 0:
                ctx_set += 1
            c1 = 1
            base_one = OFF["one"] + (16 if c_idx else 0) + 4 * ctx_set
            num_g1 = min(n_nz, 8)
            g1 = []
            first_g1_idx = -1
            for i in range(num_g1):
                b = e.decode_bin(base_one + c1)
                g1.append(b)
                if b:
                    c1 = 0
                    if first_g1_idx < 0:
                        first_g1_idx = i
                elif 0 < c1 < 3:
                    c1 += 1
            g2 = 0
            if first_g1_idx >= 0:
                g2 = e.decode_bin(OFF["abs"] + (4 if c_idx else 0) + ctx_set)
            n_signs = n_nz - 1 if hide_sign else n_nz
            signs = [e.decode_bypass() for _ in range(n_signs)]
            # levels
            abs_vals = []
            for i in range(n_nz):
                if i < num_g1:
                    base = 1 + g1[i] + (g2 if i == first_g1_idx else 0)
                else:
                    base = 1
                abs_vals.append(base)
            if c1 == 0 or n_nz > 8:
                go_rice = 0
                first_coeff2 = 1
                for i in range(n_nz):
                    base_level = (2 + first_coeff2) if i < 8 else 1
                    if abs_vals[i] >= base_level:
                        rem = self._decode_remaining(go_rice)
                        abs_vals[i] = base_level + rem
                        if abs_vals[i] > (3 << go_rice):
                            go_rice = min(go_rice + 1, 4)
                    if abs_vals[i] >= 2:
                        first_coeff2 = 0
            # reconstruct signs incl. hidden
            if hide_sign:
                total = sum(abs_vals)
                hidden_negative = (total & 1) == 1
                signs = signs + [1 if hidden_negative else 0]
            vals = [a * (-1 if s else 1) for a, s in zip(abs_vals, signs)]
            for p, vv in zip(sig_positions, vals):
                scoefs[p] = vv
        out = np.zeros(size * size, np.int32)
        out[scan] = scoefs
        return out.reshape(size, size)

    def _decode_remaining(self, r_param: int) -> int:
        e = self.e
        prefix = 0
        while prefix < 32 and e.decode_bypass():
            prefix += 1
        if prefix < 3:
            suffix = e.decode_bypass_bins(r_param) if r_param else 0
            return (prefix << r_param) + suffix
        length = prefix - 3 + r_param
        suffix = e.decode_bypass_bins(length) if length else 0
        return (((1 << (prefix - 3)) + 2) << r_param) + suffix

    def _decode_last_component(self, log2_size, c_idx, base) -> int:
        e = self.e
        if c_idx == 0:
            ctx_offset = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
            ctx_shift = (log2_size + 1) >> 2
        else:
            ctx_offset = 15  # chroma contexts start at 15 within the element
            ctx_shift = log2_size - 2
        g_max = (log2_size << 1) - 1
        prefix = 0
        while prefix < g_max and e.decode_bin(base + ctx_offset + (prefix >> ctx_shift)):
            prefix += 1
        return prefix  # suffix applied later

    def _decode_last_suffix(self, prefix: int) -> int:
        if prefix <= 3:
            return prefix
        e = self.e
        suffix_len = (prefix >> 1) - 1
        suffix = e.decode_bypass_bins(suffix_len)
        return ((2 + (prefix & 1)) << suffix_len) + suffix


# ---- whole streams (the port's own; the JAX module parses payloads) -------

def _expect(ok: bool, what) -> None:
    """Raise ValueError naming the syntax element a stream got wrong."""
    if not ok:
        raise ValueError(f"unexpected {what}")


def split_annexb(stream: bytes) -> list[bytes]:
    """The NAL units of an Annex-B stream (start codes dropped; a NAL's
    trailing zero bytes belong to the next start code)."""
    out = []
    i = stream.find(b"\x00\x00\x01")
    while i >= 0:
        j = stream.find(b"\x00\x00\x01", i + 3)
        end = len(stream) if j < 0 else j
        out.append(stream[i + 3:end].rstrip(b"\x00"))
        i = j
    return out


def read_slice_header(ps: ParamSets, br, nal_type: int) -> dict:
    """Read the slice segment header that the port's write_slice_header
    writes (one slice per picture, under the SPS and PPS that
    headers.parse_parameter_sets accepts) up to
    its byte alignment. Returns the slice type, POC (the LSBs; 0 for an
    IDR), QP, SAO flags, each reference list's first POC distance
    (ref_dists, as the pipeline derives them), the POC distance of each
    active list-0 reference of a multi-reference slice (ref_dists_l0,
    None with one) and the WPP entry point offsets."""
    irap = 16 <= nal_type <= 23
    idr = nal_type in (19, 20)
    _expect(br.read(1) == 1, "first_slice_segment_in_pic_flag")
    if irap:
        br.read(1)                          # no_output_of_prior_pics_flag
    _expect(br.read_ue() == 0, "slice_pic_parameter_set_id")
    st = br.read_ue()
    poc, before, after = 0, [], []
    if not idr:
        poc = br.read(ps.log2_max_poc_lsb)
        _expect(br.read(1) == 0, "short_term_ref_pic_set_sps_flag")
        n_neg, n_pos = br.read_ue(), br.read_ue()
        prev = poc
        for _ in range(n_neg):
            prev -= br.read_ue() + 1
            _expect(br.read(1) == 1, "used_by_curr_pic_s0_flag")
            before.append(prev)
        prev = poc
        for _ in range(n_pos):
            prev += br.read_ue() + 1
            _expect(br.read(1) == 1, "used_by_curr_pic_s1_flag")
            after.append(prev)
    sao = (False, False)
    if ps.sao_enabled:
        sao = (bool(br.read(1)), bool(br.read(1)))
    l1_swap = False
    num_ref_l0 = 1
    if st != SLICE_I:
        if br.read(1):                      # num_ref_idx_active_override
            num_ref_l0 = br.read_ue() + 1
            if st == SLICE_B:
                br.read_ue()
        npt = len(before) + len(after)
        if npt > 1:
            nbits = max(1, (npt - 1).bit_length())
            _expect(br.read(1) == 0, "ref_pic_list_modification_flag_l0")
            if st == SLICE_B and br.read(1):
                _expect(br.read(nbits) == 1, "list_entry_l1[0]")
                l1_swap = True
        if st == SLICE_B:
            _expect(br.read(1) == 0, "mvd_l1_zero_flag")
        _expect(br.read_ue() == 0, "five_minus_max_num_merge_cand")
    qp = ps.init_qp + br.read_se()
    if sao[0] or sao[1] or ps.deblocking_enabled:
        br.read(1)               # slice_loop_filter_across_slices_enabled
    offsets = []
    if ps.wpp:
        n = br.read_ue()
        if n:
            nbits = br.read_ue() + 1
            offsets = [br.read(nbits) + 1 for _ in range(n)]
    _expect(br.read(1) == 1, "alignment_bit_equal_to_one")
    br.byte_align()
    l0 = before[0] if before else (after[0] if after else poc - 1)
    if after:
        l1 = after[0]
    elif l1_swap and len(before) >= 2:
        l1 = before[1]
    else:
        l1 = l0
    rdl0 = (tuple(poc - b for b in before[:num_ref_l0])
            if num_ref_l0 > 1 else None)
    return dict(slice_type=st, poc=poc, qp=qp, sao=sao,
                ref_dists=(poc - l0, poc - l1), ref_dists_l0=rdl0,
                entry_points=offsets)


def parse_slice_nal(ps: ParamSets, nal: bytes, parser=None):
    """Parse one slice NAL of a stream coded with `ps` (its picture size in
    whole CTUs): its header, then every CTU of its slice data, one CABAC
    substream per CTU row under WPP (contexts from
    the state after the second CTB of the row above, the QP predictor
    reset to the slice QP). parser: the slice-data parser class
    (SliceDataParser by default; another with its constructor). Returns
    (header dict, parser) with the parsed FrameDesc in parser.d and the
    SAO parameters in parser.sao."""
    from hevcbench.reference.bitstream import _ebsp_positions
    from hevcbench.reference.cabac_dec import BitReader, unescape_ebsp
    from hevcbench.reference.ctx_tables import init_contexts
    nal_type = (nal[0] >> 1) & 0x3F
    rbsp = unescape_ebsp(nal[2:])
    br = BitReader(rbsp)
    hdr = read_slice_header(ps, br, nal_type)
    st = hdr["slice_type"]
    name = {SLICE_I: "I", SLICE_B: "B"}.get(st, "P")
    qp = hdr["qp"]
    # the slice data's substreams, at escaped byte offsets (spec 7.4.7.1)
    # from the data's first byte, itself after the header's escapes
    hl = br.pos >> 3
    start = 2 + hl + sum(1 for q in _ebsp_positions(rbsp) if q < hl)
    bounds = [start]
    for off in hdr["entry_points"]:
        bounds.append(bounds[-1] + off)
    bounds.append(len(nal))
    subs = [unescape_ebsp(nal[a:b]) for a, b in zip(bounds, bounds[1:])]
    p = (parser or SliceDataParser)(ps, ps.pic_width, ps.pic_height,
                                    CabacDecoder(BitReader(subs[0]),
                                                 init_contexts(name, qp)),
                                    st, qp, sao_enabled=any(hdr["sao"]),
                                    ref_dists=hdr["ref_dists"],
                                    ref_dists_l0=hdr["ref_dists_l0"])
    saved = None
    for cy in range(ps.ctus_y):
        if ps.wpp and cy > 0:
            ctx = init_contexts(name, qp) if saved is None else saved.copy()
            p.e = CabacDecoder(BitReader(subs[cy]), ctx)
            p.qp_pred = qp
        for cx in range(ps.ctus_x):
            p.parse_ctu(cx, cy)
            last = cy == ps.ctus_y - 1 and cx == ps.ctus_x - 1
            _expect(p.parse_ctu_end() == int(last),
                    f"end_of_slice_segment_flag at CTU ({cx}, {cy})")
            if ps.wpp and cx == 1:
                saved = p.e.ctx.copy()
        if ps.wpp and cy != ps.ctus_y - 1:
            _expect(p.e.decode_terminate() == 1, "end_of_subset_one_bit")
    return hdr, p


def desc_mismatches(got, want, sao_got=None, sao_want=None) -> list[str]:
    """The fields in which a parsed FrameDesc `got` (and its SAO
    parameters) differ from the serialized `want`, compared where the
    syntax carries them: CU depths, prediction modes and every
    coefficient level; intra luma and chroma modes in intra CUs; skip
    flags; each list's MV where that list predicts, and list 0's
    reference index in a multi-reference slice; the QP in 8x8 units
    with a coded level (before a quantization group's first coded CU the
    decoder keeps the predicted QP); SAO types and merges, offsets of the
    CTBs that apply them (magnitudes for edge offsets, whose signs the
    class fixes), band positions and edge classes."""
    from hevcbench.reference.syntax import MODE_INTER, MODE_INTRA
    want = want.densify()
    bad = []

    def check(name, ok):
        if not ok:
            bad.append(name)
    for f in ("cu_depth", "pred_mode", "coef_y", "coef_u", "coef_v"):
        check(f, np.array_equal(getattr(got, f), getattr(want, f)))
    intra8 = want.pred_mode == MODE_INTRA
    intra4 = np.repeat(np.repeat(intra8, 2, 0), 2, 1)
    check("luma_mode", np.array_equal(got.luma_mode[intra4],
                                      want.luma_mode[intra4]))
    check("chroma_mode", np.array_equal(got.chroma_mode[intra8],
                                        want.chroma_mode[intra8]))
    inter8 = want.pred_mode == MODE_INTER
    if want.skip is not None and inter8.any():
        check("skip", np.array_equal(got.skip[inter8] != 0,
                                     want.skip[inter8] != 0))
    if inter8.any():
        d = (want.inter_dir if want.inter_dir is not None
             else np.ones_like(want.pred_mode))
        l0 = inter8 & ((d & 1) != 0)
        check("mv", np.array_equal(got.mv[l0], want.mv[l0]))
        if want.ref_idx is not None:
            check("ref_idx", got.ref_idx is not None and np.array_equal(
                got.ref_idx[l0], want.ref_idx[l0]))
        if got.inter_dir is not None and want.inter_dir is not None:
            check("inter_dir", np.array_equal(got.inter_dir[inter8],
                                              want.inter_dir[inter8]))
            l1 = inter8 & ((d & 2) != 0)
            check("mv_l1", np.array_equal(got.mv_l1[l1], want.mv_l1[l1]))
    if want.qp_map is not None:
        h8, w8 = want.qp_map.shape

        def nz(plane, n):
            return (plane.reshape(h8, n, w8, n) != 0).any(axis=(1, 3))
        coded = (nz(want.coef_y, 8) | nz(want.coef_u, 4)
                 | nz(want.coef_v, 4))
        check("qp_map", got.qp_map is not None and np.array_equal(
            got.qp_map[coded].astype(np.int32),
            want.qp_map[coded].astype(np.int32)))
    if sao_want is not None or sao_got is not None:
        if sao_want is None or sao_got is None:
            return bad + ["sao"]
        q, r = sao_got, sao_want
        for f in ("merge_left", "merge_up", "type_luma", "type_chroma"):
            check(f"sao.{f}", np.array_equal(getattr(q, f), getattr(r, f)))
        for c, types in ((0, r.type_luma), (1, r.type_chroma),
                         (2, r.type_chroma)):
            bo, eo = types == 1, types == 2
            check(f"sao.offsets[{c}]",
                  np.array_equal(q.offsets[bo, c], r.offsets[bo, c])
                  and np.array_equal(np.abs(q.offsets[eo, c]),
                                     np.abs(r.offsets[eo, c])))
            check(f"sao.band_pos[{c}]", np.array_equal(q.band_pos[bo, c],
                                                       r.band_pos[bo, c]))
        check("sao.eo_class", np.array_equal(
            q.eo_class_luma[r.type_luma == 2],
            r.eo_class_luma[r.type_luma == 2]) and np.array_equal(
            q.eo_class_chroma[r.type_chroma == 2],
            r.eo_class_chroma[r.type_chroma == 2]))
    return bad
