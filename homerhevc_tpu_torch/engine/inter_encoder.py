"""P-frame encoder, flat CU16 (PyTorch port of the flat path of
homerhevc_tpu/engine/inter_encoder.py TpuInterEncoder).

All CUs of a P frame are one batch (no intra-frame dependency): a
hierarchical full-pel search (2x-decimated coarse sweep -> top-K votes ->
shortlist + exact +-4 fine sweep at full resolution), half/quarter-pel
refinement, luma MC + T/Q/SBH/zero-forcing, the batched merge-RD stage,
chroma MC + residual, BS-map luma deblocking, device SAO and the compact
wire.
Bit-exact to the JAX program and to golden encode_inter_frame
(merge_rd="fast").

The coarse sweep runs the hand-written CUDA kernel on a CUDA device
(ops/me_sad.py); there is no gate at the call site.

Not ported yet (the pipeline refuses such configs, engine/pipeline.py
unported): the CU32/CU64 tree, the FAR level (me_range > 32), intra-in-P,
per-CTB QP maps and the bi-predicted program.
"""

from __future__ import annotations

import numpy as np
import torch

from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.hevc import tables as T
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.hevc.inter_syntax import (MERGE_FAST_BITS_BASE,
                                                   select_inter_syntax,
                                                   zf_multiplier)
from homerhevc_tpu_torch.hevc.syntax import MODE_INTER, FrameDesc
from homerhevc_tpu_torch.utils.profiler import PROFILER
from homerhevc_tpu_torch.device import resolve_device
from homerhevc_tpu_torch.engine.intra_encoder import (DevicePlane, _sh1,
                                                      _u8, _parse_cg_wire,
                                                      _unpack_cg_frame,
                                                      as_device_plane)
from homerhevc_tpu_torch.ops.deblock import deblock_luma_bs
from homerhevc_tpu_torch.ops.interp import (LUMA_TAPS, extract_patches,
                                            mc_chroma_batch)
from homerhevc_tpu_torch.ops.me_sad import coarse_sweep_sads
from homerhevc_tpu_torch.ops.pack import (cg_cap, esc_capacity,
                                          pack_capacity, pack_sparse_cg)
from homerhevc_tpu_torch.ops.quant import (dequantize, quantize,
                                           sign_bit_hiding)
from homerhevc_tpu_torch.ops.sao_dev import (pack_params, params_nbytes,
                                             sao_analyze_apply,
                                             sao_lambda_x256, unpack_params)
from homerhevc_tpu_torch.ops.transform import (forward_transform,
                                               inverse_transform)
from homerhevc_tpu_torch.state import tables_to_torch


def pad_edge(x: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """Edge (replicate) padding of a 2D integer plane by clamped index
    vectors (F.pad's replicate mode wants float, 3D/4D input)."""
    H, W = x.shape
    rows = torch.clamp(torch.arange(-py, H + py, device=x.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-px, W + px, device=x.device), 0, W - 1)
    return x.index_select(0, rows).index_select(1, cols)


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """out[y] = x[y-1], 0 at y=0 (dim 0)."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def select_intra_independent(want: torch.Tensor) -> torch.Tensor:
    """Twin of golden select_intra_independent (king-graph 4-class sweep):
    a subset of `want` (gh, gw) bool with no two selected CUs adjacent."""
    gh, gw = want.shape
    dev = want.device
    gy = (torch.arange(gh, device=dev) & 1)[:, None]
    gx = (torch.arange(gw, device=dev) & 1)[None, :]
    sel = torch.zeros_like(want)
    for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        p = torch.zeros((gh + 2, gw + 2), dtype=torch.bool, device=dev)
        p[1:-1, 1:-1] = sel
        blocked = (p[:-2, :-2] | p[:-2, 1:-1] | p[:-2, 2:]
                   | p[1:-1, :-2] | p[1:-1, 2:]
                   | p[2:, :-2] | p[2:, 1:-1] | p[2:, 2:])
        sel = sel | (want & (gy == cy) & (gx == cx) & ~blocked)
    return sel


class TorchInterEncoder:
    def __init__(self, ps: ParamSets, cfg: EncoderConfig, cu: int = 16,
                 search: int = 16, *, device):
        self.device = resolve_device(device)
        self.ps = ps
        self.cfg = cfg
        self.cu = cu
        self.search = search
        self.w, self.h = cfg.width, cfg.height
        assert self.w % cu == 0 and self.h % cu == 0
        if ps.ctu_size != cu or cu != 16:
            raise NotImplementedError("the torch P program is flat CU16")
        if cfg.me_range > max(32, 2 * search):
            raise NotImplementedError("the FAR ME level is not ported")
        if cfg.intra_in_p:
            raise NotImplementedError("intra-in-P is not ported")
        self.perf = int(getattr(cfg, "performance_mode", 0))
        self.merge_rd = (bool(getattr(cfg, "merge_rd_device", True))
                         and self.perf == 0)
        # maximum full-pel roam of any ME candidate (sets ref padding);
        # the shortlist bands stay inside it by construction
        self.reach = 2 * search + 2
        self.gw, self.gh = self.w // cu, self.h // cu
        n_tot = self.w * self.h * 3 // 2
        self.pack_C = pack_capacity(n_tot, max(0, cfg.qp - 4))
        self.cg_C = cg_cap(n_tot, max(0, cfg.qp - 4))
        self.tab = tables_to_torch(ps, cfg, self.device, cu)
        self.taps = torch.as_tensor(LUMA_TAPS, device=self.device)
        self.last_dev = None

    def _bits(self, v: torch.Tensor) -> torch.Tensor:
        """MVD rate of each component; |v| clamped to the table's end (as
        the JAX gather clamps out-of-range indices)."""
        t = self.tab["mvd_bits"]
        return t[torch.clamp(torch.abs(v), max=t.shape[0] - 1).long()]

    def _hier_me(self, sy, ry, lam16: int):
        """Hierarchical shortlist full-pel ME vs one reference plane
        (golden twin: hier_pel_fields). Returns (mvs (B,2) qpel, prior)."""
        cu = self.cu
        gw, gh = self.gw, self.gh
        R = self.search
        dev = self.device
        side = 2 * R + 1
        K, G16 = 3, 8

        def decim(p):
            h2, w2 = (p.shape[0] // 2) * 2, (p.shape[1] // 2) * 2
            q = p[:h2, :w2]
            return (q[0::2, 0::2] + q[1::2, 0::2]
                    + q[0::2, 1::2] + q[1::2, 1::2] + 2) >> 2

        m = cu // 2
        sd8 = decim(sy).to(torch.uint8).contiguous()      # (gh*m, gw*m)
        rd = decim(ry)
        pad_c = pad_edge(rd.to(torch.uint8), R, R).contiguous()
        # coarse sweep: the hand-written kernel on CUDA (plain on CPU)
        sads = coarse_sweep_sads(sd8, pad_c, R, m)
        n_off = side * side
        ks = torch.arange(n_off, dtype=torch.int32, device=dev)

        # prior + top-K votes -> G16 global shortlist offsets
        gq = sads.sum(dim=(1, 2), dtype=torch.int64).argmin()
        prior = torch.stack([8 * (gq % side - R),
                             8 * (torch.div(gq, side, rounding_mode="floor")
                                  - R)]).to(torch.int32)
        rate = (self._bits(8 * (ks % side - R) - prior[0])
                + self._bits(8 * (torch.div(ks, side, rounding_mode="floor")
                                  - R) - prior[1]))
        cost = 4 * sads + ((lam16 * rate) >> 4)[:, None, None]
        cc = cost.reshape(n_off, -1).clone()
        cols = torch.arange(cc.shape[1], device=dev)
        hist = torch.zeros(n_off, dtype=torch.int32, device=dev)
        ones = torch.ones(cc.shape[1], dtype=torch.int32, device=dev)
        for _ in range(K):
            kb = cc.argmin(dim=0)
            hist.index_add_(0, kb, ones)
            cc[kb, cols] = 1 << 30
        short16 = []
        for _ in range(G16):
            kg = hist.argmax()
            short16.append(kg)
            hist.index_fill_(0, kg.reshape(1), -1)

        # offset list: exact +-4 fine sweep, then the shortlist
        # neighbourhoods (golden order: argmin first-min == the golden
        # sequential strict-< scan)
        Fr = 4
        nf = 2 * Fr + 1
        fine_k = torch.arange(nf * nf, dtype=torch.int32, device=dev)
        all_dx = [fine_k % nf - Fr]
        all_dy = [torch.div(fine_k, nf, rounding_mode="floor") - Fr]
        go = torch.arange(25, dtype=torch.int32, device=dev)
        grid_dx = go % 5 - 2
        grid_dy = torch.div(go, 5, rounding_mode="floor") - 2
        centers = []
        for kg in short16:
            cdx = (2 * (kg % side - R)).to(torch.int32)
            cdy = (2 * (torch.div(kg, side, rounding_mode="floor")
                        - R)).to(torch.int32)
            centers.append((cdx, cdy))
            all_dx.append(cdx + grid_dx)
            all_dy.append(cdy + grid_dy)
        all_dx = torch.cat(all_dx)
        all_dy = torch.cat(all_dy)
        n_offs_r = all_dx.shape[0]
        P = self.reach
        assert P >= 2 * R + 2      # shortlist bands lie inside the padding
        pad8F = pad_edge(ry.to(torch.uint8), P, P)
        sy16 = sy.to(torch.int16)

        def bsum16(diff):
            return diff.reshape(gh, cu, gw, cu).sum(dim=(1, 3),
                                                    dtype=torch.int32)
        sads_list = []
        for k in range(nf * nf):
            dx, dy = k % nf - Fr, k // nf - Fr
            sh = pad8F[P + dy:P + dy + self.h, P + dx:P + dx + self.w] \
                .to(torch.int16)
            sads_list.append(bsum16(torch.abs(sy16 - sh).to(torch.int32)))
        ar_h = torch.arange(self.h, device=dev)
        ar_w = torch.arange(self.w + 4, device=dev)
        for cdx, cdy in centers:
            cols_b = P + cdx - 2 + ar_w
            for oy in (-2, -1, 0, 1, 2):
                # a device-valued row band (lax.dynamic_slice twin)
                band = pad8F.index_select(0, P + cdy + oy + ar_h) \
                    .index_select(1, cols_b).to(torch.int16)
                for ox in range(5):
                    d = torch.abs(sy16 - band[:, ox:ox + self.w])
                    sads_list.append(bsum16(d.to(torch.int32)))
        sads_r = torch.stack(sads_list)                   # (n_offs_r, gh, gw)

        rate = (self._bits(4 * all_dx - prior[0])
                + self._bits(4 * all_dy - prior[1]))
        cost = sads_r.reshape(n_offs_r, -1) + ((lam16 * rate) >> 4)[:, None]
        bi = cost.argmin(dim=0)
        mvs = torch.stack([all_dx[bi], all_dy[bi]], dim=-1) * 4
        return mvs, prior

    # ---- device program -----------------------------------------------------

    def _impl(self, src_y, src_u, src_v, ref_y, ref_u, ref_v, zf_mult,
              qp: int):
        tab = self.tab
        cu, cuc = self.cu, self.cu // 2
        gw, gh = self.gw, self.gh
        dev = self.device
        sl = self.ps.scaling_list_enabled
        sy = src_y.to(torch.int32)
        su = src_u.to(torch.int32)
        sv = src_v.to(torch.int32)
        ry = ref_y.to(torch.int32)
        # host scalars from the numpy tables (no device round trip)
        qp_c = int(T.CHROMA_QP_MAP[min(max(qp + self.ps.cb_qp_offset, 0),
                                       57)])
        lam16 = int(T.LAMBDA_ME_X16_TAB[qp])
        mvs, prior = self._hier_me(sy, ry, lam16)

        # ---- sub-pel refinement (half then quarter) over one (n+8)^2
        # patch per block, all 16 quarter-pel phases interpolated ----
        B = gh * gw
        padL = self.reach + 8
        ref_padL = pad_edge(ry, padL, padL)
        taps = self.taps
        bidx = torch.arange(B, device=dev, dtype=torch.int32)
        x0s = (bidx % gw) * cu
        y0s = torch.div(bidx, gw, rounding_mode="floor") * cu
        src_blk = sy.reshape(gh, cu, gw, cu).permute(0, 2, 1, 3) \
            .reshape(B, cu, cu)
        me_prec = int(self.cfg.motion_estimation_precision)
        ar_b = torch.arange(B, device=dev)

        def make_v16(x0v, y0v, mv0, n):
            """(16, B, n+1, n+1) quarter-pel interpolations of the patch
            anchored one pel up-left of the full-pel mv0."""
            ix0, iy0 = mv0[:, 0] >> 2, mv0[:, 1] >> 2
            by = y0v + iy0 - 1 + padL - 3
            bx = x0v + ix0 - 1 + padL - 3
            patch = extract_patches(ref_padL, by, bx, n + 8)  # (B, n+8, n+8)
            h4 = sum(taps[:, k, None, None, None]
                     * patch[None, :, :, k:k + n + 1] for k in range(8))
            v = sum(taps[:, k, None, None, None, None]
                    * h4[None, :, :, k:k + n + 1, :] for k in range(8)) >> 6
            v16 = torch.clamp((v + 32) >> 6, 0, 255)
            return v16.reshape(16, -1, n + 1, n + 1), ix0, iy0

        def mc_v16(v16, ix0, iy0, mv, n):
            p = ((mv[:, 1] & 3) * 4 + (mv[:, 0] & 3)).long()
            oy = (mv[:, 1] >> 2) - (iy0 - 1)
            ox = (mv[:, 0] >> 2) - (ix0 - 1)
            sel = v16[p, ar_b[:mv.shape[0]]]                # (B, n+1, n+1)
            idx = (oy * 2 + ox)[:, None, None]
            return torch.where(
                idx == 0, sel[:, 0:n, 0:n],
                torch.where(idx == 1, sel[:, 0:n, 1:n + 1],
                            torch.where(idx == 2, sel[:, 1:n + 1, 0:n],
                                        sel[:, 1:n + 1, 1:n + 1])))

        def refine_with(v16, ix0, iy0, src_b, nb, mv_cur, step, pr):
            bc = torch.full((mv_cur.shape[0],), 1 << 30, dtype=torch.int32,
                            device=dev)
            bmv = mv_cur
            for dy in (-step, 0, step):
                for dx in (-step, 0, step):
                    cand = mv_cur + torch.tensor([dx, dy], dtype=torch.int32,
                                                 device=dev)
                    p = mc_v16(v16, ix0, iy0, cand, nb)
                    sad = torch.abs(src_b - p).sum(dim=(-1, -2),
                                                   dtype=torch.int32)
                    rt = (self._bits(cand[:, 0] - pr[0])
                          + self._bits(cand[:, 1] - pr[1]))
                    cost = sad + ((lam16 * rt) >> 4)
                    better = cost < bc
                    bc = torch.where(better, cost, bc)
                    bmv = torch.where(better[:, None], cand, bmv)
            return bmv

        v16, ix0, iy0 = make_v16(x0s, y0s, mvs, cu)
        if me_prec >= 1:
            mvs = refine_with(v16, ix0, iy0, src_blk, cu, mvs, 2, prior)
        if me_prec >= 2:
            mvs = refine_with(v16, ix0, iy0, src_blk, cu, mvs, 1, prior)

        def code(resid, n, q):
            coef = forward_transform(resid, False)
            lvl = quantize(coef, n, q, False, sl)
            if self.ps.sign_hiding:
                lvl = sign_bit_hiding(lvl, coef, n, q, False, 0, sl)
            rres = inverse_transform(dequantize(lvl, n, q, False, sl), False)
            return self._zero_force(resid, lvl, rres, zf_mult)

        def recon(pred, lvl, rres):
            nz = (lvl != 0).any(dim=-1).any(dim=-1)
            return torch.where(nz[:, None, None],
                               torch.clamp(pred + rres, 0, 255), pred)

        # ---- luma MC + residual ----
        pred = mc_v16(v16, ix0, iy0, mvs, cu)
        resid = src_blk - pred
        lvl, rres = code(resid, cu, qp)
        rec = recon(pred, lvl, rres)

        lam = tab["rd_lambda_p"][qp]                      # float32 scalar

        def model_cost(src_b, rec_b, lvl_b, bits_b):
            dd = (src_b - rec_b).to(torch.float32)
            ssd = (dd * dd).sum(dim=(-1, -2))
            nnzf = (lvl_b != 0).sum(dim=(-1, -2)).to(torch.float32)
            lsum = torch.abs(lvl_b).sum(dim=(-1, -2)).to(torch.float32)
            return ssd + lam * (3.0 * nnzf + lsum + bits_b)

        # ---- batched merge-RD (golden twin: merge_rd_fast): the first two
        # spec merge candidates from the pre-pass field, re-coded and
        # model-costed; a king-independent improving subset flips ----
        if self.merge_rd:
            mvg = mvs.reshape(gh, gw, 2)
            pad_m = torch.zeros((gh + 2, gw + 2, 2), dtype=mvs.dtype,
                                device=dev)
            pad_m[1:-1, 1:-1] = mvg
            gxs_g = torch.arange(gw, device=dev)[None, :]
            gys_g = torch.arange(gh, device=dev)[:, None]
            zb = torch.zeros((gh, gw), dtype=torch.bool, device=dev)
            va1 = (gxs_g > 0) | zb
            vb1 = (gys_g > 0) | zb
            vb0 = ((gys_g > 0) & (gxs_g < gw - 1)) | zb
            vb2 = ((gys_g > 0) & (gxs_g > 0)) | zb
            a1 = pad_m[1:1 + gh, 0:gw]
            b1 = pad_m[0:gh, 1:1 + gw]
            b0 = pad_m[0:gh, 2:2 + gw]
            b2 = pad_m[0:gh, 0:gw]

            def neq(pm, qm, vq):
                return ~vq | (pm != qm).any(dim=-1)
            kept = torch.stack([va1, vb1 & neq(b1, a1, va1),
                                vb0 & neq(b0, b1, vb1),
                                vb2 & neq(b2, a1, va1) & neq(b2, b1, vb1)])
            mvs_k = torch.stack([a1, b1, b0, b2])
            order = torch.cumsum(kept.to(torch.int32), dim=0) * kept
            cand = []
            for c in range(2):
                sel_c = torch.zeros((gh, gw, 2), dtype=torch.int32,
                                    device=dev)
                for s in range(4):
                    sel_c = torch.where((order[s] == c + 1)[..., None],
                                        mvs_k[s], sel_c)
                cand.append(sel_c.reshape(-1, 2))
            rt = (self._bits(mvs[:, 0] - prior[0])
                  + self._bits(mvs[:, 1] - prior[1])).to(torch.float32)
            # CU_AMVP_BITS == the 6.0 CU-overhead constant
            cur_cost = model_cost(src_blk, rec, lvl, 6.0 + rt)
            best_cost = torch.full((B,), float("inf"), dtype=torch.float32,
                                   device=dev)
            best_lvl, best_rec, best_mv = lvl, rec, mvs
            for c in range(2):
                mvc = cand[c]
                vC, ixC, iyC = make_v16(x0s, y0s, mvc, cu)
                predc = mc_v16(vC, ixC, iyC, mvc, cu)
                residc = src_blk - predc
                lvlc_, rrc_ = code(residc, cu, qp)
                recc_ = recon(predc, lvlc_, rrc_)
                cost = model_cost(src_blk, recc_, lvlc_,
                                  MERGE_FAST_BITS_BASE + c)
                same = (mvc == mvs).all(dim=-1)
                if c == 1:
                    same = same | (cand[1] == cand[0]).all(dim=-1)
                cost = torch.where(same, float("inf"), cost)
                better = cost < best_cost
                best_cost = torch.where(better, cost, best_cost)
                best_lvl = torch.where(better[:, None, None], lvlc_,
                                       best_lvl)
                best_rec = torch.where(better[:, None, None], recc_,
                                       best_rec)
                best_mv = torch.where(better[:, None], mvc, best_mv)
            want = (best_cost < cur_cost).reshape(gh, gw)
            selm = select_intra_independent(want).reshape(-1)
            mvs = torch.where(selm[:, None], best_mv, mvs)
            lvl = torch.where(selm[:, None, None], best_lvl, lvl)
            rec = torch.where(selm[:, None, None], best_rec, rec)
        nz = (lvl != 0).any(dim=-1).any(dim=-1)

        # ---- chroma MC + residual (after merge-RD so flipped CUs' chroma
        # codes at the final MV) ----
        padC = self.reach // 2 + 4    # full-pel chroma reach + filter taps
        cx0s, cy0s = x0s // 2, y0s // 2

        def chroma(src_c, ref_c):
            ref_padC = pad_edge(ref_c.to(torch.int32), padC, padC)
            predc = mc_chroma_batch(ref_padC, padC, cx0s, cy0s, cuc, mvs)
            src_cb = src_c.reshape(gh, cuc, gw, cuc).permute(0, 2, 1, 3) \
                .reshape(B, cuc, cuc)
            lvlc, rrc = code(src_cb - predc, cuc, qp_c)
            return lvlc, recon(predc, lvlc, rrc)

        lvl_u, rec_u = chroma(su, ref_u)
        lvl_v, rec_v = chroma(sv, ref_v)

        def unblock(blocks, n, hh, ww):
            return blocks.reshape(hh // n, ww // n, n, n) \
                .permute(0, 2, 1, 3).reshape(hh, ww)
        hc, wc = self.h // 2, self.w // 2
        recon_y = unblock(rec, cu, self.h, self.w)
        recon_u = unblock(rec_u, cuc, hc, wc)
        recon_v = unblock(rec_v, cuc, hc, wc)
        ly = unblock(lvl.to(torch.int16), cu, self.h, self.w)
        lu = unblock(lvl_u.to(torch.int16), cuc, hc, wc)
        lv = unblock(lvl_v.to(torch.int16), cuc, hc, wc)
        mvs16 = mvs.reshape(gh, gw, 2).to(torch.int16)
        if self.ps.deblocking_enabled:
            nz8 = nz.reshape(gh, gw).repeat_interleave(2, 0) \
                .repeat_interleave(2, 1)
            mv8 = mvs.reshape(gh, gw, 2).repeat_interleave(2, 0) \
                .repeat_interleave(2, 1)
            recon_y = self._deblock_inter(recon_y, nz8, mv8, qp)
        extra = [mvs16]
        if self.ps.sao_enabled:
            recon_y, recon_u, recon_v, sao_p = self._sao(
                sy, su, sv, recon_y, recon_u, recon_v, qp)
            extra.append(sao_p)
        return self._wire(recon_y, recon_u, recon_v, sy, extra, ly, lu, lv)

    def _deblock_inter(self, plane_y, nz8, mv8, qp):
        """BS maps (spec 8.7.2.4: nz or mv mismatch -> 1 on the TU16 grid)
        + device luma deblock. Chroma is untouched at BS<2 (8.7.2.5.5)."""
        h8, w8 = nz8.shape
        dev = self.device
        ux = torch.arange(w8, device=dev)[None, :]
        uy = torch.arange(h8, device=dev)[:, None]
        ts8 = 16
        vv = (ux > 0) & (((ux * 8) % ts8) == 0)
        vh = (uy > 0) & (((uy * 8) % ts8) == 0)
        dl = (torch.abs(mv8 - _sh1(mv8)) >= 4).any(dim=-1)
        dt = (torch.abs(mv8 - _shift_down(mv8)) >= 4).any(dim=-1)
        bs_v = (vv & (nz8 | _sh1(nz8) | dl)).to(torch.int32)
        bs_h = (vh & (nz8 | _shift_down(nz8) | dt)).to(torch.int32)
        return deblock_luma_bs(plane_y, bs_v, bs_h, qp)

    def _sao(self, sy, su, sv, recon_y, recon_u, recon_v, qp: int):
        """Device SAO decide + apply (ops/sao_dev.py): the filtered planes
        and the packed params for the wire meta."""
        ry_f, ru_f, rv_f, params = sao_analyze_apply(
            sy, su, sv, recon_y.to(torch.int32), recon_u.to(torch.int32),
            recon_v.to(torch.int32), self.ps.ctu_size, sao_lambda_x256(qp))
        return ry_f, ru_f, rv_f, pack_params(params)

    def _wire(self, recon_y, recon_u, recon_v, sy, extra, ly, lu, lv):
        """Device->host wire: recon planes stay on the device; levels go as
        the two-tier CG wire; the motion metadata and the per-row luma SSD
        (exact int32, for the avg_dist zero-forcing feedback) ride in the
        same uint8 buffer, fetched in one copy."""
        recon_y = recon_y.to(torch.uint8)
        recon_u = recon_u.to(torch.uint8)
        recon_v = recon_v.to(torch.uint8)
        d = recon_y.to(torch.int32) - sy
        row_ssd = (d * d).sum(dim=1, dtype=torch.int32)
        cg_bitmap, masks16, codes, esc_idx, esc_val, count, esc_count, \
            cg_count = pack_sparse_cg([ly, lu, lv], self.pack_C, self.cg_C)
        meta = torch.cat(
            [_u8(x.reshape(-1)) for x in extra]
            + [_u8(row_ssd), cg_bitmap, _u8(masks16), codes,
               _u8(esc_idx), _u8(esc_val), _u8(count.reshape(1)),
               _u8(esc_count.reshape(1)), _u8(cg_count.reshape(1))])
        return (recon_y, recon_u, recon_v, ly, lu, lv, meta)

    def _zero_force(self, resid, lvl, rres, zf_mult):
        """Reference-parity residual zero-forcing (hmr_motion_inter.c:106):
        per TU, drop the coded block when
        ssd_zero <= ssd_coded + zf_mult * sum|lvl| (float32, as golden)."""
        r = resid.to(torch.float32)
        ssd_zero = (r * r).sum(dim=(-1, -2))
        dc = (resid - rres).to(torch.float32)
        ssd_coded = (dc * dc).sum(dim=(-1, -2))
        lsum = torch.abs(lvl).sum(dim=(-1, -2)).to(torch.float32)
        drop = ssd_zero <= ssd_coded + zf_mult * lsum
        lvl = torch.where(drop[:, None, None], 0, lvl)
        rres = torch.where(drop[:, None, None], 0, rres)
        return lvl, rres

    # ---- host driver ---------------------------------------------------

    def dispatch(self, src, ref, avg_dist: float = 1000.0, qp=None):
        """Launch the device program; returns the device output tuple
        without any device->host copy. self.last_dev holds the
        (device-resident) post-deblock, post-SAO recon for chaining the
        next frame."""
        qp = self.cfg.qp if qp is None else int(qp)
        zf = torch.tensor(zf_multiplier(avg_dist, qp), dtype=torch.float32,
                          device=self.device)
        planes = [as_device_plane(a, self.device) for a in (*src, *ref)]
        with PROFILER.scope("disp_run"):
            out = self._impl(*planes, zf, qp)
        self.last_dev = (out[0], out[1], out[2])
        return out

    def fetch(self, out):
        """Download one dispatched frame's wire buffer and build the
        FrameDesc (host half of encode_frame); recon stays on the device."""
        recon_y, recon_u, recon_v, ly, lu, lv, meta = out
        meta_np = meta.cpu().numpy()
        gh, gw = self.gh, self.gw
        nmv = gh * gw * 4
        mvs = meta_np[:nmv].copy().view(np.int16).reshape(gh, gw, 2)
        off = nmv
        sao_params = None
        if self.ps.sao_enabled:
            sgh = self.h // self.ps.ctu_size
            sgw = self.w // self.ps.ctu_size
            nb = params_nbytes(sgh, sgw)
            sao_params = unpack_params(meta_np[off:off + nb], sgh, sgw)
            off += nb
        row_ssd = meta_np[off:off + self.h * 4].copy().view(np.int32)
        off += self.h * 4
        n_tot = self.w * self.h * 3 // 2
        E = esc_capacity(n_tot, self.pack_C)
        wire = _parse_cg_wire(meta_np[None, off:], 0, n_tot, self.pack_C,
                              self.cg_C, E)
        shapes = [(self.h, self.w), (self.h // 2, self.w // 2),
                  (self.h // 2, self.w // 2)]
        py, pu, pv = _unpack_cg_frame(
            wire, 0, n_tot, shapes,
            lambda: (ly.cpu().numpy(), lu.cpu().numpy(), lv.cpu().numpy()))
        cu = self.cu
        desc = FrameDesc.alloc(self.w, self.h)
        desc.pred_mode[:] = MODE_INTER
        desc.cu_depth[:] = self.ps.log2_ctu - (cu.bit_length() - 1)
        r8 = cu // 8
        desc.mv[:] = np.repeat(np.repeat(mvs.astype(np.int32), r8, 0), r8, 1)
        desc.coef_y = np.ascontiguousarray(py, np.int16)
        desc.coef_u = np.ascontiguousarray(pu, np.int16)
        desc.coef_v = np.ascontiguousarray(pv, np.int16)
        desc.row_ssd_y = row_ssd     # exact luma SSD per row vs source
        desc.sao_params = sao_params  # device-decided (recon pre-filtered)
        select_inter_syntax(self.ps, desc, cu)
        return (desc, DevicePlane(recon_y), DevicePlane(recon_u),
                DevicePlane(recon_v))

    def encode_frame(self, src, ref, avg_dist: float = 1000.0, qp=None):
        return self.fetch(self.dispatch(src, ref, avg_dist, qp=qp))
