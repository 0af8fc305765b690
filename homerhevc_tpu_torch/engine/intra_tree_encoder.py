"""Intra CU-tree encoder (PyTorch port of
homerhevc_tpu/engine/intra_tree_encoder.py TpuIntraTreeEncoder): a
batched open-loop decision pass, then a closed-loop CTB32 wavefront
encode with the modes fixed.

Pass 1 (decide): reference samples come from the SOURCE planes under the
decoder's z-scan availability, so every block at every depth (32/16/8)
is independent: one batched pass per depth (35-mode SAD search + MPM
cost, the TU pipeline at the chosen mode with chroma riding on the luma
mode, an integer RD cost), then the bottom-up consolidation.

Pass 2 (encode): the anti-diagonals d = cx + 2*cy over CTB32s (slot =
cy), a Python loop where the JAX package scans; frames are a leading
batch axis where it vmaps. Each step codes the 21-node hypothesis set of
every CTB on the diagonal (1 CU32 + 4 CU16 + 16 CU8, each one
predict_mode + TU pipeline) and keeps the nodes of the decided tree, so
references always come from the final reconstruction. U and V share
mode, shape and QP and ride one node call, stacked on the batch axis.
Then in-loop deblocking over the decided TU edges, device SAO and the
compact wire. ctu_size 64 runs the same CTB32 program with base depth 1.

Decisions, levels and recon are bit-exact to the JAX encoder and to the
golden numpy tree encoder.
"""

from __future__ import annotations

import numpy as np
import torch

from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.device import resolve_device
from homerhevc_tpu_torch.engine.intra_encoder import (WireFrameEncoder,
                                                      _mpm, _u8,
                                                      unpack_frames)
from homerhevc_tpu_torch.hevc import tables as T
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.hevc.intra_tree import (
    COEF_BITS_NNZ, COEF_BITS_SUM, COEF_BITS_TU, CU_OVERHEAD_BITS,
    MODE_BITS_MPM, MODE_BITS_REM, SPLIT_BITS, TreeDecision)
from homerhevc_tpu_torch.hevc.syntax import FrameDesc
from homerhevc_tpu_torch.ops import intra as dip
from homerhevc_tpu_torch.ops.deblock import deblock_chroma_bs, deblock_luma_bs
from homerhevc_tpu_torch.ops.pack import (cg_cap, pack_capacity,
                                          pack_sparse_cg)
from homerhevc_tpu_torch.ops.quant import (dequantize, quantize, scan_class,
                                           sign_bit_hiding)
from homerhevc_tpu_torch.ops.sao_dev import (pack_params, params_nbytes,
                                             sao_analyze_apply,
                                             sao_lambda_x256, unpack_params)
from homerhevc_tpu_torch.ops.transform import (forward_transform,
                                               inverse_transform)

# z-order of the sub-blocks of a quadrant / CTB
_QOFF = ((0, 0), (1, 0), (0, 1), (1, 1))
_I32 = torch.int32


def _rep(a: torch.Tensor, r: int) -> torch.Tensor:
    return a.repeat_interleave(r, dim=-2).repeat_interleave(r, dim=-1)


def _blocks(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(F, hh, ww) -> (F, (hh/n)*(ww/n), n, n) raster-order blocks."""
    F, hh, ww = plane.shape
    return plane.reshape(F, hh // n, n, ww // n, n).permute(0, 1, 3, 2, 4) \
        .reshape(F, -1, n, n)


class TorchIntraTreeEncoder(WireFrameEncoder):
    """Intra CU-tree encoder on one torch device. One instance per
    geometry; QP is a per-frame input. Needs w % 32 == 0, h % 32 == 0 and
    ctu_size 32 or 64."""

    def __init__(self, ps: ParamSets, cfg: EncoderConfig, *, device):
        self.device = resolve_device(device)
        self.ps = ps
        self.cfg = cfg
        w, h = cfg.width, cfg.height
        assert ps.ctu_size in (32, 64)
        assert w % ps.ctu_size == 0 and h % ps.ctu_size == 0, \
            "the tree path needs whole CTUs"
        self.w, self.h = w, h
        self.gw, self.gh = w // 32, h // 32      # CTB32 grid
        self.base_depth = ps.log2_ctu - 5
        self.pack_C = pack_capacity(w * h * 3 // 2, max(0, cfg.qp - 4))
        self.cg_C = cg_cap(w * h * 3 // 2, max(0, cfg.qp - 4))
        dev = self.device
        self.chroma_qp_map = torch.as_tensor(T.CHROMA_QP_MAP, device=dev)
        self.lam_tab = torch.as_tensor(
            [T.lambda_int(q, "I") for q in range(52)], dtype=_I32,
            device=dev)
        self.bits_tab = torch.as_tensor(
            [T.intra_mode_bits(q) for q in range(52)], dtype=_I32,
            device=dev)
        self._build_static()
        self._per_batch = {}

    # ---- static geometry ----------------------------------------------------

    def _build_static(self):
        """numpy masks and the diagonal layout, built once."""
        w, h, ctu = self.w, self.h, self.ps.ctu_size
        gw, gh = self.gw, self.gh
        # decision-pass availability masks per depth size (luma + chroma)
        self.dec_mask = {}
        for n in (32, 16, 8):
            gxs = np.arange(w // n) * n
            gys = np.arange(h // n) * n
            self.dec_mask[n] = dip.avail_masks(
                w, h, ctu, n, 0, gxs[None, :], gys[:, None])
            nc = n // 2
            cxs = np.arange((w // 2) // nc) * nc
            cys = np.arange((h // 2) // nc) * nc
            self.dec_mask[(n, "c")] = dip.avail_masks(
                w, h, ctu, nc, 1, cxs[None, :], cys[:, None])
        # MPM above-mode gating per block row of each decision size
        self.same_row = {n: (np.arange(h // n) * n % ctu) != 0
                         for n in (32, 16, 8)}

        # encode-pass schedule over CTB32s: step t codes the CTB32s of
        # st_gx/st_gy[t, slot] (invalid slots padded)
        st_gx, st_gy = self._schedule()
        valid = (st_gx >= 0)
        self.nsteps, self.nslot = st_gx.shape
        gx_c, gy_c = np.maximum(st_gx, 0), np.maximum(st_gy, 0)
        self.st_valid = valid
        self.st_flat = np.where(valid, gy_c * gw + gx_c, gh * gw) \
            .astype(np.int64)
        self._flat_valid = torch.as_tensor(self.st_flat[valid],
                                           device=self.device)
        self._slot_valid = torch.as_tensor(np.nonzero(valid.reshape(-1))[0],
                                           device=self.device)
        # reference / write-back sample indices into the flat recon buffers
        # (one row and column of padding above/left, 32 below/right; the
        # write-back of an invalid slot goes to a scratch tail)
        self.buf_idx = {}
        for comp, n, hh, ww in (("y", 32, h, w), ("c", 16, h // 2, w // 2)):
            wp = ww + n + 1
            size = (hh + n + 1) * wp
            x0 = (gx_c * n)[..., None]                 # padded coords of
            y0 = (gy_c * n)[..., None]                 # the above-left
            r = np.arange(2 * n)
            t_idx = y0 * wp + x0 + np.arange(2 * n + 1)
            l_idx = np.concatenate([y0 * wp + x0, (y0 + 1 + r) * wp + x0],
                                   axis=-1)
            rr, cc = np.divmod(np.arange(n * n), n)
            w_idx = (y0 + 1 + rr) * wp + x0 + 1 + cc
            scratch = size + np.arange(self.nslot)[:, None] * n * n \
                + np.arange(n * n)
            w_idx = np.where(valid[..., None], w_idx, scratch[None])
            self.buf_idx[comp] = (size + self.nslot * n * n, wp) + tuple(
                torch.as_tensor(a.reshape(self.nsteps, -1),
                                device=self.device)
                for a in (t_idx, l_idx, w_idx))

        # per-node availability masks in the (nsteps, nslot) layout
        ctb_x, ctb_y = gx_c * 32, gy_c * 32

        def node_mask(lx, ly, n, chroma):
            if chroma:
                m = dip.avail_masks(w, h, ctu, n, 1, (ctb_x // 2) + lx,
                                    (ctb_y // 2) + ly)
            else:
                m = dip.avail_masks(w, h, ctu, n, 0, ctb_x + lx, ctb_y + ly)
            return np.where(valid[..., None], m, False)
        self.m32 = node_mask(0, 0, 32, False)[None]
        self.m32c = node_mask(0, 0, 16, True)[None]
        self.m16 = np.stack([node_mask(16 * qx, 16 * qy, 16, False)
                             for qx, qy in _QOFF])
        self.m16c = np.stack([node_mask(8 * qx, 8 * qy, 8, True)
                              for qx, qy in _QOFF])
        m8, m8c = [], []
        for qx, qy in _QOFF:
            for sx, sy in _QOFF:
                m8.append(node_mask(16 * qx + 8 * sx, 16 * qy + 8 * sy, 8,
                                    False))
                m8c.append(node_mask(8 * qx + 4 * sx, 8 * qy + 4 * sy, 4,
                                     True))
        self.m8 = np.stack(m8)
        self.m8c = np.stack(m8c)

    def _schedule(self):
        """(st_gx, st_gy) (nsteps, nslot) CTB32 coordinates of each step
        (-1 where a slot is empty). A CTB32 is coded after every CTB32 it
        predicts from. CTU 32: the anti-diagonals t = cx + 2*cy (slot cy).
        CTU 64: t = 4*i + 7*j + k for the CTB32 of z-index k in CTU64 (i, j)
        (slot j): the CTB32s of a CTU64 go in decode order, and the first
        of them predicts from the below-left samples of the previous
        CTU64's last one, which the decoder has (spec 6.4.1)."""
        gw, gh = self.gw, self.gh
        if self.ps.ctu_size == 32:
            t = np.arange((gw - 1) + 2 * (gh - 1) + 1)[:, None]
            s = np.arange(gh)[None, :]
            gx = t - 2 * s
            ok = (gx >= 0) & (gx < gw)
            gy = np.broadcast_to(s, gx.shape)
        else:
            gw2, gh2 = gw // 2, gh // 2
            t = np.arange(4 * (gw2 - 1) + 7 * (gh2 - 1) + 4)[:, None]
            j = np.arange(gh2)[None, :]
            i, k = np.divmod(t - 7 * j, 4)
            ok = (t - 7 * j >= 0) & (i < gw2)
            gx = 2 * i + (k & 1)
            gy = 2 * j + (k >> 1)
        return np.where(ok, gx, -1), np.where(ok, gy, -1)

    def _batch_tables(self, F: int) -> dict:
        """Device masks tiled for a batch of F frames (luma rows F*nslot
        per step; chroma 2*F*nslot: U frames, then V frames). Cached per
        F."""
        tab = self._per_batch.get(F)
        if tab is not None:
            return tab
        dev = self.device

        def tile(m, k):
            # (..., m, L) -> (..., k*m, L) on the device
            t = torch.as_tensor(m, device=dev)
            return t.unsqueeze(-3).expand(
                t.shape[:-2] + (k,) + t.shape[-2:]).reshape(
                t.shape[:-2] + (k * t.shape[-2], t.shape[-1])).contiguous()
        tab = {"m32": tile(self.m32, F), "m32c": tile(self.m32c, 2 * F),
               "m16": tile(self.m16, F), "m16c": tile(self.m16c, 2 * F),
               "m8": tile(self.m8, F), "m8c": tile(self.m8c, 2 * F)}
        for n in (32, 16, 8):
            L = 4 * n + 1
            tab[("dec", n)] = tile(self.dec_mask[n].reshape(-1, L), F)
            tab[("dec", n, "c")] = tile(
                self.dec_mask[(n, "c")].reshape(-1, 2 * n + 1), 2 * F)
            tab[("row", n)] = torch.as_tensor(self.same_row[n], device=dev)
        self._per_batch[F] = tab
        return tab

    # ---- the TU pipeline ----------------------------------------------------

    def _tu(self, src_blk, pred, n, qp, scan_sel):
        """T -> Q -> (SBH) -> IQ -> IT over (B,) blocks: (lvl, rec)."""
        sl = self.ps.scaling_list_enabled
        coef = forward_transform(src_blk - pred, False)
        lvl = quantize(coef, n, qp, True, sl)
        if self.ps.sign_hiding:
            lvl = sign_bit_hiding(lvl, coef, n, qp, True, scan_sel, sl)
        rres = inverse_transform(dequantize(lvl, n, qp, True, sl), False)
        any_nz = (lvl != 0).any(dim=-1).any(dim=-1)
        rec = torch.where(any_nz[:, None, None],
                          torch.clamp(pred + rres, 0, 255), pred)
        return lvl, rec

    def _tu_eval(self, src_blk, pred, n, qp, scan_sel):
        """The TU pipeline plus its RD terms: (ssd, coef_bits) int32."""
        lvl, rec = self._tu(src_blk, pred, n, qp, scan_sel)
        d = rec - src_blk
        ssd = (d * d).sum(dim=(-1, -2), dtype=_I32)
        nnz = (lvl != 0).sum(dim=(-1, -2), dtype=_I32)
        sabs = torch.abs(lvl).sum(dim=(-1, -2), dtype=_I32)
        cbits = torch.where(nnz > 0, COEF_BITS_NNZ * nnz
                            + COEF_BITS_SUM * sabs + COEF_BITS_TU, 0)
        return ssd, cbits

    # ---- decision pass (open loop, batched) ---------------------------------

    def _decide_impl(self, src_y, src_u, src_v, qp):
        """src_*: (F, H, W) uint8; qp (F,) int32. Returns (depth8, mode8)
        (F, H/8, W/8) int32 maps, the twin of golden decide_intra_tree."""
        ps = self.ps
        F = src_y.shape[0]
        tab = self._batch_tables(F)
        w, h = self.w, self.h
        qp_c = self.chroma_qp_map[
            torch.clamp(qp + ps.cb_qp_offset, 0, 57).long()]
        lam = self.lam_tab[qp.long()]
        bits_mpm = self.bits_tab[qp.long(), 0]
        bits_rem = self.bits_tab[qp.long(), 1]
        src_c = torch.cat([src_u, src_v])               # (2F, H/2, W/2)
        modes_r = torch.arange(35, dtype=_I32, device=self.device)

        costs, modes = {}, {}
        for n in (32, 16, 8):
            gh, gw = h // n, w // n
            per_frame = lambda v, k=1: v.repeat(k)[:, None].expand(
                k * F, gh * gw).reshape(-1)
            seq = dip.gather_ref_seq(src_y, n).reshape(-1, 4 * n + 1)
            seq = dip.substitute_refs(seq, tab[("dec", n)])
            top, left = dip.seq_to_refs(seq, n)
            preds = dip.predict_all_modes(top, left, n, True)
            preds = dip.edge_fixes(preds, top, left, n, True)
            src_blk = _blocks(src_y, n).reshape(-1, n, n).to(_I32)
            sad = torch.abs(src_blk[:, None] - preds).sum(dim=(-1, -2),
                                                          dtype=_I32)
            pre = sad.argmin(dim=-1).to(_I32).reshape(F, gh, gw)
            # MPM from the neighbours' pre-modes (left always coded; above
            # gated to the same CTU row)
            ones = torch.ones_like(pre[:, :, :1])
            left_m = torch.cat([ones, pre[:, :, :-1]], dim=2)
            above_m = torch.cat([torch.ones_like(pre[:, :1]), pre[:, :-1]],
                                dim=1)
            above_m = torch.where(tab[("row", n)][:, None], above_m, 1)
            mpm = _mpm(left_m.reshape(-1), above_m.reshape(-1))
            in_mpm = (modes_r[None, :, None] == mpm[:, None, :]).any(dim=-1)
            mcost = sad + torch.where(in_mpm, per_frame(bits_mpm)[:, None],
                                      per_frame(bits_rem)[:, None])
            mode = mcost.argmin(dim=-1).to(_I32)
            B = mode.shape[0]
            pred = preds[torch.arange(B, device=self.device), mode.long()]
            ssd, cbits = self._tu_eval(src_blk, pred, n, per_frame(qp),
                                       scan_class(mode, n, True))
            # chroma (DM) rides along: U and V in one batch
            nc = n // 2
            cseq = dip.gather_ref_seq(src_c, nc).reshape(-1, 4 * nc + 1)
            cseq = dip.substitute_refs(cseq, tab[("dec", n, "c")])
            ctop, cleft = dip.seq_to_refs(cseq, nc)
            mode2 = mode.repeat(2)
            cpred = dip.predict_mode(ctop, cleft, nc, mode2, False)
            cblk = _blocks(src_c, nc).reshape(-1, nc, nc).to(_I32)
            cssd, ccbits = self._tu_eval(cblk, cpred, nc, per_frame(qp_c, 2),
                                         scan_class(mode2, nc, False))
            ssd = ssd + cssd[:B] + cssd[B:]
            cbits = cbits + ccbits[:B] + ccbits[B:]
            sel_mpm = in_mpm[torch.arange(B, device=self.device),
                             mode.long()]
            mode_bits = torch.where(sel_mpm, MODE_BITS_MPM,
                                    MODE_BITS_REM).to(_I32)
            cost = ssd + per_frame(lam) * (cbits + mode_bits
                                           + CU_OVERHEAD_BITS)
            costs[n] = cost.reshape(F, gh, gw)
            modes[n] = mode.reshape(F, gh, gw)

        # bottom-up consolidation (split iff the children are cheaper)
        def q4(a):
            return (a[:, 0::2, 0::2] + a[:, 0::2, 1::2] + a[:, 1::2, 0::2]
                    + a[:, 1::2, 1::2])
        lam_s = (lam * SPLIT_BITS)[:, None, None]
        csum16 = q4(costs[8]) + lam_s
        split16 = csum16 < costs[16]
        best16 = torch.where(split16, csum16, costs[16])
        csum32 = q4(best16) + lam_s
        split32 = csum32 < costs[32]
        s32u = _rep(split32, 4)
        s16u = _rep(split16, 2)
        depth8 = torch.where(~s32u, 0, torch.where(~s16u, 1, 2)) \
            .to(_I32) + self.base_depth
        mode8 = torch.where(~s32u, _rep(modes[32], 4),
                            torch.where(~s16u, _rep(modes[16], 2),
                                        modes[8])).to(_I32)
        return depth8, mode8

    # ---- encode pass (closed-loop CTB32 wavefront) --------------------------

    def _node(self, buf, t_ext, l_ext, lx, ly, n, mask, mode_vec, src_tile,
              qp, is_luma):
        """One hypothesis node over (B,) CTBs: refs from the working tile
        and the boundary carry, single-mode prediction, TU pipeline.
        Returns (lvl, rec), each (B, n, n)."""
        n2 = 2 * n
        if lx == 0:
            col = l_ext[:, 1 + ly:1 + ly + n2]
        else:
            col = buf[:, ly:ly + n2, lx - 1]
        if lx == 0 and ly == 0:
            corner = t_ext[:, 0:1]
        elif ly == 0:
            corner = t_ext[:, lx:lx + 1]
        elif lx == 0:
            corner = l_ext[:, ly:ly + 1]
        else:
            corner = buf[:, ly - 1, lx - 1:lx]
        if ly == 0:
            toprow = t_ext[:, 1 + lx:1 + lx + n2]
        else:
            toprow = buf[:, ly - 1, lx:lx + n2]
        seq = torch.cat([col.flip(-1), corner, toprow], dim=1)
        seq = dip.substitute_refs(seq, mask)
        top, left = dip.seq_to_refs(seq, n)
        pred = dip.predict_mode(top, left, n, mode_vec, is_luma)
        src_blk = src_tile[:, ly:ly + n, lx:lx + n].to(_I32)
        return self._tu(src_blk, pred, n, qp,
                        scan_class(mode_vec, n, is_luma))

    def _assemble(self, blocks, n, hh, ww):
        """(nsteps, F*nslot, n, n) slot blocks -> (F, hh, ww) planes."""
        S = self.nslot
        F = blocks.shape[1] // S
        gh, gw = hh // n, ww // n
        slots = blocks.reshape(self.nsteps, F, S, n, n) \
            .permute(1, 0, 2, 3, 4).reshape(F, -1, n, n)
        buf = torch.zeros((F, gh * gw, n, n), dtype=blocks.dtype,
                          device=blocks.device)
        buf[:, self._flat_valid] = slots[:, self._slot_valid]
        return buf.reshape(F, gh, gw, n, n).permute(0, 1, 3, 2, 4) \
            .reshape(F, hh, ww)

    def _step_blocks(self, plane, n):
        """(F, hh, ww) -> (nsteps, F*nslot, n, n): the n-blocks of the CTB32
        of every (step, slot)."""
        b = _blocks(plane, n)
        b = torch.cat([b, torch.zeros_like(b[:, :1])], dim=1)
        flat = torch.as_tensor(self.st_flat, device=plane.device)
        return b[:, flat].transpose(0, 1).reshape(self.nsteps, -1, n, n)

    def _frame_impl(self, src_y, src_u, src_v, qp):
        """src_*: (F, H, W) / (F, H/2, W/2) uint8; qp (F,) int32. Returns
        (recon_y, recon_u, recon_v (uint8), ly, lu, lv (int16), meta
        (F, meta_len) uint8). The stages are methods of their own, so that
        a profiler can tell them apart."""
        qp = qp.to(_I32)
        depth8, mode8 = self._decide_impl(src_y, src_u, src_v, qp)
        recon, lvl, lvl_c = self._wavefront(src_y, src_u, src_v, qp,
                                            depth8, mode8)
        recon = self._deblock(recon, depth8, qp)
        sao_vec = []
        if self.ps.sao_enabled:
            recon, sao_vec = self._sao(src_y, src_u, src_v, recon, qp)
        return self._pack(recon, lvl, lvl_c, depth8, mode8, sao_vec)

    def _wavefront(self, src_y, src_u, src_v, qp, depth8, mode8,
                   n_steps=None):
        """The closed-loop encode over the schedule's steps (all of them,
        or the first n_steps for a profile). Each step gathers the
        reference samples of its CTB32s from the recon buffers, codes the
        21 nodes and writes the selected recon back. Returns the recon
        planes (int32) and the slot blocks of the levels: luma
        (nsteps, F*nslot, 32, 32), chroma (nsteps, 2*F*nslot, 16, 16) with
        U frames before V frames."""
        ps = self.ps
        S = self.nslot
        F = src_y.shape[0]
        dev = self.device
        tab = self._batch_tables(F)
        qp_c = self.chroma_qp_map[
            torch.clamp(qp + ps.cb_qp_offset, 0, 57).long()]
        base = self.base_depth
        B = F * S
        qp_b = qp[:, None].expand(F, S).reshape(-1)
        qpc_b = qp_c.repeat(2)[:, None].expand(2 * F, S).reshape(-1)

        by = self._step_blocks(src_y, 32)
        bc = torch.cat([self._step_blocks(src_u, 16),
                        self._step_blocks(src_v, 16)], dim=1)
        dep_u = self._step_blocks(depth8, 4)             # (nsteps, B, 4, 4)
        mod_u = self._step_blocks(mode8, 4)
        size_y, wp_y, t_iy, l_iy, w_iy = self.buf_idx["y"]
        size_c, wp_c, t_ic, l_ic, w_ic = self.buf_idx["c"]
        buf_y = torch.zeros((F, size_y), dtype=_I32, device=dev)
        buf_c = torch.zeros((2 * F, size_c), dtype=_I32, device=dev)
        outs = []
        for d in range(self.nsteps if n_steps is None else n_steps):
            sy, sc, dep, mod = by[d], bc[d], dep_u[d], mod_u[d]
            t_y = buf_y.index_select(1, t_iy[d]).reshape(B, -1)
            l_y = buf_y.index_select(1, l_iy[d]).reshape(B, -1)
            t_c = buf_c.index_select(1, t_ic[d]).reshape(2 * B, -1)
            l_c = buf_c.index_select(1, l_ic[d]).reshape(2 * B, -1)
            # working tiles (48 wide/high: the interior 32 plus masked
            # slack for top-right / below-left reads)
            yb = torch.zeros((B, 48, 48), dtype=_I32, device=dev)
            cb = torch.zeros((2 * B, 24, 24), dtype=_I32, device=dev)
            lyb = torch.empty((B, 32, 32), dtype=_I32, device=dev)
            lcb = torch.empty((2 * B, 16, 16), dtype=_I32, device=dev)

            def luma(lx, ly, n, mask, m):
                return self._node(yb, t_y, l_y, lx, ly, n, mask, m, sy,
                                  qp_b, True)

            def chroma(lx, ly, n, mask, m):
                return self._node(cb, t_c, l_c, lx, ly, n, mask,
                                  m.repeat(2), sc, qpc_b, False)
            # CU32 hypothesis (reads only the external refs)
            m32v = mod[:, 0, 0]
            lvl32, rec32 = luma(0, 0, 32, tab["m32"][0, d], m32v)
            lvl32c, rec32c = chroma(0, 0, 16, tab["m32c"][0, d], m32v)
            for q, (qx, qy) in enumerate(_QOFF):
                ox, oy = 16 * qx, 16 * qy
                m16v = mod[:, 2 * qy, 2 * qx]
                lvl16, rec16 = luma(ox, oy, 16, tab["m16"][q, d], m16v)
                lvl16c, rec16c = chroma(ox // 2, oy // 2, 8,
                                        tab["m16c"][q, d], m16v)
                l8t = torch.empty((B, 16, 16), dtype=_I32, device=dev)
                l8tc = torch.empty((2 * B, 8, 8), dtype=_I32, device=dev)
                for k, (sx, sy8) in enumerate(_QOFF):
                    lx, ly = ox + 8 * sx, oy + 8 * sy8
                    ni = 4 * q + k
                    m8v = mod[:, ly // 8, lx // 8]
                    lvl8, rec8 = luma(lx, ly, 8, tab["m8"][ni, d], m8v)
                    yb[:, ly:ly + 8, lx:lx + 8] = rec8
                    l8t[:, 8 * sy8:8 * sy8 + 8, 8 * sx:8 * sx + 8] = lvl8
                    lvl8c, rec8c = chroma(lx // 2, ly // 2, 4,
                                          tab["m8c"][ni, d], m8v)
                    cb[:, ly // 2:ly // 2 + 4, lx // 2:lx // 2 + 4] = rec8c
                    l8tc[:, 4 * sy8:4 * sy8 + 4, 4 * sx:4 * sx + 4] = lvl8c
                # quadrant selection (depth base+1: the whole CU16)
                is16 = (dep[:, 2 * qy, 2 * qx] <= base + 1)[:, None, None]
                is16c = is16.repeat(2, 1, 1)
                ys, xs = slice(oy, oy + 16), slice(ox, ox + 16)
                yb[:, ys, xs] = torch.where(is16, rec16, yb[:, ys, xs])
                lyb[:, ys, xs] = torch.where(is16, lvl16, l8t)
                ys, xs = (slice(oy // 2, oy // 2 + 8),
                          slice(ox // 2, ox // 2 + 8))
                cb[:, ys, xs] = torch.where(is16c, rec16c, cb[:, ys, xs])
                lcb[:, ys, xs] = torch.where(is16c, lvl16c, l8tc)

            is32 = (dep[:, 0, 0] == base)[:, None, None]
            is32c = is32.repeat(2, 1, 1)
            rec_f = torch.where(is32, rec32, yb[:, :32, :32])
            rec_fc = torch.where(is32c, rec32c, cb[:, :16, :16])
            buf_y.index_copy_(1, w_iy[d], rec_f.reshape(F, -1))
            buf_c.index_copy_(1, w_ic[d], rec_fc.reshape(2 * F, -1))
            outs.append((torch.where(is32, lvl32, lyb),
                         torch.where(is32c, lvl32c, lcb)))
        lvl, lvl_c = (torch.stack(x) for x in zip(*outs))

        def plane(buf, wp, hh, ww):
            return buf[:, :(hh + 1) * wp].reshape(-1, hh + 1, wp)[
                :, 1:, 1:ww + 1]
        h, w = self.h, self.w
        recon_c = plane(buf_c, wp_c, h // 2, w // 2)
        return ((plane(buf_y, wp_y, h, w), recon_c[:F], recon_c[F:]),
                lvl, lvl_c)

    def _deblock(self, recon, depth8, qp):
        """In-loop deblocking over the DECIDED maps: BS 2 on every TU edge
        of the 8-grid (TU size == CU size on this path)."""
        ps = self.ps
        if not ps.deblocking_enabled:
            return recon
        ry, ru, rv = recon
        dev = self.device
        tu8 = torch.bitwise_right_shift(
            torch.full_like(depth8, ps.ctu_size), depth8)
        ux8 = torch.arange(self.w // 8, dtype=_I32, device=dev) * 8
        uy8 = torch.arange(self.h // 8, dtype=_I32, device=dev) * 8
        bs_v = torch.where((ux8[None, None, :] % tu8) == 0, 2, 0)
        bs_v[:, :, 0] = 0
        bs_h = torch.where((uy8[None, :, None] % tu8) == 0, 2, 0)
        bs_h[:, 0, :] = 0
        return (deblock_luma_bs(ry, bs_v, bs_h, qp),
                deblock_chroma_bs(ru, bs_v == 2, bs_h == 2, qp,
                                  ps.cb_qp_offset),
                deblock_chroma_bs(rv, bs_v == 2, bs_h == 2, qp,
                                  ps.cr_qp_offset))

    def _sao(self, src_y, src_u, src_v, recon, qp):
        """Device SAO decide + apply: the filtered planes (the next P
        frame's reference stays on the device) and the packed params."""
        ry, ru, rv = recon
        ry_f, ru_f, rv_f, sparams = sao_analyze_apply(
            src_y.to(_I32), src_u.to(_I32), src_v.to(_I32), ry.to(_I32),
            ru.to(_I32), rv.to(_I32), self.ps.ctu_size, sao_lambda_x256(qp))
        return (ry_f, ru_f, rv_f), [pack_params(sparams)]

    def _pack(self, recon, lvl, lvl_c, depth8, mode8, sao_vec):
        """uint8 recon, int16 level planes and the compact wire: depth8,
        mode8, the SAO params, then the two-tier CG wire, in ONE uint8
        buffer per frame."""
        F = depth8.shape[0]
        w, h = self.w, self.h
        hc, wc = h // 2, w // 2
        B = F * self.nslot
        recon_y, recon_u, recon_v = (p.to(torch.uint8) for p in recon)
        ly = self._assemble(lvl.to(torch.int16), 32, h, w)
        lu = self._assemble(lvl_c[:, :B].to(torch.int16), 16, hc, wc)
        lv = self._assemble(lvl_c[:, B:].to(torch.int16), 16, hc, wc)
        cg_bitmap, masks16, codes, esc_idx, esc_val, count, esc_count, \
            cg_count = pack_sparse_cg([ly, lu, lv], self.pack_C, self.cg_C)
        meta = torch.cat(
            [depth8.to(torch.uint8).reshape(F, -1),
             mode8.to(torch.uint8).reshape(F, -1)] + sao_vec
            + [cg_bitmap, _u8(masks16), codes, _u8(esc_idx), _u8(esc_val),
               _u8(count[:, None]), _u8(esc_count[:, None]),
               _u8(cg_count[:, None])], dim=1)
        return recon_y, recon_u, recon_v, ly, lu, lv, meta

    # ---- host glue (WireFrameEncoder) ---------------------------------------

    def _meta_prefix(self) -> int:
        """depth8, mode8, then the SAO params when SAO is on."""
        n = 2 * (self.h // 8) * (self.w // 8)
        if self.ps.sao_enabled:
            n += params_nbytes(self.h // self.ps.ctu_size,
                               self.w // self.ps.ctu_size)
        return n

    def _desc(self, prefix):
        h8, w8 = self.h // 8, self.w // 8
        ng = h8 * w8
        mode8 = prefix[ng:2 * ng].reshape(h8, w8)
        desc = FrameDesc.alloc(self.w, self.h)
        desc.cu_depth[:] = prefix[:ng].reshape(h8, w8)
        desc.tr_depth[:] = 0
        desc.luma_mode[:] = np.repeat(np.repeat(mode8, 2, 0), 2, 1)
        desc.chroma_mode[:] = mode8
        if self.ps.sao_enabled:
            desc.sao_params = unpack_params(
                prefix[2 * ng:], self.h // self.ps.ctu_size,
                self.w // self.ps.ctu_size)
        return desc

    def decide(self, y, u, v, qp: int) -> TreeDecision:
        """Run only the decision pass (tests)."""
        d8, m8 = self._decide_impl(
            *unpack_frames(self.pack_upload([(y, u, v)]), self.w, self.h),
            torch.tensor([qp], dtype=_I32, device=self.device))
        d8 = d8[0].cpu().numpy().astype(np.uint8)
        m8 = m8[0].cpu().numpy().astype(np.uint8)
        return TreeDecision(depth8=d8, mode8=m8, chroma8=m8.copy())
