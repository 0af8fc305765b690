"""The benchmark's plain reference decoder: NumPy only.

It reads the access unit of one picture with the frozen parser beside
it, under the parameter sets the stream itself carries
(`headers.parse_parameter_sets`), and rebuilds the picture the way a
decoder does: intra prediction from the samples already decoded, motion
compensation from the reference picture it is given, dequantisation and
the inverse transforms, then deblocking and SAO where the stream turns
them on (SAO is this module's own, written from the spec's 8.7.3). What
the encoder under test reports as its reconstruction is judged against
this picture, never fed into it, apart from the reference picture of a P
slice (see `decode_picture`).

The syntax the benchmark's configurations produce is covered: intra CUs
(2Nx2N and NxN), single-reference P CUs (2Nx2N, 2NxN, Nx2N; skip, merge and
AMVP), any transform tree, one slice per picture, WPP or not. Anything
else raises `Unsupported`, which the check counts as a stream it could not
decode.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hevcbench.reference import deblock as hdb
from hevcbench.reference import intra_pred as ip
from hevcbench.reference import tables as T
from hevcbench.reference.cabac_dec import BitReader, unescape_ebsp
from hevcbench.reference.config import EncoderConfig
from hevcbench.reference.headers import (
    SLICE_I, SLICE_P, ParamSets, Unsupported)
from hevcbench.reference.interp import mc_chroma, mc_luma
from hevcbench.reference.parse import (
    parse_slice_nal, read_slice_header, split_annexb)
from hevcbench.reference.quantize import dequantize
from hevcbench.reference.sao import SAO_BAND, SAO_OFF
from hevcbench.reference.syntax import MODE_INTRA
from hevcbench.reference.transform import inverse_transform

# 8.7.3: (hPos, vPos) of the two neighbours compared, by SaoEoClass
EO_NEIGHBOURS = {0: ((-1, 0), (1, 0)), 1: ((0, -1), (0, 1)),
                 2: ((-1, -1), (1, 1)), 3: ((1, -1), (-1, 1))}


def stated_param_sets(cfg: EncoderConfig) -> ParamSets:
    """The parameter sets a stream of this configuration must state: the
    picture padded to whole CTUs and cropped back by the conformance
    window."""
    ctu = cfg.ctu_size
    cw, ch = -(-cfg.width // ctu) * ctu, -(-cfg.height // ctu) * ctu
    ps = ParamSets.from_config(dataclasses.replace(cfg, width=cw, height=ch))
    ps.conf_win_right = cw - cfg.width
    ps.conf_win_bottom = ch - cfg.height
    return ps


def slice_header(ps: ParamSets, nals: list[bytes]) -> dict:
    """The header of an access unit's one slice, read from its first bytes
    alone (no slice data)."""
    slices = [n for n in nals if ((n[0] >> 1) & 0x3F) < 32]
    if len(slices) != 1:
        raise Unsupported(f"{len(slices)} slices in one access unit")
    n = slices[0]
    return read_slice_header(ps, BitReader(unescape_ebsp(n[2:258])),
                             (n[0] >> 1) & 0x3F)


def sao_filter(rec: np.ndarray, sao, c_idx: int, ctb: int) -> np.ndarray:
    """8.7.3 on one component of the deblocked picture `rec`: each CTB
    (`ctb` samples of this component a side) by its SaoTypeIdx, band
    offset or edge offset against the deblocked neighbours, a neighbour
    outside the picture leaving the sample as it is. `sao`: the parsed
    SaoFrameParams (band offsets signed, edge offsets as magnitudes)."""
    h, w = rec.shape
    rec = rec.astype(np.int32)
    out = rec.copy()
    types = sao.type_luma if c_idx == 0 else sao.type_chroma
    classes = sao.eo_class_luma if c_idx == 0 else sao.eo_class_chroma
    for ry in range(types.shape[0]):
        for rx in range(types.shape[1]):
            t = int(types[ry, rx])
            if t == SAO_OFF:
                continue
            y0, x0 = ry * ctb, rx * ctb
            y1, x1 = min(y0 + ctb, h), min(x0 + ctb, w)
            blk = rec[y0:y1, x0:x1]
            off = [int(o) for o in sao.offsets[ry, rx, c_idx]]
            if t == SAO_BAND:
                band_table = np.zeros(32, np.int32)
                for k in range(4):
                    band_table[(k + int(sao.band_pos[ry, rx, c_idx])) & 31] \
                        = k + 1
                val = np.array([0] + off, np.int32)[band_table[blk >> 3]]
            else:
                ys = np.arange(y0, y1)[:, None]
                xs = np.arange(x0, x1)[None, :]
                edge = np.full(blk.shape, 2, np.int32)
                inside = np.ones(blk.shape, bool)
                for hp, vp in EO_NEIGHBOURS[int(classes[ry, rx])]:
                    ny, nx = ys + vp, xs + hp
                    inside &= (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
                    edge += np.sign(blk - rec[np.clip(ny, 0, h - 1),
                                              np.clip(nx, 0, w - 1)])
                edge = np.where(edge == 2, 0, np.where(edge < 2, edge + 1,
                                                       edge))
                val = np.array([0, off[0], off[1], -off[2], -off[3]],
                               np.int32)[edge]
                val[~inside] = 0
            out[y0:y1, x0:x1] = np.clip(blk + val, 0, 255)
    return out


def _qp_c(qp: int, offset: int) -> int:
    return T.chroma_qp(qp + offset)


class _Picture:
    """One picture's reconstruction from a parsed FrameDesc."""

    def __init__(self, ps: ParamSets, d, slice_type: int, qp: int,
                 ref=None):
        self.ps, self.d, self.st, self.qp = ps, d, slice_type, qp
        w, h = d.width, d.height
        self.w, self.h = w, h
        self.y = np.zeros((h, w), np.int32)
        self.u = np.zeros((h // 2, w // 2), np.int32)
        self.v = np.zeros((h // 2, w // 2), np.int32)
        self.avail = ip.Availability(w, h, ps.ctu_size)
        self.ref = ref
        self.sl = ps.scaling_list_enabled
        if d.qp_map is not None and ps.cu_qp_delta_enabled:
            self.qp8 = hdb.decoder_qp_map8(d, ps, qp, wpp=ps.wpp)
        else:
            self.qp8 = None

    def _cu_qp(self, x, y) -> int:
        return self.qp if self.qp8 is None else int(self.qp8[y // 8, x // 8])

    # ---- coding quadtree ----------------------------------------------------

    def run(self):
        ctu = self.ps.ctu_size
        for cy in range(0, self.h, ctu):
            for cx in range(0, self.w, ctu):
                self._cqt(cx, cy, ctu, 0)

    def _cqt(self, x0, y0, size, depth):
        if x0 >= self.w or y0 >= self.h:
            return
        if int(self.d.cu_depth[y0 // 8, x0 // 8]) > depth:
            half = size // 2
            for dy, dx in ((0, 0), (0, half), (half, 0), (half, half)):
                self._cqt(x0 + dx, y0 + dy, half, depth + 1)
            return
        if int(self.d.pred_mode[y0 // 8, x0 // 8]) == MODE_INTRA:
            self._tt(x0, y0, size, x0, y0, size, True)
        else:
            self._inter_pred(x0, y0, size)
            if int(self.d.root_cbf[y0 // 8, x0 // 8]):
                self._tt(x0, y0, size, x0, y0, size, False)

    # ---- transform tree -----------------------------------------------------

    def _tu_size(self, x, y, cu_size) -> int:
        return max(4, cu_size >> int(self.d.tr_depth[y // 8, x // 8]))

    def _tt(self, x0, y0, size, cu_x, cu_y, cu_size, intra):
        """Transform units in z-order; a split of an 8x8 node into four
        4x4 luma units codes its 4x4 chroma after the fourth."""
        if size > self._tu_size(x0, y0, cu_size):
            half = size // 2
            for dy, dx in ((0, 0), (0, half), (half, 0), (half, half)):
                self._tt(x0 + dx, y0 + dy, half, cu_x, cu_y, cu_size, intra)
            if half == 4:
                self._chroma_tu(x0 // 2, y0 // 2, 4, x0, y0, intra)
            return
        self._luma_tu(x0, y0, size, intra)
        if size > 4:
            self._chroma_tu(x0 // 2, y0 // 2, size // 2, x0, y0, intra)

    def _residual(self, lvl, qp, intra, dst):
        if not np.any(lvl):
            return 0
        return inverse_transform(dequantize(lvl, qp, intra, self.sl), dst)

    def _luma_tu(self, x0, y0, n, intra):
        qp = self._cu_qp(x0, y0)
        lvl = self.d.coef_y[y0:y0 + n, x0:x0 + n]
        if intra:
            mode = int(self.d.luma_mode[y0 // 4, x0 // 4])
            top, left = ip.build_reference_samples(self.y, x0, y0, n,
                                                   self.avail)
            ft, fl = ip.filter_reference_samples(
                top, left, n, mode, True, self.ps.strong_intra_smoothing)
            pred = ip.predict(ft, fl, n, mode, True)
        else:
            pred = self.y[y0:y0 + n, x0:x0 + n]
        r = self._residual(lvl, qp, intra, intra and n == 4)
        self.y[y0:y0 + n, x0:x0 + n] = np.clip(pred + r, 0, 255)

    def _chroma_tu(self, cx, cy, n, lx, ly, intra):
        qp = self._cu_qp(lx, ly)
        for plane, coef, off in ((self.u, self.d.coef_u, self.ps.cb_qp_offset),
                                 (self.v, self.d.coef_v, self.ps.cr_qp_offset)):
            if intra:
                mode = int(self.d.chroma_mode[ly // 8, lx // 8])
                top, left = ip.build_reference_samples(plane, cx, cy, n,
                                                       self.avail,
                                                       comp_shift=1)
                pred = ip.predict(top, left, n, mode, False)
            else:
                pred = plane[cy:cy + n, cx:cx + n]
            lvl = coef[cy:cy + n, cx:cx + n]
            r = self._residual(lvl, _qp_c(qp, off), intra, False)
            plane[cy:cy + n, cx:cx + n] = np.clip(pred + r, 0, 255)

    # ---- inter prediction ---------------------------------------------------

    def _inter_pred(self, x0, y0, size):
        d = self.d
        if self.ref is None or self.st != SLICE_P:
            raise Unsupported("an inter CU outside a P slice")
        if d.ref_idx is not None and np.any(
                d.ref_idx[y0 // 8:(y0 + size) // 8, x0 // 8:(x0 + size) // 8]):
            raise Unsupported("a reference index other than 0")
        part = 0 if d.inter_part is None else int(d.inter_part[y0 // 8,
                                                                x0 // 8])
        if part == 0:
            pus = [(x0, y0, size, size)]
        elif part == 1:
            pus = [(x0, y0, size, size // 2), (x0, y0 + size // 2, size,
                                               size // 2)]
        else:
            pus = [(x0, y0, size // 2, size), (x0 + size // 2, y0, size // 2,
                                               size)]
        ry, ru, rv = self.ref
        for px, py, pw, ph in pus:
            mvx, mvy = (int(c) for c in d.mv[py // 8, px // 8])
            n = max(pw, ph)
            self.y[py:py + ph, px:px + pw] = mc_luma(
                ry, px, py, n, mvx, mvy)[:ph, :pw]
            for plane, rp in ((self.u, ru), (self.v, rv)):
                plane[py // 2:(py + ph) // 2, px // 2:(px + pw) // 2] = \
                    mc_chroma(rp, px // 2, py // 2, n // 2, mvx, mvy)[
                        :ph // 2, :pw // 2]

    # ---- in-loop filters ----------------------------------------------------

    def loop_filters(self, sao_flags, sao_params):
        ps, d = self.ps, self.d
        y, u, v = self.y, self.u, self.v
        if ps.deblocking_enabled:
            tu8 = ((ps.ctu_size >> d.cu_depth.astype(np.int32))
                   >> d.tr_depth.astype(np.int32)).astype(np.int32)
            qp8 = (self.qp8 if self.qp8 is not None
                   else np.full_like(tu8, self.qp))
            if self.st == SLICE_I:
                bs_v, bs_h = hdb.intra_bs_maps(tu8)
            else:
                bs_v, bs_h = hdb.inter_bs_maps(d, tu8)
            y = hdb.deblock_plane_luma(y, tu8, qp8, bs_v, bs_h)
            u = hdb.deblock_plane_chroma(u, qp8, bs_v, bs_h, ps.cb_qp_offset)
            v = hdb.deblock_plane_chroma(v, qp8, bs_v, bs_h, ps.cr_qp_offset)
        if sao_params is not None and any(sao_flags):
            ctu = ps.ctu_size
            if sao_flags[0]:
                y = sao_filter(y, sao_params, 0, ctu)
            if sao_flags[1]:
                u = sao_filter(u, sao_params, 1, ctu // 2)
                v = sao_filter(v, sao_params, 2, ctu // 2)
        return y, u, v


def decode_picture(ps: ParamSets, nals: list[bytes], ref=None,
                   out_size=None):
    """Decode one access unit (NAL payloads without start codes) under
    `ps`, the parameter sets of its stream. ref: the (y, u, v) uint8 planes of the picture
    a P slice predicts from, at the coded size. Returns (slice type,
    (y, u, v) uint8 planes cropped to out_size (w, h))."""
    slices = [n for n in nals if ((n[0] >> 1) & 0x3F) < 32]
    if len(slices) != 1:
        raise Unsupported(f"{len(slices)} slices in one access unit")
    hdr, p = parse_slice_nal(ps, slices[0])
    st = hdr["slice_type"]
    if st not in (SLICE_I, SLICE_P):
        raise Unsupported("a B slice")
    if st == SLICE_P and hdr["ref_dists_l0"] is not None:
        raise Unsupported("more than one reference picture")
    pic = _Picture(ps, p.d, st, hdr["qp"], ref)
    pic.run()
    y, u, v = pic.loop_filters(hdr["sao"], p.sao)
    w, h = out_size or (ps.pic_width, ps.pic_height)
    return st, (np.asarray(y, np.uint8)[:h, :w],
                np.asarray(u, np.uint8)[:h // 2, :w // 2],
                np.asarray(v, np.uint8)[:h // 2, :w // 2])


def decode_access_unit(ps: ParamSets, annexb: bytes, ref=None, out_size=None):
    """decode_picture over an Annex-B access unit."""
    return decode_picture(ps, split_annexb(annexb), ref, out_size)
