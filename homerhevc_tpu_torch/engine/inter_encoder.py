"""Inter-frame encoder (PyTorch port of homerhevc_tpu/engine/inter_encoder.py
TpuInterEncoder): the uni-predicted P program (_impl) and the bi-capable
program of B and generalized-B frames (_impl_b).

All CUs of a frame are one batch (no intra-frame dependency): a
hierarchical full-pel search (2x-decimated coarse sweep -> top-K votes ->
shortlist + exact +-4 fine sweep at full resolution, with the 4x-decimated
FAR level when me_range > 32), half/quarter-pel refinement, luma MC +
T/Q/SBH/zero-forcing, the batched merge-RD stage (flat CU16), chroma MC +
residual, the CU32 / CU64 layers of the CU tree at CTU 32 / 64 (each CTB
coded once as one CU and kept where it wins SSD + lambda * rate; FAST
masks that by the fast-skip predicate and UFAST drops the CU64 layer),
the intra-in-P fallback, BS-map deblocking, device SAO and the compact
wire. The bi-capable program searches both references (list 1 also
against the bi target 2 * src - pred0, a plane that leaves [0, 255]) and
picks uni-L0, uni-L1 or the 14-bit bi average per CU at CU16 and CU32.
Bit-exact to the JAX programs and to golden encode_inter_frame
(merge_rd="fast") / encode_inter_frame_tree / encode_b_frame_tree.

Both programs are generators split at their coarse sweeps (one in _impl,
three in _impl_b): each sweep's two planes are yielded and its SADs sent
back, so the sweep is launched by the program's driver (_sweep) and never
inside the program. On the CPU the driver runs the program eagerly with
the plain sweep. On the card the sweep is the hand-written CUDA kernel
(ops/me_sad.py: the 8-bit entry point for source planes, the wide one for
the bi target), and the program is replayed from CUDA graphs, one for
each part between two sweeps, per key (TorchInterEncoder._launch): the
~13.5 k small kernels of a 720p P frame cost two graph launches, while
every sweep stays one eager launch of the kernel through this module's
coarse_sweep_sads, counted by device.count_launch.
"""

from __future__ import annotations

import numpy as np
import torch

from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.hevc import tables as T
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.hevc.inter_syntax import (
    INTRA_P_MODE_BITS_MPM, INTRA_P_MODE_BITS_REM, INTRA_P_ROUNDS,
    MERGE_FAST_BITS_BASE, far_grid, select_inter_syntax,
    select_inter_syntax_tree, zf_multiplier)
from homerhevc_tpu_torch.hevc.syntax import MODE_INTER, MODE_INTRA, FrameDesc
from homerhevc_tpu_torch.utils.profiler import PROFILER
from homerhevc_tpu_torch.device import FrameGraph, resolve_device
from homerhevc_tpu_torch.engine.intra_encoder import (DevicePlane, _sh1,
                                                      _u8, _parse_cg_wire,
                                                      _unpack_cg_frame,
                                                      as_device_plane,
                                                      fetch_planes)
from homerhevc_tpu_torch.ops import intra as dip
from homerhevc_tpu_torch.ops.deblock import deblock_chroma_bs, deblock_luma_bs
from homerhevc_tpu_torch.ops.interp import (LUMA_TAPS, extract_patches,
                                            mc_chroma_batch,
                                            mc_chroma_batch_14)
from homerhevc_tpu_torch.ops.me_sad import coarse_sweep_sads, sads_like
from homerhevc_tpu_torch.ops.pack import (cg_cap, esc_capacity,
                                          pack_capacity, pack_sparse_cg)
from homerhevc_tpu_torch.ops.quant import (dequantize, quantize,
                                           sign_bit_hiding)
from homerhevc_tpu_torch.ops.sao_dev import (pack_params, params_nbytes,
                                             sao_analyze_apply,
                                             sao_lambda_x256, unpack_params)
from homerhevc_tpu_torch.ops.transform import (forward_transform,
                                               inverse_transform)


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


def _rep(a: torch.Tensor, r: int) -> torch.Tensor:
    """Repeat each element of the two leading axes r times."""
    return a.repeat_interleave(r, 0).repeat_interleave(r, 1)


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """Append `rows` zero rows (dim 0)."""
    if rows == 0:
        return a
    return torch.cat([a, a.new_zeros((rows,) + a.shape[1:])], dim=0)


def _decim(p: torch.Tensor) -> torch.Tensor:
    """2x2 rounded average of an int32 plane (odd edges dropped)."""
    h2, w2 = (p.shape[0] // 2) * 2, (p.shape[1] // 2) * 2
    q = p[:h2, :w2]
    return (q[0::2, 0::2] + q[1::2, 0::2]
            + q[0::2, 1::2] + q[1::2, 1::2] + 2) >> 2


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _top_k_votes(cost: torch.Tensor, k: int) -> torch.Tensor:
    """Histogram over the rows of cost (n, blocks): each block votes for
    its k cheapest rows. Duplicates add up (index_add_, not an indexed
    +=)."""
    cc = cost.clone()
    dev = cc.device
    hist = torch.zeros(cc.shape[0], dtype=torch.int32, device=dev)
    ones = torch.ones(cc.shape[1], dtype=torch.int32, device=dev)
    for _ in range(k):
        kb = cc.argmin(dim=0)
        hist.index_add_(0, kb, ones)
        cc.scatter_(0, kb[None], 1 << 30)       # each block's kb row
    return hist


def _take_top(hist: torch.Tensor, g: int) -> list:
    """The g most voted entries of hist, first maximum first, as device
    scalars (no host sync); hist is consumed."""
    out = []
    for _ in range(g):
        kg = hist.argmax()
        out.append(kg)
        hist.index_fill_(0, kg.reshape(1), -1)
    return out


def _sum2x2(c: torch.Tensor) -> torch.Tensor:
    """(2gh, 2gw) float32 -> (gh, gw) sums of 2x2 groups, added in XLA's
    order for a reduce over the two size-2 axes, (c00 + c01) + c10 + c11:
    the sums are not integers, so their rounding follows the order."""
    return (c[0::2, 0::2] + c[0::2, 1::2]) + c[1::2, 0::2] + c[1::2, 1::2]


def _blocks(p: torch.Tensor, n: int) -> torch.Tensor:
    """(hh, ww) plane -> (hh/n * ww/n, n, n) raster-ordered blocks."""
    hh, ww = p.shape
    return p.reshape(hh // n, n, ww // n, n).permute(0, 2, 1, 3) \
        .reshape(-1, n, n)


def _unblock(b: torch.Tensor, n: int, hh: int, ww: int) -> torch.Tensor:
    return b.reshape(hh // n, ww // n, n, n).permute(0, 2, 1, 3) \
        .reshape(hh, ww)


def _recon(pred, lvl, rres):
    """The reconstruction of a TU: pred + residual where the TU codes a
    nonzero level, the prediction where it codes none."""
    nz = (lvl != 0).any(dim=-1).any(dim=-1)
    return torch.where(nz[:, None, None], torch.clamp(pred + rres, 0, 255),
                       pred)


# the intra-in-P fallback's MPM modes: independence => every intra CU's
# neighbours are inter, so the decoder-side MPM list is the constant
# mpm_candidates(DC, DC)
_IN_MPM = np.isin(np.arange(35), (0, 1, 26))

# the most CUDA graphs (keys) an inter encoder keeps live; a key past them
# runs eagerly
MAX_GRAPHS = 4


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
        # performance modes: FAST (>= 1) drops the merge-RD stage and masks
        # the CU32/CU64 consolidation by the fast-skip predicate; UFAST
        # (>= 2) also drops the CU64 layer
        self.perf = int(getattr(cfg, "performance_mode", 0))
        self.merge_rd = (bool(getattr(cfg, "merge_rd_device", True))
                         and self.perf == 0)
        # FAR (4x-decimated) level beyond the 2x sweep's +-2*search reach;
        # reach = the maximum full-pel roam of any ME candidate (sets the
        # reference padding): FAR centres reach +-(far+4), their +-2
        # neighbourhoods +-(far+6)
        self.far = cfg.me_range if cfg.me_range > max(32, 2 * search) else 0
        self.reach = max(2 * search + 2, self.far + 8)
        if self.far:
            # the FAR level's (qx, qy) grid and which of it votes
            grid, vote_mask = far_grid(search, self.far)
            self.far_grid = (
                torch.as_tensor([q[0] for q in grid], dtype=torch.int32,
                                device=self.device),
                torch.as_tensor([q[1] for q in grid], dtype=torch.int32,
                                device=self.device),
                torch.as_tensor(vote_mask, device=self.device))
        self.gw, self.gh = self.w // cu, self.h // cu
        # the CU tree: CU32 over CU16 at CTU 32 and 64; CTU 64 adds the
        # CU64 layer (luma as four forced-split TU32s) unless UFAST
        self.tree = ps.ctu_size in (32, 64)
        self.tree64 = ps.ctu_size == 64 and self.perf < 2
        if self.tree64:
            assert self.w % 64 == 0 and self.h % 64 == 0, \
                "the CTU-64 P program needs dimensions divisible by 64"
        self.gw2, self.gh2 = self.w // 32, self.h // 32
        self.gw4, self.gh4 = self.w // 64, self.h // 64
        n_tot = self.w * self.h * 3 // 2
        self.pack_C = pack_capacity(n_tot, max(0, cfg.qp - 4))
        self.cg_C = cg_cap(n_tot, max(0, cfg.qp - 4))
        # the two tables the program reads (the intra encoders' layout
        # tables would cost ~1 s per encoder at 1080p)
        self.mvd_bits = torch.as_tensor(T.MVD_BITS, device=self.device)
        self.rd_lambda_p = torch.as_tensor(T.RD_LAMBDA_P_TAB,
                                           device=self.device)
        self.chroma_qp_map = torch.as_tensor(T.CHROMA_QP_MAP,
                                             device=self.device)
        self.taps = torch.as_tensor(LUMA_TAPS, device=self.device)
        # the +-step neighbourhoods of the sub-pel refinement
        self.steps = {s: [torch.tensor([dx, dy], dtype=torch.int32,
                                       device=self.device)
                          for dy in (-s, 0, s) for dx in (-s, 0, s)]
                      for s in (1, 2)}
        if cfg.intra_in_p:
            # static z-scan reference availability of the CU16 fallback
            # grid (luma 16x16, chroma 8x8 blocks)
            gxs = np.arange(self.w // 16)
            gys = np.arange(self.h // 16)
            self.if_mask = torch.as_tensor(dip.avail_masks(
                self.w, self.h, ps.ctu_size, 16, 0, gxs[None, :] * 16,
                gys[:, None] * 16), device=self.device)
            self.if_mask_c = torch.as_tensor(dip.avail_masks(
                self.w, self.h, ps.ctu_size, 8, 1, gxs[None, :] * 8,
                gys[:, None] * 8), device=self.device)
            # the fallback's mode rates: of its RD cost (float32), and of
            # its mode search at each slice QP (52, 35)
            self.if_mode_bits = torch.as_tensor(
                np.where(_IN_MPM, INTRA_P_MODE_BITS_MPM,
                         INTRA_P_MODE_BITS_REM).astype(np.float32),
                device=self.device)
            bits = np.asarray([T.intra_mode_bits(q) for q in range(52)],
                              np.int32)
            self.if_mode_sad_bits = torch.as_tensor(
                np.where(_IN_MPM, bits[:, :1], bits[:, 1:]),
                device=self.device)
        # the SAO lambda x 256 at each slice QP
        self.sao_lam = sao_lambda_x256(torch.arange(52)).to(self.device)
        self._aranges = {}
        # by key (_launch): the keys dispatched once, and the graphs of
        # those dispatched again while fewer than MAX_GRAPHS were live
        self._seen: set[tuple] = set()
        self._graphs: dict[tuple, _SweepSplitGraph] = {}
        self.last_dev = None

    def _bits(self, v: torch.Tensor) -> torch.Tensor:
        """MVD rate of each component; |v| clamped to the table's end (as
        the JAX gather clamps out-of-range indices)."""
        t = self.mvd_bits
        return t[torch.clamp(torch.abs(v), max=t.shape[0] - 1).long()]

    def _mv_rate(self, dx, dy, pr) -> torch.Tensor:
        return self._bits(dx - pr[0]) + self._bits(dy - pr[1])

    def _hier_me(self, sy, ry, lam16: int):
        """Hierarchical shortlist full-pel ME vs one reference plane
        (golden twin: hier_pel_fields). sy is the source plane: uint8, or
        int16 where its values may leave [0, 255] (the B program's bi
        target 2 * src - pred, in [-255, 510]); ry the int32 reference.
        A generator: it yields the coarse sweep's (decimated source,
        padded decimated reference) and takes their SADs back (_eager
        drives it alone). Returns (mvs (B, 2) qpel, prior, mv32 (B2, 2)
        qpel, prior2, mv64 (B4, 2) qpel, prior4); the tree levels are
        None when the program has no tree / no CU64 layer."""
        cu = self.cu
        gw, gh = self.gw, self.gh
        R = self.search
        dev = self.device
        side = 2 * R + 1
        K, G16, G32, G64 = 3, 8, 4, 2

        m = cu // 2
        # the decimated source keeps the plane's own dtype (a 2x2 mean
        # stays inside its plane's range), so a wide plane is never cast
        # to uint8; the sweep's entry point follows the dtype
        assert sy.dtype in (torch.uint8, torch.int16), sy.dtype
        sd = _decim(sy.to(torch.int32)).to(sy.dtype).contiguous()
        rd = _decim(ry)
        pad_c = pad_edge(rd.to(torch.uint8), R, R).contiguous()
        # coarse sweep: launched by the driver (_sweep), outside the
        # program and its graphs
        sads = yield sd, pad_c
        n_off = side * side
        ks = torch.arange(n_off, dtype=torch.int32, device=dev)

        def prior_votes(sads_lvl, g):
            """The prior (the offset of least total SAD) and the g offsets
            most voted for by the blocks' K cheapest."""
            gq = sads_lvl.sum(dim=(1, 2), dtype=torch.int64).argmin()
            pr = torch.stack([8 * (gq % side - R),
                              8 * (_floordiv(gq, side) - R)]).to(torch.int32)
            rate = self._mv_rate(8 * (ks % side - R),
                                 8 * (_floordiv(ks, side) - R), pr)
            cost = 4 * sads_lvl + ((lam16 * rate) >> 4)[:, None, None]
            return pr, _take_top(_top_k_votes(cost.reshape(n_off, -1), K),
                                 g)

        gh2, gw2 = self.gh2, self.gw2
        prior, short16 = prior_votes(sads, G16)
        prior2 = prior4 = None
        short32, short64 = [], []
        if self.tree:
            # 32-level coarse SADs: 2x2 sums (a height that is not a
            # multiple of 32 leaves its last CU16 row out)
            s4c = sads[:, :gh2 * 2, :].reshape(n_off, gh2, 2, gw2, 2) \
                .sum(dim=(2, 4), dtype=torch.int32)
            prior2, short32 = prior_votes(s4c, G32)
        tree64 = self.tree64 and self.gh4 > 0 and self.gw4 > 0
        if tree64:
            gh4, gw4 = self.gh4, self.gw4
            s8c = s4c[:, :gh4 * 2, :gw4 * 2] \
                .reshape(n_off, gh4, 2, gw4, 2).sum(dim=(2, 4),
                                                    dtype=torch.int32)
            prior4, short64 = prior_votes(s8c, G64)

        # the FAR (4x-decimated) level: global candidates beyond the 2x
        # reach (golden twin: the far block of hier_pel_fields)
        far_centers = []                       # device (cdx, cdy) pairs
        if self.far:
            far_centers = self._far_centers(sd, rd, prior, lam16, K)

        # offset list: exact +-4 fine sweep, then the shortlist and FAR
        # neighbourhoods (golden order: argmin first-min == the golden
        # sequential strict-< scan)
        Fr = 4
        nf = 2 * Fr + 1
        fine_k = torch.arange(nf * nf, dtype=torch.int32, device=dev)
        all_dx = [fine_k % nf - Fr]
        all_dy = [_floordiv(fine_k, nf) - Fr]
        go = torch.arange(25, dtype=torch.int32, device=dev)
        grid_dx = go % 5 - 2
        grid_dy = _floordiv(go, 5) - 2
        centers = []
        for kg in short16 + short32 + short64:
            centers.append(((2 * (kg % side - R)).to(torch.int32),
                            (2 * (_floordiv(kg, side) - R)).to(torch.int32)))
        centers += far_centers
        for cdx, cdy in centers:
            all_dx.append(cdx + grid_dx)
            all_dy.append(cdy + grid_dy)
        all_dx = torch.cat(all_dx)
        all_dy = torch.cat(all_dy)
        n_offs_r = all_dx.shape[0]
        P = self.reach
        # every band lies inside the padding: shortlist centres roam
        # +-2R, FAR centres +-(4 * far // 4 + 4), each with +-2 around
        assert P >= 2 * R + 2 and P >= 4 * (self.far // 4) + 6
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

        def level_best(sads_lvl, pr):
            rate = self._mv_rate(4 * all_dx, 4 * all_dy, pr)
            cost = sads_lvl.reshape(n_offs_r, -1) \
                + ((lam16 * rate) >> 4)[:, None]
            bi = cost.argmin(dim=0)
            return torch.stack([all_dx[bi], all_dy[bi]], dim=-1) * 4

        mvs = level_best(sads_r, prior)
        mv32 = mv64 = None
        if self.tree:
            s32r = sads_r[:, :gh2 * 2, :] \
                .reshape(n_offs_r, gh2, 2, gw2, 2).sum(dim=(2, 4),
                                                       dtype=torch.int32)
            mv32 = level_best(s32r, prior2)
            if tree64:
                s64r = s32r[:, :self.gh4 * 2, :self.gw4 * 2] \
                    .reshape(n_offs_r, self.gh4, 2, self.gw4, 2) \
                    .sum(dim=(2, 4), dtype=torch.int32)
                mv64 = level_best(s64r, prior4)
        return mvs, prior, mv32, prior2, mv64, prior4

    def _far_centers(self, sd, rd, prior, lam16: int, K: int):
        """The FAR level of _hier_me: a dense 4x-decimated sweep over
        +-far x +-min(far, 64) full-pel, votes of the offsets the 2x sweep
        does not cover, and a 2x-level +-2 refine of the GQ most voted by
        global decimated SAD. sd is the 2x-decimated source with its true
        values (uint8 or int16). Returns GQ device (cdx, cdy) full-pel
        centres."""
        dev = self.device
        GQ = 4
        qxs, qys, vote_mask = self.far_grid
        n_grid = qxs.shape[0]
        xq, yq = self.far // 4, min(self.far // 4, 16)
        sd4 = _decim(sd.to(torch.int32))
        rd4 = _decim(rd)
        m4 = 4
        gh4x, gw4x = sd4.shape[0] // m4, sd4.shape[1] // m4
        h4, w4 = gh4x * m4, gw4x * m4
        sd4 = sd4[:h4, :w4].to(torch.int16)
        pad_q = pad_edge(rd4.to(torch.uint8), yq, xq)
        # grid order: qy major, qx minor; one row band per qy, its 2xq+1
        # column shifts as windows of the band
        sq_rows = []
        for qy in range(-yq, yq + 1):
            band = pad_q[yq + qy:yq + qy + h4].to(torch.int16)
            win = band.unfold(1, w4, 1)[:, :2 * xq + 1]   # (h4, nqx, w4)
            d = torch.abs(sd4[:, None, :] - win).to(torch.int32)
            sq_rows.append(d.reshape(gh4x, m4, 2 * xq + 1, gw4x, m4)
                           .sum(dim=(1, 4), dtype=torch.int32)
                           .permute(1, 0, 2))           # (nqx, gh4x, gw4x)
        sads_q = torch.cat(sq_rows)                     # (n_grid, ...)
        rate_q = self._mv_rate(16 * qxs, 16 * qys, prior)
        cost_q = 16 * sads_q + ((lam16 * rate_q) >> 4)[:, None, None]
        # the offsets the 2x sweep covers never vote
        cq = torch.where(vote_mask[:, None], cost_q.reshape(n_grid, -1),
                         1 << 30)
        hist_q = _top_k_votes(cq, K)
        # 2x-level +-2 refine of each candidate by GLOBAL decimated SAD;
        # the bands start at py2 + 2qy + oy >= 0 and end inside the plane
        py2, px2 = 2 * yq + 2, 2 * xq + 2
        pad_c2 = pad_edge(rd.to(torch.uint8), py2, px2)
        h2c, w2c = sd.shape
        sdi = sd.to(torch.int16)
        ar_h = torch.arange(h2c, device=dev)
        ar_w = torch.arange(w2c + 4, device=dev)
        centers = []
        for kq in _take_top(hist_q, GQ):
            # take: a device-valued index that never waits for the card
            qx, qy = torch.take(qxs, kq), torch.take(qys, kq)
            cols_b = px2 + 2 * qx - 2 + ar_w
            gsum = []
            for oy in (-2, -1, 0, 1, 2):
                band = pad_c2.index_select(0, py2 + 2 * qy + oy + ar_h) \
                    .index_select(1, cols_b).to(torch.int16)
                win = band.unfold(1, w2c, 1)                # (h2c, 5, w2c)
                gsum.append(torch.abs(sdi[:, None, :] - win)
                            .to(torch.int32).sum(dim=(0, 2),
                                                 dtype=torch.int32))
            gbest = torch.cat(gsum).argmin().to(torch.int32)
            centers.append((4 * qx + 2 * (gbest % 5 - 2),
                            4 * qy + 2 * (_floordiv(gbest, 5) - 2)))
        return centers

    # ---- device program -----------------------------------------------------

    def _qp_vectors(self, qp_map):
        """The per-block QP vectors of a per-CTB QP map (rows, cols) on the
        device: (luma, chroma) for the CU16 blocks, the CTB32s (tree) and
        the four TU quarters of each CTB64 (CU64 layer); those of a layer
        the program does not run are None."""
        ctu = self.ps.ctu_size
        qpm = qp_map.to(torch.int32)

        def chroma(q):
            return self.chroma_qp_map[
                torch.clamp(q + self.ps.cb_qp_offset, 0, 57).long()]
        qp16 = _rep(qpm, ctu // self.cu)[:self.gh, :self.gw].reshape(-1)
        out = [(qp16, chroma(qp16)), (None, None), (None, None)]
        if self.tree:
            qp32 = _rep(qpm, ctu // 32)[:self.gh2, :self.gw2].reshape(-1)
            out[1] = (qp32, chroma(qp32))
        if self.tree64:
            qp64 = qpm.reshape(-1).repeat_interleave(4)
            out[2] = (qp64, chroma(qp64))
        return out

    def _impl(self, src_y, src_u, src_v, ref_y, ref_u, ref_v, zf_mult,
              qp: int, qp_map=None):
        """One P frame. qp_map: None, or the per-CTB QP map (rows, cols)
        int32 on the device (AQ / row-RC): the quant of every level reads
        per-block QP vectors; the lambdas and the zero-forcing stay at the
        slice QP; merge-RD and intra-in-P are skipped. A generator over
        its one coarse sweep (_hier_me); returns the wire's outputs."""
        cu, cuc = self.cu, self.cu // 2
        gw, gh = self.gw, self.gh
        dev = self.device
        sy = src_y.to(torch.int32)
        su = src_u.to(torch.int32)
        sv = src_v.to(torch.int32)
        ry = ref_y.to(torch.int32)
        # host scalars from the numpy tables (no device round trip)
        qp_c = int(T.CHROMA_QP_MAP[min(max(qp + self.ps.cb_qp_offset, 0),
                                       57)])
        lam16 = int(T.LAMBDA_ME_X16_TAB[qp])
        if qp_map is None:
            (qp16, qpc16), (qp32, qpc32), (qp64, qpc64) = [(qp, qp_c)] * 3
        else:
            (qp16, qpc16), (qp32, qpc32), (qp64, qpc64) = \
                self._qp_vectors(qp_map)
        mvs, prior, mv32, prior2, mv64, prior4 = \
            yield from self._hier_me(src_y, ry, lam16)

        # ---- sub-pel refinement (half then quarter) over one (n+8)^2
        # patch per block, all 16 quarter-pel phases interpolated ----
        B = gh * gw
        padL = self.reach + 8
        ref_padL = pad_edge(ry, padL, padL)
        bidx = torch.arange(B, device=dev, dtype=torch.int32)
        x0s = (bidx % gw) * cu
        y0s = torch.div(bidx, gw, rounding_mode="floor") * cu
        src_blk = _blocks(sy, cu)
        me_prec = int(self.cfg.motion_estimation_precision)

        def make_v16(x0v, y0v, mv0, n):
            v16, _, ix0, iy0 = self._make_v(ref_padL, padL, x0v, y0v, mv0, n)
            return v16, ix0, iy0

        def subpel(x0v, y0v, src_b, mv0, n, pr):
            """Half- then quarter-pel refinement and the prediction at the
            refined MV."""
            v16, ix0, iy0 = make_v16(x0v, y0v, mv0, n)
            mv = mv0
            for step in (2, 1)[:me_prec]:
                mv = self._refine(v16, ix0, iy0, src_b, n, mv, step, pr,
                                  lam16)
            return mv, self._sel_phase(v16, ix0, iy0, mv, n)

        def code(resid, n, q):
            return self._code(resid, n, q, zf_mult)

        # ---- luma MC + residual ----
        mvs, pred = subpel(x0s, y0s, src_blk, mvs, cu, prior)
        resid = src_blk - pred
        lvl, rres = code(resid, cu, qp16)
        rec = _recon(pred, lvl, rres)

        lam = self.rd_lambda_p[qp]                        # float32 scalar

        def model_cost(src_b, rec_b, lvl_b, bits_b):
            return self._model_cost(src_b, rec_b, lvl_b, bits_b, lam)

        def cu_cost(src_b, rec_b, lvl_b, mv_b, pr):
            """The CU cost with a 6-bin overhead and the MV's rate against
            the prior pr (CU_AMVP_BITS == 6.0)."""
            rt = self._mv_rate(mv_b[:, 0], mv_b[:, 1], pr).to(torch.float32)
            return model_cost(src_b, rec_b, lvl_b, 6.0 + rt)

        # ---- batched merge-RD (golden twin: merge_rd_fast): the first two
        # spec merge candidates from the pre-pass field, re-coded and
        # model-costed; a king-independent improving subset flips ----
        if (not self.tree) and self.merge_rd and qp_map is None:
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
            cur_cost = cu_cost(src_blk, rec, lvl, mvs, prior)
            best_cost = torch.full((B,), float("inf"), dtype=torch.float32,
                                   device=dev)
            best_lvl, best_rec, best_mv = lvl, rec, mvs
            for c in range(2):
                mvc = cand[c]
                vC, ixC, iyC = make_v16(x0s, y0s, mvc, cu)
                predc = self._sel_phase(vC, ixC, iyC, mvc, cu)
                residc = src_blk - predc
                lvlc_, rrc_ = code(residc, cu, qp)
                recc_ = _recon(predc, lvlc_, rrc_)
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
        ref_padU = pad_edge(ref_u.to(torch.int32), padC, padC)
        ref_padV = pad_edge(ref_v.to(torch.int32), padC, padC)

        def chroma(src_c, ref_padc, x0v, y0v, n, mv, rows, q):
            """Chroma MC + residual of the n x n chroma blocks at luma
            origins (x0v, y0v), coded as TUs of at most 16 at the QP q:
            (levels, recon), (B, n, n) each."""
            predc = mc_chroma_batch(ref_padc, padC, x0v // 2, y0v // 2, n,
                                    mv)
            src_cb = _blocks(src_c[:rows], n)
            resc = src_cb - predc
            if n <= 16:
                lvlc, rrc = code(resc, n, q)
                return lvlc, _recon(predc, lvlc, rrc)
            # CU64: four 16x16 TUs over the 32x32 chroma block
            lvlc, rrc = code(_quarters(resc, 16), 16, q)
            return (_full(lvlc, 16),
                    torch.clamp(predc + _full(rrc, 16), 0, 255))

        hc, wc = self.h // 2, self.w // 2
        lvl_u, rec_u = chroma(su, ref_padU, x0s, y0s, cuc, mvs, hc, qpc16)
        lvl_v, rec_v = chroma(sv, ref_padV, x0s, y0s, cuc, mvs, hc, qpc16)
        recon_y = _unblock(rec, cu, self.h, self.w)
        recon_u = _unblock(rec_u, cuc, hc, wc)
        recon_v = _unblock(rec_v, cuc, hc, wc)
        ly = _unblock(lvl.to(torch.int16), cu, self.h, self.w)
        lu = _unblock(lvl_u.to(torch.int16), cuc, hc, wc)
        lv = _unblock(lvl_v.to(torch.int16), cuc, hc, wc)
        extra = [mvs.reshape(gh, gw, 2).to(torch.int16)]
        planes = [recon_y, recon_u, recon_v, ly, lu, lv]
        # deblocking maps on the 8-grid: nonzero TU, MV, TU size
        nz8 = _rep(nz.reshape(gh, gw), 2)
        mv8 = _rep(mvs.reshape(gh, gw, 2), 2)
        ts8 = 16
        excl16 = None

        intra_in_p = self.cfg.intra_in_p and qp_map is None
        if not self.tree:
            c16 = None
            if intra_in_p:
                c16 = cu_cost(src_blk, rec, lvl, mvs, prior).reshape(gh, gw)
        else:
            # ---- CU32 layer: code each full CTB32 as one CU32, keep
            # whichever side wins SSD + lambda * rate (golden
            # encode_inter_frame_tree twin); mv32 / prior2 come from the
            # shared 16/32 shortlist search ----
            gh2, gw2 = self.gh2, self.gw2
            B2 = gh2 * gw2
            b2 = torch.arange(B2, device=dev, dtype=torch.int32)
            x0s2 = (b2 % gw2) * 32
            y0s2 = torch.div(b2, gw2, rounding_mode="floor") * 32
            src32 = _blocks(sy[:gh2 * 32], 32)
            mv32, pred32 = subpel(x0s2, y0s2, src32, mv32, 32, prior2)
            lvl32, rres32 = code(src32 - pred32, 32, qp32)
            nz32 = (lvl32 != 0).any(dim=-1).any(dim=-1)
            rec32 = _recon(pred32, lvl32, rres32)
            c32 = cu_cost(src32, rec32, lvl32, mv32, prior2) \
                .reshape(gh2, gw2)
            c16 = cu_cost(src_blk, rec, lvl, mvs, prior2).reshape(gh, gw)
            c16p = _sum2x2(c16[:gh2 * 2])
            choose = c32 <= c16p                           # (gh2, gw2)
            mv16g = mvs.reshape(gh, gw, 2)
            if self.perf >= 1:
                # fast-skip consolidation (golden mv_spread16 twin): a
                # merged CU whose sub-CU motion disagrees by > 16 qpel
                # never wins
                choose = choose & (self._spread(mv16g[:gh2 * 2], 2) <= 16)
            lvl_u32, rec_u32 = chroma(su, ref_padU, x0s2, y0s2, 16, mv32,
                                      gh2 * 16, qpc32)
            lvl_v32, rec_v32 = chroma(sv, ref_padV, x0s2, y0s2, 16, mv32,
                                      gh2 * 16, qpc32)

            planes = [_combine32(p, b, m, choose) for p, b, m in zip(
                planes, (rec32, rec_u32, rec_v32, lvl32, lvl_u32, lvl_v32),
                (32, 16, 16, 32, 16, 16))]
            extra += [choose.to(torch.uint8),
                      mv32.reshape(gh2, gw2, 2).to(torch.int16)]
            # the deblocking maps of the adopted CU32s (their TU is 32)
            pad_rows = self.h // 8 - gh2 * 4
            chf = _pad_rows(_rep(choose, 4), pad_rows)
            nz8 = torch.where(chf, _pad_rows(_rep(nz32.reshape(gh2, gw2), 4),
                                             pad_rows), nz8)
            mv8 = torch.where(chf[..., None],
                              _pad_rows(_rep(mv32.reshape(gh2, gw2, 2), 4),
                                        pad_rows), mv8)
            ts8 = torch.where(chf, 32, 16)
            ch16 = _rep(choose, 2)

            if self.tree64:
                # ---- CU64 layer (CTB64): one CU64 per CTB, luma as four
                # forced-split TU32s (golden twin: encode_inter_frame_tree
                # want64); its refine reads prior2, as the reference
                # does ----
                gh4, gw4 = self.gh4, self.gw4
                B4 = gh4 * gw4
                b4 = torch.arange(B4, device=dev, dtype=torch.int32)
                x0s4 = (b4 % gw4) * 64
                y0s4 = torch.div(b4, gw4, rounding_mode="floor") * 64
                src64 = _blocks(sy, 64)
                mv64, pred64 = subpel(x0s4, y0s4, src64, mv64, 64, prior2)
                lvl64q, rr64q = code(_quarters(src64 - pred64, 32), 32,
                                     qp64)
                nz64q = (lvl64q != 0).any(dim=-1).any(dim=-1)  # (B4*4,)
                lvl64 = _full(lvl64q, 32)
                rec64 = torch.clamp(pred64 + _full(rr64q, 32), 0, 255)
                c64 = cu_cost(src64, rec64, lvl64, mv64, prior2) \
                    .reshape(gh4, gw4)
                # the adopted region's cost after the CU32 pass
                r32 = torch.where(choose, c32, c16p)
                choose64 = c64 <= _sum2x2(r32[:gh4 * 2, :gw4 * 2])
                if self.perf >= 1:
                    # fast-skip over the motion field after the CU32
                    # adoption (golden reads desc.mv after the CU32 pass)
                    mv16p = torch.where(
                        ch16[..., None], _rep(mv32.reshape(gh2, gw2, 2), 2),
                        mv16g[:gh2 * 2])
                    choose64 = choose64 & (
                        self._spread(mv16p[:gh4 * 4, :gw4 * 4], 4) <= 16)
                lvl_u64, rec_u64 = chroma(su, ref_padU, x0s4, y0s4, 32,
                                          mv64, hc, qpc64)
                lvl_v64, rec_v64 = chroma(sv, ref_padV, x0s4, y0s4, 32,
                                          mv64, hc, qpc64)

                def combine64(plane, blocks, m):
                    p64 = _unblock(blocks.to(plane.dtype), m, gh4 * m,
                                   gw4 * m)
                    return torch.where(_rep(choose64, m), p64, plane)

                planes = [combine64(p, b, m) for p, b, m in zip(
                    planes, (rec64, rec_u64, rec_v64, lvl64, lvl_u64,
                             lvl_v64), (64, 32, 32, 64, 32, 32))]
                extra += [choose64.to(torch.uint8),
                          mv64.reshape(gh4, gw4, 2).to(torch.int16)]
                ch8_64 = _rep(choose64, 8)
                # per-TU32 nonzero map on the 8-grid; CU64 luma TUs are
                # the four forced-split TU32s
                nzq8 = _rep(nz64q.reshape(gh4, gw4, 2, 2).permute(0, 2, 1, 3)
                            .reshape(gh4 * 2, gw4 * 2), 4)
                nz8 = torch.where(ch8_64, nzq8, nz8)
                mv8 = torch.where(ch8_64[..., None],
                                  _rep(mv64.reshape(gh4, gw4, 2), 8), mv8)
                ts8 = torch.where(ch8_64, 32, ts8)
                ch16 = ch16 | _rep(choose64, 4)[:ch16.shape[0],
                                                :ch16.shape[1]]
            # CU16 cells covered by an adopted CU32 / CU64 are excluded
            # from the intra fallback (golden skips consolidated nodes)
            excl16 = _pad_rows(ch16, gh - ch16.shape[0])

        recon_y, recon_u, recon_v, ly, lu, lv = planes
        intra8 = None
        if intra_in_p:
            (recon_y, recon_u, recon_v, ly, lu, lv, intra16,
             imode16) = self._intra_fallback(
                sy, su, sv, recon_y, recon_u, recon_v, ly, lu, lv, qp,
                qp_c, c16, lam, excl16)
            extra += [intra16.to(torch.uint8), imode16.to(torch.uint8)]
            intra8 = _rep(intra16, 2)
        if self.ps.deblocking_enabled:
            recon_y = self._deblock_inter(recon_y, nz8, mv8, qp, ts8, intra8)
            if intra8 is not None:
                recon_u, recon_v = self._deblock_chroma_intra(
                    recon_u, recon_v, intra8, qp)
        if self.ps.sao_enabled:
            recon_y, recon_u, recon_v, sao_p = self._sao(
                sy, su, sv, recon_y, recon_u, recon_v, qp)
            extra.append(sao_p)
        return self._wire(recon_y, recon_u, recon_v, sy, extra, ly, lu, lv)

    def _impl_b(self, src_y, src_u, src_v, r0y, r0u, r0v, r1y, r1u, r1v,
                zf_mult, qp: int):
        """The bi-capable frame (a B frame of IBP, or a generalized-B "P"
        frame) of the CU32/CU16 tree, with a per-CU choice of uni-L0,
        uni-L1 or bi by SSD + lambda * rate: the twin of the JAX
        _impl_b and of golden encode_b_frame_tree; a generator over its
        three coarse sweeps (_hier_me). The uni-L1 candidate
        searches the source, the bi list-1 field the bi target
        2 * src - pred0 (a wide plane, in [-255, 510]); list 0 is then
        re-refined against 2 * src - pred1. Bi predicts by the normative
        14-bit average (p14a + p14b + 64) >> 7."""
        assert self.tree
        cu, cuc = self.cu, self.cu // 2
        gw, gh = self.gw, self.gh
        gh2, gw2 = self.gh2, self.gw2
        dev = self.device
        sy = src_y.to(torch.int32)
        su = src_u.to(torch.int32)
        sv = src_v.to(torch.int32)
        ry0 = r0y.to(torch.int32)
        ry1 = r1y.to(torch.int32)
        qp_c = int(T.CHROMA_QP_MAP[min(max(qp + self.ps.cb_qp_offset, 0),
                                       57)])
        lam16 = int(T.LAMBDA_ME_X16_TAB[qp])
        lam = self.rd_lambda_p[qp]                        # float32 scalar
        me_prec = int(self.cfg.motion_estimation_precision)
        B, B2 = gh * gw, gh2 * gw2
        padL = self.reach + 8
        padC = self.reach // 2 + 4

        mvs0, pr0, mv32_0, pr2_0, _, _ = \
            yield from self._hier_me(src_y, ry0, lam16)
        # the uni-L1 candidate's motion field, matched to the source
        mvs1s, pr1s, mv32_1s, pr2_1s, _, _ = \
            yield from self._hier_me(src_y, ry1, lam16)

        bidx = torch.arange(B, device=dev, dtype=torch.int32)
        x0s = (bidx % gw) * cu
        y0s = torch.div(bidx, gw, rounding_mode="floor") * cu
        b2 = torch.arange(B2, device=dev, dtype=torch.int32)
        x0s2 = (b2 % gw2) * 32
        y0s2 = torch.div(b2, gw2, rounding_mode="floor") * 32
        src_blk = _blocks(sy, cu)
        src32 = _blocks(sy[:gh2 * 32], 32)
        ref_padL0 = pad_edge(ry0, padL, padL)
        ref_padL1 = pad_edge(ry1, padL, padL)

        def refine_and_pred(ref_padL, mvq, pr, src_b, x0v, y0v, n):
            """Sub-pel refine mvq; (mvq, its 14-bit prediction, its
            rounded uni prediction)."""
            v16, v14, ix0, iy0 = self._make_v(ref_padL, padL, x0v, y0v, mvq,
                                              n)
            for step in (2, 1)[:me_prec]:
                mvq = self._refine(v16, ix0, iy0, src_b, n, mvq, step, pr,
                                   lam16)
            return (mvq, self._sel_phase(v14, ix0, iy0, mvq, n),
                    self._sel_phase(v16, ix0, iy0, mvq, n))

        def code_pred(pred, src_b, n, q):
            """TU coding of one prediction: (levels, recon, nonzero)."""
            lvl, rres = self._code(src_b - pred, n, q, zf_mult)
            return lvl, _recon(pred, lvl, rres), (lvl != 0).any(-1).any(-1)

        def code_bi(p14a, p14b, src_b, n):
            pred = torch.clamp((p14a + p14b + 64) >> 7, 0, 255)
            return code_pred(pred, src_b, n, qp)

        def rate_of(mv, pr):
            return self._mv_rate(mv[:, 0], mv[:, 1], pr)

        def cu_cost(src_b, rec_b, lvl_b, rt):
            return self._model_cost(src_b, rec_b, lvl_b,
                                    6.0 + rt.to(torch.float32), lam)

        def choose3(cbi, cu0, cu1):
            """The direction bitmask per block: bi wins ties against both
            unis, uni-L0 against uni-L1 (golden choose() twin)."""
            return torch.where((cbi <= cu0) & (cbi <= cu1), 3,
                               torch.where(cu0 <= cu1, 1, 2)) \
                .to(torch.int32)

        def sel3(dirv, a_bi, a_u0, a_u1):
            d = dirv.reshape(dirv.shape + (1,) * (a_bi.ndim - 1))
            return torch.where(d == 3, a_bi, torch.where(d == 1, a_u0, a_u1))

        def refine_bi0(mv0c, pr_, pu8b, p14b, mv1c, pr1_, src_b, x0v, y0v,
                       n, lvl_b, rec_b, nz_b, cb):
            """Alternating bi refinement: re-refine list 0 against the
            complement target 2 * src - pred1 inside the volume at mv0c,
            keep the refined bi coding where it wins RD (golden twin:
            refine_l0_against)."""
            tgt0 = 2 * src_b - pu8b
            v16r, v14r, ixr, iyr = self._make_v(ref_padL0, padL, x0v, y0v,
                                                mv0c, n)
            bounds = (torch.stack([4 * ixr - 4, 4 * iyr - 4], dim=1),
                      torch.stack([4 * ixr + 3, 4 * iyr + 3], dim=1))
            mv0r = mv0c
            for step in (2, 1)[:me_prec]:
                mv0r = self._refine(v16r, ixr, iyr, tgt0, n, mv0r, step, pr_,
                                    lam16, bounds)
            lvl_r, rec_r, nz_r = code_bi(
                self._sel_phase(v14r, ixr, iyr, mv0r, n), p14b, src_b, n)
            cbr = cu_cost(src_b, rec_r, lvl_r,
                          rate_of(mv0r, pr_) + rate_of(mv1c, pr1_))
            use = cbr < cb
            return (torch.where(use[:, None], mv0r, mv0c),
                    torch.where(use[:, None, None], lvl_r, lvl_b),
                    torch.where(use[:, None, None], rec_r, rec_b),
                    torch.where(use, nz_r, nz_b), torch.minimum(cb, cbr))

        def level(l0, l1, tgt_b, l1s, src_b, x0v, y0v, n):
            """One level of the tree (CU16 or CU32) from the refined list-0
            candidate l0 = (mv, prior, 14-bit pred, uni pred), the list-1
            field l1 = (mv, prior) matched to the bi target tgt_b and the
            uni-L1 field l1s matched to the source: the three candidates
            coded, the direction chosen, the chosen coding and the
            effective per-list motion (zero where a list is unused; the bi
            list-0 MV may differ from the uni-L0 one after refine_bi0)."""
            mv0, pr_0, p14_0, pu8_0 = l0
            mv1, p14_1, pu8_1 = refine_and_pred(ref_padL1, *l1, tgt_b, x0v,
                                                y0v, n)
            mv1s, _, pu8_1s = refine_and_pred(ref_padL1, *l1s, src_b, x0v,
                                              y0v, n)
            lvl_bi, rec_bi, nz_bi = code_bi(p14_0, p14_1, src_b, n)
            cbi = cu_cost(src_b, rec_bi, lvl_bi,
                          rate_of(mv0, pr_0) + rate_of(mv1, l1[1]))
            mv0bi, lvl_bi, rec_bi, nz_bi, cbi = refine_bi0(
                mv0, pr_0, pu8_1, p14_1, mv1, l1[1], src_b, x0v, y0v, n,
                lvl_bi, rec_bi, nz_bi, cbi)
            lvl_u0, rec_u0, nz_u0 = code_pred(pu8_0, src_b, n, qp)
            lvl_u1, rec_u1, nz_u1 = code_pred(pu8_1s, src_b, n, qp)
            cu0 = cu_cost(src_b, rec_u0, lvl_u0, rate_of(mv0, pr_0))
            cu1 = cu_cost(src_b, rec_u1, lvl_u1, rate_of(mv1s, l1s[1]))
            dirv = choose3(cbi, cu0, cu1)
            mv1_sel = torch.where((dirv == 3)[:, None], mv1, mv1s)
            return dict(
                dir=dirv, cost=torch.minimum(cbi, torch.minimum(cu0, cu1)),
                lvl=sel3(dirv, lvl_bi, lvl_u0, lvl_u1),
                rec=sel3(dirv, rec_bi, rec_u0, rec_u1),
                nz=sel3(dirv, nz_bi, nz_u0, nz_u1),
                mv0=mv0, mv0bi=mv0bi, mv1=mv1, mv1s=mv1s,
                mv0_eff=torch.where((dirv == 3)[:, None], mv0bi,
                                    torch.where((dirv == 1)[:, None], mv0,
                                                0)),
                mv1_eff=torch.where((dirv & 2).bool()[:, None], mv1_sel, 0))

        # ---- CU16 level: list 0 first, then bi list 1 by bi-target
        # matching (2 * src - pred0) over the whole plane ----
        mvs0, p14, pu8 = refine_and_pred(ref_padL0, mvs0, pr0, src_blk, x0s,
                                         y0s, cu)
        tgt_plane = 2 * sy - _unblock(pu8, cu, self.h, self.w)
        mvs1, pr1, mv32_1, pr2_1, _, _ = yield from self._hier_me(
            tgt_plane.to(torch.int16), ry1, lam16)
        L16 = level((mvs0, pr0, p14, pu8), (mvs1, pr1),
                    _blocks(tgt_plane, cu), (mvs1s, pr1s), src_blk, x0s, y0s,
                    cu)

        # ---- chroma: the chosen direction's prediction, coded once (the
        # uni / bi choice is luma-driven, exactly as golden) ----
        r0up = pad_edge(r0u.to(torch.int32), padC, padC)
        r0vp = pad_edge(r0v.to(torch.int32), padC, padC)
        r1up = pad_edge(r1u.to(torch.int32), padC, padC)
        r1vp = pad_edge(r1v.to(torch.int32), padC, padC)

        def chroma_sel(src_c, rows, rpa, rpb, x0v, y0v, n, L):
            ca14 = mc_chroma_batch_14(rpa, padC, x0v, y0v, n, L["mv0bi"])
            cb14 = mc_chroma_batch_14(rpb, padC, x0v, y0v, n, L["mv1"])
            pred = sel3(L["dir"], torch.clamp((ca14 + cb14 + 64) >> 7, 0, 255),
                        mc_chroma_batch(rpa, padC, x0v, y0v, n, L["mv0"]),
                        mc_chroma_batch(rpb, padC, x0v, y0v, n, L["mv1s"]))
            return code_pred(pred, _blocks(src_c[:rows], n), n, qp_c)[:2]

        hc, wc = self.h // 2, self.w // 2
        lvl_u, rec_u = chroma_sel(su, hc, r0up, r1up, x0s // 2, y0s // 2,
                                  cuc, L16)
        lvl_v, rec_v = chroma_sel(sv, hc, r0vp, r1vp, x0s // 2, y0s // 2,
                                  cuc, L16)
        planes = [_unblock(L16["rec"], cu, self.h, self.w),
                  _unblock(rec_u, cuc, hc, wc), _unblock(rec_v, cuc, hc, wc),
                  _unblock(L16["lvl"].to(torch.int16), cu, self.h, self.w),
                  _unblock(lvl_u.to(torch.int16), cuc, hc, wc),
                  _unblock(lvl_v.to(torch.int16), cuc, hc, wc)]

        # ---- CU32 level (the same three-way selection) ----
        mv32_0, p14, pu8 = refine_and_pred(ref_padL0, mv32_0, pr2_0, src32,
                                           x0s2, y0s2, 32)
        L32 = level((mv32_0, pr2_0, p14, pu8), (mv32_1, pr2_1),
                    2 * src32 - pu8, (mv32_1s, pr2_1s), src32, x0s2, y0s2,
                    32)
        c16p = _sum2x2(L16["cost"].reshape(gh, gw)[:gh2 * 2])
        choose = L32["cost"].reshape(gh2, gw2) <= c16p
        lvl_u32, rec_u32 = chroma_sel(su, gh2 * 16, r0up, r1up, x0s2 // 2,
                                      y0s2 // 2, 16, L32)
        lvl_v32, rec_v32 = chroma_sel(sv, gh2 * 16, r0vp, r1vp, x0s2 // 2,
                                      y0s2 // 2, 16, L32)
        planes = [_combine32(p, b, m, choose) for p, b, m in zip(
            planes, (L32["rec"], rec_u32, rec_v32, L32["lvl"], lvl_u32,
                     lvl_v32), (32, 16, 16, 32, 16, 16))]
        recon_y, recon_u, recon_v, ly, lu, lv = planes

        if self.ps.deblocking_enabled:
            recon_y = self._deblock_bi(recon_y, L16, L32, choose, qp)
        extra = [L16["mv0_eff"].reshape(gh, gw, 2).to(torch.int16),
                 L16["mv1_eff"].reshape(gh, gw, 2).to(torch.int16),
                 L16["dir"].reshape(gh, gw).to(torch.uint8),
                 choose.to(torch.uint8),
                 L32["mv0_eff"].reshape(gh2, gw2, 2).to(torch.int16),
                 L32["mv1_eff"].reshape(gh2, gw2, 2).to(torch.int16),
                 L32["dir"].reshape(gh2, gw2).to(torch.uint8)]
        if self.ps.sao_enabled:
            recon_y, recon_u, recon_v, sao_p = self._sao(
                sy, su, sv, recon_y, recon_u, recon_v, qp)
            extra.append(sao_p)
        return self._wire(recon_y, recon_u, recon_v, sy, extra, ly, lu, lv)

    def _deblock_bi(self, plane_y, L16, L32, choose, qp: int):
        """Luma deblocking of a bi-capable frame (spec 8.7.2.4): on a TU
        edge BS 1 where either side codes a nonzero TU, the directions
        differ, or a list both sides use has MVs 4 quarter-pels or more
        apart (golden bs_between)."""
        gh, gw, gh2, gw2 = self.gh, self.gw, self.gh2, self.gw2
        pad_rows = self.h // 8 - gh2 * 4
        chf = _pad_rows(_rep(choose, 4), pad_rows)

        def map8(key, comps=()):
            a = _rep(L16[key].reshape(gh, gw, *comps), 2)
            b = _pad_rows(_rep(L32[key].reshape(gh2, gw2, *comps), 4),
                          pad_rows)
            return torch.where(chf.reshape(chf.shape + (1,) * len(comps)),
                               b, a)
        nz8, dir8 = map8("nz"), map8("dir")
        ts8 = torch.where(chf, 32, 16)
        ux = torch.arange(nz8.shape[1], device=self.device)[None, :]
        uy = torch.arange(nz8.shape[0], device=self.device)[:, None]
        vv = (ux > 0) & (((ux * 8) % ts8) == 0)
        vh = (uy > 0) & (((uy * 8) % ts8) == 0)
        edge_v = nz8 | _sh1(nz8) | (dir8 != _sh1(dir8))
        edge_h = nz8 | _shift_down(nz8) | (dir8 != _shift_down(dir8))
        for key, bit in (("mv0_eff", 1), ("mv1_eff", 2)):
            mv8 = map8(key, (2,))
            use = (dir8 & bit).bool()
            edge_v = edge_v | ((torch.abs(mv8 - _sh1(mv8)) >= 4).any(dim=-1)
                               & use)
            edge_h = edge_h | ((torch.abs(mv8 - _shift_down(mv8)) >= 4)
                               .any(dim=-1) & use)
        return deblock_luma_bs(plane_y, (vv & edge_v).to(torch.int32),
                               (vh & edge_h).to(torch.int32), qp)

    # ---- the programs' shared stages --------------------------------------

    def _arange(self, n: int) -> torch.Tensor:
        """torch.arange(n) on the device, made once per length."""
        a = self._aranges.get(n)
        if a is None:
            a = self._aranges[n] = torch.arange(n, device=self.device)
        return a

    def _make_v(self, ref_padL, padL: int, x0v, y0v, mv0, n: int):
        """(v16, v14, ix0, iy0): the 16 quarter-pel interpolations
        (16, B, n+1, n+1) of each block's (n+8)^2 patch of ref_padL (the
        reference edge-padded by padL), anchored one pel up-left of the
        full-pel part of mv0, rounded to 8 bits (v16) and as the filter's
        14-bit intermediate (v14, the bi average's input)."""
        taps = self.taps
        ix0, iy0 = mv0[:, 0] >> 2, mv0[:, 1] >> 2
        by = y0v + iy0 - 1 + padL - 3
        bx = x0v + ix0 - 1 + padL - 3
        patch = extract_patches(ref_padL, by, bx, n + 8)    # (B, n+8, n+8)
        h4 = sum(taps[:, k, None, None, None]
                 * patch[None, :, :, k:k + n + 1] for k in range(8))
        v = sum(taps[:, k, None, None, None, None]
                * h4[None, :, :, k:k + n + 1, :] for k in range(8)) >> 6
        v16 = torch.clamp((v + 32) >> 6, 0, 255)
        return (v16.reshape(16, -1, n + 1, n + 1),
                v.reshape(16, -1, n + 1, n + 1), ix0, iy0)

    def _sel_phase(self, v, ix0, iy0, mv, n: int):
        """The (B, n, n) prediction at the quarter-pel mv out of a _make_v
        volume v (its v16 or v14): the phase plane, then one of the four
        integer crops."""
        p = ((mv[:, 1] & 3) * 4 + (mv[:, 0] & 3)).long()
        oy = (mv[:, 1] >> 2) - (iy0 - 1)
        ox = (mv[:, 0] >> 2) - (ix0 - 1)
        sel = v[p, self._arange(mv.shape[0])]               # (B, n+1, n+1)
        idx = (oy * 2 + ox)[:, None, None]
        return torch.where(
            idx == 0, sel[:, 0:n, 0:n],
            torch.where(idx == 1, sel[:, 0:n, 1:n + 1],
                        torch.where(idx == 2, sel[:, 1:n + 1, 0:n],
                                    sel[:, 1:n + 1, 1:n + 1])))

    def _refine(self, v16, ix0, iy0, src_b, n: int, mv_cur, step: int, pr,
                lam16: int, bounds=None):
        """One +-step sub-pel refinement round: the candidate of least
        SAD + MV rate, the first minimum in scan order. bounds (lo, hi)
        clamp each candidate into the interpolation volume, which covers
        two integer positions per axis: a volume anchored at a
        non-zero-phase MV could otherwise be left and _sel_phase would read
        the wrong pixels."""
        bc = torch.full((mv_cur.shape[0],), 1 << 30, dtype=torch.int32,
                        device=self.device)
        bmv = mv_cur
        for off in self.steps[step]:
            cand = mv_cur + off
            if bounds is not None:
                cand = torch.clamp(cand, bounds[0], bounds[1])
            p = self._sel_phase(v16, ix0, iy0, cand, n)
            sad = torch.abs(src_b - p).sum(dim=(-1, -2), dtype=torch.int32)
            rt = self._mv_rate(cand[:, 0], cand[:, 1], pr)
            cost = sad + ((lam16 * rt) >> 4)
            better = cost < bc
            bc = torch.where(better, cost, bc)
            bmv = torch.where(better[:, None], cand, bmv)
        return bmv

    def _code(self, resid, n: int, q, zf_mult):
        """TU coding of a residual at the QP q (an int, or a per-block
        vector): T, Q (+ SBH), IQ, IT and the zero-forcing. Returns
        (levels, reconstructed residual)."""
        sl = self.ps.scaling_list_enabled
        coef = forward_transform(resid, False)
        lvl = quantize(coef, n, q, False, sl)
        if self.ps.sign_hiding:
            lvl = sign_bit_hiding(lvl, coef, n, q, False, 0, sl)
        rres = inverse_transform(dequantize(lvl, n, q, False, sl), False)
        return self._zero_force(resid, lvl, rres, zf_mult)

    @staticmethod
    def _model_cost(src_b, rec_b, lvl_b, bits_b, lam):
        """ssd + lam * (3 nnz + sum|l| + bits), float32. The SSD is summed
        exactly as int32, then rounded once: equal to JAX's float32 sum
        wherever that is exact (below 2^24, always for a 16x16 block),
        rounded once where JAX rounds each partial sum above 2^24, and the
        same on every device."""
        dd = src_b - rec_b
        ssd = (dd * dd).sum(dim=(-1, -2), dtype=torch.int32) \
            .to(torch.float32)
        nnzf = (lvl_b != 0).sum(dim=(-1, -2)).to(torch.float32)
        lsum = torch.abs(lvl_b).sum(dim=(-1, -2)).to(torch.float32)
        return ssd + lam * (3.0 * nnzf + lsum + bits_b)

    @staticmethod
    def _spread(g: torch.Tensor, r: int) -> torch.Tensor:
        """Largest spread (max - min, over both components) of the MVs of
        each r x r group of the CU16 motion field g (r*gh, r*gw, 2)."""
        gh, gw = g.shape[0] // r, g.shape[1] // r
        g = g.reshape(gh, r, gw, r, 2)
        return (g.amax(dim=(1, 3)) - g.amin(dim=(1, 3))).amax(dim=-1)

    def _intra_fallback(self, sy, su, sv, ry, ru, rv, ly, lu, lv, qp: int,
                        qp_c: int, cost_p, lam, excl16):
        """Device twin of golden intra_fallback_p: INTRA_P_ROUNDS batched
        rounds of {35-mode search from the current recon -> TU16 RD ->
        king-graph independent-set commit}. Returns the updated planes and
        levels, and the committed (gh, gw) intra mask and mode map."""
        dev = self.device
        gh, gw = self.h // 16, self.w // 16
        B = gh * gw
        hc, wc = self.h // 2, self.w // 2
        sl = self.ps.scaling_list_enabled
        sbh = self.ps.sign_hiding
        mode_sad_bits = self.if_mode_sad_bits[qp]
        mb_f = self.if_mode_bits
        mask65 = self.if_mask.reshape(B, 65)
        mask33 = self.if_mask_c.reshape(B, 33)
        src16 = _blocks(sy, 16)
        srcu = _blocks(su, 8)
        srcv = _blocks(sv, 8)
        ar = torch.arange(B, device=dev)
        is_intra = torch.zeros((gh, gw), dtype=torch.bool, device=dev)
        mode16 = torch.zeros((gh, gw), dtype=torch.int32, device=dev)

        def code_intra(resid, n, q):
            coef = forward_transform(resid, False)
            lvl = quantize(coef, n, q, True, sl)
            if sbh:
                lvl = sign_bit_hiding(lvl, coef, n, q, True, 0, sl)
            rres = inverse_transform(dequantize(lvl, n, q, True, sl), False)
            return lvl, rres

        for _ in range(INTRA_P_ROUNDS):
            # X may not be a reference of a committed intra CU (committed
            # at X's E, SE, S, SW or NE neighbour blocks X)
            p = torch.zeros((gh + 2, gw + 2), dtype=torch.bool, device=dev)
            p[1:-1, 1:-1] = is_intra
            blocked = (p[1:-1, 2:] | p[2:, 2:] | p[2:, 1:-1]
                       | p[2:, :-2] | p[:-2, 2:])
            seq = dip.substitute_refs(
                dip.gather_ref_seq(ry, 16).reshape(B, 65), mask65)
            top, left = dip.seq_to_refs(seq, 16)
            preds = dip.edge_fixes(dip.predict_all_modes(top, left, 16, True),
                                   top, left, 16, True)
            sad = torch.abs(src16[:, None] - preds).sum(dim=(-1, -2),
                                                        dtype=torch.int32)
            mode = (sad + mode_sad_bits[None, :]).argmin(dim=-1)
            pred = preds[ar, mode]
            lvl, rres = code_intra(src16 - pred, 16, qp)
            nz = (lvl != 0).any(dim=-1).any(dim=-1)
            rec = torch.where(nz[:, None, None],
                              torch.clamp(pred + rres, 0, 255), pred)
            d = src16 - rec
            ssd = (d * d).sum(dim=(-1, -2), dtype=torch.int32) \
                .to(torch.float32)
            nnzf = (lvl != 0).sum(dim=(-1, -2)).to(torch.float32)
            lsum = torch.abs(lvl).sum(dim=(-1, -2)).to(torch.float32)
            cost_i = ssd + lam * (3.0 * nnzf + lsum + 6.0 + mb_f[mode])
            want = (cost_i.reshape(gh, gw) < cost_p) & ~is_intra & ~blocked
            if excl16 is not None:
                want = want & ~excl16
            sel = select_intra_independent(want)
            is_intra = is_intra | sel
            mode16 = torch.where(sel, mode.reshape(gh, gw).to(torch.int32),
                                 mode16)
            selrep = _rep(sel, 16)
            ry = torch.where(selrep, _unblock(rec, 16, self.h, self.w), ry)
            ly = torch.where(selrep, _unblock(lvl.to(torch.int16), 16,
                                              self.h, self.w), ly)
            selrep_c = _rep(sel, 8)
            outc = []
            for plane, srcc, lev in ((ru, srcu, lu), (rv, srcv, lv)):
                cseq = dip.substitute_refs(
                    dip.gather_ref_seq(plane, 8).reshape(B, 33), mask33)
                ctop, cleft = dip.seq_to_refs(cseq, 8)
                cpred = dip.predict_mode(ctop, cleft, 8, mode, False)
                clvl, crr = code_intra(srcc - cpred, 8, qp_c)
                cnz = (clvl != 0).any(dim=-1).any(dim=-1)
                crec = torch.where(cnz[:, None, None],
                                   torch.clamp(cpred + crr, 0, 255), cpred)
                plane = torch.where(selrep_c, _unblock(crec, 8, hc, wc),
                                    plane)
                lev = torch.where(selrep_c, _unblock(clvl.to(torch.int16), 8,
                                                     hc, wc), lev)
                outc.append((plane, lev))
            (ru, lu), (rv, lv) = outc
        return ry, ru, rv, ly, lu, lv, is_intra, mode16

    def _deblock_inter(self, plane_y, nz8, mv8, qp, ts8=16, intra8=None):
        """BS maps (spec 8.7.2.4) + device luma deblock: either side intra
        (intra-fallback CUs) -> BS 2; else a nonzero TU or an MV mismatch
        on a TU edge -> 1. Chroma is untouched at BS < 2 (8.7.2.5.5); the
        BS-2 chroma pass runs separately when intra CUs are present."""
        h8, w8 = nz8.shape
        dev = self.device
        ux = torch.arange(w8, device=dev)[None, :]
        uy = torch.arange(h8, device=dev)[:, None]
        vv = (ux > 0) & (((ux * 8) % ts8) == 0)
        vh = (uy > 0) & (((uy * 8) % ts8) == 0)
        dl = (torch.abs(mv8 - _sh1(mv8)) >= 4).any(dim=-1)
        dt = (torch.abs(mv8 - _shift_down(mv8)) >= 4).any(dim=-1)
        bs_v = (vv & (nz8 | _sh1(nz8) | dl)).to(torch.int32)
        bs_h = (vh & (nz8 | _shift_down(nz8) | dt)).to(torch.int32)
        if intra8 is not None:
            bs_v = torch.where(vv & (intra8 | _sh1(intra8)), 2, bs_v)
            bs_h = torch.where(vh & (intra8 | _shift_down(intra8)), 2, bs_h)
        return deblock_luma_bs(plane_y, bs_v, bs_h, qp)

    def _deblock_chroma_intra(self, ru, rv, intra8, qp):
        """BS-2 chroma pass over the edges of intra-fallback CUs (the
        chroma 8-grid is the even luma 8-units)."""
        h8, w8 = intra8.shape
        dev = self.device
        ux = torch.arange(w8, device=dev)[None, :]
        uy = torch.arange(h8, device=dev)[:, None]
        bs2_v = (ux > 0) & ((ux & 1) == 0) & (intra8 | _sh1(intra8))
        bs2_h = (uy > 0) & ((uy & 1) == 0) & (intra8 | _shift_down(intra8))
        return (deblock_chroma_bs(ru, bs2_v, bs2_h, qp,
                                  self.ps.cb_qp_offset),
                deblock_chroma_bs(rv, bs2_v, bs2_h, qp,
                                  self.ps.cr_qp_offset))

    def _sao(self, sy, su, sv, recon_y, recon_u, recon_v, qp: int):
        """Device SAO decide + apply (ops/sao_dev.py): the filtered planes
        and the packed params for the wire meta."""
        ry_f, ru_f, rv_f, params = sao_analyze_apply(
            sy, su, sv, recon_y.to(torch.int32), recon_u.to(torch.int32),
            recon_v.to(torch.int32), self.ps.ctu_size, self.sao_lam[qp])
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
        ssd_zero <= ssd_coded + zf_mult * sum|lvl| (float32, as golden;
        the SSDs summed exactly, then rounded once)."""
        ssd_zero = (resid * resid).sum(dim=(-1, -2), dtype=torch.int32) \
            .to(torch.float32)
        dc = resid - rres
        ssd_coded = (dc * dc).sum(dim=(-1, -2), dtype=torch.int32) \
            .to(torch.float32)
        lsum = torch.abs(lvl).sum(dim=(-1, -2)).to(torch.float32)
        drop = ssd_zero <= ssd_coded + zf_mult * lsum
        lvl = torch.where(drop[:, None, None], 0, lvl)
        rres = torch.where(drop[:, None, None], 0, rres)
        return lvl, rres

    # ---- host driver ---------------------------------------------------

    def dispatch(self, src, ref, avg_dist: float = 1000.0, qp=None,
                 qp_map=None):
        """Launch the device program; returns the device output tuple
        without any device->host copy. self.last_dev holds the
        (device-resident) post-deblock, post-SAO recon for chaining the
        next frame. qp_map: a per-CTB QP map (numpy, rows x cols),
        uploaded once; deblocking must be off with one (the decoder-view
        QP the deblocking filter reads needs the host's inference)."""
        if qp_map is not None:
            if self.ps.deblocking_enabled:
                raise ValueError("per-CTB QP maps need deblocking off (the "
                                 "decoder-view QP)")
            qp_map = torch.as_tensor(np.asarray(qp_map, np.int32),
                                     device=self.device)
        return self._run(self._impl, (*src, *ref), avg_dist, qp, qp_map)

    def dispatch_b(self, src, ref0, ref1, avg_dist: float = 1000.0,
                   qp=None):
        """Launch the bi-capable program (_impl_b) against the list-0
        reference ref0 and the list-1 reference ref1."""
        return self._run(self._impl_b, (*src, *ref0, *ref1), avg_dist, qp)

    def _run(self, impl, planes, avg_dist: float, qp, qp_map=None):
        PROFILER.count("inter.frames")
        with PROFILER.scope("inter.dispatch"):
            qp = self.cfg.qp if qp is None else int(qp)
            zf = torch.tensor(zf_multiplier(avg_dist, qp),
                              dtype=torch.float32, device=self.device)
            planes = [as_device_plane(a, self.device) for a in planes]
            out = self._launch(impl, [*planes, zf], qp,
                               [] if qp_map is None else [qp_map])
        self.last_dev = (out[0], out[1], out[2])
        return out

    def _launch(self, impl, inputs, qp: int, maps):
        """The program impl over its device inputs (the planes and the
        zero-forcing multiplier) at the slice QP qp, with the QP map in
        maps where one is given. On the card a key, (program, QP, QP map
        given), runs eagerly at its first dispatch, which fills the
        encoder's caches; its second captures the program into CUDA graphs
        split at the sweeps (_SweepSplitGraph) while fewer than
        MAX_GRAPHS are live, else it stays eager; each later one copies
        its inputs in and replays. The graphs share one memory pool. On
        the CPU every dispatch runs eagerly."""
        n = len(inputs)

        def program(*ins):
            return impl(*ins[:n], qp, *ins[n:])
        inputs = [*inputs, *maps]
        key = (impl.__name__, qp, bool(maps))
        graph = self._graphs.get(key)
        if graph is not None:
            PROFILER.count("inter.graph_replays")
            return graph.replay(*inputs)
        if (self.device.type != "cuda" or key not in self._seen
                or len(self._graphs) >= MAX_GRAPHS):
            PROFILER.count("inter.eager")
            self._seen.add(key)
            return self._eager(program(*inputs))
        PROFILER.count("inter.graph_captures")
        shared = next(iter(self._graphs.values()), None)
        graph = self._graphs[key] = _SweepSplitGraph(
            program, inputs, self._sweep, self.search, self.cu // 2,
            shared and shared.parts[0])
        return graph.replay(*inputs)

    def _sweep(self, sd, pad_c):
        """The coarse sweep a program asks for: this module's
        coarse_sweep_sads, looked up at each call (on the card the
        kernel, one launch counted; on the CPU the plain version)."""
        return coarse_sweep_sads(sd, pad_c, self.search, self.cu // 2)

    def _eager(self, steps):
        """Run a program's steps (the generator of _impl, _impl_b or
        _hier_me) eagerly: each sweep it asks for is computed by _sweep
        and sent back. Returns what the program returns."""
        try:
            request = next(steps)
            while True:
                request = steps.send(self._sweep(*request))
        except StopIteration as done:
            return done.value

    def fetch(self, out, is_b: bool = False, bi: bool = False,
              ref_dists=(1, 2), qp_map=None):
        """Download one dispatched frame's wire buffer and build the
        FrameDesc (host half of encode_frame); recon stays on the device.
        The meta is read in the JAX order: mvs (and with bi, the list-1
        mvs and the directions), the tree's choose / mv32 (with bi, the
        list-1 mv32 and the CU32 directions) and choose64 / mv64, the
        intra-in-P mask and modes, SAO, the row SSDs, then the CG wire.
        bi: the output came from _impl_b, which has no CU64 layer and no
        intra-in-P; is_b: a B slice of uni-L0 CUs; ref_dists feed the
        AMVP scaling of the tree's syntax selection; qp_map: the per-CTB QP
        map the frame was dispatched with (its program ran no intra-in-P),
        attached per 8x8 unit for the cu_qp_delta serializer. While the
        tracer is on, the desc carries d2h_bytes: the meta buffer, plus
        the full planes where its wire overflowed."""
        with PROFILER.scope("inter.fetch"):
            return self._fetch(out, is_b, bi, ref_dists, qp_map)

    def _fetch(self, out, is_b, bi, ref_dists, qp_map):
        recon_y, recon_u, recon_v, ly, lu, lv, meta = out
        meta_np = meta.cpu().numpy()
        PROFILER.count("d2h_bytes", meta_np.nbytes)
        gh, gw = self.gh, self.gw
        gh2, gw2 = self.gh2, self.gw2
        off = 0

        def take(nbytes, dt=None, shape=None):
            nonlocal off
            a = meta_np[off:off + nbytes]
            off += nbytes
            if dt is not None:
                a = a.copy().view(dt)
            return a.reshape(shape) if shape is not None else a
        mvs = take(gh * gw * 4, np.int16, (gh, gw, 2))
        if bi:
            mvs1 = take(gh * gw * 4, np.int16, (gh, gw, 2))
            dir16 = take(gh * gw, None, (gh, gw))
        if self.tree:
            choose = take(gh2 * gw2, None, (gh2, gw2))
            mv32 = take(gh2 * gw2 * 4, np.int16, (gh2, gw2, 2))
            if bi:
                mv32_1 = take(gh2 * gw2 * 4, np.int16, (gh2, gw2, 2))
                dir32 = take(gh2 * gw2, None, (gh2, gw2))
        choose64 = mv64 = None
        if self.tree64 and not bi:
            gh4, gw4 = self.gh4, self.gw4
            choose64 = take(gh4 * gw4, None, (gh4, gw4))
            mv64 = take(gh4 * gw4 * 4, np.int16, (gh4, gw4, 2))
        intra16 = imode16 = None
        if self.cfg.intra_in_p and not bi and qp_map is None:
            gih, giw = self.h // 16, self.w // 16
            intra16 = take(gih * giw, None, (gih, giw)).astype(bool)
            imode16 = take(gih * giw, None, (gih, giw))
        sao_params = None
        if self.ps.sao_enabled:
            sgh = self.h // self.ps.ctu_size
            sgw = self.w // self.ps.ctu_size
            sao_params = unpack_params(take(params_nbytes(sgh, sgw)),
                                       sgh, sgw)
        row_ssd = take(self.h * 4, np.int32)
        n_tot = self.w * self.h * 3 // 2
        E = esc_capacity(n_tot, self.pack_C)
        wire = _parse_cg_wire(meta_np[None, off:], 0, n_tot, self.pack_C,
                              self.cg_C, E)
        shapes = [(self.h, self.w), (self.h // 2, self.w // 2),
                  (self.h // 2, self.w // 2)]
        full = []

        def fallback():
            full.extend(fetch_planes(ly, lu, lv))
            return full
        py, pu, pv = _unpack_cg_frame(wire, 0, n_tot, shapes, fallback)
        cu = self.cu
        desc = FrameDesc.alloc(self.w, self.h)
        desc.pred_mode[:] = MODE_INTER
        desc.cu_depth[:] = self.ps.log2_ctu - (cu.bit_length() - 1)
        r8 = cu // 8
        desc.mv[:] = np.repeat(np.repeat(mvs.astype(np.int32), r8, 0), r8, 1)
        if bi:
            desc.mv_l1 = np.repeat(np.repeat(mvs1.astype(np.int32), r8, 0),
                                   r8, 1)
            desc.mvp_flag_l1 = np.zeros_like(desc.mvp_flag)
            desc.inter_dir = np.repeat(np.repeat(dir16.astype(np.uint8), r8,
                                                 0), r8, 1)
        desc.coef_y = np.ascontiguousarray(py, np.int16)
        desc.coef_u = np.ascontiguousarray(pu, np.int16)
        desc.coef_v = np.ascontiguousarray(pv, np.int16)
        desc.row_ssd_y = row_ssd     # exact luma SSD per row vs source
        if PROFILER.on:
            desc.d2h_bytes = meta_np.nbytes + sum(a.nbytes for a in full)
        desc.sao_params = sao_params  # device-decided (recon pre-filtered)
        if qp_map is not None:
            r = self.ps.ctu_size // 8
            desc.qp_map = np.repeat(np.repeat(
                np.asarray(qp_map), r, 0), r, 1)[
                :self.h // 8, :self.w // 8].astype(np.int8)
        if intra16 is not None and intra16.any():
            m8 = np.repeat(np.repeat(intra16, 2, 0), 2, 1)
            desc.pred_mode[m8] = MODE_INTRA
            desc.tr_depth[m8] = 0
            desc.skip[m8] = 0
            desc.mv[m8] = 0
            m4 = np.repeat(np.repeat(intra16, 4, 0), 4, 1)
            lm4 = np.repeat(np.repeat(imode16, 4, 0), 4, 1)
            desc.luma_mode[m4] = lm4[m4]
            cm8 = np.repeat(np.repeat(imode16, 2, 0), 2, 1)
            desc.chroma_mode[m8] = cm8[m8]
        if self.tree:
            ch = np.repeat(np.repeat(choose.astype(bool), 4, 0), 4, 1)
            m32 = np.repeat(np.repeat(mv32.astype(np.int32), 4, 0), 4, 1)
            full = np.zeros(desc.cu_depth.shape, bool)
            full[:ch.shape[0], :ch.shape[1]] = ch
            desc.cu_depth[full] = self.ps.log2_ctu - 5    # CU32 depth
            desc.mv[:ch.shape[0], :ch.shape[1]][ch] = m32[ch]
            if choose64 is not None:
                c64 = np.repeat(np.repeat(choose64.astype(bool), 8, 0),
                                8, 1)
                m64 = np.repeat(np.repeat(mv64.astype(np.int32), 8, 0),
                                8, 1)
                desc.cu_depth[c64] = 0
                desc.tr_depth[c64] = 1        # forced TU32 split
                desc.mv[c64] = m64[c64]
            if bi:
                m32b = np.repeat(np.repeat(mv32_1.astype(np.int32), 4, 0), 4,
                                 1)
                desc.mv_l1[:ch.shape[0], :ch.shape[1]][ch] = m32b[ch]
                d32r = np.repeat(np.repeat(dir32.astype(np.uint8), 4, 0), 4,
                                 1)
                desc.inter_dir[:ch.shape[0], :ch.shape[1]][ch] = d32r[ch]
            with PROFILER.scope("inter.syntax"):
                select_inter_syntax_tree(self.ps, desc, is_b=is_b or bi,
                                         dists=ref_dists)
        else:
            with PROFILER.scope("inter.syntax"):
                select_inter_syntax(self.ps, desc, cu, is_b=is_b)
        return (desc, DevicePlane(recon_y), DevicePlane(recon_u),
                DevicePlane(recon_v))

    def encode_frame(self, src, ref, avg_dist: float = 1000.0, qp=None, *,
                     is_b: bool = False, qp_map=None):
        """One P frame (or, with is_b, a B frame of uni-L0 CUs), with a
        per-CTB QP map when qp_map is given."""
        return self.fetch(self.dispatch(src, ref, avg_dist, qp=qp,
                                        qp_map=qp_map),
                          is_b=is_b, qp_map=qp_map)

    def encode_frame_b(self, src, ref0, ref1, avg_dist: float = 1000.0,
                       qp=None, ref_dists=(1, -1)):
        """One bi-capable frame; ref_dists are the POC distances of the
        two lists' references (a B frame between its anchors by
        default)."""
        return self.fetch(self.dispatch_b(src, ref0, ref1, avg_dist, qp=qp),
                          bi=True, ref_dists=ref_dists)


class _SweepSplitGraph:
    """An inter program on the card as CUDA graphs split at its coarse
    sweeps: the first FrameGraph runs from the program's inputs to its
    first sweep's planes, each next one from a sweep's SADs to the next
    sweep's planes or to the program's outputs. replay() replays them in
    turn and launches every sweep between them eagerly through `sweep`
    (TorchInterEncoder._sweep, at radius R over m x m blocks), so each
    sweep stays one launch of the kernel, counted and seen by a wrapper
    of coarse_sweep_sads.

    Capture runs the program's generator once, one part per graph: a
    tensor made in one part and read in a later one is a buffer of the
    shared pool, written and read in the order of the capture at every
    replay. `shared`, a part of an earlier graph of the same encoder,
    lends every part its memory pool and capture stream."""

    def __init__(self, program, inputs, sweep, R: int, m: int,
                 shared=None):
        steps, done = None, []

        def first(*ins):
            nonlocal steps
            steps = program(*ins)
            return next(steps)

        def then(sads):
            try:
                return steps.send(sads)
            except StopIteration as stop:
                done.append(True)
                return stop.value
        self.sweep = sweep
        self.parts = [FrameGraph(first, inputs, shared)]
        shared = shared or self.parts[0]
        while not done:
            sads = sads_like(self.parts[-1].outputs[0], R, m)
            self.parts.append(FrameGraph(then, (sads,), shared))

    def replay(self, *inputs):
        out = self.parts[0].replay(*inputs)
        for part in self.parts[1:]:
            out = part.replay(self.sweep(*out))
        return out


def _combine32(plane16: torch.Tensor, blocks32: torch.Tensor, m: int,
               choose: torch.Tensor) -> torch.Tensor:
    """Overwrite the top gh2*m rows of plane16 with the m x m blocks32 of
    the CTB32s chosen (gh2, gw2) as one CU."""
    gh2, gw2 = choose.shape
    p32 = _unblock(blocks32.to(plane16.dtype), m, gh2 * m, gw2 * m)
    top = torch.where(_rep(choose, m), p32, plane16[:gh2 * m])
    return torch.cat([top, plane16[gh2 * m:]], dim=0)


def _quarters(blocks: torch.Tensor, m: int) -> torch.Tensor:
    """(B, 2m, 2m) -> (4B, m, m): each block's four m x m quarters in z
    order."""
    B = blocks.shape[0]
    return blocks.reshape(B, 2, m, 2, m).permute(0, 1, 3, 2, 4) \
        .reshape(B * 4, m, m)


def _full(quarters: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of _quarters: (4B, m, m) -> (B, 2m, 2m)."""
    B = quarters.shape[0] // 4
    return quarters.reshape(B, 2, 2, m, m).permute(0, 1, 3, 2, 4) \
        .reshape(B, 2 * m, 2 * m)
