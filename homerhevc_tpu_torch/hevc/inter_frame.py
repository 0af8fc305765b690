"""Host (numpy) P and B frame encoder: the port's copy of the encode half
of homerhevc_tpu/golden/inter_frame.py, which the JAX package runs for
every inter frame its device P programs do not serve (engine/pipeline.py
routes them here by configuration: intra_rdo at CU16, per-CTB QP maps with
deblocking on or with intra-in-P at CU32 / CU64, multi-reference P frames
with num_ref_frames > 2, and IBP's host anchors and bi B frames). The
syntax selection half (merge / skip / AMVP over the final motion field)
lives in hevc/inter_syntax.py, shared with the device P programs.

Full-pel motion estimation over a search window in the reference picture
(a hierarchical sweep on the 2x-decimated planes, then quarter-pel
refinement), 2Nx2N CUs with the counted-bits RD post-passes (merge-RD,
rectangular PUs, the intra fallback), the CU32 / CU64 tree, and the
bi-predicted B tree at CTU 32.

Parity with reference: hmr_motion_inter.c motion_inter (:4467) with the
branch-heavy diamond search (:1404) replaced by a windowed full search,
exhaustive within the window.
"""

from __future__ import annotations

import numpy as np

from homerhevc_tpu_torch.hevc import deblock as hdb
from homerhevc_tpu_torch.hevc import intra_pred as ip
from homerhevc_tpu_torch.hevc import tables as T
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.hevc.inter import MotionField, merge_candidates
from homerhevc_tpu_torch.hevc.inter_syntax import (
    INTRA_P_MODE_BITS_MPM, INTRA_P_MODE_BITS_REM, INTRA_P_ROUNDS,
    MERGE_FAST_BITS_BASE, far_grid, far_range, select_inter_syntax,
    select_inter_syntax_tree, zf_multiplier,
)
from homerhevc_tpu_torch.hevc.interp import (bi_average, mc_chroma,
                                             mc_chroma_14, mc_luma,
                                             mc_luma_14)
from homerhevc_tpu_torch.hevc.quantize import (dequantize, quantize,
                                               sign_bit_hiding)
from homerhevc_tpu_torch.hevc.rd_bits import RdBits
from homerhevc_tpu_torch.hevc.syntax import FrameDesc, MODE_INTER, MODE_INTRA
from homerhevc_tpu_torch.hevc.transform import (forward_transform,
                                                inverse_transform)


def zero_force(resid, lvl, rres, zf_mult):
    """Reference-parity non-normative residual zero-forcing
    (hmr_motion_inter.c:106): drop the quantized block when
    ssd_zero <= ssd_coded + clip(avg_dist/2.5 - 5, 1, 20000) * sum|lvl|.
    zf_mult is the clipped multiplier derived from the previous frame's
    average 4x4 distortion (adaptive feedback: stops the encoder from
    spending bits correcting the reference picture's own quant noise).
    float32 arithmetic so the device path is bit-identical."""
    r32 = resid.astype(np.float32)
    ssd_zero = np.float32(np.sum(r32 * r32))
    d32 = (resid - rres).astype(np.float32)
    ssd_coded = np.float32(np.sum(d32 * d32))
    lsum = np.float32(np.sum(np.abs(lvl)))
    return ssd_zero <= ssd_coded + np.float32(zf_mult) * lsum


def mv_rate(mvx_q, mvy_q, prior_q) -> np.ndarray:
    """mvd bin count of (mvx, mvy) against the prior, quarter-pel units.
    Works elementwise on arrays; identical table lookup on device."""
    bx = T.MVD_BITS[np.minimum(np.abs(mvx_q - prior_q[0]),
                               len(T.MVD_BITS) - 1)]
    by = T.MVD_BITS[np.minimum(np.abs(mvy_q - prior_q[1]),
                               len(T.MVD_BITS) - 1)]
    return bx + by


def full_pel_field(sy: np.ndarray, ref: np.ndarray, n: int, rng: int,
                   lam16: int) -> np.ndarray:
    """Full-pel ME for ALL n x n blocks of the frame at once.

    Two passes over the (2*rng+1)^2 window of edge-clamped plane shifts:
    pass 1 picks the global prior (offset minimising the whole-frame SAD —
    a global-motion estimate), pass 2 picks per-block
    argmin SAD + (lam16 * mvd_bits(mv - prior)) >> 4.  The lambda-weighted
    rate term is what keeps the motion field coherent (reference parity:
    hmr_motion_inter.c mv cost via est_mvd_bits); a pure min-SAD field
    scatters on content with several motion layers and explodes the
    residual + mvd rate.  Tie-break: first minimum in (dy, dx) raster
    order (device uses jnp.argmin over the identically-ordered axis).
    Returns (gh, gw, 2) full-pel (dx, dy).
    """
    H, W = sy.shape
    gh, gw = H // n, W // n
    Hc, Wc = gh * n, gw * n          # crop partial boundary blocks
    side = 2 * rng + 1
    pad = np.pad(ref, rng, mode="edge")
    src = sy[:Hc, :Wc].astype(np.int32)
    sads = np.empty((side * side, gh, gw), np.int32)
    for k in range(side * side):
        dy, dx = k // side - rng, k % side - rng
        sh = pad[rng + dy:rng + dy + Hc,
                 rng + dx:rng + dx + Wc].astype(np.int32)
        d = np.abs(src - sh)
        sads[k] = d.reshape(gh, n, gw, n).sum(axis=(1, 3))
    g = int(sads.sum(axis=(1, 2)).argmin())
    prior = np.asarray([4 * (g % side - rng), 4 * (g // side - rng)],
                       np.int32)
    ks = np.arange(side * side, dtype=np.int32)
    rate = mv_rate(4 * (ks % side - rng), 4 * (ks // side - rng), prior)
    cost = sads + ((lam16 * rate.astype(np.int32)) >> 4)[:, None, None]
    best = cost.reshape(side * side, -1).argmin(axis=0).reshape(gh, gw)
    mv = np.stack([(best % side - rng), (best // side - rng)], axis=-1)
    return mv.astype(np.int32), prior


def decimate2(plane: np.ndarray) -> np.ndarray:
    """2x2 integer average pool ((a+b+c+d+2)>>2) — the pyramid level for
    hierarchical ME. Same arithmetic on device."""
    p = plane.astype(np.int32)
    h2, w2 = (p.shape[0] // 2) * 2, (p.shape[1] // 2) * 2
    p = p[:h2, :w2]
    return (p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] + p[1::2, 1::2]
            + 2) >> 2


def hier_pel_field(sy: np.ndarray, ref: np.ndarray, n: int, rng_c: int,
                   lam16: int, K: int = 3, G: int = 8):
    """Hierarchical full-pel ME for ALL n x n blocks of the frame.

    TPU-friendly replacement for the reference's per-block diamond search
    (hmr_motion_estimation, hmr_motion_inter.c:1404), built ONLY from
    whole-plane shifts (no per-block gathers -- TPU gathers serialize):

      1. a 2x-decimated coarse sweep over (2*rng_c+1)^2 offsets covers
         +-2*rng_c full-res pels at a quarter of the pixel cost;
      2. each block votes for its K best coarse offsets; the G most
         popular offsets frame-wide form a global shortlist (multi-layer
         motion keeps one slot per layer -- tests/test_inter.py RD guard);
      3. full-res SADs are evaluated for the +-2 neighbourhood of every
         shortlist offset plus an exact +-4 fine sweep (the decimated
         level is blind to pixel-scale texture at odd shifts), each as a
         shifted-plane block-sum.

    Cost everywhere: SAD + (lam16 * mvd_bits) >> 4 against the global
    coarse prior. Returns ((gh, gw, 2) full-pel (dx, dy), prior qpel)."""
    H, W = sy.shape
    gh, gw = H // n, W // n
    m = n // 2
    side = 2 * rng_c + 1
    sd = decimate2(sy[:gh * n, :gw * n])
    rd = decimate2(ref)
    pad_c = np.pad(rd, rng_c, mode="edge")
    # ---- coarse sweep ----
    sads_c = np.empty((side * side, gh, gw), np.int32)
    for k in range(side * side):
        dy, dx = k // side - rng_c, k % side - rng_c
        sh = pad_c[rng_c + dy:rng_c + dy + gh * m,
                   rng_c + dx:rng_c + dx + gw * m]
        d = np.abs(sd - sh)
        sads_c[k] = d.reshape(gh, m, gw, m).sum(axis=(1, 3))
    g = int(sads_c.sum(axis=(1, 2)).argmin())
    prior_q = np.asarray([8 * (g % side - rng_c), 8 * (g // side - rng_c)],
                         np.int32)
    ks = np.arange(side * side, dtype=np.int32)
    rate_c = mv_rate(8 * (ks % side - rng_c), 8 * (ks // side - rng_c),
                     prior_q)
    cost_c = 4 * sads_c + ((lam16 * rate_c.astype(np.int32)) >> 4)[
        :, None, None]
    # ---- per-block top-K votes -> global shortlist of G offsets ----
    cc = cost_c.reshape(side * side, -1).copy()
    hist = np.zeros(side * side, np.int64)
    BIG = np.int32(1 << 30)
    for _ in range(K):
        kb = cc.argmin(axis=0)
        hist += np.bincount(kb, minlength=side * side)
        cc[kb, np.arange(cc.shape[1])] = BIG
    short = []
    for _ in range(G):
        kg = int(hist.argmax())
        short.append(kg)
        hist[kg] = -1
    # ---- full-res refine over shifted planes: fine +-4 sweep first,
    # then +-2 around each shortlist offset (deterministic order) ----
    P = 2 * rng_c + 2
    pad_f = np.pad(ref, P, mode="edge").astype(np.int32)
    src_pl = sy[:gh * n, :gw * n].astype(np.int32)

    best_cost = np.full(gh * gw, 1 << 30, np.int32)
    best_dx = np.zeros(gh * gw, np.int32)
    best_dy = np.zeros(gh * gw, np.int32)

    def eval_off(dx, dy):
        nonlocal best_cost, best_dx, best_dy
        sh = pad_f[P + dy:P + dy + gh * n, P + dx:P + dx + gw * n]
        sad = np.abs(src_pl - sh).reshape(gh, n, gw, n).sum(axis=(1, 3)) \
            .reshape(-1).astype(np.int32)
        rate = int(mv_rate(4 * dx, 4 * dy, prior_q))
        cost = sad + ((lam16 * rate) >> 4)
        better = cost < best_cost
        best_cost = np.where(better, cost, best_cost)
        best_dx = np.where(better, dx, best_dx)
        best_dy = np.where(better, dy, best_dy)

    F = 4
    for k in range((2 * F + 1) ** 2):
        eval_off(k % (2 * F + 1) - F, k // (2 * F + 1) - F)
    for kg in short:
        cdx, cdy = 2 * (kg % side - rng_c), 2 * (kg // side - rng_c)
        for oy in (-2, -1, 0, 1, 2):
            for ox in (-2, -1, 0, 1, 2):
                eval_off(cdx + ox, cdy + oy)
    mv = np.stack([best_dx, best_dy], axis=-1).reshape(gh, gw, 2)
    return mv.astype(np.int32), prior_q


def hier_pel_fields(sy: np.ndarray, ref: np.ndarray, rng_c: int,
                    lam16: int, K: int = 3, G16: int = 8, G32: int = 4,
                    want32: bool = False, want64: bool = False, G64: int = 2,
                    far: int = 0, GQ: int = 4):
    """Joint 16-/32-(/64-)block hierarchical full-pel ME sharing one set of
    full-res shifted-plane block sums (32-level SADs are 2x2 sums of the
    16-level sums, 64-level 2x2 sums of those — no second sweep). See
    hier_pel_field for the search structure. Returns (mv16, prior16, mv32,
    prior32[, mv64, prior64]); higher levels are None unless requested.

    far > 0 adds a THIRD (4x-decimated) pyramid level covering +-far
    full-pel horizontally (vertical capped at +-64, the reference window):
    a step-2 sweep outside the 2x coverage -> per-block votes -> GQ global
    candidates, each refined at the 2x level (+-2) and handed to the
    full-res +-2 neighbourhood refine. Matches the reference's +-128x64
    roam (hmr_motion_inter.c:1404 diamond) with data-parallel sweeps."""
    H, W = sy.shape
    gh, gw = H // 16, W // 16
    gh2, gw2 = H // 32, W // 32
    gh4, gw4 = H // 64, W // 64
    m = 8
    side = 2 * rng_c + 1
    n_off = side * side
    sd = decimate2(sy[:gh * 16, :gw * 16])
    rd = decimate2(ref)
    pad_c = np.pad(rd, rng_c, mode="edge")
    sads_c = np.empty((n_off, gh, gw), np.int32)
    for k in range(n_off):
        dy, dx = k // side - rng_c, k % side - rng_c
        sh = pad_c[rng_c + dy:rng_c + dy + gh * m,
                   rng_c + dx:rng_c + dx + gw * m]
        sads_c[k] = np.abs(sd - sh).reshape(gh, m, gw, m).sum(axis=(1, 3))
    ks = np.arange(n_off, dtype=np.int32)

    def prior_votes(sads_lvl, Glvl, unit):
        g = int(sads_lvl.sum(axis=(1, 2)).argmin())
        pr = np.asarray([8 * (g % side - rng_c), 8 * (g // side - rng_c)],
                        np.int32)
        rate = mv_rate(8 * (ks % side - rng_c), 8 * (ks // side - rng_c),
                       pr)
        cost = unit * sads_lvl + ((lam16 * rate.astype(np.int32)) >> 4)[
            :, None, None]
        cc = cost.reshape(n_off, -1).copy()
        hist = np.zeros(n_off, np.int64)
        for _ in range(K):
            kb = cc.argmin(axis=0)
            hist += np.bincount(kb, minlength=n_off)
            cc[kb, np.arange(cc.shape[1])] = np.int32(1 << 30)
        short = []
        for _ in range(Glvl):
            kg = int(hist.argmax())
            short.append(kg)
            hist[kg] = -1
        return pr, short
    prior16, short16 = prior_votes(sads_c, G16, 4)
    if want32 or want64:
        s4c = sads_c[:, :gh2 * 2, :].reshape(n_off, gh2, 2, gw2, 2) \
            .sum(axis=(2, 4))
        prior32, short32 = prior_votes(s4c, G32, 4)
    else:
        prior32, short32 = None, []
    if want64 and gh4 > 0 and gw4 > 0:
        s8c = s4c[:, :gh4 * 2, :gw4 * 2].reshape(n_off, gh4, 2, gw4, 2) \
            .sum(axis=(2, 4))
        prior64, short64 = prior_votes(s8c, G64, 4)
    else:
        prior64, short64 = None, []

    # ---- FAR (4x-decimated) level: global candidates beyond the 2x reach
    far_centers = []
    if far > 2 * rng_c:
        grid, vote_mask = far_grid(rng_c, far)
        xq, yq = far // 4, min(far // 4, 16)
        sd4 = decimate2(sd)
        rd4 = decimate2(rd)
        m4 = 4                                 # 16-block side at 4x scale
        gh4x, gw4x = sd4.shape[0] // m4, sd4.shape[1] // m4
        sd4 = sd4[:gh4x * m4, :gw4x * m4]
        pad_q = np.pad(rd4, ((yq, yq), (xq, xq)), mode="edge")
        sads_q = np.empty((len(grid), gh4x, gw4x), np.int32)
        for i, (qx, qy) in enumerate(grid):
            sh = pad_q[yq + qy:yq + qy + gh4x * m4,
                       xq + qx:xq + qx + gw4x * m4]
            sads_q[i] = np.abs(sd4 - sh).reshape(gh4x, m4, gw4x, m4) \
                .sum(axis=(1, 3))
        gx = np.asarray([16 * q[0] for q in grid], np.int32)
        gy = np.asarray([16 * q[1] for q in grid], np.int32)
        rate_q = mv_rate(gx, gy, prior16)
        cost_q = 16 * sads_q + ((lam16 * rate_q.astype(np.int32)) >> 4)[
            :, None, None]
        cq = cost_q.reshape(len(grid), -1).copy()
        cq[~vote_mask] = np.int32(1 << 30)    # 2x-covered offsets don't vote
        hist_q = np.zeros(len(grid), np.int64)
        for _ in range(K):
            kb = cq.argmin(axis=0)
            hist_q += np.bincount(kb, minlength=len(grid))
            cq[kb, np.arange(cq.shape[1])] = np.int32(1 << 30)
        # 2x-level +-2 refine of each candidate by GLOBAL decimated SAD
        py2, px2 = 2 * yq + 2, 2 * xq + 2
        pad_c2 = np.pad(rd, ((py2, py2), (px2, px2)), mode="edge")
        h2c, w2c = sd.shape
        for _ in range(GQ):
            kq = int(hist_q.argmax())
            hist_q[kq] = -1
            qx, qy = grid[kq]
            bestg = (1 << 62, 0, 0)
            for oy in (-2, -1, 0, 1, 2):
                for ox in (-2, -1, 0, 1, 2):
                    sh = pad_c2[py2 + 2 * qy + oy:py2 + 2 * qy + oy + h2c,
                                px2 + 2 * qx + ox:px2 + 2 * qx + ox + w2c]
                    g = int(np.abs(sd - sh).sum())
                    if g < bestg[0]:
                        bestg = (g, ox, oy)
            far_centers.append((4 * qx + 2 * bestg[1],
                                4 * qy + 2 * bestg[2]))

    # offset list: exact fine sweep, then shortlist neighbourhoods
    offs = [(k % 9 - 4, k // 9 - 4) for k in range(81)]
    for kg in short16 + short32 + short64:
        cdx, cdy = 2 * (kg % side - rng_c), 2 * (kg // side - rng_c)
        for oy in (-2, -1, 0, 1, 2):
            for ox in (-2, -1, 0, 1, 2):
                offs.append((cdx + ox, cdy + oy))
    for cdx, cdy in far_centers:
        for oy in (-2, -1, 0, 1, 2):
            for ox in (-2, -1, 0, 1, 2):
                offs.append((cdx + ox, cdy + oy))

    # FAR centers reach +-(far+4); their +-2 neighbourhoods +-(far+6)
    P = max(2 * rng_c + 2, far + 8 if far else 0)
    pad_f = np.pad(ref, P, mode="edge").astype(np.int32)
    src_pl = sy[:gh * 16, :gw * 16].astype(np.int32)
    bc16 = np.full(gh * gw, 1 << 30, np.int32)
    bdx16 = np.zeros(gh * gw, np.int32)
    bdy16 = np.zeros(gh * gw, np.int32)
    if want32 or want64:
        bc32 = np.full(gh2 * gw2, 1 << 30, np.int32)
        bdx32 = np.zeros(gh2 * gw2, np.int32)
        bdy32 = np.zeros(gh2 * gw2, np.int32)
    if want64:
        bc64 = np.full(gh4 * gw4, 1 << 30, np.int32)
        bdx64 = np.zeros(gh4 * gw4, np.int32)
        bdy64 = np.zeros(gh4 * gw4, np.int32)
    for dx, dy in offs:
        sh = pad_f[P + dy:P + dy + gh * 16, P + dx:P + dx + gw * 16]
        s16 = np.abs(src_pl - sh).reshape(gh, 16, gw, 16).sum(axis=(1, 3))
        r16 = int(mv_rate(4 * dx, 4 * dy, prior16))
        c16 = s16.reshape(-1).astype(np.int32) + ((lam16 * r16) >> 4)
        b = c16 < bc16
        bc16 = np.where(b, c16, bc16)
        bdx16 = np.where(b, dx, bdx16)
        bdy16 = np.where(b, dy, bdy16)
        if want32 or want64:
            s32 = s16[:gh2 * 2, :].reshape(gh2, 2, gw2, 2).sum(axis=(1, 3))
            r32 = int(mv_rate(4 * dx, 4 * dy, prior32))
            c32 = s32.reshape(-1).astype(np.int32) + ((lam16 * r32) >> 4)
            b2 = c32 < bc32
            bc32 = np.where(b2, c32, bc32)
            bdx32 = np.where(b2, dx, bdx32)
            bdy32 = np.where(b2, dy, bdy32)
            if want64 and gh4 > 0 and gw4 > 0:
                s64 = s32[:gh4 * 2, :gw4 * 2].reshape(gh4, 2, gw4, 2) \
                    .sum(axis=(1, 3))
                r64 = int(mv_rate(4 * dx, 4 * dy, prior64))
                c64 = s64.reshape(-1).astype(np.int32) + ((lam16 * r64) >> 4)
                b4 = c64 < bc64
                bc64 = np.where(b4, c64, bc64)
                bdx64 = np.where(b4, dx, bdx64)
                bdy64 = np.where(b4, dy, bdy64)
    mv16 = np.stack([bdx16, bdy16], axis=-1).reshape(gh, gw, 2) \
        .astype(np.int32)
    if not want32 and not want64:
        return mv16, prior16, None, None
    mv32 = np.stack([bdx32, bdy32], axis=-1).reshape(gh2, gw2, 2) \
        .astype(np.int32)
    if not want64:
        return mv16, prior16, mv32, prior32
    mv64 = (np.stack([bdx64, bdy64], axis=-1).reshape(gh4, gw4, 2)
            .astype(np.int32) if gh4 > 0 and gw4 > 0
            else np.zeros((gh4, gw4, 2), np.int32))
    return mv16, prior16, mv32, prior32, mv64, prior64


def subpel_refine(src_blk: np.ndarray, ref: np.ndarray, x0: int, y0: int,
                  mv_q: tuple[int, int], step: int, prior_q, lam16: int,
                  bounds=None) -> tuple[int, int]:
    """One refinement stage around mv_q (quarter-pel units) with the given
    step (2 = half-pel, 1 = quarter-pel). Evaluates the 3x3 neighbourhood in
    (dy, dx) raster order, strict '<' (identical ordering on device).
    Cost = SAD + (lam16 * mvd_bits(mv - prior)) >> 4. `bounds`
    (((lox, loy), (hix, hiy)), qpel) clamps candidates exactly as the
    device's volume-coverage clamp does (refine_v bounds)."""
    n = src_blk.shape[0]
    src = src_blk.astype(np.int32)
    best = (1 << 60, mv_q[0], mv_q[1])
    for dy in (-step, 0, step):
        for dx in (-step, 0, step):
            mvx, mvy = mv_q[0] + dx, mv_q[1] + dy
            if bounds is not None:
                mvx = min(max(mvx, bounds[0][0]), bounds[1][0])
                mvy = min(max(mvy, bounds[0][1]), bounds[1][1])
            pred = mc_luma(ref, x0, y0, n, mvx, mvy)
            sad = int(np.abs(src - pred).sum())
            cost = sad + ((lam16 * int(mv_rate(mvx, mvy, prior_q))) >> 4)
            if cost < best[0]:
                best = (cost, mvx, mvy)
    return best[1], best[2]


def _deblock_inter_luma(ps, desc, recon_y, qp):
    """In-loop luma deblock for an inter frame (BS maps from final
    coefficients + motion + intra map). Shared by the golden path; the
    device engine computes the identical maps on device."""
    cu_sz = (ps.ctu_size >> desc.cu_depth).astype(np.int32)
    tu8 = (cu_sz >> desc.tr_depth).astype(np.int32)
    qp8 = (hdb.decoder_qp_map8(desc, ps, qp, wpp=ps.cfg.wpp)
           if desc.qp_map is not None else np.full_like(tu8, qp))
    bs_v, bs_h = hdb.inter_bs_maps(desc, tu8)
    return hdb.deblock_plane_luma(recon_y, tu8, qp8, bs_v, bs_h)


def _deblock_inter_chroma(ps, desc, recon_u, recon_v, qp):
    """Chroma deblock for an inter frame: only BS==2 edges filter chroma
    (spec 8.7.2.5.5), and BS==2 needs an intra side — a no-op unless the
    frame carries intra-fallback CUs."""
    if not (desc.pred_mode == MODE_INTRA).any():
        return recon_u, recon_v
    cu_sz = (ps.ctu_size >> desc.cu_depth).astype(np.int32)
    tu8 = (cu_sz >> desc.tr_depth).astype(np.int32)
    qp8 = (hdb.decoder_qp_map8(desc, ps, qp, wpp=ps.cfg.wpp)
           if desc.qp_map is not None else np.full_like(tu8, qp))
    bs_v, bs_h = hdb.inter_bs_maps(desc, tu8)
    recon_u = hdb.deblock_plane_chroma(recon_u, qp8, bs_v, bs_h,
                                       ps.cb_qp_offset)
    recon_v = hdb.deblock_plane_chroma(recon_v, qp8, bs_v, bs_h,
                                       ps.cr_qp_offset)
    return recon_u, recon_v


def encode_inter_frame(ps: ParamSets, src_planes, ref_planes, qp: int,
                       cu_size: int = 16, search: int = 16,
                       is_b: bool = False, avg_dist: float = 1000.0,
                       merge_rd: bool = False, rect_pu: bool = False,
                       qp_map=None, ref_list=None, ref_dists=None):
    """Encode one P frame (2Nx2N CUs, optional per-CU intra fallback).
    qp_map: optional per-CTB luma QP map (AQ / row-granular RC; QG = CTB).
    ref_list: optional list of reference plane triplets (multi-reference
    L0, nearest first) with ref_dists their POC distances — per-CU ref
    choice + ref_idx_l0 coding (reference ref-pool, hmr_private.h:1407).
    Returns (FrameDesc, recon_y, recon_u, recon_v)."""
    desc, recon_y, recon_u, recon_v, prior_q = _encode_level16(
        ps, src_planes, ref_planes, qp, search, avg_dist, cu_size,
        qp_map=qp_map, ref_list=ref_list, ref_dists=ref_dists)
    if qp_map is not None or ref_list is not None:
        merge_rd = rect_pu = False   # post-passes assume slice QP + 1 ref
    if int(getattr(ps.cfg, "performance_mode", 0)) >= 1:
        # FAST/UFAST prune the RD refinement passes (reference fast-skip
        # spirit, hmr_encoder_lib.c:921-947); the device flat program
        # gates its merge-RD stage on the same predicate
        merge_rd = rect_pu = False
    if rect_pu or merge_rd:
        sy_, su_, sv_ = [np.asarray(p, np.int32) for p in src_planes]
        ry_, ru_, rv_ = [np.asarray(p, np.int32) for p in ref_planes]
        if rect_pu and cu_size == 16 \
                and not (is_b and desc.mv_l1 is not None):
            rect_pu_p(ps, desc, sy_, su_, sv_, ry_, ru_, rv_,
                      recon_y, recon_u, recon_v, qp,
                      zf_multiplier(avg_dist, qp), prior_q,
                      int(ps.cfg.motion_estimation_precision))
        if merge_rd == "fast" and cu_size == 16 and not is_b:
            # device-twin batched variant (TpuInterEncoder merge-RD stage)
            merge_rd_fast(ps, desc, sy_, su_, sv_, ry_, ru_, rv_,
                          recon_y, recon_u, recon_v, qp,
                          zf_multiplier(avg_dist, qp), prior_q)
        elif merge_rd and not (is_b and desc.mv_l1 is not None):
            merge_rd_p(ps, desc, sy_, su_, sv_, ry_, ru_, rv_,
                       recon_y, recon_u, recon_v, qp,
                       zf_multiplier(avg_dist, qp), prior_q, is_b=is_b)
    if (ps.cfg.intra_in_p and cu_size == 16 and qp_map is None
            and ref_list is None):
        intra_fallback_p(ps, desc, np.asarray(src_planes[0], np.int32),
                         np.asarray(src_planes[1], np.int32),
                         np.asarray(src_planes[2], np.int32),
                         recon_y, recon_u, recon_v, qp, prior_q)
    select_inter_syntax(ps, desc, cu_size, is_b=is_b,
                        ref_dists_l0=ref_dists)
    if ps.deblocking_enabled:
        recon_y = _deblock_inter_luma(ps, desc, recon_y, qp)
        recon_u, recon_v = _deblock_inter_chroma(ps, desc, recon_u,
                                                 recon_v, qp)
    return desc, recon_y, recon_u, recon_v


def _encode_level16(ps: ParamSets, src_planes, ref_planes, qp: int,
                    search: int, avg_dist: float, cu_size: int = 16,
                    fp16=None, qp_map=None, ref_list=None, ref_dists=None):
    sy, su, sv = [np.asarray(p, np.int32) for p in src_planes]
    if ref_list is not None:
        ref_planes = ref_list[0]
    ry_ref, ru_ref, rv_ref = [np.asarray(p, np.int32) for p in ref_planes]
    h, w = sy.shape
    n = cu_size
    nc = n // 2
    gh, gw = h // n, w // n
    desc = FrameDesc.alloc(w, h)
    desc.pred_mode[:] = MODE_INTER
    desc.cu_depth[:] = ps.log2_ctu - (n.bit_length() - 1)
    recon_y = np.zeros_like(sy)
    recon_u = np.zeros_like(su)
    recon_v = np.zeros_like(sv)
    sl = ps.scaling_list_enabled
    zf_mult = zf_multiplier(avg_dist, qp)
    lam = float(T.rd_lambda(qp, "P"))
    ctu = ps.ctu_size

    def cu_qps(x0, y0):
        """(luma, chroma) QP of the CU at (x0, y0): the slice QP, or its
        quantization group's entry of the per-CTB AQ/RC map (QG = CTB).
        Lambdas/zero-forcing stay slice-level (non-normative)."""
        if qp_map is None:
            return qp, T.chroma_qp(qp + ps.cb_qp_offset)
        q = int(qp_map[y0 // ctu, x0 // ctu])
        return q, T.chroma_qp(q + ps.cb_qp_offset)

    # ---- phase 1: independent per-CU ME + residual -------------------------
    me_prec = int(ps.cfg.motion_estimation_precision)
    lam16 = T.lambda_me_x16(qp)
    mrefs = mfields = None
    if ref_list is not None:
        # multi-reference L0 (reference ref-pool analog,
        # hmr_private.h:1407): one hierarchical field per reference;
        # per-CU choice by SAD + lambda*(mvd + ref_idx bins)
        mrefs = [[np.asarray(p, np.int32) for p in rp] for rp in ref_list]
        mfields = [hier_pel_fields(sy, r[0], search, lam16,
                                   far=far_range(ps, search))
                   for r in mrefs]
        desc.ref_idx = np.zeros(desc.pred_mode.shape, np.int8)
        fp_mv, prior_q = mfields[0][0], mfields[0][1]
    elif fp16 is not None:
        fp_mv, prior_q = fp16            # shared 16/32 field from the tree
    elif n == 16:
        fp_mv, prior_q, _, _ = hier_pel_fields(sy, ry_ref, search, lam16,
                                               far=far_range(ps, search))
    else:
        fp_mv, prior_q = hier_pel_field(sy, ry_ref, n, search, lam16)
    for gy in range(gh):
        for gx in range(gw):
            x0, y0 = gx * n, gy * n
            src_blk = sy[y0:y0 + n, x0:x0 + n]
            ry_cur, ru_cur, rv_cur = ry_ref, ru_ref, rv_ref
            if mrefs is not None:
                best = None
                for r, (rr, fld) in enumerate(zip(mrefs, mfields)):
                    fpr, prr = fld[0], fld[1]
                    mvr = (4 * int(fpr[gy, gx, 0]), 4 * int(fpr[gy, gx, 1]))
                    if me_prec >= 1:
                        mvr = subpel_refine(src_blk, rr[0], x0, y0, mvr, 2,
                                            prr, lam16)
                    if me_prec >= 2:
                        mvr = subpel_refine(src_blk, rr[0], x0, y0, mvr, 1,
                                            prr, lam16)
                    predr = mc_luma(rr[0], x0, y0, n, mvr[0], mvr[1])
                    sad = int(np.abs(src_blk - predr).sum())
                    rate = int(mv_rate(mvr[0], mvr[1], prr)) + 2 * r + 1
                    cost = sad + ((lam16 * rate) >> 4)
                    if best is None or cost < best[0]:
                        best = (cost, r, mvr, predr, prr)
                _, rbest, mv, pred, prior_cu = best
                desc.ref_idx[y0 // 8:(y0 + n) // 8,
                             x0 // 8:(x0 + n) // 8] = rbest
                ry_cur, ru_cur, rv_cur = mrefs[rbest]
                desc.mv[y0 // 8:(y0 + n) // 8, x0 // 8:(x0 + n) // 8] = mv
                qp_cu, qp_c = cu_qps(x0, y0)
            else:
                mv = (4 * int(fp_mv[gy, gx, 0]), 4 * int(fp_mv[gy, gx, 1]))
                if me_prec >= 1:  # half-pel
                    mv = subpel_refine(src_blk, ry_ref, x0, y0, mv, 2,
                                       prior_q, lam16)
                if me_prec >= 2:  # quarter-pel
                    mv = subpel_refine(src_blk, ry_ref, x0, y0, mv, 1,
                                       prior_q, lam16)
                desc.mv[y0 // 8:(y0 + n) // 8, x0 // 8:(x0 + n) // 8] = mv
                qp_cu, qp_c = cu_qps(x0, y0)
                pred = mc_luma(ry_ref, x0, y0, n, mv[0], mv[1])
            resid = src_blk - pred
            coef = forward_transform(resid, False)
            lvl = quantize(coef, qp_cu, False, sl)
            if ps.sign_hiding and np.any(lvl):
                lvl = sign_bit_hiding(lvl, coef, qp_cu, False, T.SCAN_DIAG,
                                      sl)
            if np.any(lvl):
                r = inverse_transform(dequantize(lvl, qp_cu, False, sl),
                                      False)
                if zero_force(resid, lvl, r, zf_mult):
                    lvl = np.zeros_like(lvl)
                    recon_y[y0:y0 + n, x0:x0 + n] = pred
                else:
                    recon_y[y0:y0 + n, x0:x0 + n] = np.clip(pred + r, 0, 255)
            else:
                recon_y[y0:y0 + n, x0:x0 + n] = pred
            desc.coef_y[y0:y0 + n, x0:x0 + n] = lvl.astype(np.int16)
            # chroma
            cx0, cy0 = x0 // 2, y0 // 2
            for splane, rplane, recon_c, coefs in (
                    (su, ru_cur, recon_u, desc.coef_u),
                    (sv, rv_cur, recon_v, desc.coef_v)):
                cpred = mc_chroma(rplane, cx0, cy0, nc, mv[0], mv[1])
                cres = splane[cy0:cy0 + nc, cx0:cx0 + nc] - cpred
                ccoef = forward_transform(cres, False)
                clvl = quantize(ccoef, qp_c, False, sl)
                if ps.sign_hiding and np.any(clvl):
                    clvl = sign_bit_hiding(clvl, ccoef, qp_c, False,
                                           T.SCAN_DIAG, sl)
                if np.any(clvl):
                    cr = inverse_transform(dequantize(clvl, qp_c, False, sl),
                                           False)
                    if zero_force(cres, clvl, cr, zf_mult):
                        clvl = np.zeros_like(clvl)
                        recon_c[cy0:cy0 + nc, cx0:cx0 + nc] = cpred
                    else:
                        recon_c[cy0:cy0 + nc, cx0:cx0 + nc] = \
                            np.clip(cpred + cr, 0, 255)
                else:
                    recon_c[cy0:cy0 + nc, cx0:cx0 + nc] = cpred
                coefs[cy0:cy0 + nc, cx0:cx0 + nc] = clvl.astype(np.int16)
    # boundary bands (w/h not a multiple of the CU grid, e.g. 1080p's
    # bottom 8 rows): coded as zero-MV CU8s with no residual — recon is a
    # straight copy of the reference; syntax selection assigns merge/AMVP
    # so a decoder derives the same zero motion
    if qp_map is not None:
        desc.qp_map = np.repeat(np.repeat(np.asarray(qp_map), ctu // 8, 0),
                                ctu // 8, 1)[:h // 8, :w // 8] \
            .astype(np.int8)
    h16, w16 = gh * n, gw * n
    if h16 < h:
        recon_y[h16:, :] = ry_ref[h16:, :]
        recon_u[h16 // 2:, :] = ru_ref[h16 // 2:, :]
        recon_v[h16 // 2:, :] = rv_ref[h16 // 2:, :]
    if w16 < w:
        recon_y[:h16, w16:] = ry_ref[:h16, w16:]
        recon_u[:h16 // 2, w16 // 2:] = ru_ref[:h16 // 2, w16 // 2:]
        recon_v[:h16 // 2, w16 // 2:] = rv_ref[:h16 // 2, w16 // 2:]
    return desc, recon_y, recon_u, recon_v, prior_q


def _code_tu(resid, qp, sl, sign_hiding, zf_mult, lam):
    """Transform+quant one luma/chroma TU with CG suppression, SBH and
    zero-forcing. Returns (levels, spatial residual after inverse path)."""
    coef = forward_transform(resid, False)
    lvl = quantize(coef, qp, False, sl)
    if sign_hiding and np.any(lvl):
        lvl = sign_bit_hiding(lvl, coef, qp, False, T.SCAN_DIAG, sl)
    if not np.any(lvl):
        return lvl, np.zeros_like(resid)
    r = inverse_transform(dequantize(lvl, qp, False, sl), False)
    if zero_force(resid, lvl, r, zf_mult):
        return np.zeros_like(lvl), np.zeros_like(resid)
    return lvl, r


def _cu_cost(src_blk, rec_blk, lvl, mv, prior_q, lam, rb=None):
    """float32 cost of one coded luma CU: final SSD + lambda * rate.

    rb=None: fast proxy rate (3 bins/nonzero + 1/|level| unit + ~6 CU
    syntax bins + mvd bins; same arithmetic as the device twin,
    engine.inter_encoder). rb=RdBits: counted CABAC bits — the real
    residual_coding bins measured through CabacCounter plus the AMVP
    merge_flag=0 / mvp flag / mvd bins (reference FAST_BIT_EST env,
    hmr_binary_encoding.c:280-351)."""
    d = (src_blk - rec_blk).astype(np.float32)
    ssd = np.float32(np.sum(d * d))
    if rb is not None:
        bits = (rb.luma_bits(lvl) + rb.amvp_flag_bits() + 1.0
                + float(mv_rate(mv[0], mv[1], prior_q)))
        return ssd + np.float32(lam) * np.float32(bits)
    nnz = np.float32(np.count_nonzero(lvl))
    lsum = np.float32(np.sum(np.abs(lvl)))
    bits = 3.0 * nnz + lsum + 6.0 + np.float32(mv_rate(mv[0], mv[1], prior_q))
    return ssd + np.float32(lam) * bits


def merge_rd_p(ps: ParamSets, desc: FrameDesc, sy, su, sv,
               ry_ref, ru_ref, rv_ref, recon_y, recon_u, recon_v,
               qp: int, zf_mult: float, prior_q, max_cand: int = 2,
               is_b: bool = False) -> int:
    """RD-checked merge for P frames: walk CUs in decode order and flip a
    CU's motion to its best merge candidate when the re-coded cost beats
    the ME coding (reference check_rd_cost_merge_2nx2n,
    hmr_motion_inter.c:3493 — there merge is evaluated per CU inside the
    sequential loop; here it is a decode-order post-pass over the batched
    ME field). Flips update desc.mv immediately, so later CUs derive
    candidates from the exact field a decoder will reconstruct, and the
    final syntax selection is guaranteed to re-find the merge.

    Returns the number of flipped CUs."""
    rb = RdBits(ps, "B" if is_b else "P", qp)
    lam = float(T.rd_lambda(qp, "P"))
    qp_c = T.chroma_qp(qp + ps.cb_qp_offset)
    sl = ps.scaling_list_enabled
    w, h = desc.width, desc.height
    inter = desc.pred_mode == MODE_INTER
    mf = MotionField(*desc.pred_mode.shape)
    mf.mv = desc.mv                      # live view: flips take effect
    mf.ref = np.where(inter, 0, -1)
    flips = 0

    def code_luma(pred, src_blk, n):
        """Luma TU coding of a CU (n<=32: one TU; n=64: four TU32s).
        Returns (lvl, rec)."""
        resid = src_blk - pred
        if n <= 32:
            lvl, r = _code_tu(resid, qp, sl, ps.sign_hiding, zf_mult, lam)
        else:
            lvl = np.zeros((n, n), np.int32)
            r = np.zeros((n, n), np.int32)
            for qy in (0, 32):
                for qx in (0, 32):
                    lq, rq = _code_tu(resid[qy:qy + 32, qx:qx + 32], qp, sl,
                                      ps.sign_hiding, zf_mult, lam)
                    lvl[qy:qy + 32, qx:qx + 32] = lq
                    r[qy:qy + 32, qx:qx + 32] = rq
        return lvl, np.clip(pred + r, 0, 255)

    def try_cu(x0, y0, n):
        nonlocal flips
        ux, uy = x0 // 8, y0 // 8
        if desc.pred_mode[uy, ux] != MODE_INTER:
            return
        if desc.inter_part is not None and desc.inter_part[uy, ux]:
            return    # rect CUs keep their per-PU coding
        mv_cur = (int(desc.mv[uy, ux, 0]), int(desc.mv[uy, ux, 1]))
        cands, n_spatial = merge_candidates(mf, x0, y0, n, ps.ctu_size,
                                            w, h)
        # in (uni-)B slices the decoder's fill candidates are
        # bi-predictive — only the spatial entries are selectable, and
        # their indices coincide with the B merge list's spatial part
        limit = min(max_cand, n_spatial) if is_b else max_cand
        src_blk = sy[y0:y0 + n, x0:x0 + n]
        cur_cost = _cu_cost(src_blk, recon_y[y0:y0 + n, x0:x0 + n],
                            desc.coef_y[y0:y0 + n, x0:x0 + n], mv_cur,
                            prior_q, lam, rb)
        best = None
        seen = set()
        for idx, c in enumerate(cands[:limit]):
            mv = (int(c[0]), int(c[1]))
            if c[2] != 0 or mv == mv_cur or mv in seen:
                continue
            seen.add(mv)
            pred = mc_luma(ry_ref, x0, y0, n, mv[0], mv[1])
            lvl, rec = code_luma(pred, src_blk, n)
            d = (src_blk - rec).astype(np.float32)
            ssd = np.float32(np.sum(d * d))
            rate = rb.luma_bits(lvl) + rb.merge_bits(idx)
            cost = ssd + np.float32(lam * rate)
            if cost < cur_cost and (best is None or cost < best[0]):
                best = (cost, mv, lvl, rec)
        if best is None:
            return
        _, mv, lvl, rec = best
        flips += 1
        sl8 = (slice(uy, (y0 + n) // 8), slice(ux, (x0 + n) // 8))
        desc.mv[sl8[0], sl8[1], 0] = mv[0]
        desc.mv[sl8[0], sl8[1], 1] = mv[1]
        desc.coef_y[y0:y0 + n, x0:x0 + n] = lvl.astype(np.int16)
        recon_y[y0:y0 + n, x0:x0 + n] = rec
        cx0, cy0, nc = x0 // 2, y0 // 2, n // 2
        tu_c = min(nc, 16)               # CU64: four 16x16 chroma TUs
        for splane, rplane, recon_c, coefs in (
                (su, ru_ref, recon_u, desc.coef_u),
                (sv, rv_ref, recon_v, desc.coef_v)):
            cpred = mc_chroma(rplane, cx0, cy0, nc, mv[0], mv[1])
            cres = splane[cy0:cy0 + nc, cx0:cx0 + nc] - cpred
            for qy in range(0, nc, tu_c):
                for qx in range(0, nc, tu_c):
                    clvl, cr = _code_tu(cres[qy:qy + tu_c, qx:qx + tu_c],
                                        qp_c, sl, ps.sign_hiding, zf_mult,
                                        lam)
                    coefs[cy0 + qy:cy0 + qy + tu_c,
                          cx0 + qx:cx0 + qx + tu_c] = clvl.astype(np.int16)
                    recon_c[cy0 + qy:cy0 + qy + tu_c,
                            cx0 + qx:cx0 + qx + tu_c] = np.clip(
                        cpred[qy:qy + tu_c, qx:qx + tu_c] + cr, 0, 255)

    def walk(x0, y0, n, depth):
        if x0 >= w or y0 >= h:
            return
        inside = x0 + n <= w and y0 + n <= h
        if inside and int(desc.cu_depth[y0 // 8, x0 // 8]) <= depth:
            try_cu(x0, y0, n)
            return
        half = n // 2
        if half < 8:
            return
        for (dy, dx) in ((0, 0), (0, half), (half, 0), (half, half)):
            walk(x0 + dx, y0 + dy, half, depth + 1)

    ctu = ps.ctu_size
    for cy in range(-(-h // ctu)):
        for cx in range(-(-w // ctu)):
            walk(cx * ctu, cy * ctu, ctu, 0)
    return flips


def _mc_luma_rect(ref, x0, y0, pw, ph, mvx, mvy):
    """Rect luma MC via the square helper + crop (the 8-tap filter is
    per-sample, so the crop of a bounding-square prediction equals a
    direct rect prediction)."""
    n = max(pw, ph)
    return mc_luma(ref, x0, y0, n, mvx, mvy)[:ph, :pw]


def _mc_chroma_rect(ref, cx0, cy0, pw, ph, mvx, mvy):
    n = max(pw, ph)
    return mc_chroma(ref, cx0, cy0, n, mvx, mvy)[:ph, :pw]


def rect_pu_p(ps: ParamSets, desc: FrameDesc, sy, su, sv,
              ry_ref, ru_ref, rv_ref, recon_y, recon_u, recon_v,
              qp: int, zf_mult: float, prior_q, me_prec: int) -> int:
    """Rectangular-PU pass for P frames: re-evaluate each 2Nx2N CU16 as
    2NxN / Nx2N (two PUs, per-PU motion refined around the CU and
    neighbour MVs) and adopt when the re-coded cost wins (reference:
    inter partition evaluation in motion_inter_full,
    hmr_motion_inter.c:3746 — 2NxN/Nx2N PU loop). Returns adopted count."""
    rb = RdBits(ps, "P", qp)
    lam = float(T.rd_lambda(qp, "P"))
    lam16 = T.lambda_me_x16(qp)
    qp_c = T.chroma_qp(qp + ps.cb_qp_offset)
    sl = ps.scaling_list_enabled
    w, h = desc.width, desc.height
    cu_n = 16
    depth16 = ps.log2_ctu - 4
    if desc.inter_part is None:
        desc.inter_part = np.zeros(desc.pred_mode.shape, np.uint8)
    adopted = 0

    def refine_half(px, py, pw, ph, seeds):
        """Best (cost, mv) for one rect PU: seeds + -1..1 qpel/hpel refine
        (SAD + mvd-rate, like subpel_refine but rect)."""
        src_blk = sy[py:py + ph, px:px + pw]
        best = None
        tried = set()
        for smv in seeds:
            for step in ([4, 2, 1] if me_prec >= 2
                         else ([4, 2] if me_prec else [4])):
                base = smv if best is None else best[1]
                for dy in (-step, 0, step):
                    for dx in (-step, 0, step):
                        mv = (base[0] + dx, base[1] + dy)
                        if mv in tried:
                            continue
                        tried.add(mv)
                        pred = _mc_luma_rect(ry_ref, px, py, pw, ph,
                                             mv[0], mv[1])
                        sad = int(np.abs(src_blk - pred).sum())
                        cost = sad + ((lam16 * int(mv_rate(mv[0], mv[1],
                                                           prior_q))) >> 4)
                        if best is None or cost < best[0]:
                            best = (cost, mv)
        return best[1]

    h16, w16 = (h // cu_n) * cu_n, (w // cu_n) * cu_n
    for gy in range(h16 // cu_n):
        for gx in range(w16 // cu_n):
            x0, y0 = gx * cu_n, gy * cu_n
            uy, ux = y0 // 8, x0 // 8
            if (desc.cu_depth[uy, ux] != depth16
                    or desc.pred_mode[uy, ux] != MODE_INTER
                    or desc.inter_part[uy, ux] != 0):
                continue
            src_blk = sy[y0:y0 + cu_n, x0:x0 + cu_n]
            mv_cur = (int(desc.mv[uy, ux, 0]), int(desc.mv[uy, ux, 1]))
            cur_cost = _cu_cost(src_blk, recon_y[y0:y0 + cu_n, x0:x0 + cu_n],
                                desc.coef_y[y0:y0 + cu_n, x0:x0 + cu_n],
                                mv_cur, prior_q, lam, rb)
            best = None
            for part, pus in (
                    (1, [(x0, y0, 16, 8), (x0, y0 + 8, 16, 8)]),
                    (2, [(x0, y0, 8, 16), (x0 + 8, y0, 8, 16)])):
                # neighbour MV seeds: the adjacent CU on each PU's far side
                # captures the "other object's" motion across the split
                if part == 1:
                    nbp = [(x0, y0 - 8), (x0, y0 + cu_n)]
                else:
                    nbp = [(x0 - 8, y0), (x0 + cu_n, y0)]
                nbs = []
                for nx, ny in nbp:
                    q = desc.mv[min(max(ny, 0), h - 1) // 8,
                                min(max(nx, 0), w - 1) // 8]
                    nbs.append((int(q[0]), int(q[1])))
                mvs = []
                pred = np.empty((cu_n, cu_n), np.int32)
                for i, (px, py, pw, ph) in enumerate(pus):
                    mv = refine_half(px, py, pw, ph,
                                     [mv_cur, nbs[i]])
                    mvs.append(mv)
                    pred[py - y0:py - y0 + ph, px - x0:px - x0 + pw] = \
                        _mc_luma_rect(ry_ref, px, py, pw, ph, mv[0], mv[1])
                if mvs[0] == mvs[1]:
                    continue            # degenerates to 2Nx2N
                lvl, r = _code_tu(src_blk - pred, qp, sl, ps.sign_hiding,
                                  zf_mult, lam)
                rec = np.clip(pred + r, 0, 255)
                d = (src_blk - rec).astype(np.float32)
                ssd = np.float32(np.sum(d * d))
                # counted residual bins + per-PU AMVP syntax (part_mode
                # costs ~2 extra bins vs 2Nx2N; each PU pays merge_flag=0
                # + mvp flag + mvd bins)
                rate = (rb.luma_bits(lvl) + 2.0
                        + 2.0 * (rb.amvp_flag_bits() + 1.0)
                        + float(mv_rate(mvs[0][0], mvs[0][1], prior_q))
                        + float(mv_rate(mvs[1][0], mvs[1][1], prior_q)))
                cost = ssd + np.float32(lam * rate)
                if cost < cur_cost and (best is None or cost < best[0]):
                    best = (cost, part, pus, mvs, lvl, rec)
            if best is None:
                continue
            _, part, pus, mvs, lvl, rec = best
            adopted += 1
            desc.inter_part[uy:uy + 2, ux:ux + 2] = part
            for (px, py, pw, ph), mv in zip(pus, mvs):
                psl = (slice(py // 8, (py + ph) // 8),
                       slice(px // 8, (px + pw) // 8))
                desc.mv[psl[0], psl[1], 0] = mv[0]
                desc.mv[psl[0], psl[1], 1] = mv[1]
            desc.coef_y[y0:y0 + cu_n, x0:x0 + cu_n] = lvl.astype(np.int16)
            recon_y[y0:y0 + cu_n, x0:x0 + cu_n] = rec
            # chroma: per-PU MC halves, one 8x8 TU
            cx0, cy0 = x0 // 2, y0 // 2
            for splane, rplane, recon_c, coefs in (
                    (su, ru_ref, recon_u, desc.coef_u),
                    (sv, rv_ref, recon_v, desc.coef_v)):
                cpred = np.empty((8, 8), np.int32)
                for (px, py, pw, ph), mv in zip(pus, mvs):
                    cpred[(py - y0) // 2:(py - y0 + ph) // 2,
                          (px - x0) // 2:(px - x0 + pw) // 2] = \
                        _mc_chroma_rect(rplane, px // 2, py // 2,
                                        pw // 2, ph // 2, mv[0], mv[1])
                cres = splane[cy0:cy0 + 8, cx0:cx0 + 8] - cpred
                clvl, cr = _code_tu(cres, qp_c, sl, ps.sign_hiding,
                                    zf_mult, lam)
                coefs[cy0:cy0 + 8, cx0:cx0 + 8] = clvl.astype(np.int16)
                recon_c[cy0:cy0 + 8, cx0:cx0 + 8] = np.clip(cpred + cr,
                                                            0, 255)
    return adopted


def select_intra_independent(want: np.ndarray) -> np.ndarray:
    """Deterministic parallel independent-set selection on the king graph
    (8-neighborhood): an intra CU must never source ADI samples from
    another CU that also flips to intra (left/top/corners), and must not
    BE a source for one, so selected cells may not be 8-adjacent. Four
    (gy%2, gx%2) classes are swept in fixed order; within a class cells
    are >= 2 apart, so each sweep is conflict-free and fully vectorized.
    Identical arithmetic on device (jnp twin in engine/inter_encoder)."""
    gh, gw = want.shape
    gy = np.arange(gh)[:, None] & 1
    gx = np.arange(gw)[None, :] & 1
    sel = np.zeros((gh, gw), bool)
    for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        p = np.pad(sel, 1)
        blocked = (p[:-2, :-2] | p[:-2, 1:-1] | p[:-2, 2:]
                   | p[1:-1, :-2] | p[1:-1, 2:]
                   | p[2:, :-2] | p[2:, 1:-1] | p[2:, 2:])
        sel |= want & (gy == cy) & (gx == cx) & ~blocked
    return sel


def intra_fallback_p(ps: ParamSets, desc: FrameDesc, sy, su, sv,
                     recon_y, recon_u, recon_v, qp: int, prior_q,
                     slice_type: str = "P",
                     rounds: int = INTRA_P_ROUNDS) -> float:
    """Per-CU16 intra fallback inside a P/B frame (reference analog:
    intra-vs-inter comparison inside the CU walk, hmr_motion_inter.c
    :4008-4038). TPU-first redesign: the reference compares sequentially
    with closed-loop neighbors; here a POST-PASS evaluates an intra
    candidate for every 16x16 CU against the pass-1 (all-inter) recon —
    fully batched on device — and flips a king-graph-independent subset,
    so every flipped CU's ADI sources keep their pass-1 reconstruction
    and pass-1 recon values stay exact. Dense intra-preferring regions
    converge to 1/4 intra density per frame; full scene changes are
    handled by the scene-cut IDR instead.

    Because no intra CU has an intra neighbor, the decoder-side MPM list
    is always mpm_candidates(DC, DC) = [planar, DC, 26] — a constant.

    CUs coded as intra use TU16 luma + TU8 chroma (diagonal scan only,
    no DST: mode-dependent scans stop at 8x8 luma / 4x4 chroma), so the
    residual serialization path is shared with inter TUs.

    Runs `rounds` selection rounds: committed intra CUs are final, so a
    later round may flip CUs bordering them (their ADI reads the committed
    recon); only same-round picks need mutual independence. Dense
    intra-preferring regions thus reach ~3/4 density at 3 rounds.

    Modifies desc + recon planes in place; returns the fraction of CUs
    that *wanted* intra in round 1 (scene-change statistic, reference
    analog hmr_motion_inter.c:3791-3806)."""
    rb = RdBits(ps, slice_type, qp)
    h, w = sy.shape
    gh, gw = h // 16, w // 16
    avail = ip.Availability(w, h, ps.ctu_size)
    qp_c = T.chroma_qp(qp + ps.cb_qp_offset)
    lam = np.float32(T.rd_lambda(qp, slice_type))
    sl = ps.scaling_list_enabled
    bits_mpm, bits_rem = T.intra_mode_bits(qp)
    mpm = (0, 1, 26)
    mode_sad_bits = np.asarray(
        [bits_mpm if m in mpm else bits_rem for m in range(35)], np.int64)
    is_intra16 = np.zeros((gh, gw), bool)
    ratio = 0.0

    for rnd in range(rounds):
        # a CU may flip only while NOT an ADI source of a committed intra
        # CU: committed C reads its {W, NW, N, NE, SW} neighbors, so X is
        # blocked when a committed CU sits at X's {E, SE, S, SW, NE}
        p = np.pad(is_intra16, 1)
        blocked_dir = (p[1:-1, 2:] | p[2:, 2:] | p[2:, 1:-1]
                       | p[2:, :-2] | p[:-2, 2:])
        # ---- pass A: per-CU best-mode search + RD cost vs current coding --
        want = np.zeros((gh, gw), bool)
        cand = {}
        for gy in range(gh):
            for gx in range(gw):
                x0, y0 = gx * 16, gy * 16
                if desc.cu_depth[y0 // 8, x0 // 8] != ps.log2_ctu - 4:
                    continue           # CTB adopted a larger CU here
                if is_intra16[gy, gx] or blocked_dir[gy, gx]:
                    continue
                src_blk = sy[y0:y0 + 16, x0:x0 + 16].astype(np.int32)
                top, left = ip.build_reference_samples(recon_y, x0, y0, 16,
                                                       avail)
                sads = np.empty(35, np.int64)
                preds = []
                for mode in range(35):
                    ft, fl = ip.filter_reference_samples(top, left, 16,
                                                         mode, True)
                    pr = ip.predict(ft, fl, 16, mode, True)
                    preds.append(pr)
                    sads[mode] = np.abs(src_blk - pr).sum()
                mode = int(np.argmin(sads + mode_sad_bits))
                pred = preds[mode]
                resid = src_blk - pred
                coef = forward_transform(resid, False)
                lvl = quantize(coef, qp, True, sl)
                if ps.sign_hiding and np.any(lvl):
                    lvl = sign_bit_hiding(lvl, coef, qp, True,
                                          T.SCAN_DIAG, sl)
                if np.any(lvl):
                    r = inverse_transform(dequantize(lvl, qp, True, sl),
                                          False)
                    rec = np.clip(pred + r, 0, 255)
                else:
                    rec = pred
                d = (src_blk - rec).astype(np.float32)
                ssd = np.float32(np.sum(d * d))
                mb = INTRA_P_MODE_BITS_MPM if mode in mpm \
                    else INTRA_P_MODE_BITS_REM
                cost_i = ssd + lam * np.float32(
                    rb.luma_bits(lvl) + 2.0 + float(mb))
                mv = (int(desc.mv[y0 // 8, x0 // 8, 0]),
                      int(desc.mv[y0 // 8, x0 // 8, 1]))
                s16 = sy[y0:y0 + 16, x0:x0 + 16]
                l16 = desc.coef_y[y0:y0 + 16, x0:x0 + 16]
                r16 = recon_y[y0:y0 + 16, x0:x0 + 16]
                cost_p = _cu_cost(s16, r16, l16, mv, prior_q, lam, rb)
                if cost_i < cost_p:
                    want[gy, gx] = True
                    cand[(gy, gx)] = (mode, lvl, rec)
        if rnd == 0:
            ratio = float(want.mean()) if want.size else 0.0
        if not want.any():
            break

        # ---- pass B: independent-set selection + closed-loop commit ------
        sel = select_intra_independent(want)
        is_intra16 |= sel
        for gy in range(gh):
            for gx in range(gw):
                if not sel[gy, gx]:
                    continue
                x0, y0 = gx * 16, gy * 16
                mode, lvl, rec = cand[(gy, gx)]
                recon_y[y0:y0 + 16, x0:x0 + 16] = rec
                desc.coef_y[y0:y0 + 16, x0:x0 + 16] = lvl.astype(np.int16)
                sl8 = (slice(y0 // 8, y0 // 8 + 2),
                       slice(x0 // 8, x0 // 8 + 2))
                desc.pred_mode[sl8] = MODE_INTRA
                desc.tr_depth[sl8] = 0
                desc.skip[sl8] = 0
                if desc.inter_part is not None:
                    desc.inter_part[sl8] = 0
                desc.mv[sl8[0], sl8[1], :] = 0
                if desc.mv_l1 is not None:
                    desc.mv_l1[sl8[0], sl8[1], :] = 0
                desc.luma_mode[y0 // 4:y0 // 4 + 4,
                               x0 // 4:x0 // 4 + 4] = mode
                desc.chroma_mode[sl8] = mode        # DM
                # chroma TU8 at the DM mode (ADI sources are final: inter
                # recon or an earlier-round intra commit)
                cx0, cy0 = x0 // 2, y0 // 2
                for splane, rplane, coefs in ((su, recon_u, desc.coef_u),
                                              (sv, recon_v, desc.coef_v)):
                    ct, cl = ip.build_reference_samples(rplane, cx0, cy0, 8,
                                                        avail, comp_shift=1)
                    cpred = ip.predict(ct, cl, 8, mode, False)
                    cres = splane[cy0:cy0 + 8, cx0:cx0 + 8] \
                        .astype(np.int32) - cpred
                    ccoef = forward_transform(cres, False)
                    clvl = quantize(ccoef, qp_c, True, sl)
                    if ps.sign_hiding and np.any(clvl):
                        clvl = sign_bit_hiding(clvl, ccoef, qp_c, True,
                                               T.SCAN_DIAG, sl)
                    if np.any(clvl):
                        cr = inverse_transform(
                            dequantize(clvl, qp_c, True, sl), False)
                        crec = np.clip(cpred + cr, 0, 255)
                    else:
                        crec = cpred
                    rplane[cy0:cy0 + 8, cx0:cx0 + 8] = crec
                    coefs[cy0:cy0 + 8, cx0:cx0 + 8] = clvl.astype(np.int16)
    return ratio


def encode_inter_frame_tree(ps: ParamSets, src_planes, ref_planes, qp: int,
                            search: int = 16, is_b: bool = False,
                            avg_dist: float = 1000.0,
                            merge_rd: bool = False,
                            rect_pu: bool = False, qp_map=None):
    """CTB32/CTB64 P/B frame with a multi-level CU tree: each full 32x32
    region is coded either as one 2Nx2N CU32 (TU32 luma) or four CU16s,
    chosen by SSD + lambda*rate; with CTB64 a third pass then evaluates a
    2Nx2N CU64 (luma as four forced-split TU32s, spec log2>max_tb) against
    the adopted 32/16 coding per CTB (reference analog: motion_inter depth
    consolidation, hmr_motion_inter.c:3116-3290; CU64 default
    homer_app.c:307-337). Partial boundary CTBs stay at CU16.
    Returns (FrameDesc, recon_y, recon_u, recon_v)."""
    assert ps.ctu_size in (32, 64)
    want64 = ps.ctu_size == 64
    base32 = ps.log2_ctu - 5          # quadtree depth of a CU32
    sy0 = np.asarray(src_planes[0], np.int32)
    ry0 = np.asarray(ref_planes[0], np.int32)
    lam16_ = T.lambda_me_x16(qp)
    if want64:
        fp16_mv, pr16, fp32, prior_q, fp64, prior64 = hier_pel_fields(
            sy0, ry0, search, lam16_, want32=True, want64=True,
            far=far_range(ps, search))
    else:
        fp16_mv, pr16, fp32, prior_q = hier_pel_fields(
            sy0, ry0, search, lam16_, want32=True,
            far=far_range(ps, search))
    # level-16 pass: reuse the flat encoder wholesale (fills desc at depth 1)
    desc, recon_y, recon_u, recon_v, _ = _encode_level16(
        ps, src_planes, ref_planes, qp, search, avg_dist,
        fp16=(fp16_mv, pr16), qp_map=qp_map)
    if qp_map is not None:
        merge_rd = rect_pu = False   # post-passes code at the slice QP
    sy, su, sv = [np.asarray(p, np.int32) for p in src_planes]
    ry_ref, ru_ref, rv_ref = [np.asarray(p, np.int32) for p in ref_planes]
    h, w = sy.shape
    sl = ps.scaling_list_enabled
    qp_c = T.chroma_qp(qp + ps.cb_qp_offset)
    zf_mult = zf_multiplier(avg_dist, qp)
    lam = T.rd_lambda(qp, "P")
    lam16 = T.lambda_me_x16(qp)
    me_prec = int(ps.cfg.motion_estimation_precision)

    def cu_qps(x0, y0):
        """Per-CTB (luma, chroma) QP under AQ/row-RC maps (QG = CTB)."""
        if qp_map is None:
            return qp, qp_c
        q = int(qp_map[y0 // ps.ctu_size, x0 // ps.ctu_size])
        return q, T.chroma_qp(q + ps.cb_qp_offset)

    # performance modes (reference hmr_encoder_lib.c:921-947): FAST adds a
    # fast-skip loop (consolidation passes skip regions whose sub-CU
    # motion already disagrees — the merged CU can't win); UFAST also
    # raises the min CU depth by one (the CU64 pass is skipped, like the
    # reference's performance_min_depth=1). Decision-effort pruning only
    # exists on this golden path: the device twin evaluates all levels in
    # one batched program, where pruning saves nothing — but it applies the
    # SAME fast-skip mask to its consolidation choices (bit-exact twin) and
    # drops its merge-RD stage / CU64 layer, so -performance_mode changes
    # the fps of the program the bench measures too.
    perf = int(getattr(ps.cfg, "performance_mode", 0))
    if perf >= 1:
        merge_rd = rect_pu = False   # FAST prunes the RD refinement passes

    def mv_spread16(x0, y0, n):
        """Max qpel MV disagreement among the adopted sub-CU motion of an
        n x n region (fast-skip predicate for consolidation)."""
        g = desc.mv[y0 // 8:(y0 + n) // 8:2, x0 // 8:(x0 + n) // 8:2]
        return int((g.max(axis=(0, 1)) - g.min(axis=(0, 1))).max())

    # fp32/prior_q come from the shared 16/32 hierarchical field above
    for gy in range(h // 32):
        for gx in range(w // 32):
            x0, y0 = gx * 32, gy * 32
            if perf >= 1 and mv_spread16(x0, y0, 32) > 16:
                continue     # fast skip: sub-CUs track different motion
            src_blk = sy[y0:y0 + 32, x0:x0 + 32]
            mv = (4 * int(fp32[gy, gx, 0]), 4 * int(fp32[gy, gx, 1]))
            if me_prec >= 1:
                mv = subpel_refine(src_blk, ry_ref, x0, y0, mv, 2,
                                   prior_q, lam16)
            if me_prec >= 2:
                mv = subpel_refine(src_blk, ry_ref, x0, y0, mv, 1,
                                   prior_q, lam16)
            qp_cu, qp_c_cu = cu_qps(x0, y0)
            pred = mc_luma(ry_ref, x0, y0, 32, mv[0], mv[1])
            resid = src_blk - pred
            lvl, r = _code_tu(resid, qp_cu, sl, ps.sign_hiding, zf_mult,
                              lam)
            rec32 = np.clip(pred + r, 0, 255)
            c32 = _cu_cost(src_blk, rec32, lvl, mv, prior_q, lam)
            c16 = np.float32(0.0)
            for cy16 in (y0, y0 + 16):
                for cx16 in (x0, x0 + 16):
                    mv16 = (int(desc.mv[cy16 // 8, cx16 // 8, 0]),
                            int(desc.mv[cy16 // 8, cx16 // 8, 1]))
                    s16 = sy[cy16:cy16 + 16, cx16:cx16 + 16]
                    l16 = desc.coef_y[cy16:cy16 + 16, cx16:cx16 + 16]
                    rec16 = recon_y[cy16:cy16 + 16, cx16:cx16 + 16]
                    c16 = c16 + _cu_cost(s16, rec16, l16, mv16, prior_q, lam)
            if not (c32 <= c16):
                continue
            # adopt the CU32 coding for this region
            sl8 = (slice(y0 // 8, y0 // 8 + 4), slice(x0 // 8, x0 // 8 + 4))
            desc.cu_depth[sl8] = base32
            desc.mv[sl8[0], sl8[1], 0] = mv[0]
            desc.mv[sl8[0], sl8[1], 1] = mv[1]
            desc.coef_y[y0:y0 + 32, x0:x0 + 32] = lvl.astype(np.int16)
            recon_y[y0:y0 + 32, x0:x0 + 32] = rec32
            cx0, cy0 = x0 // 2, y0 // 2
            for splane, rplane, recon_c, coefs, off in (
                    (su, ru_ref, recon_u, desc.coef_u, ps.cb_qp_offset),
                    (sv, rv_ref, recon_v, desc.coef_v, ps.cr_qp_offset)):
                cpred = mc_chroma(rplane, cx0, cy0, 16, mv[0], mv[1])
                cres = splane[cy0:cy0 + 16, cx0:cx0 + 16] - cpred
                clvl, cr = _code_tu(cres, qp_c_cu, sl, ps.sign_hiding,
                                    zf_mult, lam)
                coefs[cy0:cy0 + 16, cx0:cx0 + 16] = clvl.astype(np.int16)
                recon_c[cy0:cy0 + 16, cx0:cx0 + 16] = \
                    np.clip(cpred + cr, 0, 255)
    if want64 and perf >= 2:
        want64 = False       # UFAST: min CU depth 1 (no CU64 evaluation)
    if want64:
        def region_cost(x0, y0, n):
            """Cost of the CURRENTLY adopted coding of an n x n region
            (recursing into the CU sizes recorded in desc)."""
            cu_n = ps.ctu_size >> int(desc.cu_depth[y0 // 8, x0 // 8])
            if cu_n >= n:
                mv_ = (int(desc.mv[y0 // 8, x0 // 8, 0]),
                       int(desc.mv[y0 // 8, x0 // 8, 1]))
                return _cu_cost(sy[y0:y0 + n, x0:x0 + n],
                                recon_y[y0:y0 + n, x0:x0 + n],
                                desc.coef_y[y0:y0 + n, x0:x0 + n],
                                mv_, prior_q, lam)
            half = n // 2
            return sum(region_cost(x0 + dx, y0 + dy, half)
                       for dy, dx in ((0, 0), (0, half), (half, 0),
                                      (half, half)))

        for gy in range(h // 64):
            for gx in range(w // 64):
                x0, y0 = gx * 64, gy * 64
                if perf >= 1 and mv_spread16(x0, y0, 64) > 16:
                    continue   # fast skip (see above)
                src_blk = sy[y0:y0 + 64, x0:x0 + 64]
                mv = (4 * int(fp64[gy, gx, 0]), 4 * int(fp64[gy, gx, 1]))
                if me_prec >= 1:
                    mv = subpel_refine(src_blk, ry_ref, x0, y0, mv, 2,
                                       prior_q, lam16)
                if me_prec >= 2:
                    mv = subpel_refine(src_blk, ry_ref, x0, y0, mv, 1,
                                       prior_q, lam16)
                qp_cu, qp_c_cu = cu_qps(x0, y0)
                pred = mc_luma(ry_ref, x0, y0, 64, mv[0], mv[1])
                resid = src_blk - pred
                # luma: four forced-split TU32s (spec: log2 64 > max TB 32)
                lvl64 = np.zeros((64, 64), np.int32)
                r64 = np.zeros((64, 64), np.int32)
                for qy in (0, 32):
                    for qx in (0, 32):
                        lq, rq = _code_tu(resid[qy:qy + 32, qx:qx + 32],
                                          qp_cu, sl, ps.sign_hiding,
                                          zf_mult, lam)
                        lvl64[qy:qy + 32, qx:qx + 32] = lq
                        r64[qy:qy + 32, qx:qx + 32] = rq
                rec64 = np.clip(pred + r64, 0, 255)
                c64 = _cu_cost(src_blk, rec64, lvl64, mv, prior_q, lam)
                if not (c64 <= region_cost(x0, y0, 64)):
                    continue
                # adopt the CU64 coding for this CTB
                sl8 = (slice(y0 // 8, y0 // 8 + 8),
                       slice(x0 // 8, x0 // 8 + 8))
                desc.cu_depth[sl8] = 0
                desc.tr_depth[sl8] = 1       # forced TU32 split
                desc.pred_mode[sl8] = MODE_INTER
                desc.mv[sl8[0], sl8[1], 0] = mv[0]
                desc.mv[sl8[0], sl8[1], 1] = mv[1]
                desc.coef_y[y0:y0 + 64, x0:x0 + 64] = lvl64.astype(np.int16)
                recon_y[y0:y0 + 64, x0:x0 + 64] = rec64
                cx0, cy0 = x0 // 2, y0 // 2
                for splane, rplane, recon_c, coefs in (
                        (su, ru_ref, recon_u, desc.coef_u),
                        (sv, rv_ref, recon_v, desc.coef_v)):
                    cpred = mc_chroma(rplane, cx0, cy0, 32, mv[0], mv[1])
                    cres = splane[cy0:cy0 + 32, cx0:cx0 + 32] - cpred
                    crec = np.empty((32, 32), np.int32)
                    # chroma: four 16x16 TUs (one per TU32 leaf)
                    for qy in (0, 16):
                        for qx in (0, 16):
                            clvl, cr = _code_tu(
                                cres[qy:qy + 16, qx:qx + 16], qp_c_cu, sl,
                                ps.sign_hiding, zf_mult, lam)
                            coefs[cy0 + qy:cy0 + qy + 16,
                                  cx0 + qx:cx0 + qx + 16] = \
                                clvl.astype(np.int16)
                            crec[qy:qy + 16, qx:qx + 16] = np.clip(
                                cpred[qy:qy + 16, qx:qx + 16]
                                + cr, 0, 255)
                    recon_c[cy0:cy0 + 32, cx0:cx0 + 32] = crec
    if rect_pu and not (is_b and desc.mv_l1 is not None):
        rect_pu_p(ps, desc, sy, su, sv, ry_ref, ru_ref, rv_ref,
                  recon_y, recon_u, recon_v, qp, zf_mult, prior_q,
                  me_prec)
    if merge_rd and not (is_b and desc.mv_l1 is not None):
        merge_rd_p(ps, desc, sy, su, sv, ry_ref, ru_ref, rv_ref,
                   recon_y, recon_u, recon_v, qp, zf_mult, prior_q,
                   is_b=is_b)
    if ps.cfg.intra_in_p and qp_map is None:
        intra_fallback_p(ps, desc, sy, su, sv, recon_y, recon_u, recon_v,
                         qp, prior_q)
    select_inter_syntax_tree(ps, desc, is_b=is_b)
    if ps.deblocking_enabled:
        recon_y = _deblock_inter_luma(ps, desc, recon_y, qp)
        recon_u, recon_v = _deblock_inter_chroma(ps, desc, recon_u,
                                                 recon_v, qp)
    return desc, recon_y, recon_u, recon_v


def encode_b_frame_tree(ps: ParamSets, src_planes, ref0_planes, ref1_planes,
                        qp: int, search: int = 16, avg_dist: float = 1000.0,
                        dists=(1, -1)):
    """B frame with the CU32/CU16 tree and PER-CU uni/bi selection: each
    inter CU codes whichever of {uni-L0, uni-L1, bi} wins SSD+lambda*rate.
    Bi prediction uses the normative 14-bit weighted average
    (spec 8.5.4.2.3.2; reference analog hmr_bi_motion_estimation_HM
    hmr_motion_inter.c:1279 + weighted average :2903, per-CU uni/bi choice
    :2471-2880). Mixed directions make AMVP hit the spec 8.5.3.2.6
    POC-distance scaling branch — dists = (POC(cur)-POC(ref L0),
    POC(cur)-POC(ref L1)) feeds it. Returns (desc, ry, ru, rv)."""
    assert ps.ctu_size == 32
    sy, su, sv = [np.asarray(p, np.int32) for p in src_planes]
    r0 = [np.asarray(p, np.int32) for p in ref0_planes]
    r1 = [np.asarray(p, np.int32) for p in ref1_planes]
    h, w = sy.shape
    sl = ps.scaling_list_enabled
    qp_c = T.chroma_qp(qp + ps.cb_qp_offset)
    zf_mult = zf_multiplier(avg_dist, qp)
    lam = T.rd_lambda(qp, "P")
    lam16 = T.lambda_me_x16(qp)
    me_prec = int(ps.cfg.motion_estimation_precision)
    farv = far_range(ps, search)
    f16_0, p16_0, f32_0, p32_0 = hier_pel_fields(sy, r0[0], search, lam16,
                                                 want32=True, far=farv)
    # uni-L1 candidate motion: matched to the SOURCE (unlike the bi list-1
    # field below, which is matched to the bi target 2*src - pred0)
    f16_1s, p16_1s, f32_1s, p32_1s = hier_pel_fields(sy, r1[0], search,
                                                     lam16, want32=True,
                                                     far=farv)
    desc = FrameDesc.alloc(w, h)
    desc.pred_mode[:] = MODE_INTER
    desc.cu_depth[:] = 1
    desc.mv_l1 = np.zeros_like(desc.mv)
    desc.mvp_flag_l1 = np.zeros_like(desc.mvp_flag)
    desc.inter_dir = np.zeros(desc.pred_mode.shape, np.uint8)
    recon_y = np.zeros_like(sy)
    recon_u = np.zeros_like(su)
    recon_v = np.zeros_like(sv)

    def refine_list(x0, y0, n, fp, prior, ref_y, tgt=None):
        mv = (4 * int(fp[0]), 4 * int(fp[1]))
        src_blk = (sy if tgt is None else tgt)[y0:y0 + n, x0:x0 + n]
        if me_prec >= 1:
            mv = subpel_refine(src_blk, ref_y, x0, y0, mv, 2, prior, lam16)
        if me_prec >= 2:
            mv = subpel_refine(src_blk, ref_y, x0, y0, mv, 1, prior, lam16)
        return mv

    # ---- list-0 motion first, then bi list-1 by BI-TARGET matching: the
    # second list searches 2*src - pred0 so the weighted average lands on
    # the source (reference analog: hmr_bi_motion_estimation_HM,
    # hmr_motion_inter.c:1279) ----
    gh, gw = h // 16, w // 16
    mv0_16 = {}
    pred0_plane = np.zeros((gh * 16, gw * 16), np.int32)
    for gy in range(gh):
        for gx in range(gw):
            x0, y0 = gx * 16, gy * 16
            mv0 = refine_list(x0, y0, 16, f16_0[gy, gx], p16_0, r0[0])
            mv0_16[(gy, gx)] = mv0
            v0 = mc_luma_14(r0[0], x0, y0, 16, mv0[0], mv0[1])
            pred0_plane[y0:y0 + 16, x0:x0 + 16] = \
                np.clip((v0 + 32) >> 6, 0, 255)
    target = 2 * sy[:gh * 16, :gw * 16] - pred0_plane
    f16_1, p16_1, f32_1, p32_1 = hier_pel_fields(target, r1[0], search,
                                                 lam16, want32=True, far=farv)

    def code_bi_cu(x0, y0, n, mv0, mv1):
        """Bi MC + TU coding for one n x n CU; returns
        (lvl, rec, lvl_u, rec_u, lvl_v, rec_v)."""
        v0 = mc_luma_14(r0[0], x0, y0, n, mv0[0], mv0[1])
        v1 = mc_luma_14(r1[0], x0, y0, n, mv1[0], mv1[1])
        pred = bi_average(v0, v1)
        resid = sy[y0:y0 + n, x0:x0 + n] - pred
        lvl, rr = _code_tu(resid, qp, sl, ps.sign_hiding, zf_mult, lam)
        rec = np.clip(pred + rr, 0, 255)
        outs = [lvl, rec]
        nc = n // 2
        cx0, cy0 = x0 // 2, y0 // 2
        for sp, rp0, rp1 in ((su, r0[1], r1[1]), (sv, r0[2], r1[2])):
            c0 = mc_chroma_14(rp0, cx0, cy0, nc, mv0[0], mv0[1])
            c1 = mc_chroma_14(rp1, cx0, cy0, nc, mv1[0], mv1[1])
            cpred = bi_average(c0, c1)
            cres = sp[cy0:cy0 + nc, cx0:cx0 + nc] - cpred
            clvl, crr = _code_tu(cres, qp_c, sl, ps.sign_hiding, zf_mult,
                                 lam)
            outs += [clvl, np.clip(cpred + crr, 0, 255)]
        return outs

    def code_uni_cu(x0, y0, n, mv, rr_):
        """Uni MC (normatively rounded) + TU coding for one CU."""
        pred = mc_luma(rr_[0], x0, y0, n, mv[0], mv[1])
        resid = sy[y0:y0 + n, x0:x0 + n] - pred
        lvl, rres = _code_tu(resid, qp, sl, ps.sign_hiding, zf_mult, lam)
        rec = np.clip(pred + rres, 0, 255)
        outs = [lvl, rec]
        nc = n // 2
        cx0, cy0 = x0 // 2, y0 // 2
        for sp, rp in ((su, rr_[1]), (sv, rr_[2])):
            cpred = mc_chroma(rp, cx0, cy0, nc, mv[0], mv[1])
            cres = sp[cy0:cy0 + nc, cx0:cx0 + nc] - cpred
            clvl, crr = _code_tu(cres, qp_c, sl, ps.sign_hiding, zf_mult,
                                 lam)
            outs += [clvl, np.clip(cpred + crr, 0, 255)]
        return outs

    def cost_cu(x0, y0, n, rec, lvl, mv_bits):
        d = (sy[y0:y0 + n, x0:x0 + n] - rec).astype(np.float32)
        bits = (3.0 * np.count_nonzero(lvl) + np.sum(np.abs(lvl)) + 6.0
                + float(mv_bits))
        return float(np.sum(d * d)) + float(lam) * bits

    def store_cu(x0, y0, n, cdir, mv0, mv1, outs):
        lvl, rec, lu_, ru_, lv_, rv_ = outs
        r8 = n // 8
        s8 = (slice(y0 // 8, y0 // 8 + r8), slice(x0 // 8, x0 // 8 + r8))
        desc.inter_dir[s8] = cdir
        if cdir & 1:
            desc.mv[s8[0], s8[1], 0] = mv0[0]
            desc.mv[s8[0], s8[1], 1] = mv0[1]
        else:
            desc.mv[s8[0], s8[1], :] = 0
        if cdir & 2:
            desc.mv_l1[s8[0], s8[1], 0] = mv1[0]
            desc.mv_l1[s8[0], s8[1], 1] = mv1[1]
        else:
            desc.mv_l1[s8[0], s8[1], :] = 0
        nc = n // 2
        cy0, cx0 = y0 // 2, x0 // 2
        desc.coef_y[y0:y0 + n, x0:x0 + n] = lvl.astype(np.int16)
        recon_y[y0:y0 + n, x0:x0 + n] = rec
        desc.coef_u[cy0:cy0 + nc, cx0:cx0 + nc] = lu_.astype(np.int16)
        recon_u[cy0:cy0 + nc, cx0:cx0 + nc] = ru_
        desc.coef_v[cy0:cy0 + nc, cx0:cx0 + nc] = lv_.astype(np.int16)
        recon_v[cy0:cy0 + nc, cx0:cx0 + nc] = rv_

    def choose(cands):
        """cands: [(cost, dir, mv0, mv1, outs), ...] in (bi, uni0, uni1)
        order; bi wins ties against both unis, uni0 against uni1 — the
        device twin mirrors this exact tie-break."""
        cbi, c0, c1 = cands[0][0], cands[1][0], cands[2][0]
        if cbi <= c0 and cbi <= c1:
            return cands[0]
        return cands[1] if c0 <= c1 else cands[2]

    def refine_l0_against(x0, y0, n, mv0, mv1t):
        """Alternating bi refinement: re-refine the list-0 MV against the
        complement target 2*src - pred1 (one iteration of the reference's
        iterative bi ME, hmr_bi_motion_estimation_HM / remove_high_freq,
        hmr_motion_inter.c:954,:1279). Device twin: _impl_b refine_bi0."""
        v1 = mc_luma_14(r1[0], x0, y0, n, mv1t[0], mv1t[1])
        t0 = (2 * sy[y0:y0 + n, x0:x0 + n]
              - np.clip((v1 + 32) >> 6, 0, 255))
        mv0b = mv0
        # device-twin candidate clamp: the device volume covers
        # [4*(c>>2)-4, 4*(c>>2)+3] qpel per axis around the centre
        bounds = ((4 * (mv0[0] >> 2) - 4, 4 * (mv0[1] >> 2) - 4),
                  (4 * (mv0[0] >> 2) + 3, 4 * (mv0[1] >> 2) + 3))
        if me_prec >= 1:
            mv0b = subpel_refine(t0, r0[0], x0, y0, mv0b, 2, p16_0
                                 if n == 16 else p32_0, lam16, bounds)
        if me_prec >= 2:
            mv0b = subpel_refine(t0, r0[0], x0, y0, mv0b, 1, p16_0
                                 if n == 16 else p32_0, lam16, bounds)
        return mv0b

    cost16 = np.zeros((gh, gw), np.float32)
    for gy in range(gh):
        for gx in range(gw):
            x0, y0 = gx * 16, gy * 16
            mv0 = mv0_16[(gy, gx)]
            mv1t = refine_list(x0, y0, 16, f16_1[gy, gx], p16_1, r1[0],
                               tgt=target)
            outs_bi = code_bi_cu(x0, y0, 16, mv0, mv1t)
            cbi = cost_cu(x0, y0, 16, outs_bi[1], outs_bi[0],
                          mv_rate(mv0[0], mv0[1], p16_0)
                          + mv_rate(mv1t[0], mv1t[1], p16_1))
            mv0bi = mv0
            mv0b = refine_l0_against(x0, y0, 16, mv0, mv1t)
            if mv0b != mv0:
                outs_r = code_bi_cu(x0, y0, 16, mv0b, mv1t)
                cbir = cost_cu(x0, y0, 16, outs_r[1], outs_r[0],
                               mv_rate(mv0b[0], mv0b[1], p16_0)
                               + mv_rate(mv1t[0], mv1t[1], p16_1))
                if cbir < cbi:
                    outs_bi, cbi, mv0bi = outs_r, cbir, mv0b
            outs_u0 = code_uni_cu(x0, y0, 16, mv0, r0)
            cu0 = cost_cu(x0, y0, 16, outs_u0[1], outs_u0[0],
                          mv_rate(mv0[0], mv0[1], p16_0))
            mv1s = refine_list(x0, y0, 16, f16_1s[gy, gx], p16_1s, r1[0])
            outs_u1 = code_uni_cu(x0, y0, 16, mv1s, r1)
            cu1 = cost_cu(x0, y0, 16, outs_u1[1], outs_u1[0],
                          mv_rate(mv1s[0], mv1s[1], p16_1s))
            best = choose([(cbi, 3, mv0bi, mv1t, outs_bi),
                           (cu0, 1, mv0, None, outs_u0),
                           (cu1, 2, None, mv1s, outs_u1)])
            cost16[gy, gx] = best[0]
            store_cu(x0, y0, 16, best[1], best[2], best[3], best[4])

    # ---- CU32 layer (same three-way choice; keep CTB32 iff it beats the
    # sum of its four chosen CU16 codings) ----
    for gy in range(h // 32):
        for gx in range(w // 32):
            x0, y0 = gx * 32, gy * 32
            mv0 = refine_list(x0, y0, 32, f32_0[gy, gx], p32_0, r0[0])
            v0_32 = mc_luma_14(r0[0], x0, y0, 32, mv0[0], mv0[1])
            t32 = np.zeros_like(target)
            t32[y0:y0 + 32, x0:x0 + 32] = \
                2 * sy[y0:y0 + 32, x0:x0 + 32] \
                - np.clip((v0_32 + 32) >> 6, 0, 255)
            mv1t = refine_list(x0, y0, 32, f32_1[gy, gx], p32_1, r1[0],
                               tgt=t32)
            outs_bi = code_bi_cu(x0, y0, 32, mv0, mv1t)
            cbi = cost_cu(x0, y0, 32, outs_bi[1], outs_bi[0],
                          mv_rate(mv0[0], mv0[1], p32_0)
                          + mv_rate(mv1t[0], mv1t[1], p32_1))
            mv0bi = mv0
            mv0b = refine_l0_against(x0, y0, 32, mv0, mv1t)
            if mv0b != mv0:
                outs_r = code_bi_cu(x0, y0, 32, mv0b, mv1t)
                cbir = cost_cu(x0, y0, 32, outs_r[1], outs_r[0],
                               mv_rate(mv0b[0], mv0b[1], p32_0)
                               + mv_rate(mv1t[0], mv1t[1], p32_1))
                if cbir < cbi:
                    outs_bi, cbi, mv0bi = outs_r, cbir, mv0b
            outs_u0 = code_uni_cu(x0, y0, 32, mv0, r0)
            cu0 = cost_cu(x0, y0, 32, outs_u0[1], outs_u0[0],
                          mv_rate(mv0[0], mv0[1], p32_0))
            mv1s = refine_list(x0, y0, 32, f32_1s[gy, gx], p32_1s, r1[0])
            outs_u1 = code_uni_cu(x0, y0, 32, mv1s, r1)
            cu1 = cost_cu(x0, y0, 32, outs_u1[1], outs_u1[0],
                          mv_rate(mv1s[0], mv1s[1], p32_1s))
            best = choose([(cbi, 3, mv0bi, mv1t, outs_bi),
                           (cu0, 1, mv0, None, outs_u0),
                           (cu1, 2, None, mv1s, outs_u1)])
            c16 = float(cost16[2 * gy:2 * gy + 2, 2 * gx:2 * gx + 2].sum())
            if not (best[0] <= c16):
                continue
            desc.cu_depth[y0 // 8:y0 // 8 + 4, x0 // 8:x0 // 8 + 4] = 0
            store_cu(x0, y0, 32, best[1], best[2], best[3], best[4])
    select_inter_syntax_tree(ps, desc, is_b=True, dists=dists)
    if ps.deblocking_enabled:
        recon_y = _deblock_inter_luma(ps, desc, recon_y, qp)
    return desc, recon_y, recon_u, recon_v


CU_AMVP_BITS = 6.0             # 2Nx2N AMVP CU overhead (device cost model)


def merge_b0_avail(gh: int, gw: int, ctu_size: int) -> np.ndarray:
    """(gh, gw) bool: is the above-right (B0) neighbour of each CU16
    already coded when CU16s are visited in z-scan within CTBs of
    `ctu_size` (raster over CTBs)? True everywhere for CTB16 (flat raster);
    within CTB32/64 the bottom-right-ish z positions lose B0 (spec
    z-scan availability, 6.4.1; reference analog get_available_... in
    hmr_motion_inter.c merge candidate derivation)."""
    t = ctu_size // 16
    ys, xs = np.mgrid[0:gh, 0:gw]
    ux, uy = xs % t, ys % t

    def morton(x, y):
        z = np.zeros_like(x)
        for b in range(2):
            z |= (((x >> b) & 1) << (2 * b)) | (((y >> b) & 1) << (2 * b + 1))
        return z
    arx, ary = ux + 1, uy - 1
    within = arx < t
    za = morton(np.clip(arx, 0, t - 1), np.clip(ary, 0, t - 1))
    ok = (uy == 0) | (within & (za < morton(ux, uy)))
    return ok


def merge_rd_fast(ps: ParamSets, desc: FrameDesc, sy, su, sv,
                  ry_ref, ru_ref, rv_ref, recon_y, recon_u, recon_v,
                  qp: int, zf_mult: float, prior_q) -> int:
    """Batched merge-RD for the flat CU16 path — the DEVICE-twin variant
    of merge_rd_p (tests/test_tpu_inter.py pins bit-exactness against the
    merge-RD stage of TpuInterEncoder._impl).

    TPU-first redesign of the reference's sequential merge check
    (check_rd_cost_merge_2nx2n, hmr_motion_inter.c:3493): candidates for
    EVERY CU derive from the PRE-pass motion field in one batch (first
    two spec 8.5.3.2.3 entries, exact sample positions + pruning), both
    are re-coded and costed with the device model (3*nnz + sum|lvl| +
    syntax constants), and a king-graph-independent subset of improving
    CUs flips — so no flipped CU can change another flipped CU's
    candidate list, and the final syntax selection re-finds every merge
    against the post-flip field. Returns the number of flipped CUs."""
    lam = np.float32(T.rd_lambda(qp, "P"))
    qp_c = T.chroma_qp(qp + ps.cb_qp_offset)
    sl = ps.scaling_list_enabled
    h, w = desc.height, desc.width
    gh, gw = h // 16, w // 16
    mv = desc.mv.astype(np.int64)
    BIG = np.float32(np.inf)

    def unit(uy, ux):
        """Packed mv at 8-unit (uy, ux) per CU, invalid -> None mask."""
        oy, ox = uy, ux
        val = np.zeros((gh, gw), bool)
        out = np.zeros((gh, gw, 2), np.int64)
        ys = 2 * np.arange(gh)[:, None] + oy
        xs = 2 * np.arange(gw)[None, :] + ox
        ok = (ys >= 0) & (ys < h // 8) & (xs >= 0) & (xs < w // 8)
        ysc = np.clip(ys, 0, h // 8 - 1)
        xsc = np.clip(xs, 0, w // 8 - 1)
        out = mv[ysc, xsc]
        val = ok & (desc.pred_mode[ysc, xsc] == MODE_INTER)
        return val, out

    # spec sample positions for a 16x16 PU at 8-unit origin (2gy, 2gx)
    va1, a1 = unit(1, -1)
    vb1, b1 = unit(-1, 1)
    vb0, b0 = unit(-1, 2)
    vb2, b2 = unit(-1, -1)
    # B0 also needs coded-before: always true in flat CTB16 raster, a
    # z-scan predicate inside CTB32/64 trees (merge_b0_avail)
    vb0 = vb0 & merge_b0_avail(gh, gw, ps.ctu_size)

    def neq(p, q, vq):
        return ~vq | (p[..., 0] != q[..., 0]) | (p[..., 1] != q[..., 1])

    k1 = va1
    k2 = vb1 & neq(b1, a1, va1)
    k3 = vb0 & neq(b0, b1, vb1)
    k4 = vb2 & neq(b2, a1, va1) & neq(b2, b1, vb1)
    kept = np.stack([k1, k2, k3, k4])                 # (4, gh, gw)
    mvs_k = np.stack([a1, b1, b0, b2])                # (4, gh, gw, 2)
    order = np.cumsum(kept, axis=0) * kept            # 1-based slot index
    cand = np.zeros((2, gh, gw, 2), np.int64)         # zero-fill = (0,0)
    for s in range(4):
        for c in range(2):
            m = order[s] == c + 1
            cand[c][m] = mvs_k[s][m]
    n_spat = kept.sum(axis=0)

    cur = mv[::2, ::2]
    flips = 0
    costs = np.full((2, gh, gw), BIG, np.float32)
    lvl_cand = np.zeros((2, gh, gw, 16, 16), np.int32)
    rec_cand = np.zeros((2, gh, gw, 16, 16), np.int32)
    lam16 = T.lambda_me_x16(qp)
    for gy in range(gh):
        for gx in range(gw):
            x0, y0 = gx * 16, gy * 16
            if desc.pred_mode[2 * gy, 2 * gx] != MODE_INTER:
                continue
            if desc.inter_part is not None and desc.inter_part[2 * gy,
                                                               2 * gx]:
                continue
            src_blk = sy[y0:y0 + 16, x0:x0 + 16]
            for c in range(2):
                mvc = (int(cand[c, gy, gx, 0]), int(cand[c, gy, gx, 1]))
                if mvc == (int(cur[gy, gx, 0]), int(cur[gy, gx, 1])):
                    continue
                if c == 1 and tuple(cand[0, gy, gx]) == tuple(
                        cand[1, gy, gx]):
                    continue
                pred = mc_luma(ry_ref, x0, y0, 16, mvc[0], mvc[1])
                lvl, rr = _code_tu(src_blk - pred, qp, sl, ps.sign_hiding,
                                   zf_mult, float(lam))
                rec = np.clip(pred + rr, 0, 255)
                d = (src_blk - rec).astype(np.float32)
                ssd = np.float32(np.sum(d * d))
                rate = (3.0 * np.count_nonzero(lvl) + np.sum(np.abs(lvl))
                        + MERGE_FAST_BITS_BASE + c)
                costs[c, gy, gx] = ssd + lam * np.float32(rate)
                lvl_cand[c, gy, gx] = lvl
                rec_cand[c, gy, gx] = rec

    # current cost (device cu_cost16 arithmetic)
    cur_cost = np.full((gh, gw), BIG, np.float32)
    for gy in range(gh):
        for gx in range(gw):
            x0, y0 = gx * 16, gy * 16
            if desc.pred_mode[2 * gy, 2 * gx] != MODE_INTER:
                continue
            src_blk = sy[y0:y0 + 16, x0:x0 + 16]
            rec = recon_y[y0:y0 + 16, x0:x0 + 16]
            lvl = desc.coef_y[y0:y0 + 16, x0:x0 + 16]
            d = (src_blk - rec).astype(np.float32)
            ssd = np.float32(np.sum(d * d))
            rate = (3.0 * np.count_nonzero(lvl) + np.sum(np.abs(lvl))
                    + CU_AMVP_BITS
                    + float(mv_rate(int(cur[gy, gx, 0]),
                                    int(cur[gy, gx, 1]), prior_q)))
            cur_cost[gy, gx] = ssd + lam * np.float32(rate)

    best_c = np.argmin(costs, axis=0)                 # (gh, gw) 0/1
    best = np.take_along_axis(costs, best_c[None], axis=0)[0]
    want = best < cur_cost
    sel = select_intra_independent(want)
    for gy in range(gh):
        for gx in range(gw):
            if not sel[gy, gx]:
                continue
            c = int(best_c[gy, gx])
            x0, y0 = gx * 16, gy * 16
            mvc = (int(cand[c, gy, gx, 0]), int(cand[c, gy, gx, 1]))
            flips += 1
            desc.mv[2 * gy:2 * gy + 2, 2 * gx:2 * gx + 2] = mvc
            desc.coef_y[y0:y0 + 16, x0:x0 + 16] = \
                lvl_cand[c, gy, gx].astype(np.int16)
            recon_y[y0:y0 + 16, x0:x0 + 16] = rec_cand[c, gy, gx]
            cx0, cy0 = x0 // 2, y0 // 2
            for splane, rplane, recon_c, coefs in (
                    (su, ru_ref, recon_u, desc.coef_u),
                    (sv, rv_ref, recon_v, desc.coef_v)):
                cpred = mc_chroma(rplane, cx0, cy0, 8, mvc[0], mvc[1])
                cres = splane[cy0:cy0 + 8, cx0:cx0 + 8] - cpred
                clvl, cr = _code_tu(cres, qp_c, sl, ps.sign_hiding,
                                    zf_mult, float(lam))
                coefs[cy0:cy0 + 8, cx0:cx0 + 8] = clvl.astype(np.int16)
                recon_c[cy0:cy0 + 8, cx0:cx0 + 8] = \
                    np.clip(cpred + cr, 0, 255)
    return flips
