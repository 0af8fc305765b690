"""Inter syntax selection and the inter constants the device P program
reads: the port's copies of zf_multiplier, MERGE_FAST_BITS_BASE,
select_inter_syntax and select_inter_syntax_tree with their helpers, the
FAR level's far_range / far_grid and the intra-in-P constants, from
homerhevc_tpu/golden/inter_frame.py (pure host logic, shared by every
inter path).
"""

from __future__ import annotations

import numpy as np

from homerhevc_tpu_torch.hevc import tables as T
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.hevc.inter import (
    MERGE_MAX, MotionField, amvp_candidates, merge_candidates,
)
from homerhevc_tpu_torch.hevc.syntax import FrameDesc, MODE_INTER

MERGE_FAST_BITS_BASE = 4.0     # merge syntax bins (flag + idx TR base)
INTRA_P_MODE_BITS_MPM = np.float32(3.0)   # pred_mode bin + ~2 MPM bins
INTRA_P_MODE_BITS_REM = np.float32(7.0)   # pred_mode bin + rem 6 bins
INTRA_P_ROUNDS = 3


def zf_multiplier(avg_dist: float, qp: int) -> float:
    """clip(avg_dist/2.5 - 5, 1, cap) — reference hmr_motion_inter.c:59.

    The reference clips at 20000 but is stabilized by its CU-tree RDO and
    intra fallback (a CU whose zeroed-inter cost explodes is re-coded
    another way). This build has neither yet, so the adaptive threshold
    alone is a positive-feedback loop (more zeroing -> higher distortion ->
    higher threshold). Cap at 6*lambda(qp): the RD-consistent value for
    ~4-6 bins/level, which is also where the reference's own threshold
    sits at its equilibrium (avg_dist ~ 1000 at QP32)."""
    import os
    mult = float(os.environ.get("HOMERHEVC_ZF_CAP_LAMBDA", "6.0"))
    floor = float(os.environ.get("HOMERHEVC_ZF_FLOOR_LAMBDA", "0.0"))
    lam = T.rd_lambda(qp, "P")
    return float(np.clip(avg_dist / 2.5 - 5.0,
                         max(1.0, floor * lam), mult * lam))


def _select_rect_syntax(ps, desc, mf, x0, y0, n, part, is_b=False):
    """Per-PU merge/AMVP selection for a rectangular inter CU (P and
    uni-L0 B slices — B restricts merge matching to the spatial
    candidates, whose indices the decoder's B rect merge list shares).
    PU0 then PU1 in decode order: PU1's candidate lists see PU0's final
    motion exactly as a decoder will."""
    from homerhevc_tpu_torch.hevc.inter import (amvp_candidates_rect,
                                          merge_candidates_rect)
    w, h = desc.width, desc.height
    half = n // 2
    if part == 1:
        pus = [(x0, y0, n, half), (x0, y0 + half, n, half)]
        pname = "2NxN"
    else:
        pus = [(x0, y0, half, n), (x0 + half, y0, half, n)]
        pname = "Nx2N"
    for i, (px, py, pw, ph) in enumerate(pus):
        puy, pux = py // 8, px // 8
        psl8 = (slice(puy, (py + ph) // 8), slice(pux, (px + pw) // 8))
        mv = (int(desc.mv[puy, pux, 0]), int(desc.mv[puy, pux, 1]))
        cands, n_spat = merge_candidates_rect(mf, px, py, pw, ph, pname, i,
                                              ps.ctu_size, w, h)
        limit = n_spat if is_b else len(cands)
        merge_k = next((k for k, c in enumerate(cands[:limit])
                        if (c[0], c[1]) == mv and c[2] == 0), None)
        if merge_k is not None:
            desc.inter_mode[psl8] = 1
            desc.merge_idx[psl8] = merge_k
        else:
            desc.inter_mode[psl8] = 2
            mvp = amvp_candidates_rect(mf, px, py, pw, ph, ps.ctu_size,
                                       w, h, part=pname, pu_idx=i)
            c0 = abs(mv[0] - mvp[0][0]) + abs(mv[1] - mvp[0][1])
            c1 = abs(mv[0] - mvp[1][0]) + abs(mv[1] - mvp[1][1])
            desc.mvp_flag[psl8] = 0 if c0 <= c1 else 1
    sl8 = (slice(y0 // 8, (y0 + n) // 8), slice(x0 // 8, (x0 + n) // 8))
    has_res = (desc.coef_y[y0:y0 + n, x0:x0 + n].any()
               or desc.coef_u[y0 // 2:(y0 + n) // 2,
                              x0 // 2:(x0 + n) // 2].any()
               or desc.coef_v[y0 // 2:(y0 + n) // 2,
                              x0 // 2:(x0 + n) // 2].any())
    desc.skip[sl8] = 0
    desc.root_cbf[sl8] = 1 if has_res else 0


def _select_cu_syntax(ps, desc, x0, y0, n, is_b, dists=(1, 1),
                      ref_dists_l0=None):
    from homerhevc_tpu_torch.hevc.inter import (amvp_candidates_2,
                                          amvp_candidates_mref,
                                          merge_candidates_b)
    w, h = desc.width, desc.height
    bi_lists = is_b and desc.mv_l1 is not None
    inter = desc.pred_mode == MODE_INTER
    dirs = desc.inter_dir
    if dirs is None:
        dirs = np.full(inter.shape, 3 if bi_lists else 1, np.uint8)
    mf = MotionField(*desc.pred_mode.shape)
    mf.mv = desc.mv
    r0m = desc.ref_idx.astype(np.int32) if desc.ref_idx is not None else 0
    mf.ref = np.where(inter & ((dirs & 1) != 0), r0m, -1)
    if bi_lists:
        mf.mv1 = desc.mv_l1
        mf.ref1 = np.where(inter & ((dirs & 2) != 0), 0, -1)
    ux, uy = x0 // 8, y0 // 8
    if desc.pred_mode[uy, ux] != MODE_INTER:
        return
    part = (int(desc.inter_part[uy, ux])
            if desc.inter_part is not None else 0)
    if part and not bi_lists:
        _select_rect_syntax(ps, desc, mf, x0, y0, n, part, is_b=is_b)
        return
    mv = (int(desc.mv[uy, ux, 0]), int(desc.mv[uy, ux, 1]))
    has_res = (desc.coef_y[y0:y0 + n, x0:x0 + n].any()
               or desc.coef_u[y0 // 2:(y0 + n) // 2,
                              x0 // 2:(x0 + n) // 2].any()
               or desc.coef_v[y0 // 2:(y0 + n) // 2,
                              x0 // 2:(x0 + n) // 2].any())
    if bi_lists:
        cdir = int(dirs[uy, ux])
        mv0t = mv if (cdir & 1) else None
        mv1t = ((int(desc.mv_l1[uy, ux, 0]), int(desc.mv_l1[uy, ux, 1]))
                if (cdir & 2) else None)
        cands = merge_candidates_b(mf, x0, y0, n, ps.ctu_size, w, h, dists)
        merge_k = next((k for k, c in enumerate(cands)
                        if c == (cdir, mv0t, mv1t)), None)
    else:
        cdir = 1
        cur_ref = int(desc.ref_idx[uy, ux]) if desc.ref_idx is not None \
            else 0
        cands, n_spatial = merge_candidates(mf, x0, y0, n, ps.ctu_size, w, h)
        # zero-fill candidates carry ref 0; with multi-ref they are only
        # selectable for ref-0 CUs (matching any conformant decoder)
        limit = n_spatial if is_b else len(cands)
        merge_k = next((k for k, c in enumerate(cands[:limit])
                        if (c[0], c[1]) == mv and c[2] == cur_ref), None)
    sl8 = (slice(uy, (y0 + n) // 8), slice(ux, (x0 + n) // 8))
    if merge_k is not None and not has_res:
        desc.skip[sl8] = 1
        desc.inter_mode[sl8] = 0
        desc.merge_idx[sl8] = merge_k
        desc.root_cbf[sl8] = 0
    elif merge_k is not None:
        desc.inter_mode[sl8] = 1
        desc.merge_idx[sl8] = merge_k
        desc.root_cbf[sl8] = 1
    else:
        desc.inter_mode[sl8] = 2
        desc.root_cbf[sl8] = 1 if has_res else 0
        if bi_lists:
            if cdir & 1:
                mvp = amvp_candidates_2(mf, x0, y0, n, ps.ctu_size, w, h,
                                        0, dists)
                c0 = abs(mv[0] - mvp[0][0]) + abs(mv[1] - mvp[0][1])
                c1 = abs(mv[0] - mvp[1][0]) + abs(mv[1] - mvp[1][1])
                desc.mvp_flag[sl8] = 0 if c0 <= c1 else 1
            if cdir & 2:
                mvp1 = amvp_candidates_2(mf, x0, y0, n, ps.ctu_size, w, h,
                                         1, dists)
                d0 = abs(mv1t[0] - mvp1[0][0]) + abs(mv1t[1] - mvp1[0][1])
                d1 = abs(mv1t[0] - mvp1[1][0]) + abs(mv1t[1] - mvp1[1][1])
                desc.mvp_flag_l1[sl8] = 0 if d0 <= d1 else 1
        elif ref_dists_l0 is not None and len(ref_dists_l0) > 1:
            mvp = amvp_candidates_mref(mf, x0, y0, n, ps.ctu_size, w, h,
                                       cur_ref, ref_dists_l0)
            c0 = abs(mv[0] - mvp[0][0]) + abs(mv[1] - mvp[0][1])
            c1 = abs(mv[0] - mvp[1][0]) + abs(mv[1] - mvp[1][1])
            desc.mvp_flag[sl8] = 0 if c0 <= c1 else 1
        else:
            mvp = amvp_candidates(mf, x0, y0, n, ps.ctu_size, w, h)
            c0 = abs(mv[0] - mvp[0][0]) + abs(mv[1] - mvp[0][1])
            c1 = abs(mv[0] - mvp[1][0]) + abs(mv[1] - mvp[1][1])
            desc.mvp_flag[sl8] = 0 if c0 <= c1 else 1


def select_inter_syntax(ps: ParamSets, desc: FrameDesc, cu_size: int,
                        is_b: bool = False, ref_dists_l0=None) -> None:
    """Choose skip/merge/AMVP syntax per CU from final MVs + residuals.
    Shared by the golden and device paths (pure host logic). In B slices the
    zero-fill merge candidates are bi-predictive, so matching is restricted
    to the spatial candidates (L0-uni B path)."""
    has_rect = desc.inter_part is not None and desc.inter_part.any()
    mref = desc.ref_idx is not None
    if (cu_size == ps.ctu_size and desc.width % cu_size == 0
            and desc.height % cu_size == 0 and not has_rect and not mref):
        _select_inter_syntax_vec(ps, desc, cu_size, is_b)
    else:
        # the vectorized pass samples neighbour motion at CU origins,
        # which is wrong once a neighbour carries per-PU (rect) motion
        # or a per-CU ref_idx — the loop samples the exact spec
        # positions per unit
        _select_inter_syntax_loop(ps, desc, cu_size, is_b,
                                  ref_dists_l0=ref_dists_l0)
    if has_rect and not (is_b and desc.mv_l1 is not None):
        # the passes above assume 2Nx2N; re-select rectangular CUs
        # per-PU (and clear any skip they may have set — skip implies
        # 2Nx2N)
        inter = desc.pred_mode == MODE_INTER
        mf = MotionField(*desc.pred_mode.shape)
        mf.mv = desc.mv
        mf.ref = np.where(inter, 0, -1)
        r = cu_size // 8
        for uy in range(0, desc.height // 8, r):
            for ux in range(0, desc.width // 8, r):
                part = int(desc.inter_part[uy, ux])
                if part and inter[uy, ux]:
                    desc.skip[uy:uy + r, ux:ux + r] = 0
                    _select_rect_syntax(ps, desc, mf, ux * 8, uy * 8,
                                        cu_size, part, is_b=is_b)


def _select_inter_syntax_vec(ps: ParamSets, desc: FrameDesc, n: int,
                             is_b: bool) -> None:
    """Vectorized specialization of the per-CU loop for cu_size == ctu_size
    (the device path). With one CU per CTU, z-scan precedence collapses to
    raster CTU order: A1/B1/B0/B2 availability is pure grid geometry and A0
    (below-left) is never coded yet. Output is identical to the loop
    version (tests/test_inter.py::test_select_syntax_vec_matches_loop)."""
    w, h = desc.width, desc.height
    gh, gw = h // n, w // n
    r8 = n // 8
    mv = desc.mv[::r8, ::r8].astype(np.int64)            # (gh, gw, 2)
    inter = (desc.pred_mode[::r8, ::r8] == MODE_INTER)

    # residual presence per CU
    def blk_any(plane, m):
        return plane.reshape(gh, m, gw, m).any(axis=(1, 3))
    has_res = (blk_any(desc.coef_y, n) | blk_any(desc.coef_u, n // 2)
               | blk_any(desc.coef_v, n // 2))

    OFFP = np.int64(1) << 16                 # bias so components stay >= 0
    pack = (mv[..., 0] + OFFP) * (1 << 33) + (mv[..., 1] + OFFP)
    ZEROP = OFFP * (1 << 33) + OFFP          # pack of mv == (0, 0)
    SENT = np.int64(1) << 62
    v_a1 = np.zeros((gh, gw), bool); p_a1 = np.full((gh, gw), SENT)
    v_a1[:, 1:] = inter[:, :-1]; p_a1[:, 1:] = pack[:, :-1]
    v_b1 = np.zeros((gh, gw), bool); p_b1 = np.full((gh, gw), SENT)
    v_b1[1:, :] = inter[:-1, :]; p_b1[1:, :] = pack[:-1, :]
    v_b0 = np.zeros((gh, gw), bool); p_b0 = np.full((gh, gw), SENT)
    v_b0[1:, :-1] = inter[:-1, 1:]; p_b0[1:, :-1] = pack[:-1, 1:]
    v_b2 = np.zeros((gh, gw), bool); p_b2 = np.full((gh, gw), SENT)
    v_b2[1:, 1:] = inter[:-1, :-1]; p_b2[1:, 1:] = pack[:-1, :-1]
    p_a1 = np.where(v_a1, p_a1, SENT)
    p_b1 = np.where(v_b1, p_b1, SENT)
    p_b0 = np.where(v_b0, p_b0, SENT)
    p_b2 = np.where(v_b2, p_b2, SENT)

    kept_a1 = v_a1
    kept_b1 = v_b1 & ~(v_a1 & (p_b1 == p_a1))
    kept_b0 = v_b0 & ~(v_b1 & (p_b0 == p_b1))
    kept_b2 = v_b2 & ~(v_a1 & (p_b2 == p_a1)) & ~(v_b1 & (p_b2 == p_b1))

    pos_a1 = np.zeros((gh, gw), np.int32)
    pos_b1 = kept_a1.astype(np.int32)
    pos_b0 = pos_b1 + kept_b1
    pos_b2 = pos_b0 + kept_b0
    n_spatial = pos_b2 + kept_b2

    cur = pack
    BIG = np.int32(99)
    k = np.full((gh, gw), BIG, np.int32)
    for kept, p, pos in ((kept_b2, p_b2, pos_b2), (kept_b0, p_b0, pos_b0),
                         (kept_b1, p_b1, pos_b1), (kept_a1, p_a1, pos_a1)):
        m = kept & (p == cur)
        k = np.where(m, pos, k)
    if not is_b:
        zfill = (cur == ZEROP) & (n_spatial < MERGE_MAX) & (k == BIG)
        k = np.where(zfill, n_spatial, k)
    merged = k != BIG

    # AMVP (mv_a = A1 since A0 is never coded; mv_b = first of B0, B1, B2)
    mva_p = np.where(v_a1, p_a1, SENT)
    mvb_p = np.where(v_b0, p_b0, np.where(v_b1, p_b1,
                                          np.where(v_b2, p_b2, SENT)))
    have_a = mva_p != SENT
    have_b = mvb_p != SENT
    lst0 = np.where(have_a, mva_p, np.where(have_b, mvb_p, ZEROP))
    dup = have_a & have_b & (mvb_p == mva_p)
    lst1 = np.where(have_a & have_b & ~dup, mvb_p, ZEROP)

    def unpack(p):
        x = (p >> 33) - OFFP
        y = (p & ((np.int64(1) << 33) - 1)) - OFFP
        return x, y

    l0x, l0y = unpack(lst0)
    l1x, l1y = unpack(lst1)
    c0 = np.abs(mv[..., 0] - l0x) + np.abs(mv[..., 1] - l0y)
    c1 = np.abs(mv[..., 0] - l1x) + np.abs(mv[..., 1] - l1y)
    mvp_f = (c0 > c1).astype(np.uint8)

    skip = merged & ~has_res & inter
    mrg = merged & has_res & inter
    amvp = ~merged & inter
    im = np.where(skip, 0, np.where(mrg, 1, 2)).astype(np.uint8)
    ki = np.where(merged, k, 0).astype(np.uint8)
    rcbf = np.where(skip, 0, np.where(mrg, 1,
                    has_res.astype(np.uint8))).astype(np.uint8)
    f8 = np.where(amvp, mvp_f, 0).astype(np.uint8)

    def rep(a):
        return np.repeat(np.repeat(a, r8, 0), r8, 1)
    m8 = rep(inter)
    desc.skip[m8] = rep(skip.astype(np.uint8))[m8]
    desc.inter_mode[m8] = rep(im)[m8]
    desc.merge_idx[m8] = rep(ki)[m8]
    desc.root_cbf[m8] = rep(rcbf)[m8]
    desc.mvp_flag[m8] = rep(f8)[m8]


def _select_inter_syntax_loop(ps: ParamSets, desc: FrameDesc, cu_size: int,
                              is_b: bool = False, ref_dists_l0=None) -> None:
    w, h = desc.width, desc.height
    n = cu_size
    # boundary bands not covered by the n-grid: CU8 zero-MV units
    h16, w16 = (h // n) * n, (w // n) * n
    for y0 in range(h16, h, 8):
        for x0 in range(0, w, 8):
            _select_cu_syntax(ps, desc, x0, y0, 8, is_b,
                              ref_dists_l0=ref_dists_l0)
    for y0 in range(0, h16, 8):
        for x0 in range(w16, w, 8):
            _select_cu_syntax(ps, desc, x0, y0, 8, is_b,
                              ref_dists_l0=ref_dists_l0)
    if desc.ref_idx is not None:
        # multi-reference: the per-CU path samples ref-aware candidates
        for gy in range(h // n):
            for gx in range(w // n):
                _select_cu_syntax(ps, desc, gx * n, gy * n, n, is_b,
                                  ref_dists_l0=ref_dists_l0)
        return
    mf = MotionField(*desc.pred_mode.shape)
    mf.mv = desc.mv
    mf.ref = np.where(desc.pred_mode == MODE_INTER, 0, -1)
    for gy in range(h // n):
        for gx in range(w // n):
            x0, y0 = gx * n, gy * n
            ux, uy = x0 // 8, y0 // 8
            if desc.pred_mode[uy, ux] != MODE_INTER:
                continue
            mv = (int(desc.mv[uy, ux, 0]), int(desc.mv[uy, ux, 1]))
            has_res = (desc.coef_y[y0:y0 + n, x0:x0 + n].any()
                       or desc.coef_u[y0 // 2:(y0 + n) // 2,
                                      x0 // 2:(x0 + n) // 2].any()
                       or desc.coef_v[y0 // 2:(y0 + n) // 2,
                                      x0 // 2:(x0 + n) // 2].any())
            cands, n_spatial = merge_candidates(mf, x0, y0, n,
                                                ps.ctu_size, w, h)
            limit = n_spatial if is_b else len(cands)
            merge_k = next((k for k, c in enumerate(cands[:limit])
                            if (c[0], c[1]) == mv and c[2] == 0), None)
            sl8 = (slice(uy, (y0 + n) // 8), slice(ux, (x0 + n) // 8))
            if merge_k is not None and not has_res:
                desc.skip[sl8] = 1
                desc.inter_mode[sl8] = 0
                desc.merge_idx[sl8] = merge_k
                desc.root_cbf[sl8] = 0
            elif merge_k is not None:
                desc.inter_mode[sl8] = 1
                desc.merge_idx[sl8] = merge_k
                desc.root_cbf[sl8] = 1  # merge 2Nx2N: root cbf inferred 1
            else:
                mvp = amvp_candidates(mf, x0, y0, n, ps.ctu_size, w, h)
                c0 = abs(mv[0] - mvp[0][0]) + abs(mv[1] - mvp[0][1])
                c1 = abs(mv[0] - mvp[1][0]) + abs(mv[1] - mvp[1][1])
                f = 0 if c0 <= c1 else 1
                desc.inter_mode[sl8] = 2
                desc.mvp_flag[sl8] = f
                desc.root_cbf[sl8] = 1 if has_res else 0


def far_range(ps, search: int) -> int:
    """FAR-level range from config: me_range beyond the default +-32 reach
    (and beyond the 2x sweep's +-2*search) activates the 4x pyramid
    level. The default me_range=32 never activates it."""
    mr = int(getattr(ps.cfg, "me_range", 32))
    return mr if mr > max(32, 2 * search) else 0


def far_grid(rng_c: int, far: int):
    """Dense offset grid for the 4x-decimated FAR pyramid level: covers
    +-far horizontal / +-min(far,64) vertical full-pel (reference search
    window +-128x64, hmr_private.h:76-77). Step 1 — coarser strides alias
    on noise-like texture (a 4-full-pel shift maps 2x2 pools onto disjoint
    pixels, erasing the SAD signal). Returns (offsets, vote_mask): offsets
    in 4x-pel units raster order; vote_mask False where the 2x sweep
    already covers the offset (those never enter the FAR shortlist)."""
    xq, yq = far // 4, min(far // 4, 16)
    inner = 2 * rng_c - 4          # full-res reach safely inside the 2x sweep
    grid = [(qx, qy)
            for qy in range(-yq, yq + 1)
            for qx in range(-xq, xq + 1)]
    mask = np.asarray([not (abs(4 * qx) <= inner and abs(4 * qy) <= inner)
                       for qx, qy in grid], bool)
    return grid, mask


def _zorder_total(h8: int, w8: int, ctu: int) -> np.ndarray:
    """Total coding-order key per 8x8 unit: CTB raster index major,
    within-CTB Morton (z) order minor — T[a] < T[b] iff unit a is coded
    before unit b (same rule as hevc.inter._coded_before, which compares
    at 4-px granularity; 8-px-aligned points order identically)."""
    uy, ux = np.mgrid[0:h8, 0:w8]
    ctbs_x = -(-(w8 * 8) // ctu)
    ctb_idx = ((uy * 8) // ctu) * ctbs_x + (ux * 8) // ctu
    zy = ((uy * 8) % ctu) // 4
    zx = ((ux * 8) % ctu) // 4
    z = np.zeros_like(zy)
    for b in range(5):
        z |= ((zx >> b) & 1) << (2 * b)
        z |= ((zy >> b) & 1) << (2 * b + 1)
    zmax = 1 << 10
    return ctb_idx.astype(np.int64) * zmax + z


def _select_inter_syntax_tree_vec(ps: ParamSets, desc: FrameDesc) -> None:
    """Vectorized tree-syntax selection (P slices, 2Nx2N, single ref):
    one batched pass per CU size class over the final motion field. The
    z-scan coded-before predicate for B0/A0 becomes an array compare of
    precomputed total-order keys. Bit-identical to the recursive walk
    (tests/test_inter.py::test_select_syntax_tree_vec_matches_walk);
    replaces a ~0.5 s/frame python recursion at 1080p in the device
    fetch path."""
    w, h = desc.width, desc.height
    ctu = ps.ctu_size
    h8, w8 = h // 8, w // 8
    inter_u = desc.pred_mode == MODE_INTER
    T = _zorder_total(h8, w8, ctu)
    OFFP = np.int64(1) << 16
    packu = ((desc.mv[..., 0].astype(np.int64) + OFFP) * (1 << 33)
             + (desc.mv[..., 1].astype(np.int64) + OFFP))
    ZEROP = OFFP * (1 << 33) + OFFP
    SENT = np.int64(1) << 62
    packu = np.where(inter_u, packu, SENT)

    log2ctu = ps.log2_ctu
    for n in (64, 32, 16):
        if n > ctu or h % n or w % n:
            continue
        r8 = n // 8
        gh, gw = h // n, w // n
        dep_n = log2ctu - (n.bit_length() - 1)
        origin = (slice(0, None, r8), slice(0, None, r8))
        present = (desc.cu_depth[origin] == dep_n) & inter_u[origin]
        if not present.any():
            continue
        uyc = np.arange(gh)[:, None] * r8        # CU origin in 8-units
        uxc = np.arange(gw)[None, :] * r8
        t_cur = T[origin]

        def nb(duy, dux):
            """(valid, pack) of the unit at CU-relative 8-unit offset."""
            uy = uyc + duy
            ux = uxc + dux
            inb = (uy >= 0) & (uy < h8) & (ux >= 0) & (ux < w8)
            uyc_ = np.clip(uy, 0, h8 - 1)
            uxc_ = np.clip(ux, 0, w8 - 1)
            ok = inb & (T[uyc_, uxc_] < t_cur) & inter_u[uyc_, uxc_]
            return ok, np.where(ok, packu[uyc_, uxc_], SENT)

        v_a1, p_a1 = nb(r8 - 1, -1)
        v_b1, p_b1 = nb(-1, r8 - 1)
        v_b0, p_b0 = nb(-1, r8)
        v_a0, p_a0 = nb(r8, -1)
        v_b2, p_b2 = nb(-1, -1)

        kept_a1 = v_a1
        kept_b1 = v_b1 & ~(v_a1 & (p_b1 == p_a1))
        kept_b0 = v_b0 & ~(v_b1 & (p_b0 == p_b1))
        kept_a0 = v_a0 & ~(v_a1 & (p_a0 == p_a1))
        n4 = (kept_a1.astype(np.int32) + kept_b1 + kept_b0 + kept_a0)
        kept_b2 = (v_b2 & (n4 < 4) & ~(v_a1 & (p_b2 == p_a1))
                   & ~(v_b1 & (p_b2 == p_b1)))

        pos_a1 = np.zeros((gh, gw), np.int32)
        pos_b1 = kept_a1.astype(np.int32)
        pos_b0 = pos_b1 + kept_b1
        pos_a0 = pos_b0 + kept_b0
        pos_b2 = pos_a0 + kept_a0
        n_spatial = pos_b2 + kept_b2

        cur = packu[origin]
        BIG = np.int32(99)
        k = np.full((gh, gw), BIG, np.int32)
        for kept, p, pos in ((kept_b2, p_b2, pos_b2),
                             (kept_a0, p_a0, pos_a0),
                             (kept_b0, p_b0, pos_b0),
                             (kept_b1, p_b1, pos_b1),
                             (kept_a1, p_a1, pos_a1)):
            k = np.where(kept & (p == cur), pos, k)
        zfill = (cur == ZEROP) & (n_spatial < MERGE_MAX) & (k == BIG)
        k = np.where(zfill, n_spatial, k)
        merged = (k != BIG) & present

        def blk_any(plane, m):
            return plane.reshape(gh, m, gw, m).any(axis=(1, 3))
        has_res = (blk_any(desc.coef_y, n)
                   | blk_any(desc.coef_u, n // 2)
                   | blk_any(desc.coef_v, n // 2))

        # AMVP: mv_a = first of (A0, A1); mv_b = first of (B0, B1, B2)
        mva_p = np.where(v_a0, p_a0, np.where(v_a1, p_a1, SENT))
        mvb_p = np.where(v_b0, p_b0, np.where(v_b1, p_b1,
                                              np.where(v_b2, p_b2, SENT)))
        have_a = mva_p != SENT
        have_b = mvb_p != SENT
        lst0 = np.where(have_a, mva_p, np.where(have_b, mvb_p, ZEROP))
        dup = have_a & have_b & (mvb_p == mva_p)
        lst1 = np.where(have_a & have_b & ~dup, mvb_p, ZEROP)

        def unpack(p):
            return ((p >> 33) - OFFP, (p & ((np.int64(1) << 33) - 1)) - OFFP)
        l0x, l0y = unpack(lst0)
        l1x, l1y = unpack(lst1)
        mvx = desc.mv[origin + (0,)].astype(np.int64)
        mvy = desc.mv[origin + (1,)].astype(np.int64)
        c0 = np.abs(mvx - l0x) + np.abs(mvy - l0y)
        c1 = np.abs(mvx - l1x) + np.abs(mvy - l1y)
        mvp_f = (c0 > c1).astype(np.uint8)

        skip = merged & ~has_res
        mrg = merged & has_res
        amvp = present & ~merged
        im = np.where(skip, 0, np.where(mrg, 1, 2)).astype(np.uint8)
        ki = np.where(merged, k, 0).astype(np.uint8)
        rcbf = np.where(skip, 0, np.where(mrg, 1,
                        has_res.astype(np.uint8))).astype(np.uint8)
        f8 = np.where(amvp, mvp_f, 0).astype(np.uint8)

        def rep(a):
            return np.repeat(np.repeat(a, r8, 0), r8, 1)
        m8 = rep(present)
        desc.skip[m8] = rep(skip.astype(np.uint8))[m8]
        desc.inter_mode[m8] = rep(im)[m8]
        desc.merge_idx[m8] = rep(ki)[m8]
        desc.root_cbf[m8] = rep(rcbf)[m8]
        desc.mvp_flag[m8] = rep(f8)[m8]


def select_inter_syntax_tree(ps: ParamSets, desc: FrameDesc,
                             is_b: bool = False, dists=(1, 1)) -> None:
    """Skip/merge/AMVP selection for a mixed CU32/CU16 tree. Candidate
    derivation depends only on the final motion field + geometry (what a
    decoder derives), so CUs can be visited in any order. dists feed the
    AMVP POC-distance scaling of mixed-direction B slices."""
    ctu = ps.ctu_size
    if (not is_b and desc.mv_l1 is None and desc.ref_idx is None
            and (desc.inter_part is None or not desc.inter_part.any())
            and desc.width % ctu == 0 and desc.height % ctu == 0
            and desc.coef_y is not None):
        _select_inter_syntax_tree_vec(ps, desc)
        return

    def walk(x0, y0, n, depth):
        if x0 >= desc.width or y0 >= desc.height:
            return
        inside = x0 + n <= desc.width and y0 + n <= desc.height
        if inside and int(desc.cu_depth[y0 // 8, x0 // 8]) <= depth:
            _select_cu_syntax(ps, desc, x0, y0, n, is_b, dists)
            return
        half = n // 2
        for (dy, dx) in ((0, 0), (0, half), (half, 0), (half, half)):
            walk(x0 + dx, y0 + dy, half, depth + 1)

    for cy in range(-(-desc.height // ctu)):
        for cx in range(-(-desc.width // ctu)):
            walk(cx * ctu, cy * ctu, ctu, 0)
