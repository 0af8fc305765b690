"""SAO: parameter model, golden apply (decoder-exact, spec 8.7.3),
statistics collection and a simple conformant RDO decision.

Parity with reference: hmr_sao.c (stats :75, offsets :480, mode RDO
:663/:854, apply :960/:1210) — decisions here are simpler (stats-driven
offsets + lambda cost) which is legal: SAO parameters are non-normative,
only their syntax and the filter are.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from homerhevc_tpu_torch.hevc import tables as T

SAO_OFF, SAO_BAND, SAO_EDGE = 0, 1, 2
# edgeIdx -> category mapping (spec 8.7.3: 0,1->min/edge, 2->none, 3,4)
EDGE_CAT = np.array([1, 2, 0, 3, 4], np.int32)
# EO class sample offsets (hPos/vPos pairs)
EO_DELTAS = {
    0: ((0, -1), (0, 1)),     # horizontal
    1: ((-1, 0), (1, 0)),     # vertical
    2: ((-1, -1), (1, 1)),    # 135 deg
    3: ((1, -1), (-1, 1)),    # 45 deg
}
MAX_OFFSET = 7  # (1 << (min(8,10)-5)) - 1


@dataclasses.dataclass
class SaoFrameParams:
    """Per-CTU SAO decisions. Arrays indexed [ctu_y, ctu_x]."""
    merge_left: np.ndarray   # bool
    merge_up: np.ndarray     # bool
    type_luma: np.ndarray    # 0/1/2
    type_chroma: np.ndarray  # 0/1/2 (shared cb/cr)
    eo_class_luma: np.ndarray    # 0..3
    eo_class_chroma: np.ndarray  # 0..3
    band_pos: np.ndarray     # (cy, cx, 3) band position per component
    offsets: np.ndarray      # (cy, cx, 3, 4) signed offsets per component

    @classmethod
    def alloc(cls, cy: int, cx: int) -> "SaoFrameParams":
        return cls(
            merge_left=np.zeros((cy, cx), bool),
            merge_up=np.zeros((cy, cx), bool),
            type_luma=np.zeros((cy, cx), np.int32),
            type_chroma=np.zeros((cy, cx), np.int32),
            eo_class_luma=np.zeros((cy, cx), np.int32),
            eo_class_chroma=np.zeros((cy, cx), np.int32),
            band_pos=np.zeros((cy, cx, 3), np.int32),
            offsets=np.zeros((cy, cx, 3, 4), np.int32),
        )

    def copy_from(self, sy, sx, dy, dx):
        self.type_luma[dy, dx] = self.type_luma[sy, sx]
        self.type_chroma[dy, dx] = self.type_chroma[sy, sx]
        self.eo_class_luma[dy, dx] = self.eo_class_luma[sy, sx]
        self.eo_class_chroma[dy, dx] = self.eo_class_chroma[sy, sx]
        self.band_pos[dy, dx] = self.band_pos[sy, sx]
        self.offsets[dy, dx] = self.offsets[sy, sx]

    def copy_from_other(self, other: "SaoFrameParams", cy, cx):
        self.type_luma[cy, cx] = other.type_luma[cy, cx]
        self.type_chroma[cy, cx] = other.type_chroma[cy, cx]
        self.eo_class_luma[cy, cx] = other.eo_class_luma[cy, cx]
        self.eo_class_chroma[cy, cx] = other.eo_class_chroma[cy, cx]
        self.band_pos[cy, cx] = other.band_pos[cy, cx]
        self.offsets[cy, cx] = other.offsets[cy, cx]


def _eo_categories(plane: np.ndarray, eo_class: int) -> np.ndarray:
    """Per-sample EO category (0..4); boundary samples get 0 (unfiltered)."""
    h, w = plane.shape
    p = plane.astype(np.int32)
    (dy0, dx0), (dy1, dx1) = EO_DELTAS[eo_class]
    a = np.zeros((h, w), np.int32)
    b = np.zeros((h, w), np.int32)
    valid = np.zeros((h, w), bool)
    ys, xs = np.mgrid[0:h, 0:w]
    y0, x0 = ys + dy0, xs + dx0
    y1, x1 = ys + dy1, xs + dx1
    ok = (y0 >= 0) & (y0 < h) & (x0 >= 0) & (x0 < w) & \
         (y1 >= 0) & (y1 < h) & (x1 >= 0) & (x1 < w)
    a[ok] = p[y0[ok], x0[ok]]
    b[ok] = p[y1[ok], x1[ok]]
    sgn = np.sign(p - a) + np.sign(p - b) + 2
    cat = EDGE_CAT[sgn]
    cat[~ok] = 0
    return cat


def sao_apply_component(plane: np.ndarray, params: SaoFrameParams,
                        comp: int, ctu_size: int) -> np.ndarray:
    """Apply SAO to a full (deblocked) component plane. comp: 0=Y,1=Cb,2=Cr.
    ctu_size is in THIS component's samples."""
    out = plane.astype(np.int32).copy()
    h, w = plane.shape
    cy_n, cx_n = params.type_luma.shape
    type_map = params.type_luma if comp == 0 else params.type_chroma
    eo_map = params.eo_class_luma if comp == 0 else params.eo_class_chroma
    # precompute per-class category planes lazily
    cats = {}
    for cy in range(cy_n):
        for cx in range(cx_n):
            t = int(type_map[cy, cx])
            if t == SAO_OFF:
                continue
            y0, x0 = cy * ctu_size, cx * ctu_size
            y1, x1 = min(y0 + ctu_size, h), min(x0 + ctu_size, w)
            off = params.offsets[cy, cx, comp]
            if t == SAO_BAND:
                bp = int(params.band_pos[cy, cx, comp])
                lut = np.zeros(32, np.int32)
                for k in range(4):
                    lut[(bp + k) % 32] = off[k]
                blk = plane[y0:y1, x0:x1].astype(np.int32)
                out[y0:y1, x0:x1] = np.clip(blk + lut[blk >> 3], 0, 255)
            else:
                ec = int(eo_map[cy, cx])
                if ec not in cats:
                    cats[ec] = _eo_categories(plane, ec)
                cat = cats[ec][y0:y1, x0:x1]
                lut = np.array([0, off[0], off[1], -off[2], -off[3]], np.int32)
                blk = plane[y0:y1, x0:x1].astype(np.int32)
                out[y0:y1, x0:x1] = np.clip(blk + lut[cat], 0, 255)
    return out


def _stats_for_block(src, rec, cat, ncat=5):
    diffs = np.zeros(ncat, np.int64)
    counts = np.zeros(ncat, np.int64)
    d = src.astype(np.int64) - rec.astype(np.int64)
    for c in range(ncat):
        m = cat == c
        counts[c] = m.sum()
        diffs[c] = d[m].sum()
    return diffs, counts


def _best_offset(diff, count, max_abs=MAX_OFFSET, positive=None):
    if count == 0:
        return 0, 0
    o = int(np.round(diff / count))
    o = max(-max_abs, min(max_abs, o))
    if positive is True:
        o = max(0, o)
    if positive is False:
        o = min(0, o)
    # distortion delta for applying offset o: count*o^2 - 2*o*diff
    dd = count * o * o - 2 * o * diff
    if dd > 0:
        return 0, 0
    return o, dd


def _block_sum(x: np.ndarray, by: int, bx: int) -> np.ndarray:
    h, w = x.shape
    return x.reshape(h // by, by, w // bx, bx).sum(axis=(1, 3))


def _eo_stats_vec(src, rec, ctu):
    """Per-class EO stats for one component: returns (dd[4,gh,gw],
    offs[4,gh,gw,4]) — distortion delta and abs offsets per EO class."""
    h, w = src.shape
    gh, gw = h // ctu, w // ctu
    diff = src.astype(np.int64) - rec.astype(np.int64)
    dd_all = np.zeros((4, gh, gw), np.float64)
    off_all = np.zeros((4, gh, gw, 4), np.int64)
    for ec in range(4):
        cat = _eo_categories(rec, ec)
        for k, positive in ((1, True), (2, True), (3, False), (4, False)):
            m = cat == k
            cnt = _block_sum(m.astype(np.int64), ctu, ctu)
            dsum = _block_sum(np.where(m, diff, 0), ctu, ctu)
            o = np.where(cnt > 0, np.round(dsum / np.maximum(cnt, 1)), 0)
            o = np.clip(o, -MAX_OFFSET, MAX_OFFSET).astype(np.int64)
            o = np.maximum(o, 0) if positive else np.minimum(o, 0)
            dd = cnt * o * o - 2 * o * dsum
            bad = dd > 0
            o = np.where(bad, 0, o)
            dd = np.where(bad, 0, dd)
            off_all[ec, :, :, k - 1] = np.abs(o)
            dd_all[ec] += dd
    return dd_all, off_all


def _decide_component_vec(src, rec, ctu, lam, extra_bits):
    """Vectorized per-CTU EO decision for one component."""
    dd_all, off_all = _eo_stats_vec(src, rec, ctu)
    cost = dd_all + lam * (extra_bits + off_all.sum(axis=3))
    best_class = cost.argmin(axis=0)
    gh, gw = best_class.shape
    iy, ix = np.mgrid[0:gh, 0:gw]
    best_cost = cost[best_class, iy, ix]
    chosen = best_cost < lam * 1.0
    best_off = off_all[best_class, iy, ix]
    types = np.where(chosen, SAO_EDGE, SAO_OFF).astype(np.int32)
    best_off = np.where(chosen[:, :, None], best_off, 0)
    best_class = np.where(chosen, best_class, 0)
    return types, best_class.astype(np.int32), best_off.astype(np.int32)


def _full_stats(src, rec, ctu):
    """Complete per-CTB SAO statistics for one component:
    (eo_cnt[4cls, 4cat, gh, gw], eo_sum[...], bo_cnt[32, gh, gw],
    bo_sum[32, gh, gw]) — the analog of the reference's stats tensors
    (hmr_sao.c sao_get_ctu_stats :75-349 collects the same EO-category and
    band histograms)."""
    h, w = src.shape
    gh, gw = h // ctu, w // ctu
    diff = src.astype(np.int64) - rec.astype(np.int64)
    eo_cnt = np.zeros((4, 4, gh, gw), np.int64)
    eo_sum = np.zeros((4, 4, gh, gw), np.int64)
    for ec in range(4):
        cat = _eo_categories(rec, ec)
        for k in (1, 2, 3, 4):
            m = cat == k
            eo_cnt[ec, k - 1] = _block_sum(m.astype(np.int64), ctu, ctu)
            eo_sum[ec, k - 1] = _block_sum(np.where(m, diff, 0), ctu, ctu)
    band = (rec.astype(np.int64) >> 3)
    ctb = (np.arange(h)[:, None] // ctu) * gw + np.arange(w)[None, :] // ctu
    key = (band * (gh * gw) + ctb).ravel()
    bo_cnt = np.bincount(key, minlength=32 * gh * gw) \
        .reshape(32, gh, gw).astype(np.int64)
    bo_sum = np.bincount(key, weights=diff.ravel().astype(np.float64),
                         minlength=32 * gh * gw).reshape(32, gh, gw) \
        .astype(np.int64)
    return eo_cnt, eo_sum, bo_cnt, bo_sum


def _rd_offset(cnt, dsum, lam, signed):
    """RD-refined offset magnitude (reference sao_derive_offsets,
    hmr_sao.c:480): over |o| in 0..7 minimize
    dd(o) = cnt*o^2 - 2*o*d_eff plus lam * TU bits (|o| + terminator +
    sign for BO). Vectorized over arbitrary leading shape.
    Returns (o_signed, dd, bits)."""
    s = np.sign(dsum).astype(np.int64)
    d_eff = np.abs(dsum)
    m = np.arange(8, dtype=np.int64).reshape((8,) + (1,) * cnt.ndim)
    dd = cnt[None] * m * m - 2 * m * d_eff[None]
    bits = np.minimum(m, 7) + (m < 7)          # TU cMax 7 bypass bins
    if signed:
        bits = bits + (m > 0)                  # sign bin for nonzero BO
    cost = dd.astype(np.float64) + lam * bits
    k = cost.argmin(axis=0)
    take = lambda a: np.take_along_axis(a, k[None], axis=0)[0]
    return s * take(np.broadcast_to(m, dd.shape)), take(dd), take(
        np.broadcast_to(bits, dd.shape))


def _derive_eo(eo_cnt, eo_sum, lam):
    """Per EO class: best offsets per category (cats 1,2 positive, 3,4
    negative — spec-constrained signs). Returns (dd[4,gh,gw],
    off_abs[4,gh,gw,4], bits[4,gh,gw])."""
    sgn = np.array([1, 1, -1, -1], np.int64)
    dd = np.zeros(eo_cnt.shape[:1] + eo_cnt.shape[2:], np.float64)
    bits = np.zeros_like(dd)
    offs = np.zeros(eo_cnt.shape[:1] + eo_cnt.shape[2:] + (4,), np.int64)
    for k in range(4):
        d_eff = sgn[k] * eo_sum[:, k]          # want positive gain
        d_eff = np.maximum(d_eff, 0)           # wrong-sign: offset 0
        o, dd_k, b_k = _rd_offset(eo_cnt[:, k], d_eff, lam, signed=False)
        offs[..., k] = o                       # magnitude (signs inferred)
        dd += dd_k
        bits += b_k
    return dd, offs, bits


def _derive_bo(bo_cnt, bo_sum, lam):
    """Band offset: RD offsets for all 32 bands, then the best 4-band
    window (wrapping band_pos semantics). Returns (dd[gh,gw],
    off[gh,gw,4] signed, band[gh,gw], bits[gh,gw])."""
    o, dd_b, bits_b = _rd_offset(bo_cnt, bo_sum, lam, signed=True)
    gh, gw = dd_b.shape[1:]
    wins_dd = np.zeros((32, gh, gw), np.float64)
    wins_bits = np.zeros((32, gh, gw), np.float64)
    for bp in range(32):
        idx = [(bp + k) % 32 for k in range(4)]
        wins_dd[bp] = dd_b[idx].sum(axis=0)
        wins_bits[bp] = bits_b[idx].sum(axis=0)
    cost = wins_dd + lam * wins_bits
    band = cost.argmin(axis=0)
    iy, ix = np.mgrid[0:gh, 0:gw]
    off = np.stack([o[(band + k) % 32, iy, ix] for k in range(4)], axis=-1)
    return wins_dd[band, iy, ix], off, band, wins_bits[band, iy, ix]


def _params_dd_ctb(stats, t, ec, off_signed, band) -> float:
    """Distortion delta of applying given params to one CTB, from its
    stats (used by the merge RDO: the neighbour's params are evaluated on
    THIS block's statistics — reference sao_derive_mode_merge_rdo,
    hmr_sao.c:854)."""
    eo_cnt, eo_sum, bo_cnt, bo_sum = stats
    if t == SAO_OFF:
        return 0.0
    if t == SAO_EDGE:
        sgn = (1, 1, -1, -1)
        dd = 0
        for k in range(4):
            o = sgn[k] * abs(int(off_signed[k]))
            dd += int(eo_cnt[ec, k]) * o * o - 2 * o * int(eo_sum[ec, k])
        return float(dd)
    dd = 0
    for k in range(4):
        b = (int(band) + k) % 32
        o = int(off_signed[k])
        dd += int(bo_cnt[b]) * o * o - 2 * o * int(bo_sum[b])
    return float(dd)


def _count_sao_bits(counter, sp: SaoFrameParams, cy: int, cx: int) -> None:
    """Feed one CTB's SAO syntax through a CabacCounter (twin of
    SliceDataEncoder._encode_sao_ctu; reference counts bits the same way
    via its EE_COUNTER env, hmr_sao.c:663)."""
    from homerhevc_tpu_torch.hevc.ctx_tables import OFF
    e = counter
    if cx > 0:
        e.encode_bin(OFF["sao_merge"], int(sp.merge_left[cy, cx]))
    if cy > 0 and not (cx > 0 and sp.merge_left[cy, cx]):
        e.encode_bin(OFF["sao_merge"], int(sp.merge_up[cy, cx]))
    if (cx > 0 and sp.merge_left[cy, cx]) or sp.merge_up[cy, cx]:
        return
    for c_idx in range(3):
        t = int(sp.type_luma[cy, cx]) if c_idx == 0 \
            else int(sp.type_chroma[cy, cx])
        if c_idx < 2:
            e.encode_bin(OFF["sao_type"], int(t != 0))
            if t != 0:
                e.encode_bypass(int(t == 2))
        if t == 0:
            continue
        off = sp.offsets[cy, cx, c_idx]
        for i in range(4):
            v = abs(int(off[i]))
            e.encode_bypass_bins(0, v + (1 if v < 7 else 0))
        if t == SAO_BAND:
            e.encode_bypass_bins(0, sum(1 for i in range(4) if off[i]))
            e.encode_bypass_bins(0, 5)
        elif c_idx == 0 or c_idx == 1:
            e.encode_bypass_bins(0, 2)


def sao_decide(src_planes, rec_planes, ctu_size_luma: int,
               qp: int) -> SaoFrameParams:
    """Full SAO RDO (reference parity: hmr_sao.c sao_decide_blk_params
    :1295): per-CTB stats -> RD-refined EO + BO candidates -> new-vs-merge
    decision with CABAC-counted bits (CabacCounter with the live sao
    context chain — sao contexts are touched only by sao syntax, so the
    raster decision order reproduces serialization-time states exactly
    for single-substream slices).

    Falls back to the per-CTU loop for non-CTB-multiple geometry."""
    sy, su, sv = src_planes
    h, w = sy.shape[:2]
    cs = ctu_size_luma
    if h % cs != 0 or w % cs != 0:
        return _sao_decide_loop(src_planes, rec_planes, ctu_size_luma, qp)
    ry, ru, rv = [np.asarray(p) for p in rec_planes]
    sy, su, sv = np.asarray(sy), np.asarray(su), np.asarray(sv)
    lam = T.rd_lambda(qp, "I")
    st_y = _full_stats(sy, ry, cs)
    st_u = _full_stats(su, ru, cs // 2)
    st_v = _full_stats(sv, rv, cs // 2)
    gh, gw = st_y[0].shape[2:]

    # ---- new-mode candidates (vectorized) -----------------------------------
    dd_eo_y, off_eo_y, bits_eo_y = _derive_eo(st_y[0], st_y[1], lam)
    dd_bo_y, off_bo_y, band_y, bits_bo_y = _derive_bo(st_y[2], st_y[3], lam)
    # luma type: argmin over {off, eo(best class), bo}; type_idx bins:
    # off=1 ctx bin, eo/bo = ctx + bypass; eo adds 2 class bins, bo 5 band
    cost_eo = dd_eo_y + lam * (bits_eo_y + 2 + 2)
    ec_y = cost_eo.argmin(axis=0)
    iy, ix = np.mgrid[0:gh, 0:gw]
    c_eo = cost_eo[ec_y, iy, ix]
    c_bo = dd_bo_y + lam * (bits_bo_y + 5 + 2)
    c_off = lam * 1.0
    ty = np.where(c_eo <= c_bo, SAO_EDGE, SAO_BAND)
    ty = np.where(np.minimum(c_eo, c_bo) < c_off, ty, SAO_OFF)

    # chroma: shared type + shared eo class, joint Cb+Cr cost
    dd_eo_u, off_eo_u, bits_eo_u = _derive_eo(st_u[0], st_u[1], lam)
    dd_eo_v, off_eo_v, bits_eo_v = _derive_eo(st_v[0], st_v[1], lam)
    dd_bo_u, off_bo_u, band_u, bits_bo_u = _derive_bo(st_u[2], st_u[3], lam)
    dd_bo_v, off_bo_v, band_v, bits_bo_v = _derive_bo(st_v[2], st_v[3], lam)
    cost_eo_c = (dd_eo_u + dd_eo_v
                 + lam * (bits_eo_u + bits_eo_v + 2 + 2))
    ec_c = cost_eo_c.argmin(axis=0)
    c_eo_c = cost_eo_c[ec_c, iy, ix]
    c_bo_c = (dd_bo_u + dd_bo_v
              + lam * (bits_bo_u + bits_bo_v + 10 + 2))
    tc = np.where(c_eo_c <= c_bo_c, SAO_EDGE, SAO_BAND)
    tc = np.where(np.minimum(c_eo_c, c_bo_c) < c_off, tc, SAO_OFF)

    # assemble the per-CTB "new" candidate
    new = SaoFrameParams.alloc(gh, gw)
    new.type_luma[:] = ty
    new.type_chroma[:] = tc
    for cy in range(gh):
        for cx in range(gw):
            if ty[cy, cx] == SAO_EDGE:
                new.eo_class_luma[cy, cx] = ec_y[cy, cx]
                new.offsets[cy, cx, 0] = off_eo_y[ec_y[cy, cx], cy, cx]
            elif ty[cy, cx] == SAO_BAND:
                new.band_pos[cy, cx, 0] = band_y[cy, cx]
                new.offsets[cy, cx, 0] = off_bo_y[cy, cx]
            if tc[cy, cx] == SAO_EDGE:
                new.eo_class_chroma[cy, cx] = ec_c[cy, cx]
                new.offsets[cy, cx, 1] = off_eo_u[ec_c[cy, cx], cy, cx]
                new.offsets[cy, cx, 2] = off_eo_v[ec_c[cy, cx], cy, cx]
            elif tc[cy, cx] == SAO_BAND:
                new.band_pos[cy, cx, 1] = band_u[cy, cx]
                new.band_pos[cy, cx, 2] = band_v[cy, cx]
                new.offsets[cy, cx, 1] = off_bo_u[cy, cx]
                new.offsets[cy, cx, 2] = off_bo_v[cy, cx]

    # ---- merge RDO (raster, counted bits) -----------------------------------
    from homerhevc_tpu_torch.hevc.cabac import CabacCounter
    from homerhevc_tpu_torch.hevc.ctx_tables import init_contexts
    ctx = init_contexts("I", qp)
    params = SaoFrameParams.alloc(gh, gw)

    def ctb_dd(cy, cx, sp, sy_, sx_):
        tL = int(sp.type_luma[sy_, sx_])
        tC = int(sp.type_chroma[sy_, sx_])
        dd = _params_dd_ctb(tuple(a[..., cy, cx] for a in st_y), tL,
                            int(sp.eo_class_luma[sy_, sx_]),
                            sp.offsets[sy_, sx_, 0],
                            sp.band_pos[sy_, sx_, 0])
        dd += _params_dd_ctb(tuple(a[..., cy, cx] for a in st_u), tC,
                             int(sp.eo_class_chroma[sy_, sx_]),
                             sp.offsets[sy_, sx_, 1],
                             sp.band_pos[sy_, sx_, 1])
        dd += _params_dd_ctb(tuple(a[..., cy, cx] for a in st_v), tC,
                             int(sp.eo_class_chroma[sy_, sx_]),
                             sp.offsets[sy_, sx_, 2],
                             sp.band_pos[sy_, sx_, 2])
        return dd

    for cy in range(gh):
        for cx in range(gw):
            # candidate 0: new params
            params.copy_from_other(new, cy, cx)
            params.merge_left[cy, cx] = False
            params.merge_up[cy, cx] = False
            cnt = CabacCounter(ctx.copy())
            _count_sao_bits(cnt, params, cy, cx)
            best = (ctb_dd(cy, cx, new, cy, cx) + lam * cnt.bits(), False,
                    False)
            if cx > 0:
                cnt = CabacCounter(ctx.copy())
                params.merge_left[cy, cx] = True
                _count_sao_bits(cnt, params, cy, cx)
                params.merge_left[cy, cx] = False
                c = ctb_dd(cy, cx, params, cy, cx - 1) + lam * cnt.bits()
                if c < best[0]:
                    best = (c, True, False)
            if cy > 0:
                cnt = CabacCounter(ctx.copy())
                params.merge_up[cy, cx] = True
                _count_sao_bits(cnt, params, cy, cx)
                params.merge_up[cy, cx] = False
                c = ctb_dd(cy, cx, params, cy - 1, cx) + lam * cnt.bits()
                if c < best[0]:
                    best = (c, False, True)
            _, ml, mu = best
            if ml:
                params.copy_from(cy, cx - 1, cy, cx)
            elif mu:
                params.copy_from(cy - 1, cx, cy, cx)
            params.merge_left[cy, cx] = ml
            params.merge_up[cy, cx] = mu
            # advance the live sao context chain with the chosen coding
            _count_sao_bits(CabacCounter(ctx), params, cy, cx)
    return params


def _sao_decide_v1(src_planes, rec_planes, ctu_size_luma: int,
                   qp: int) -> SaoFrameParams:
    """Round-2 EO-only vectorized decision (kept as a comparison
    baseline for RD experiments)."""
    sy, su, sv = src_planes
    h, w = sy.shape[:2]
    cs = ctu_size_luma
    if h % cs == 0 and w % cs == 0:
        ry, ru, rv = rec_planes
        lam = T.rd_lambda(qp, "I")
        tl, el, ol = _decide_component_vec(np.asarray(sy), np.asarray(ry),
                                           cs, lam, 6)
        # chroma: shared type/class, joint cost over Cb+Cr
        dd_u, off_u = _eo_stats_vec(np.asarray(su), np.asarray(ru), cs // 2)
        dd_v, off_v = _eo_stats_vec(np.asarray(sv), np.asarray(rv), cs // 2)
        costc = (dd_u + dd_v
                 + lam * (8 + off_u.sum(axis=3) + off_v.sum(axis=3)))
        ec_best = costc.argmin(axis=0)
        gh, gw = ec_best.shape
        iy, ix = np.mgrid[0:gh, 0:gw]
        chosen_c = costc[ec_best, iy, ix] < lam * 1.0
        params = SaoFrameParams.alloc(gh, gw)
        params.type_luma[:] = tl
        params.eo_class_luma[:] = el
        params.offsets[:, :, 0] = ol
        params.type_chroma[:] = np.where(chosen_c, SAO_EDGE, SAO_OFF)
        params.eo_class_chroma[:] = np.where(chosen_c, ec_best, 0)
        params.offsets[:, :, 1] = np.where(chosen_c[:, :, None],
                                           off_u[ec_best, iy, ix], 0)
        params.offsets[:, :, 2] = np.where(chosen_c[:, :, None],
                                           off_v[ec_best, iy, ix], 0)
        # merge flags where params identical to neighbours
        def same_shift(ax, ay):
            ok = np.ones((gh, gw), bool)
            for arr in (params.type_luma, params.type_chroma,
                        params.eo_class_luma, params.eo_class_chroma):
                sh = np.roll(arr, (ay, ax), axis=(0, 1))
                ok &= arr == sh
            for arr in (params.band_pos, params.offsets):
                sh = np.roll(arr, (ay, ax), axis=(0, 1))
                ok &= (arr == sh).reshape(gh, gw, -1).all(axis=2)
            return ok
        left_same = same_shift(1, 0)
        left_same[:, 0] = False
        up_same = same_shift(0, 1)
        up_same[0, :] = False
        params.merge_left[:] = left_same
        params.merge_up[:] = (~left_same) & up_same
        return params
    return _sao_decide_loop(src_planes, rec_planes, ctu_size_luma, qp)


def _sao_decide_loop(src_planes, rec_planes, ctu_size_luma: int,
                     qp: int) -> SaoFrameParams:
    """Choose SAO parameters per CTU from (source, deblocked recon).
    Simple mode: evaluate 4 EO classes + BO per component; lambda-weighted
    rate estimate; merge flags when identical to neighbor params."""
    sy, su, sv = src_planes
    ry, ru, rv = rec_planes
    h, w = sy.shape
    cs = ctu_size_luma
    cy_n, cx_n = -(-h // cs), -(-w // cs)
    params = SaoFrameParams.alloc(cy_n, cx_n)
    lam = T.rd_lambda(qp, "I")
    cats_cache = {}

    def comp_cats(plane, ec, key):
        if (key, ec) not in cats_cache:
            cats_cache[(key, ec)] = _eo_categories(plane, ec)
        return cats_cache[(key, ec)]

    for cy in range(cy_n):
        for cx in range(cx_n):
            # ---- luma ----
            y0, x0 = cy * cs, cx * cs
            y1, x1 = min(y0 + cs, h), min(x0 + cs, w)
            sb = sy[y0:y1, x0:x1]
            rb = ry[y0:y1, x0:x1]
            best = (0.0 + lam * 1, SAO_OFF, 0, [0, 0, 0, 0])  # cost, type, class, off
            for ec in range(4):
                cat = comp_cats(ry, ec, 0)[y0:y1, x0:x1]
                diffs, counts = _stats_for_block(sb, rb, cat)
                offs, dd = [], 0
                for k, positive in ((1, True), (2, True), (3, False), (4, False)):
                    o, d2 = _best_offset(diffs[k], counts[k], positive=positive)
                    offs.append(abs(o))
                    dd += d2
                cost = dd + lam * (6 + sum(abs(o) for o in offs))
                if cost < best[0]:
                    best = (cost, SAO_EDGE, ec, offs)
            if best[1] != SAO_OFF:
                params.type_luma[cy, cx] = best[1]
                params.eo_class_luma[cy, cx] = best[2]
                params.offsets[cy, cx, 0] = best[3]
            # ---- chroma (shared type/class, separate offsets) ----
            cs2 = cs // 2
            yc0, xc0 = cy * cs2, cx * cs2
            yc1, xc1 = min(yc0 + cs2, h // 2), min(xc0 + cs2, w // 2)
            bestc = (0.0 + lam * 1, SAO_OFF, 0, None, None)
            for ec in range(4):
                catu = comp_cats(ru, ec, 1)[yc0:yc1, xc0:xc1]
                catv = comp_cats(rv, ec, 2)[yc0:yc1, xc0:xc1]
                du_, cu_ = _stats_for_block(su[yc0:yc1, xc0:xc1],
                                            ru[yc0:yc1, xc0:xc1], catu)
                dv_, cv_ = _stats_for_block(sv[yc0:yc1, xc0:xc1],
                                            rv[yc0:yc1, xc0:xc1], catv)
                dd = 0
                offu, offv = [], []
                for k, positive in ((1, True), (2, True), (3, False), (4, False)):
                    ou, d1 = _best_offset(du_[k], cu_[k], positive=positive)
                    ov, d2 = _best_offset(dv_[k], cv_[k], positive=positive)
                    offu.append(abs(ou)); offv.append(abs(ov))
                    dd += d1 + d2
                cost = dd + lam * (8 + sum(offu) + sum(offv))
                if cost < bestc[0]:
                    bestc = (cost, SAO_EDGE, ec, offu, offv)
            if bestc[1] != SAO_OFF:
                params.type_chroma[cy, cx] = bestc[1]
                params.eo_class_chroma[cy, cx] = bestc[2]
                params.offsets[cy, cx, 1] = bestc[3]
                params.offsets[cy, cx, 2] = bestc[4]
            # ---- merge flags when params identical to neighbors ----
            def same(ay, ax):
                return (params.type_luma[ay, ax] == params.type_luma[cy, cx]
                        and params.type_chroma[ay, ax] == params.type_chroma[cy, cx]
                        and params.eo_class_luma[ay, ax] == params.eo_class_luma[cy, cx]
                        and params.eo_class_chroma[ay, ax] == params.eo_class_chroma[cy, cx]
                        and np.array_equal(params.band_pos[ay, ax], params.band_pos[cy, cx])
                        and np.array_equal(params.offsets[ay, ax], params.offsets[cy, cx]))
            if cx > 0 and same(cy, cx - 1):
                params.merge_left[cy, cx] = True
            elif cy > 0 and same(cy - 1, cx):
                params.merge_up[cy, cx] = True
    return params
