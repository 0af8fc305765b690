"""Device-side SAO (PyTorch port of homerhevc_tpu/ops/sao_dev.py, bit-exact
to it): per-CTB edge-offset and band-offset statistics, integer offset
derivation with a lambda-RD magnitude search, a rate-estimated type
decision per CTB and the in-loop apply, all on the device so the filtered
recon stays device-resident for the next P frame.

Every function takes planes with any leading batch axes, (..., H, W), the
twin of the JAX package's vmap over frames; lam_x256 = int(lambda * 256)
has the batch shape. All arithmetic is int32 and wraps as the JAX int32
program does (int32 sums are asked for explicitly: torch sums int32 to
int64 by default).

Parameters are non-normative: only their syntax and the filter are. The
host CABAC writes what this module decides (packed into the wire meta);
a decoder filtering the same recon with the same parameters reproduces
the device apply bit-exactly. Merge flags are derived on the host from
equal neighbouring parameters (unpack_params), which only compacts the
syntax.
"""

from __future__ import annotations

import numpy as np
import torch

# EO class sample offsets (dy0, dx0, dy1, dx1); edgeIdx -> category is
# folded into the select chain of _eo_cat (hevc/sao.py EDGE_CAT)
_EO_DELTAS = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1), (1, -1, -1, 1))
MAX_OFFSET = 7
_I32 = torch.int32


def _eo_cat(plane: torch.Tensor, ec: int) -> torch.Tensor:
    """Per-sample EO category plane (0..4); plane-boundary samples 0.
    The rolls wrap around; the boundary mask zeroes the wrapped samples."""
    h, w = plane.shape[-2:]
    dy0, dx0, dy1, dx1 = _EO_DELTAS[ec]
    a = torch.roll(plane, (-dy0, -dx0), dims=(-2, -1))
    b = torch.roll(plane, (-dy1, -dx1), dims=(-2, -1))
    sgn = torch.sign(plane - a) + torch.sign(plane - b) + 2
    cat = torch.where(sgn == 2, 0, torch.where(sgn < 2, sgn + 1, sgn))
    ys = torch.arange(h, device=plane.device)[:, None]
    xs = torch.arange(w, device=plane.device)[None, :]
    ok = ((ys + dy0 >= 0) & (ys + dy0 < h) & (xs + dx0 >= 0)
          & (xs + dx0 < w) & (ys + dy1 >= 0) & (ys + dy1 < h)
          & (xs + dx1 >= 0) & (xs + dx1 < w))
    return torch.where(ok, cat, 0)


def _block_sum(x: torch.Tensor, n: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    return x.reshape(lead + (h // n, n, w // n, n)).sum(dim=(-3, -1),
                                                        dtype=_I32)


def _derive(dsum, cnt, positive: bool, lam):
    """RD-refined integer offset + distortion delta (twin of the host
    _rd_offset, hevc/sao.py): every magnitude 0..7, argmin of
    dd*256 + lam*(m+1) TU bins. lam broadcasts against dsum."""
    d_eff = torch.abs(dsum)
    s = torch.sign(dsum)
    best_cost = None
    best_m = torch.zeros_like(cnt)
    for m in range(MAX_OFFSET + 1):
        cost = (cnt * m * m - 2 * m * d_eff) * 256 + lam * (m + 1)
        if best_cost is None:
            best_cost = cost
        else:
            take = cost < best_cost
            best_cost = torch.where(take, cost, best_cost)
            best_m = torch.where(take, m, best_m)
    o = s * best_m
    o = torch.clamp(o, min=0) if positive else torch.clamp(o, max=0)
    dd = cnt * o * o - 2 * o * dsum
    bad = dd > 0
    return torch.where(bad, 0, o), torch.where(bad, 0, dd)


def _eo_stats(src, rec, n: int, lam):
    """(dd[4, ..., gh, gw], offs_abs[4, ..., gh, gw, 4]) for one
    component; lam shaped to broadcast over (..., gh, gw)."""
    diff = src - rec
    dds, offs = [], []
    for ec in range(4):
        cat = _eo_cat(rec, ec)
        dd_ec = 0
        off_ec = []
        for k, positive in ((1, True), (2, True), (3, False), (4, False)):
            m = cat == k
            cnt = _block_sum(m.to(_I32), n)
            dsum = _block_sum(torch.where(m, diff, 0), n)
            o, dd = _derive(dsum, cnt, positive, lam)
            off_ec.append(torch.abs(o))
            dd_ec = dd_ec + dd
        dds.append(dd_ec)
        offs.append(torch.stack(off_ec, dim=-1))
    return torch.stack(dds), torch.stack(offs)


def _bo_stats(src, rec, n: int):
    """(cnt[..., gh, gw, 32], dsum[..., gh, gw, 32]) int32: per-CTB
    32-band histograms (band = rec >> 3)."""
    band = rec >> 3
    diff = src - rec
    cnts, sums = [], []
    for b in range(32):
        m = band == b
        cnts.append(_block_sum(m.to(_I32), n))
        sums.append(_block_sum(torch.where(m, diff, 0), n))
    return torch.stack(cnts, dim=-1), torch.stack(sums, dim=-1)


def _take_last(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[..., i[...]] along the last axis (take_along_axis twin)."""
    return torch.gather(a, -1, i[..., None].long())[..., 0]


def _bo_derive(src, rec, n: int, lam):
    """Band-offset candidate for one component: per-band RD offsets
    (signed; TU bins + sign bin), then the best wrapping 4-band window.
    lam broadcasts over (..., gh, gw). Returns (dd[..., gh, gw],
    off[..., gh, gw, 4] signed, band[..., gh, gw], bits[..., gh, gw])."""
    cnt, dsum = _bo_stats(src, rec, n)
    lam4 = lam[..., None]
    d_eff = torch.abs(dsum)
    s = torch.sign(dsum)
    best_cost = None
    best_m = torch.zeros_like(cnt)
    for m in range(MAX_OFFSET + 1):
        bits_m = m + (1 if m < MAX_OFFSET else 0) + (1 if m > 0 else 0)
        cost = (cnt * m * m - 2 * m * d_eff) * 256 + lam4 * bits_m
        if best_cost is None:
            best_cost = cost
        else:
            take = cost < best_cost
            best_cost = torch.where(take, cost, best_cost)
            best_m = torch.where(take, m, best_m)
    dd_b = cnt * best_m * best_m - 2 * best_m * d_eff
    bad = dd_b > 0
    best_m = torch.where(bad, 0, best_m)
    dd_b = torch.where(bad, 0, dd_b)
    o_b = s * best_m                                    # (..., gh, gw, 32)
    bits_b = (best_m + (best_m < MAX_OFFSET).to(_I32)
              + (best_m > 0).to(_I32))
    # best wrapping 4-band window (first minimum on ties, as jnp.argmin)
    dd4 = sum(torch.roll(dd_b, -k, dims=-1) for k in range(4))
    bits4 = sum(torch.roll(bits_b, -k, dims=-1) for k in range(4))
    cost4 = dd4 * 256 + lam4 * bits4
    band = cost4.argmin(dim=-1).to(_I32)
    off = torch.stack([_take_last(o_b, (band + k) % 32) for k in range(4)],
                      dim=-1)
    return _take_last(dd4, band), off, band, _take_last(bits4, band)


def _rep(a: torch.Tensor, n: int) -> torch.Tensor:
    return a.repeat_interleave(n, dim=-2).repeat_interleave(n, dim=-1)


def _apply_sao(plane, types, classes, offs, band_pos, n: int):
    """Apply per-CTB SAO parameters to one component plane (..., H, W).
    types/classes/band_pos (..., gh, gw); offs (..., gh, gw, 4): EO
    magnitudes (the category signs are applied here) or BO signed."""
    cls_px = _rep(classes, n)
    cat_sel = torch.zeros_like(plane)
    for ec in range(4):
        cat_sel = torch.where(cls_px == ec, _eo_cat(plane, ec), cat_sel)
    adj_eo = torch.zeros_like(plane)
    for k, sign in enumerate((1, 1, -1, -1)):
        adj_eo = adj_eo + torch.where(cat_sel == k + 1,
                                      sign * _rep(offs[..., k], n), 0)
    band_px = plane >> 3
    bp = _rep(band_pos, n)
    adj_bo = torch.zeros_like(plane)
    for k in range(4):
        adj_bo = adj_bo + torch.where(band_px == ((bp + k) & 31),
                                      _rep(offs[..., k], n), 0)
    t = _rep(types, n)
    return torch.where(t == 2, torch.clamp(plane + adj_eo, 0, 255),
                       torch.where(t == 1, torch.clamp(plane + adj_bo, 0, 255),
                                   plane))


def _take_class(a: torch.Tensor, ec: torch.Tensor) -> torch.Tensor:
    """a[ec[...], ...] along axis 0 (a: (4,) + ec.shape [+ (4,)])."""
    idx = ec[None].long()
    if a.ndim > idx.ndim:
        idx = idx[..., None].expand((1,) + a.shape[1:])
    return torch.gather(a, 0, idx)[0]


def sao_analyze_apply(sy, su, sv, ry, ru, rv, ctu: int, lam_x256):
    """Decide + apply SAO for a frame (or a batch of frames) on the device.

    All planes int32 (..., H, W); ctu = luma CTB size; lam_x256 (...)
    int32 = int(lambda * 256). Returns (filtered ry, ru, rv, params dict
    of small int tensors). Types: 0 = off, 1 = band, 2 = edge."""
    lam = torch.as_tensor(lam_x256, dtype=_I32, device=ry.device)
    lam2 = lam[..., None, None]                        # over (gh, gw)
    # ---- luma: EO (per class) vs BO vs OFF ----
    dd_l, off_l = _eo_stats(sy, ry, ctu, lam2)
    cost_l = dd_l * 256 + lam2 * (6 + off_l.sum(dim=-1, dtype=_I32))
    ec_l = cost_l.argmin(dim=0).to(_I32)
    best_eo_l = _take_class(cost_l, ec_l)
    dd_bo_l, off_bo_l, band_l, bits_bo_l = _bo_derive(sy, ry, ctu, lam2)
    cost_bo_l = dd_bo_l * 256 + lam2 * (9 + bits_bo_l)
    bo_wins_l = cost_bo_l < best_eo_l
    best_l = torch.minimum(best_eo_l, cost_bo_l)
    on_l = best_l < lam2         # cost < lambda * 1.0 (x256 fixed point)
    type_l = torch.where(on_l, torch.where(bo_wins_l, 1, 2), 0).to(_I32)
    ec_l = torch.where(type_l == 2, ec_l, 0)
    band_l = torch.where(type_l == 1, band_l, 0)
    t_l = type_l[..., None]
    off_lb = torch.where(t_l == 2, _take_class(off_l, ec_l),
                         torch.where(t_l == 1, off_bo_l, 0))

    # ---- chroma: shared type + shared EO class, joint Cb+Cr cost ----
    nc = ctu // 2
    dd_u, off_u = _eo_stats(su, ru, nc, lam2)
    dd_v, off_v = _eo_stats(sv, rv, nc, lam2)
    cost_c = (dd_u + dd_v) * 256 + lam2 * (
        8 + off_u.sum(dim=-1, dtype=_I32) + off_v.sum(dim=-1, dtype=_I32))
    ec_c = cost_c.argmin(dim=0).to(_I32)
    best_eo_c = _take_class(cost_c, ec_c)
    dd_bo_u, off_bo_u, band_u, bits_bo_u = _bo_derive(su, ru, nc, lam2)
    dd_bo_v, off_bo_v, band_v, bits_bo_v = _bo_derive(sv, rv, nc, lam2)
    cost_bo_c = (dd_bo_u + dd_bo_v) * 256 \
        + lam2 * (12 + bits_bo_u + bits_bo_v)
    bo_wins_c = cost_bo_c < best_eo_c
    best_c = torch.minimum(best_eo_c, cost_bo_c)
    on_c = best_c < lam2
    type_c = torch.where(on_c, torch.where(bo_wins_c, 1, 2), 0).to(_I32)
    ec_c = torch.where(type_c == 2, ec_c, 0)
    band_u = torch.where(type_c == 1, band_u, 0)
    band_v = torch.where(type_c == 1, band_v, 0)
    t_c = type_c[..., None]
    off_ub = torch.where(t_c == 2, _take_class(off_u, ec_c),
                         torch.where(t_c == 1, off_bo_u, 0))
    off_vb = torch.where(t_c == 2, _take_class(off_v, ec_c),
                         torch.where(t_c == 1, off_bo_v, 0))

    ry_f = _apply_sao(ry, type_l, ec_l, off_lb, band_l, ctu)
    ru_f = _apply_sao(ru, type_c, ec_c, off_ub, band_u, nc)
    rv_f = _apply_sao(rv, type_c, ec_c, off_vb, band_v, nc)
    params = {
        "type_l": type_l.to(torch.uint8),
        "type_c": type_c.to(torch.uint8),
        "ec_l": ec_l.to(torch.uint8),
        "ec_c": ec_c.to(torch.uint8),
        "band": torch.stack([band_l, band_u, band_v], dim=-1)
        .to(torch.uint8),
        "off": torch.stack([off_lb, off_ub, off_vb], dim=-2).to(torch.int8),
    }
    return ry_f, ru_f, rv_f, params


def pack_params(params) -> torch.Tensor:
    """Flatten the params dict to one uint8 vector per frame (the wire
    meta section): (..., params_nbytes) with the batch axes kept. The int8
    offsets are bitcast, not converted."""
    lead = params["type_l"].shape[:-2]
    flat = lambda a: a.reshape(lead + (-1,))
    return torch.cat([flat(params["type_l"]), flat(params["type_c"]),
                      flat(params["ec_l"]), flat(params["ec_c"]),
                      flat(params["band"]),
                      flat(params["off"].contiguous().view(torch.uint8))],
                     dim=-1)


def params_nbytes(gh: int, gw: int) -> int:
    return gh * gw * (4 + 3 + 12)


def unpack_params(buf, gh: int, gw: int):
    """Host inverse of pack_params -> hevc.sao.SaoFrameParams (merge flags
    derived from equal neighbouring params, syntax-only compaction)."""
    from homerhevc_tpu_torch.hevc.sao import SaoFrameParams
    n = gh * gw
    p = SaoFrameParams.alloc(gh, gw)
    b = np.asarray(buf, np.uint8)
    p.type_luma[:] = b[:n].reshape(gh, gw)
    p.type_chroma[:] = b[n:2 * n].reshape(gh, gw)
    p.eo_class_luma[:] = b[2 * n:3 * n].reshape(gh, gw)
    p.eo_class_chroma[:] = b[3 * n:4 * n].reshape(gh, gw)
    p.band_pos[:] = b[4 * n:7 * n].reshape(gh, gw, 3)
    p.offsets[:] = b[7 * n:7 * n + 12 * n].copy().view(np.int8) \
        .reshape(gh, gw, 3, 4)
    # the EO serializer writes magnitudes with category-implied signs; the
    # BO serializer writes signed offsets: both are the conventions of the
    # host SaoFrameParams (hevc/sao.py)

    def same_shift(ax, ay):
        ok = np.ones((gh, gw), bool)
        for arr in (p.type_luma, p.type_chroma, p.eo_class_luma,
                    p.eo_class_chroma):
            ok &= arr == np.roll(arr, (ay, ax), axis=(0, 1))
        for arr in (p.band_pos, p.offsets):
            sh = np.roll(arr, (ay, ax), axis=(0, 1))
            ok &= (arr == sh).reshape(gh, gw, -1).all(axis=2)
        return ok
    left_same = same_shift(1, 0)
    left_same[:, 0] = False
    up_same = same_shift(0, 1)
    up_same[0, :] = False
    p.merge_left[:] = left_same
    p.merge_up[:] = (~left_same) & up_same
    return p


def sao_lambda_x256(qp) -> torch.Tensor:
    """int32(RD_LAMBDA_I_TAB[qp] * 256 + 0.5) in float32, as the JAX
    programs compute it; qp an int or an int tensor."""
    from homerhevc_tpu_torch.hevc import tables as T
    q = torch.as_tensor(qp)
    tab = torch.as_tensor(T.RD_LAMBDA_I_TAB, device=q.device)
    return (tab[q.long()] * 256.0 + 0.5).to(_I32)
