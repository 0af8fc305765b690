"""Batched intra prediction (PyTorch port of homerhevc_tpu/ops/intra.py):
reference construction with z-scan availability/substitution, the [1 2 1]
smoothing filter, and all 35 modes as one matmul against an augmented
reference vector. Bit-exact to golden/intra_pred.py.

The static numpy tables (pred_weights, avail_masks) are copies of the JAX
module's, which this package cannot import without importing jax.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from homerhevc_tpu_torch import device as _device  # noqa: F401  (TF32 off)
from homerhevc_tpu_torch.hevc.intra_pred import (INV_ANGLE, PRED_ANGLE,
                                                 _zorder_table)

# modes that use the filtered reference per size (HM m_aucIntraFilter rule)
_FILTER_THRESH = {4: 10, 8: 7, 16: 1, 32: 0}


def mode_uses_filtered(mode: int, size: int, is_luma: bool) -> bool:
    if not is_luma or mode == 1 or size not in _FILTER_THRESH:
        return False
    dist = min(abs(mode - 26), abs(mode - 10)) if mode != 0 else 10
    return dist > _FILTER_THRESH[size]


@lru_cache(maxsize=None)
def pred_weights(n: int, is_luma: bool):
    """Build (W, S): W int32 [35, n*n, R], S int32 [35] with
    pred[m] = (W[m] @ ref_aug) >> S[m], where
    ref_aug = concat(top_u[2n+1], left_u[2n+1], top_f[2n+1], left_f[2n+1], [1])
    (u=unfiltered, f=filtered; layout [corner, samples...]).

    DC edge filtering and mode 10/26 gradient fixes are NOT in W (they nest
    floors); they are applied by `edge_fixes` afterwards.
    """
    reflen = 2 * n + 1
    R = 4 * reflen + 1
    W = np.zeros((35, n * n, R), np.int32)
    S = np.zeros(35, np.int32)
    log2n = n.bit_length() - 1

    def base(filtered: bool, which: str) -> int:
        o = 2 * reflen if filtered else 0
        return o + (0 if which == "top" else reflen)

    for mode in range(35):
        filt = mode_uses_filtered(mode, n, is_luma)
        tb = base(filt, "top")
        lb = base(filt, "left")
        const = R - 1
        if mode == 0:  # planar, shift log2n+1
            S[mode] = log2n + 1
            for y in range(n):
                for x in range(n):
                    p = y * n + x
                    W[mode, p, lb + 1 + y] += (n - 1 - x)
                    W[mode, p, tb + 1 + n] += (x + 1)      # top-right p[N][-1]
                    W[mode, p, tb + 1 + x] += (n - 1 - y)
                    W[mode, p, lb + 1 + n] += (y + 1)      # bottom-left
                    W[mode, p, const] += n
        elif mode == 1:  # DC (never filtered refs)
            S[mode] = log2n + 1
            tu, lu = base(False, "top"), base(False, "left")
            for p in range(n * n):
                for i in range(n):
                    W[mode, p, tu + 1 + i] += 1
                    W[mode, p, lu + 1 + i] += 1
                W[mode, p, const] += n
        else:  # angular
            S[mode] = 5
            angle = int(PRED_ANGLE[mode - 2])
            vertical = mode >= 18
            mb = tb if vertical else lb
            sb = lb if vertical else tb

            def ref_entry(k: int):
                """spec ref[k]: k>=0 -> main[k] (corner at k=0);
                k<0 -> side[(k*inv+128)>>8] (projected)."""
                if k >= 0:
                    return mb + k
                inv = int(INV_ANGLE[mode - 11])
                return sb + ((k * inv + 128) >> 8)
            for y in range(n):
                for x in range(n):
                    row, col = (y, x) if vertical else (x, y)
                    pos = (row + 1) * angle
                    i_idx = pos >> 5
                    f = pos & 31
                    pp = row * n + col if vertical else col * n + row
                    k = col + i_idx + 1
                    W[mode, pp, ref_entry(k)] += 32 - f
                    if f:
                        W[mode, pp, ref_entry(k + 1)] += f
                    W[mode, pp, const] += 16
    return W, S


@lru_cache(maxsize=None)
def pred_weights_t(n: int, is_luma: bool, device: torch.device):
    """(W^T float32 (R, 35*n*n), S int32 (35,)) on `device`."""
    W, S = pred_weights(n, is_luma)
    wt = torch.as_tensor(W.reshape(35 * n * n, -1).T.astype(np.float32)
                         .copy(), device=device)
    return wt, torch.as_tensor(S, device=device)


def filter_refs(top: torch.Tensor, left: torch.Tensor):
    """[1 2 1] filter of (B, 2n+1) ref arrays (corner-first layout).
    Returns (top_f, left_f); endpoints unfiltered; corner joint-filtered."""
    corner = (left[..., 1] + 2 * top[..., 0] + top[..., 1] + 2) >> 2

    def f(arr):
        mid = (arr[..., :-2] + 2 * arr[..., 1:-1] + arr[..., 2:] + 2) >> 2
        return torch.cat([corner[..., None], mid, arr[..., -1:]], dim=-1)
    return f(top), f(left)


def predict_all_modes(top_u: torch.Tensor, left_u: torch.Tensor, n: int,
                      is_luma: bool) -> torch.Tensor:
    """(B, 2n+1) int32 refs -> (B, 35, n, n) int32 predictions (pre
    edge-fix). The contraction runs in float32: |W| <= 64, refs <= 255 and
    every partial sum stays below 2^24, so it is exact in full fp32 (TF32
    is pinned off in device.py)."""
    top_f, left_f = filter_refs(top_u, left_u)
    ones = torch.ones(top_u.shape[:-1] + (1,), dtype=top_u.dtype,
                      device=top_u.device)
    ref_aug = torch.cat([top_u, left_u, top_f, left_f, ones], dim=-1)
    wt, s = pred_weights_t(n, is_luma, top_u.device)
    raw = torch.matmul(ref_aug.to(torch.float32), wt).to(torch.int32)
    pred = raw.reshape(-1, 35, n * n) >> s[None, :, None]
    return pred.reshape(ref_aug.shape[0], 35, n, n)


def edge_fixes(pred: torch.Tensor, top_u, left_u, n: int, is_luma: bool):
    """DC edge smoothing and mode 10/26 gradient fixes (luma, n<32).
    pred: (B, 35, n, n); returns a new tensor."""
    if not is_luma or n >= 32:
        return pred
    t = top_u[..., 1:n + 1]
    l = left_u[..., 1:n + 1]
    corner = top_u[..., 0]
    pred = pred.clone()
    dc = pred[:, 1, n - 1, n - 1]  # interior value = dc
    row0 = (t + 3 * dc[..., None] + 2) >> 2
    col0 = (l + 3 * dc[..., None] + 2) >> 2
    c00 = (l[..., 0] + 2 * dc + t[..., 0] + 2) >> 2
    pred[:, 1, 0, :] = row0
    pred[:, 1, :, 0] = col0
    pred[:, 1, 0, 0] = c00
    pred[:, 26, :, 0] = torch.clamp(
        t[..., 0:1] + ((l - corner[..., None]) >> 1), 0, 255)
    pred[:, 10, 0, :] = torch.clamp(
        l[..., 0:1] + ((t - corner[..., None]) >> 1), 0, 255)
    return pred


@lru_cache(maxsize=None)
def _mode_tables_np(n: int, is_luma: bool):
    """Static per-mode lookup tables for predict_mode: (uses_filtered[35],
    angle[35], inv_angle[35])."""
    uses = np.zeros(35, bool)
    ang = np.zeros(35, np.int32)
    inv = np.zeros(35, np.int32)
    for m in range(35):
        uses[m] = mode_uses_filtered(m, n, is_luma)
        if m >= 2:
            ang[m] = int(PRED_ANGLE[m - 2])
        if 11 <= m <= 25:
            inv[m] = int(INV_ANGLE[m - 11])
    return uses, ang, inv


@lru_cache(maxsize=None)
def _mode_tables(n: int, is_luma: bool, device: torch.device):
    return tuple(torch.as_tensor(t, device=device)
                 for t in _mode_tables_np(n, is_luma))


def predict_mode(top_u: torch.Tensor, left_u: torch.Tensor, n: int,
                 mode: torch.Tensor, is_luma: bool) -> torch.Tensor:
    """Single-mode batched intra prediction with a per-block mode tensor.

    top_u/left_u: (B, 2n+1) int32 corner-first refs; mode: (B,) int.
    Returns (B, n, n) int32, bit-exact to the golden predictor (the [1 2 1]
    filter rule, DC edge smoothing, the mode 10/26 gradient fixes). The
    tree encoder's wavefront uses it where the mode is already decided:
    one prediction instead of 35 in the sequential loop."""
    B = top_u.shape[0]
    dev = top_u.device
    mode = mode.long()
    uses_t, ang_t, inv_t = _mode_tables(n, is_luma, dev)
    use_f = uses_t[mode][:, None]
    top_f, left_f = filter_refs(top_u, left_u)
    top = torch.where(use_f, top_f, top_u)
    left = torch.where(use_f, left_f, left_u)
    log2n = n.bit_length() - 1
    x = torch.arange(n, dtype=torch.int32, device=dev)

    # planar (spec 8.4.4.2.4): filtered refs per the distance rule
    l_col = left[:, 1:n + 1]
    t_row = top[:, 1:n + 1]
    tr = top[:, n + 1, None, None]
    bl = left[:, n + 1, None, None]
    planar = ((n - 1 - x)[None, None, :] * l_col[:, :, None]
              + (x + 1)[None, None, :] * tr
              + (n - 1 - x)[None, :, None] * t_row[:, None, :]
              + (x + 1)[None, :, None] * bl
              + n) >> (log2n + 1)

    # DC: unfiltered refs always
    tu = top_u[:, 1:n + 1]
    lu = left_u[:, 1:n + 1]
    dc = (tu.sum(dim=1, dtype=torch.int32) + lu.sum(dim=1, dtype=torch.int32)
          + n) >> (log2n + 1)
    dcp = dc[:, None, None].expand(B, n, n)
    if is_luma and n < 32:
        dcp = dcp.clone()
        dcp[:, 0, :] = (tu + 3 * dc[:, None] + 2) >> 2
        dcp[:, :, 0] = (lu + 3 * dc[:, None] + 2) >> 2
        dcp[:, 0, 0] = (lu[:, 0] + 2 * dc + tu[:, 0] + 2) >> 2

    # angular (spec 8.4.4.2.6), both orientations via a main/side swap
    angle = ang_t[mode]
    inv = inv_t[mode]
    vertical = (mode >= 18)[:, None]
    main = torch.where(vertical, top, left)              # (B, 2n+1)
    side = torch.where(vertical, left, top)
    # extended ref ext[k+n] for k in [-n, 2n]
    kk_neg = torch.arange(-n, 0, dtype=torch.int32, device=dev)
    j = (kk_neg[None, :] * inv[:, None] + 128) >> 8      # (B, n)
    ext_neg = torch.gather(side, 1, torch.clamp(j, 0, 2 * n).long())
    ext = torch.cat([ext_neg, main], dim=1)              # (B, 3n+1)
    pos = (x + 1)[None, :] * angle[:, None]              # (B, n) per row
    frac = (pos & 31)[:, :, None]
    bidx = (n + 1 + (pos >> 5)[:, :, None] + x[None, None, :]) \
        .reshape(B, n * n)
    a = torch.gather(ext, 1, torch.clamp(bidx, 0, 3 * n).long())
    b = torch.gather(ext, 1, torch.clamp(bidx + 1, 0, 3 * n).long())
    pr = ((32 - frac) * a.reshape(B, n, n) + frac * b.reshape(B, n, n)
          + 16) >> 5
    angp = torch.where(vertical[:, :, None], pr, pr.transpose(1, 2))
    if is_luma and n < 32:
        # mode 26 first-column / mode 10 first-row gradient fixes
        corner = top_u[:, 0:1]
        v26 = torch.clamp(tu[:, 0:1] + ((lu - corner) >> 1), 0, 255)
        h10 = torch.clamp(lu[:, 0:1] + ((tu - corner) >> 1), 0, 255)
        angp = angp.clone()
        angp[:, :, 0] = torch.where(mode[:, None] == 26, v26, angp[:, :, 0])
        angp[:, 0, :] = torch.where(mode[:, None] == 10, h10, angp[:, 0, :])
    m3 = mode[:, None, None]
    out = torch.where(m3 == 0, planar, torch.where(m3 == 1, dcp, angp))
    return out.to(torch.int32)


def avail_masks(w: int, h: int, ctu: int, n: int, comp_shift: int,
                xs0: np.ndarray, ys0: np.ndarray) -> np.ndarray:
    """Vectorized z-scan availability (spec 6.4.1) for the substitution
    sequence [left bottom..top (2n), corner, top (2n)] of blocks whose
    component-space top-left corners are xs0/ys0 (broadcastable arrays).
    Coordinates are in component space; availability is evaluated in luma
    space (<< comp_shift). Returns bool array xs0.shape + (4n+1,)."""
    cs = comp_shift
    n2 = 2 * n
    offx = np.concatenate([np.full(n2, -1), [-1], np.arange(n2)])
    offy = np.concatenate([n2 - 1 - np.arange(n2), [-1], np.full(n2, -1)])
    xs0 = np.asarray(xs0)[..., None]
    ys0 = np.asarray(ys0)[..., None]
    xn = (xs0 + offx) << cs
    yn = (ys0 + offy) << cs
    xc, yc = xs0 << cs, ys0 << cs
    inside = (xn >= 0) & (yn >= 0) & (xn < w) & (yn < h)
    ctus_x = -(-w // ctu)
    ctu_c = (yc // ctu) * ctus_x + xc // ctu
    ctu_n = (yn // ctu) * ctus_x + xn // ctu
    z = _zorder_table(ctu.bit_length() - 1, 2)
    zc = z[(yc % ctu) // 4, (xc % ctu) // 4]
    zn = z[(np.clip(yn, 0, None) % ctu) // 4,
           (np.clip(xn, 0, None) % ctu) // 4]
    return inside & ((ctu_n < ctu_c) | ((ctu_n == ctu_c) & (zn < zc)))


def gather_ref_seq(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(..., gh, gw, 4n+1) substitution-order raw reference samples for
    every aligned n-block of `plane` (..., hh, ww) (pre availability
    mask); leading axes are frames."""
    hh, ww = plane.shape[-2:]
    n2 = 2 * n
    dev = plane.device
    pp = torch.nn.functional.pad(plane.to(torch.int32), (1, n2, 1, n2))
    gys = torch.arange(hh // n, device=dev) * n
    gxs = torch.arange(ww // n, device=dev) * n
    lall = pp[..., gxs]                                 # (hh+n2+1, gw)
    jidx = torch.arange(n2, device=dev)
    rows = gys[:, None] + (n2 - jidx)[None, :]          # (gh, n2)
    seq_left = lall[..., rows, :].transpose(-1, -2)     # (gh, gw, n2)
    tall = pp[..., gys, :]                              # (gh, ww+n2+1)
    corner = tall[..., gxs]                             # (gh, gw)
    cols = gxs[:, None] + 1 + jidx[None, :]             # (gw, n2)
    seq_top = tall[..., cols]                           # (gh, gw, n2)
    return torch.cat([seq_left, corner[..., None], seq_top], dim=-1)


def seq_to_refs(seq: torch.Tensor, n: int):
    """Substitution-order (B, 4n+1) -> corner-first (top, left) (B, 2n+1)."""
    n2 = 2 * n
    left = seq[:, :n2].flip(-1)
    corner = seq[:, n2:n2 + 1]
    top = seq[:, n2 + 1:]
    return torch.cat([corner, top], dim=1), torch.cat([corner, left], dim=1)


def substitute_refs(vals: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """Reference sample substitution (spec 8.4.4.2.2), batched.

    vals: (B, L) int32 gathered samples in substitution scan order
          [left bottom..top, corner, top left..right]
    avail: (B, L) bool availability.
    Returns substituted vals; rows with nothing available become 128."""
    L = vals.shape[-1]
    idx = torch.arange(L, dtype=torch.int64, device=vals.device)
    # index of the most recent available position at-or-before i
    marked = torch.where(avail, idx, -1)
    last_ok = torch.cummax(marked, dim=-1).values
    # position 0 unavailable: take the first available overall
    first_ok = avail.to(torch.int32).argmax(dim=-1)
    src = torch.where(last_ok >= 0, last_ok, first_ok[..., None])
    out = torch.gather(vals, -1, src)
    any_ok = avail.any(dim=-1, keepdim=True)
    return torch.where(any_ok, out, 128).to(vals.dtype)
