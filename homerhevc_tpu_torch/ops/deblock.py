"""Deblocking filter (PyTorch port of homerhevc_tpu/ops/deblock.py):
uniform-grid luma/chroma filtering for the intra CU16 path and BS-map
luma/chroma filtering for the inter path. Bit-exact to golden/deblock.py.

Planes are (..., H, W) int tensors; leading dims are a frame batch. QP is a
Python int or an int tensor of the leading (frame) shape. Each direction
is one batched pass over all edge strips; vertical edges first, then
horizontal edges on the vertically-filtered plane (normative order).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from homerhevc_tpu_torch.hevc.deblock import BETA_TABLE, TC_TABLE
from homerhevc_tpu_torch.hevc.tables import CHROMA_QP_MAP


@lru_cache(maxsize=None)
def _tab(name: str, device: torch.device) -> torch.Tensor:
    src = {"beta": BETA_TABLE, "tc": TC_TABLE, "cqp": CHROMA_QP_MAP}[name]
    return torch.as_tensor(np.asarray(src, np.int32), device=device)


def _lookup(name: str, idx, lo: int, hi: int, device) -> torch.Tensor:
    i = torch.clamp(torch.as_tensor(idx, device=device), lo, hi).long()
    return _tab(name, device)[i]


def _frame_shape(v: torch.Tensor, nd: int) -> torch.Tensor:
    """Per-frame value (leading shape) broadcastable against a tensor with
    `nd` trailing dims."""
    return v.reshape(v.shape + (1,) * nd)


def _clip3(lo, hi, v):
    return torch.minimum(torch.maximum(v, lo), hi)


def _luma_filter_groups(p, q, beta, tc):
    """p, q: (..., 4lines, 4taps) int32 (tap 0 adjacent to the edge).
    beta/tc: int32 tensors broadcastable to the group dims (...)."""
    tc_l = tc[..., None]   # per-line broadcast of the group tc
    dp = torch.abs(p[..., :, 2] - 2 * p[..., :, 1] + p[..., :, 0])
    dq = torch.abs(q[..., :, 2] - 2 * q[..., :, 1] + q[..., :, 0])
    dp0, dp3 = dp[..., 0], dp[..., 3]
    dq0, dq3 = dq[..., 0], dq[..., 3]
    on = (dp0 + dq0 + dp3 + dq3) < beta

    def sc(k):
        return ((2 * (dp[..., k] + dq[..., k]) < (beta >> 2))
                & (torch.abs(p[..., k, 3] - p[..., k, 0])
                   + torch.abs(q[..., k, 0] - q[..., k, 3]) < (beta >> 3))
                & (torch.abs(p[..., k, 0] - q[..., k, 0]) < ((5 * tc + 1) >> 1)))
    strong = on & sc(0) & sc(3)
    normal = on & ~strong

    p0, p1, p2, p3 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    t2 = 2 * tc_l
    sp0 = _clip3(p0 - t2, p0 + t2, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = _clip3(p1 - t2, p1 + t2, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = _clip3(p2 - t2, p2 + t2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = _clip3(q0 - t2, q0 + t2, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3)
    sq1 = _clip3(q1 - t2, q1 + t2, (q2 + q1 + q0 + p0 + 2) >> 2)
    sq2 = _clip3(q2 - t2, q2 + t2, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    do_line = torch.abs(delta) < 10 * tc_l
    dlt = _clip3(-tc_l, tc_l, delta)
    np0 = torch.clamp(p0 + dlt, 0, 255)
    nq0 = torch.clamp(q0 - dlt, 0, 255)
    side = (beta + (beta >> 1)) >> 3
    dEp = (dp0 + dp3 < side)[..., None]
    dEq = (dq0 + dq3 < side)[..., None]
    tc2 = tc_l >> 1
    np1 = torch.clamp(p1 + _clip3(-tc2, tc2, (((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1), 0, 255)
    nq1 = torch.clamp(q1 + _clip3(-tc2, tc2, (((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1), 0, 255)

    sN = strong[..., None]
    nN = normal[..., None] & do_line
    op = torch.stack([
        torch.where(sN, sp0, torch.where(nN, np0, p0)),
        torch.where(sN, sp1, torch.where(nN & dEp, np1, p1)),
        torch.where(sN, sp2, p2),
        p3,
    ], dim=-1)
    oq = torch.stack([
        torch.where(sN, sq0, torch.where(nN, nq0, q0)),
        torch.where(sN, sq1, torch.where(nN & dEq, nq1, q1)),
        torch.where(sN, sq2, q2),
        q3,
    ], dim=-1)
    return op, oq


@lru_cache(maxsize=None)
def _edge_cols(ne: int, step: int, taps: int, device) -> torch.Tensor:
    xs = (np.arange(ne) + 1) * step
    cols = xs[:, None] + np.arange(-taps, taps)[None, :]
    return torch.as_tensor(cols.reshape(-1), device=device)


def _luma_pass(x, step, beta, tc, bsg=None):
    """One direction of luma deblocking over the vertical edges every
    `step` columns. x: (F, H, W) int32; beta: (F,) ; tc: (F,) or, with a
    BS map, (F, E, H/4) per line group; bsg: (F, E, H/4) or None."""
    F, h, w = x.shape
    ne = w // step - 1
    if ne <= 0:
        return x
    cols = _edge_cols(ne, step, 4, x.device)
    strips = x[:, :, cols].reshape(F, h, ne, 8).permute(0, 2, 1, 3)
    g = strips.reshape(F, ne, h // 4, 4, 8)               # (F, E, G, 4, 8)
    p = g[..., :4].flip(-1)
    q = g[..., 4:]
    beta_g = _frame_shape(beta, 2)
    tc_g = tc if tc.ndim == 3 else _frame_shape(tc, 2)
    op, oq = _luma_filter_groups(p, q, beta_g, tc_g)
    if bsg is not None:
        off = (bsg == 0)[..., None, None]
        op = torch.where(off, p, op)
        oq = torch.where(off, q, oq)
    ng = torch.cat([op.flip(-1), oq], dim=-1)              # (F, E, G, 4, 8)
    ns = ng.reshape(F, ne, h, 8).permute(0, 2, 1, 3).reshape(F, h, ne * 8)
    out = x.clone()
    out[:, :, cols] = ns
    return out


def _as_batch(plane):
    x = plane.to(torch.int32)
    return x.reshape((-1,) + x.shape[-2:]), plane.shape


def _per_frame(v, lead, device) -> torch.Tensor:
    """Per-frame int32 vector (F,) from a scalar or a leading-shape QP (an
    int is filled in on the device, not uploaded: a CUDA graph may
    capture the call)."""
    t = (torch.full((), v, dtype=torch.int32, device=device)
         if isinstance(v, int)
         else torch.as_tensor(v, dtype=torch.int32, device=device))
    F = int(np.prod(lead)) if lead else 1
    return t.expand(lead).reshape(F) if t.ndim else t.expand(F)


def deblock_luma_uniform(plane: torch.Tensor, bsize: int, qp,
                         beta_offset: int = 0, tc_offset: int = 0):
    """plane: (..., H, W) int, uniform TU grid of `bsize`, BS=2 everywhere."""
    x, shape = _as_batch(plane)
    qv = _per_frame(qp, shape[:-2], x.device)
    beta = _lookup("beta", qv + beta_offset * 2, 0, 51, x.device)
    tc = _lookup("tc", qv + 2 + tc_offset * 2, 0, 53, x.device)
    out = _luma_pass(x, bsize, beta, tc)
    out = _luma_pass(out.transpose(-1, -2), bsize, beta, tc) \
        .transpose(-1, -2)
    return out.reshape(shape)


def _chroma_pass(x, step, tc, on=None):
    """One direction of chroma deblocking: vertical edges every `step`
    columns. tc: (F,); on: (F, E, h) bool line mask or None."""
    F, h, w = x.shape
    ne = w // step - 1
    if ne <= 0:
        return x
    cols = _edge_cols(ne, step, 2, x.device)
    s = x[:, :, cols].reshape(F, h, ne, 4).permute(0, 2, 1, 3)  # (F,E,h,4)
    p1, p0, q0, q1 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    t = _frame_shape(tc, 2)
    delta = _clip3(-t, t, (((q0 - p0) * 4) + p1 - q1 + 4) >> 3)
    np0 = torch.clamp(p0 + delta, 0, 255)
    nq0 = torch.clamp(q0 - delta, 0, 255)
    if on is not None:
        np0 = torch.where(on, np0, p0)
        nq0 = torch.where(on, nq0, q0)
    ns = torch.stack([p1, np0, nq0, q1], dim=-1).permute(0, 2, 1, 3) \
        .reshape(F, h, ne * 4)
    out = x.clone()
    out[:, :, cols] = ns
    return out


def _chroma_tc(qp, lead, chroma_qp_off, tc_offset, device):
    qv = _per_frame(qp, lead, device)
    qpc = _lookup("cqp", qv + chroma_qp_off, 0, 57, device)
    return _lookup("tc", qpc + 2 + tc_offset * 2, 0, 53, device)


def deblock_chroma_uniform(plane: torch.Tensor, bsize_luma: int, qp,
                           chroma_qp_off: int = 0, tc_offset: int = 0):
    """Chroma plane; edges on the chroma 8-grid at TU boundaries (intra
    BS=2), every max(8, bsize_luma/2) chroma samples. tc == 0 no-ops
    naturally (the filter delta clips to zero)."""
    step = max(8, bsize_luma // 2)
    x, shape = _as_batch(plane)
    tc = _chroma_tc(qp, shape[:-2], chroma_qp_off, tc_offset, x.device)
    out = _chroma_pass(x, step, tc)
    out = _chroma_pass(out.transpose(-1, -2), step, tc).transpose(-1, -2)
    return out.reshape(shape)


def deblock_chroma_bs(plane: torch.Tensor, bs2_v: torch.Tensor,
                      bs2_h: torch.Tensor, qp, chroma_qp_off: int = 0,
                      tc_offset: int = 0):
    """Chroma deblocking over BS==2 edges only (spec 8.7.2.5.5).
    bs2_v/bs2_h: (..., h8, w8) bool luma 8-unit maps marking BS2 on the
    unit's LEFT/TOP edge (chroma filters only at even units)."""
    x, shape = _as_batch(plane)
    F = x.shape[0]
    tc = _chroma_tc(qp, shape[:-2], chroma_qp_off, tc_offset, x.device)
    bv = bs2_v.reshape((F,) + bs2_v.shape[-2:])
    bh = bs2_h.reshape((F,) + bs2_h.shape[-2:])
    ne_v = x.shape[2] // 8 - 1
    ev = torch.arange(2, 2 * ne_v + 1, 2, device=x.device)
    mv = bv.transpose(1, 2)[:, ev, :]                      # (F, E, h8)
    x = _chroma_pass(x, 8, tc, mv.repeat_interleave(4, dim=2))
    ne_h = x.shape[1] // 8 - 1
    eh = torch.arange(2, 2 * ne_h + 1, 2, device=x.device)
    mh = bh[:, eh, :]                                      # (F, E, w8)
    x = _chroma_pass(x.transpose(-1, -2), 8, tc,
                     mh.repeat_interleave(4, dim=2)).transpose(-1, -2)
    return x.reshape(shape)


def _bs_pass(x, bs, qp, boff, toff):
    """One direction of bs-gated luma deblocking on the dense 8-grid.
    x: (F, H, W) int32; bs: (F, h8, w8) strength of each unit's LEFT
    edge; qp: (F,)."""
    ne = x.shape[2] // 8 - 1
    if ne <= 0:
        return x
    bsa = bs[:, :, 1:].transpose(1, 2)                     # (F, E, h8)
    bsg = bsa.repeat_interleave(2, dim=2)                  # (F, E, h4)
    beta = _lookup("beta", qp + boff * 2, 0, 51, x.device)
    tcv = _lookup("tc", _frame_shape(qp, 2) + 2 * (bsg - 1) + toff * 2,
                  0, 53, x.device)
    return _luma_pass(x, 8, beta, tcv, bsg)


def deblock_luma_bs(plane: torch.Tensor, bs_v: torch.Tensor,
                    bs_h: torch.Tensor, qp, beta_offset: int = 0,
                    tc_offset: int = 0):
    """Luma deblocking with per-edge boundary strengths on the 8-grid
    (inter path: BS in {0,1,2} per unit edge)."""
    x, shape = _as_batch(plane)
    F = x.shape[0]
    qv = _per_frame(qp, shape[:-2], x.device)
    bv = bs_v.reshape((F,) + bs_v.shape[-2:]).to(torch.int32)
    bh = bs_h.reshape((F,) + bs_h.shape[-2:]).to(torch.int32)
    out = _bs_pass(x, bv, qv, beta_offset, tc_offset)
    out = _bs_pass(out.transpose(-1, -2), bh.transpose(-1, -2), qv,
                   beta_offset, tc_offset).transpose(-1, -2)
    return out.reshape(shape)
