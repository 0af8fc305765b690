"""Batched quantization / dequantization + vectorized sign-bit hiding
(PyTorch port of homerhevc_tpu/ops/quant.py, bit-exact to it).

QP is either a Python int or an int tensor broadcastable to the block
dims (coef.shape[:-2]): one formula serves both, as the JAX package's
traced-QP path does (the 6-periodic scale table is indexed with qp % 6
and the shift uses qp // 6). int32 throughout, as in the reference.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from homerhevc_tpu_torch.hevc import tables as T


def quant_params(size: int, qp: int, is_intra: bool, scaling_lists: bool):
    """Static per-call tables: (qc[size,size], qbits, add) for forward."""
    log2n = size.bit_length() - 1
    per, rem = qp // 6, qp % 6
    tshift = T.MAX_TR_DYNAMIC_RANGE - 8 - log2n
    qbits = T.QUANT_SHIFT + per + tshift
    sl = T.scaling_list(size, is_intra, flat=not scaling_lists)
    qc = (int(T.QUANT_SCALE[rem]) << 4) // sl
    add = 171 << (qbits - 9)
    return np.asarray(qc, np.int32), qbits, add


def _qc6_np(size: int, is_intra: bool, scaling_lists: bool) -> np.ndarray:
    """Forward scale tables for all six qp%6 classes: (6, N, N) int32."""
    sl = T.scaling_list(size, is_intra, flat=not scaling_lists)
    return np.stack([(int(T.QUANT_SCALE[r]) << 4) // sl for r in range(6)]) \
        .astype(np.int32)


def _dq6_np(size: int, is_intra: bool, scaling_lists: bool) -> np.ndarray:
    sl = T.scaling_list(size, is_intra, flat=not scaling_lists)
    return np.stack([int(T.INV_QUANT_SCALE[r]) * sl for r in range(6)]) \
        .astype(np.int32)


@lru_cache(maxsize=None)
def qc6(size: int, is_intra: bool, scaling_lists: bool,
        device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_qc6_np(size, is_intra, scaling_lists),
                           device=device)


@lru_cache(maxsize=None)
def dq6(size: int, is_intra: bool, scaling_lists: bool,
        device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_dq6_np(size, is_intra, scaling_lists),
                           device=device)


@lru_cache(maxsize=None)
def _scan_tabs(n: int, scan_idx: int, device: torch.device):
    scan = np.asarray(T.coeff_scan(n.bit_length() - 1, scan_idx), np.int64)
    inv = np.argsort(scan)
    return (torch.as_tensor(scan, device=device),
            torch.as_tensor(inv, device=device))


@lru_cache(maxsize=None)
def _qc6_scan(size: int, is_intra: bool, scaling_lists: bool, scan_idx: int,
              device: torch.device) -> torch.Tensor:
    scan = np.asarray(T.coeff_scan(size.bit_length() - 1, scan_idx))
    q = _qc6_np(size, is_intra, scaling_lists).reshape(6, -1)[:, scan]
    return torch.as_tensor(q.reshape(6, -1, 16), device=device)


def _qp_split(qp, like: torch.Tensor):
    """(per, rem) of the QP: per as int32 shaped to broadcast over
    (..., N, N), rem as an int64 index shaped like the block dims. An int
    QP gives a 0-d per filled in on the device and an int rem: nothing is
    uploaded and no index waits for the card, so a CUDA graph may
    capture the call."""
    if isinstance(qp, int):
        return (torch.full((), qp // 6, dtype=torch.int32,
                           device=like.device), qp % 6)
    q = torch.as_tensor(qp, dtype=torch.int32, device=like.device)
    per = torch.div(q, 6, rounding_mode="floor")
    return per.reshape(q.shape + (1, 1)) if q.ndim else per, (q % 6).long()


def quantize(coef: torch.Tensor, size: int, qp, is_intra: bool,
             scaling_lists: bool = False) -> torch.Tensor:
    """coef: (..., N, N) int32. Product |coef|*qc < 2^31 (see golden)."""
    log2n = size.bit_length() - 1
    tshift = T.MAX_TR_DYNAMIC_RANGE - 8 - log2n
    per, rem = _qp_split(qp, coef)
    qc = qc6(size, is_intra, scaling_lists, coef.device)[rem]
    qbits = T.QUANT_SHIFT + tshift + per
    add = torch.bitwise_left_shift(torch.full_like(qbits, 171), qbits - 9)
    a = torch.abs(coef)
    level = torch.bitwise_right_shift(a * qc + add, qbits)
    return torch.clamp(level * torch.sign(coef), -32768, 32767) \
        .to(torch.int32)


def dequantize(level: torch.Tensor, size: int, qp, is_intra: bool,
               scaling_lists: bool = False) -> torch.Tensor:
    log2n = size.bit_length() - 1
    tshift = T.MAX_TR_DYNAMIC_RANGE - 8 - log2n
    shift = T.QUANT_IQUANT_SHIFT - T.QUANT_SHIFT - tshift + 4
    per, rem = _qp_split(qp, level)
    dq = dq6(size, is_intra, scaling_lists, level.device)[rem]
    prod = level.to(torch.int32) * dq
    # both shift directions computed branchless, selected on per < shift
    s1 = torch.clamp(shift - per, min=1)
    one = torch.ones_like(s1)
    out_r = torch.bitwise_right_shift(
        prod + torch.bitwise_left_shift(one, s1 - 1), s1)
    s2 = torch.clamp(per - shift, min=0)
    hi = torch.bitwise_right_shift(torch.full_like(s2, 32767), s2)
    lo = -torch.bitwise_right_shift(torch.full_like(s2, 32768), s2)
    out_l = torch.bitwise_left_shift(
        torch.maximum(torch.minimum(prod, hi), lo), s2)
    out = torch.where(per < shift, out_r, out_l)
    return torch.clamp(out, -32768, 32767).to(torch.int32)


# the stacked tables below are stacked on the host and copied once (a
# blocking copy): a cached table is read from the CUDA streams of every
# slot of a mesh (parallel/mesh.py), so it must be whole when it is
# returned, not queued on the first caller's stream


@lru_cache(maxsize=None)
def _scan_tabs3(n: int, device: torch.device):
    """The three scans (diag, hor, ver) of an n-block stacked: (3, n*n)."""
    scans = np.stack([np.asarray(T.coeff_scan(n.bit_length() - 1, s),
                                 np.int64) for s in (0, 1, 2)])
    return (torch.as_tensor(scans, device=device),
            torch.as_tensor(np.argsort(scans, axis=1), device=device))


@lru_cache(maxsize=None)
def _qc6_scan3(size: int, is_intra: bool, scaling_lists: bool,
               device: torch.device) -> torch.Tensor:
    q = _qc6_np(size, is_intra, scaling_lists).reshape(6, -1)
    return torch.as_tensor(np.stack([
        q[:, np.asarray(T.coeff_scan(size.bit_length() - 1, s))]
        .reshape(6, -1, 16) for s in (0, 1, 2)]), device=device)


def scan_class(modes: torch.Tensor, n: int, is_luma: bool):
    """Intra scan index (0 diag, 1 hor, 2 ver) per block of an n-block
    coded in `modes` (spec 7.4.9.11), or 0 where only the diagonal scan
    can occur at this size: sign_bit_hiding's scan_idx."""
    log2n = n.bit_length() - 1
    if not (log2n == 2 or (log2n == 3 and is_luma)):
        return 0
    ver = (modes >= 6) & (modes <= 14)
    hor = (modes >= 22) & (modes <= 30)
    return torch.where(ver, 2, torch.where(hor, 1, 0))


def sign_bit_hiding(level: torch.Tensor, coef: torch.Tensor, size: int, qp,
                    is_intra: bool, scan_idx,
                    scaling_lists: bool = False) -> torch.Tensor:
    """Vectorized SBH over (..., N, N) blocks, bit-exact to golden: per
    eligible CG with wrong parity, the position minimizing the cost over
    {increase |l| (256-delta), decrease |l| (256+delta, not on a first
    coeff with |l|==1)}; ties go to the earlier scan position, and up
    beats down at equal cost.

    scan_idx is one scan for every block, or a per-block int tensor of
    the block dims (0 diag, 1 hor, 2 ver): one call then gives what three
    calls and a per-block select would."""
    n = size
    log2n = n.bit_length() - 1
    ncg = (n * n) // 16
    batch = level.shape[:-2]
    per, rem = _qp_split(qp, level)
    if isinstance(scan_idx, torch.Tensor):
        scans, invs = _scan_tabs3(n, level.device)
        s = scan_idx.long()
        scan, inv = scans[s], invs[s]                 # batch + (n*n,)

        def to_scan(a):
            return torch.gather(a.reshape(batch + (n * n,)), -1, scan)
        qc_scan = _qc6_scan3(n, is_intra, scaling_lists,
                             level.device)[s, rem]
    else:
        scan, inv = _scan_tabs(n, scan_idx, level.device)

        def to_scan(a):
            return a.reshape(batch + (n * n,))[..., scan]
        qc_scan = _qc6_scan(n, is_intra, scaling_lists, scan_idx,
                            level.device)[rem]
    cg_l = to_scan(level).reshape(batch + (ncg, 16))
    cg_c = to_scan(coef).reshape(batch + (ncg, 16))
    tshift = T.MAX_TR_DYNAMIC_RANGE - 8 - log2n
    qbits = T.QUANT_SHIFT + tshift + per          # () or batch + (1, 1)
    abs_c = torch.abs(cg_c)
    abs_l = torch.abs(cg_l)
    # delta = (|c|*qc - |l|<<qbits) >> (qbits-8), in int32 with the
    # shifted level clamped as in the JAX version
    cap = torch.bitwise_right_shift(torch.full_like(qbits, 1 << 30), qbits)
    shifted_l = torch.bitwise_left_shift(
        torch.minimum(abs_l, cap), qbits)
    delta_u = torch.bitwise_right_shift(abs_c * qc_scan - shifted_l,
                                        qbits - 8)

    nz = cg_l != 0
    nzi = nz.to(torch.int32)
    idx = torch.arange(16, dtype=torch.int32, device=level.device)
    has_nz = nz.any(dim=-1)
    first = nzi.argmax(dim=-1)                            # first nz scan pos
    last = 15 - nzi.flip(-1).argmax(dim=-1)               # last nz scan pos
    eligible = has_nz & ((last - first) >= T.SBH_THRESHOLD)
    sign_first = torch.gather(cg_l, -1, first[..., None])[..., 0] < 0
    parity = (abs_l.sum(dim=-1) & 1).to(torch.bool)
    need_fix = eligible & (parity != sign_first)

    first_i = first[..., None].to(torch.int32)
    last_i = last[..., None].to(torch.int32)
    in_range = (idx >= first_i) & (idx <= last_i) & nz
    big = 1 << 23  # sentinel; survives the *64 tiebreak in int32
    cost_up = torch.where(in_range, 256 - delta_u, big)
    is_first_one = (idx == first_i) & (abs_l == 1)
    cost_dn = torch.where(in_range & ~is_first_one, 256 + delta_u, big)
    comb_up = cost_up * 64 + 2 * idx
    comb_dn = cost_dn * 64 + 2 * idx + 1
    comb = torch.minimum(comb_up, comb_dn)
    best_k = comb.argmin(dim=-1)
    best_comb = comb.min(dim=-1).values
    dir_up = (best_comb & 1) == 0
    step = torch.where(dir_up, 1, -1).to(torch.int32)
    lv_at = torch.gather(cg_l, -1, best_k[..., None])[..., 0]
    new_val = lv_at + step * torch.where(lv_at > 0, 1, -1).to(torch.int32)
    upd = torch.where(need_fix, new_val, lv_at)
    cg_l = torch.where((idx == best_k[..., None]) & need_fix[..., None],
                       upd[..., None], cg_l)
    cg_l = cg_l.reshape(batch + (n * n,))
    out = (torch.gather(cg_l, -1, inv) if isinstance(scan_idx, torch.Tensor)
           else cg_l[..., inv])
    return out.reshape(batch + (n, n)).to(torch.int32)
