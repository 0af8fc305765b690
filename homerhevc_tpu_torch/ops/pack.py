"""Device-side sparse packing of quantized coefficient planes (PyTorch
port of the two-tier CG wire of homerhevc_tpu/ops/pack.py).

The wire bytes are what the host CABAC tier reads
(engine/intra_encoder._parse_cg_wire, native unpack_sparse_cg): per-4x4
group presence bits, compacted 16-bit significance masks, 2-bit level
codes {+1, -1, +2, -2} and an escape list for larger levels. Compaction
is a prefix-sum scatter, so no host synchronisation is needed.

The capacity helpers and the numpy host inverse are copies of the JAX
module's, which this package cannot import without importing jax.
"""

from __future__ import annotations

import numpy as np
import torch

_PAD_KEY = 1 << 30      # key of unused escape slots, as in the JAX wire


def pack_capacity(n_total: int, qp: int) -> int:
    """Static compaction capacity: generous at high QP, full at low QP."""
    if qp >= 30:
        frac = 6
    elif qp >= 24:
        frac = 4
    elif qp >= 18:
        frac = 2
    else:
        return n_total
    c = -(-n_total // frac)
    return -(-c // 8) * 8


def esc_capacity(n_total: int, capacity: int) -> int:
    """Escape-list capacity: levels outside [-2, 2] are rare, so a small
    per-frame list suffices; overflow falls back to full planes."""
    return min(capacity, max(2048, -(-n_total // 512)))


def cg_cap(n_total: int, qp: int) -> int:
    """Static capacity for the compacted per-CG significance masks."""
    if qp >= 30:
        d = 48
    elif qp >= 24:
        d = 24
    else:
        return n_total // 16
    return min(n_total // 16, -(-n_total // d // 8) * 8)


def _blk4(p: torch.Tensor) -> torch.Tensor:
    """Plane (..., h, w) -> (..., h*w) in spatial 4x4-block raster order."""
    h, w = p.shape[-2:]
    lead = p.shape[:-2]
    return p.reshape(lead + (h // 4, 4, w // 4, 4)).transpose(-3, -2) \
        .reshape(lead + (h * w,))


def _unblk4(flat, h, w):
    """Host inverse of _blk4 (numpy)."""
    return flat.reshape(h // 4, w // 4, 4, 4).transpose(0, 2, 1, 3) \
        .reshape(h, w)


def _compact(mask: torch.Tensor, vals: torch.Tensor, cap: int,
             fill: int = 0) -> torch.Tensor:
    """Stable compaction along the last axis: the `vals` where `mask`
    holds, in order, into `cap` slots (the rest `fill`)."""
    pos = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    dst = torch.where(mask & (pos < cap), pos, cap)
    out = torch.full(vals.shape[:-1] + (cap + 1,), fill, dtype=vals.dtype,
                     device=vals.device)
    out.scatter_(-1, dst, torch.where(dst < cap, vals,
                                      torch.full_like(vals, fill)))
    return out[..., :cap]


def pack_sparse_cg(planes, capacity: int, cgcap: int):
    """Two-tier CG wire of the planes (each (..., h, w) int, leading batch
    dims shared), in spatial 4x4-block order. Returns (cg_bitmap u8
    (..., n/128), masks16 i16 (..., cgcap), codes u8 (..., capacity/4),
    esc_idx i32 (..., E), esc_val i16 (..., E), count, esc_count,
    cg_count), the counts int32 of shape (...)."""
    assert capacity % 4 == 0
    flat = torch.cat([_blk4(p) for p in planes], dim=-1).to(torch.int16)
    lead = flat.shape[:-1]
    n = flat.shape[-1]
    assert n % 128 == 0
    dev = flat.device
    cg = flat.reshape(lead + (n // 16, 16))
    bitw = torch.bitwise_left_shift(
        torch.ones(16, dtype=torch.int32, device=dev),
        torch.arange(16, dtype=torch.int32, device=dev))
    mask16 = ((cg != 0).to(torch.int32) * bitw).sum(dim=-1,
                                                     dtype=torch.int32)
    cg_nz = mask16 != 0
    cg_count = cg_nz.sum(dim=-1, dtype=torch.int32)
    w8 = torch.bitwise_left_shift(
        torch.ones(8, dtype=torch.int32, device=dev),
        torch.arange(8, dtype=torch.int32, device=dev))
    cg_bitmap = (cg_nz.reshape(lead + (-1, 8)).to(torch.int32) * w8) \
        .sum(dim=-1, dtype=torch.int32).to(torch.uint8)
    smasks = _compact(cg_nz, mask16.to(torch.int16), cgcap)
    nz = flat != 0
    count = nz.sum(dim=-1, dtype=torch.int32)
    svals = _compact(nz, flat, capacity)
    code = torch.where(svals == -1, 1,
                       torch.where(svals == 2, 2,
                                   torch.where(svals == -2, 3, 0))) \
        .to(torch.int32)
    w4 = 4 ** torch.arange(4, dtype=torch.int32, device=dev)
    codes = (code.reshape(lead + (-1, 4)) * w4).sum(
        dim=-1, dtype=torch.int32).to(torch.uint8)
    E = esc_capacity(n, capacity)
    pos = torch.arange(capacity, dtype=torch.int32, device=dev)
    is_esc = (torch.abs(svals) > 2) & (pos < count[..., None])
    esc_count = is_esc.sum(dim=-1, dtype=torch.int32)
    sidx = _compact(is_esc, pos.expand(is_esc.shape), E, fill=_PAD_KEY)
    sval = _compact(is_esc, svals, E)
    return (cg_bitmap, smasks, codes, sidx, sval, count, esc_count,
            cg_count)


_CODE_LUT = np.asarray([1, -1, 2, -2], np.int16)


def unpack_sparse_cg(cg_bitmap, masks16, codes, count, cg_count,
                     esc_idx, esc_val, shapes):
    """Host inverse of pack_sparse_cg (numpy fallback; native twin is
    hevcenc_unpack_sparse_cg)."""
    n = sum(h * w for h, w in shapes)
    cgnz = np.unpackbits(np.asarray(cg_bitmap, np.uint8),
                         bitorder="little")[:n // 16].astype(bool)
    nz_cg = np.flatnonzero(cgnz)
    assert len(nz_cg) == cg_count
    m = np.asarray(masks16[:cg_count], np.int16).astype(np.uint16)
    bits = ((m[:, None] >> np.arange(16)) & 1).astype(bool)
    flat_pos = (nz_cg[:, None] * 16 + np.arange(16))[bits]
    cb = np.asarray(codes, np.uint8)
    code4 = np.stack([(cb >> s) & 3 for s in (0, 2, 4, 6)], axis=1) \
        .reshape(-1)[:count]
    vals = _CODE_LUT[code4]
    if len(esc_idx):
        vals[np.asarray(esc_idx)] = np.asarray(esc_val, np.int16)
    out = np.zeros(n, np.int16)
    out[flat_pos] = vals
    planes = []
    off = 0
    for h, w in shapes:
        planes.append(_unblk4(out[off:off + h * w], h, w))
        off += h * w
    return planes
