"""Batched MC interpolation (PyTorch port of homerhevc_tpu/ops/interp.py:
luma and chroma MC per block, the 14-bit chroma intermediate the
bi-prediction average reads, and the 16 quarter-pel phase planes of a
whole reference with MC sampled from them).

The JAX version contracts taps with int32 einsums; CUDA matmuls take no
integer operands, so the filters here are explicit integer tap loops over
shifted views (8 or 4 multiply-adds), exact by construction. Bit-exact to
golden/interp.py.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# luma 8-tap (quarter-pel) — spec Table 8-10
LUMA_FILT = {
    0: (0, 0, 0, 64, 0, 0, 0, 0),
    1: (-1, 4, -10, 58, 17, -5, 1, 0),
    2: (-1, 4, -11, 40, 40, -11, 4, -1),
    3: (0, 1, -5, 17, 58, -10, 4, -1),
}
# chroma 4-tap (eighth-pel) — spec Table 8-32
CHROMA_FILT = {
    0: (0, 64, 0, 0),
    1: (-2, 58, 10, -2),
    2: (-4, 54, 16, -2),
    3: (-6, 46, 28, -4),
    4: (-4, 36, 36, -4),
    5: (-4, 28, 46, -6),
    6: (-2, 16, 54, -4),
    7: (-2, 10, 58, -2),
}

LUMA_TAPS = np.asarray([LUMA_FILT[f] for f in range(4)], np.int32)     # (4,8)
CHROMA_TAPS = np.asarray([CHROMA_FILT[f] for f in range(8)], np.int32)  # (8,4)


@lru_cache(maxsize=None)
def _taps(name: str, device: torch.device) -> torch.Tensor:
    src = LUMA_TAPS if name == "luma" else CHROMA_TAPS
    return torch.as_tensor(src, device=device)


def _filter(x: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """sum_k taps[..., k] * x[shifted by k along axis]; taps is (B, K)
    per block (broadcast over the block dims of x (B, ...))."""
    k = taps.shape[-1]
    n = x.shape[axis] - k + 1
    tb = taps.reshape(taps.shape[:1] + (1,) * (x.ndim - 1) + taps.shape[1:])
    out = x.narrow(axis, 0, n) * tb[..., 0]
    for i in range(1, k):
        out = out + x.narrow(axis, i, n) * tb[..., i]
    return out


def extract_patches(pad_plane: torch.Tensor, by: torch.Tensor,
                    bx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n, n) patches of a 2D plane at per-block starts (by, bx).
    Callers keep the starts in range by construction (as the JAX version's
    dynamic_slice requires); they are clamped into the plane so that no
    read can leave it."""
    H, W = pad_plane.shape
    by = torch.clamp(by, 0, H - n).long()
    bx = torch.clamp(bx, 0, W - n).long()
    ar = torch.arange(n, device=pad_plane.device)
    rows = (by[:, None] + ar)[:, :, None]
    cols = (bx[:, None] + ar)[:, None, :]
    return pad_plane[rows, cols]


def mc_luma_batch(ref_pad: torch.Tensor, pad: int, x0s: torch.Tensor,
                  y0s: torch.Tensor, n: int,
                  mvs: torch.Tensor) -> torch.Tensor:
    """Batched luma MC: ref_pad is the reference edge-padded by `pad`;
    x0s/y0s (B,) block origins (unpadded coords); mvs (B, 2) quarter-pel.
    Returns (B, n, n) int32 pixels."""
    mvx, mvy = mvs[:, 0], mvs[:, 1]
    by = y0s + (mvy >> 2) + pad - 3
    bx = x0s + (mvx >> 2) + pad - 3
    patch = extract_patches(ref_pad, by, bx, n + 7).to(torch.int32)
    lt = _taps("luma", ref_pad.device)
    h = _filter(patch, lt[(mvx & 3).long()], axis=2)    # (B, n+7, n)
    v = _filter(h, lt[(mvy & 3).long()], axis=1) >> 6   # (B, n, n)
    return torch.clamp((v + 32) >> 6, 0, 255)


def luma_phase_planes(ref_pad: torch.Tensor) -> torch.Tensor:
    """All 16 quarter-pel interpolated planes of an edge-padded reference,
    filtered over the whole plane (two separable passes). Returns
    (16, Hp-7, Wp-7) uint8, phase index fy*4 + fx; sampling it equals
    mc_luma_batch."""
    P = ref_pad.to(torch.int32)
    Hp, Wp = P.shape
    lt = _taps("luma", ref_pad.device)
    # h[fx, y, x] = sum_k taps[fx, k] P[y, x + k]; then
    # v[fy, fx, y, x] = sum_k taps[fy, k] h[fx, y + k, x]
    h = sum(lt[:, k, None, None] * P[None, :, k:k + Wp - 7]
            for k in range(8))                          # (4, Hp, Wp-7)
    v = sum(lt[:, k, None, None, None] * h[None, :, k:k + Hp - 7]
            for k in range(8)) >> 6                     # (4, 4, Hp-7, Wp-7)
    out = torch.clamp((v + 32) >> 6, 0, 255).to(torch.uint8)
    return out.reshape(16, Hp - 7, Wp - 7)


def mc_luma_batch_planes(planes: torch.Tensor, pad: int, x0s: torch.Tensor,
                         y0s: torch.Tensor, n: int,
                         mvs: torch.Tensor) -> torch.Tensor:
    """Batched luma MC sampled from the phase planes of the same padded
    reference (luma_phase_planes): the same (B, n, n) int32 as
    mc_luma_batch(ref_pad, pad, ...)."""
    mvx, mvy = mvs[:, 0], mvs[:, 1]
    p = ((mvy & 3) * 4 + (mvx & 3)).long()
    by = (y0s + (mvy >> 2) + pad - 3).long()
    bx = (x0s + (mvx >> 2) + pad - 3).long()
    ar = torch.arange(n, device=planes.device)
    rows = by[:, None, None] + ar[None, :, None]
    cols = bx[:, None, None] + ar[None, None, :]
    return planes[p[:, None, None], rows, cols].to(torch.int32)


def _chroma_14(ref_pad: torch.Tensor, pad: int, x0s: torch.Tensor,
               y0s: torch.Tensor, n: int, mvs: torch.Tensor) -> torch.Tensor:
    """The chroma filter's 14-bit output (before rounding to 8 bits)."""
    mvx, mvy = mvs[:, 0], mvs[:, 1]
    by = y0s + (mvy >> 3) + pad - 1
    bx = x0s + (mvx >> 3) + pad - 1
    patch = extract_patches(ref_pad, by, bx, n + 3).to(torch.int32)
    ct = _taps("chroma", ref_pad.device)
    h = _filter(patch, ct[(mvx & 7).long()], axis=2)    # (B, n+3, n)
    return _filter(h, ct[(mvy & 7).long()], axis=1) >> 6


def mc_chroma_batch(ref_pad: torch.Tensor, pad: int, x0s: torch.Tensor,
                    y0s: torch.Tensor, n: int,
                    mvs: torch.Tensor) -> torch.Tensor:
    """Batched chroma MC: mvs are the LUMA quarter-pel MVs (chroma
    eighth-pel). Block origins in chroma coords. Returns (B, n, n) int32."""
    v = _chroma_14(ref_pad, pad, x0s, y0s, n, mvs)
    return torch.clamp((v + 32) >> 6, 0, 255)


def mc_chroma_batch_14(ref_pad: torch.Tensor, pad: int, x0s: torch.Tensor,
                       y0s: torch.Tensor, n: int,
                       mvs: torch.Tensor) -> torch.Tensor:
    """14-bit intermediate chroma MC, the input of the bi-prediction
    average (golden twin mc_chroma_14): (B, n, n) int32, not rounded."""
    return _chroma_14(ref_pad, pad, x0s, y0s, n, mvs)
