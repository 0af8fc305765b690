"""Batched integer transforms (PyTorch): HEVC DCT 4/8/16/32 + DST 4x4.

Port of homerhevc_tpu/ops/transform.py. The JAX version contracts in
int32; CUDA matmuls take no integer operands, so both stages run as
float64 matmuls, which are exact here: every product and partial sum is an
integer below 2^31 (see the bounds below), far inside float64's 2^53. The
rounding shifts and 16-bit clamps then run in int32 as in the reference.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from homerhevc_tpu_torch.hevc.tables import DCT, DST4


@lru_cache(maxsize=None)
def _mats(n: int, is_dst: bool, device: torch.device) -> torch.Tensor:
    m = DST4 if (is_dst and n == 4) else DCT[n]
    return torch.as_tensor(np.asarray(m, np.float64), device=device)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64).to(torch.int32)


def forward_transform(res: torch.Tensor, is_dst: bool,
                      bit_depth: int = 8) -> torch.Tensor:
    """res: (..., N, N) int residual -> (..., N, N) int32 coefficients.
    tmp = (T @ X^T + r1) >> s1 ; coef = (T @ tmp^T + r2) >> s2
    (|sums| <= 90 * 255 * 32 and 90 * 2^16 * 32 before the shifts)."""
    n = res.shape[-1]
    log2n = n.bit_length() - 1
    t = _mats(n, is_dst, res.device)
    s1 = log2n - 1 + bit_depth - 8
    s2 = log2n + 6
    x = res.to(torch.float64)
    # tmp[k, j] = sum_i T[k, i] * X[j, i]  ==  (X @ T^T)^T
    tmp = (_i32(torch.matmul(x, t.T).transpose(-1, -2))
           + (1 << (s1 - 1))) >> s1
    coef = (_i32(torch.matmul(tmp.to(torch.float64), t.T).transpose(-1, -2))
            + (1 << (s2 - 1))) >> s2
    return coef


def inverse_transform(coef: torch.Tensor, is_dst: bool,
                      bit_depth: int = 8) -> torch.Tensor:
    """Decoder-exact inverse (spec 8.6.4.2): columns first then rows,
    16-bit clamp between and after stages."""
    n = coef.shape[-1]
    t = _mats(n, is_dst, coef.device)
    s1, s2 = 7, 20 - bit_depth
    c = coef.to(torch.float64)
    # stage 1: tmp[i, j] = sum_k T[k, i] * C[k, j]  ==  T^T @ C
    tmp = (_i32(torch.matmul(t.T, c)) + (1 << (s1 - 1))) >> s1
    tmp = torch.clamp(tmp, -32768, 32767)
    # stage 2: out[i, j] = sum_k T[k, j] * tmp[i, k]  ==  tmp @ T
    out = (_i32(torch.matmul(tmp.to(torch.float64), t))
           + (1 << (s2 - 1))) >> s2
    return torch.clamp(out, -32768, 32767)
