# Frozen copy of homerhevc_tpu_torch/hevc/quantize.py, lines 1-115, for the
# benchmark's plain reference decoder: later changes to the program
# do not move it. Imports point at the other copies beside it.
"""Host (numpy) quantization / dequantization + sign-bit hiding, the port's
copy of homerhevc_tpu/golden/quantize.py for its host intra programs; the
device tier keeps ops/quant.py.

Parity with reference: hmr_quant.c (quant :172, iquant :224, SBH :61) and
spec 8.6.3 (scaling). Dequant here is bit-exact to a conformant decoder.
"""

from __future__ import annotations

import numpy as np

from hevcbench.reference import tables as T


def _scaling(size: int, is_intra: bool, scaling_lists: bool) -> np.ndarray:
    return T.scaling_list(size, is_intra, flat=not scaling_lists)


def quantize(coef: np.ndarray, qp: int, is_intra: bool,
             scaling_lists: bool = False, bit_depth: int = 8) -> np.ndarray:
    """Forward quant with the reference's deadzone (add = 171<<(qbits-9))."""
    n = coef.shape[0]
    log2n = n.bit_length() - 1
    per, rem = qp // 6, qp % 6
    tshift = T.MAX_TR_DYNAMIC_RANGE - bit_depth - log2n
    qbits = T.QUANT_SHIFT + per + tshift
    qc = (int(T.QUANT_SCALE[rem]) << 4) // _scaling(n, is_intra, scaling_lists)
    add = 171 << (qbits - 9)
    a = np.abs(coef.astype(np.int64))
    level = (a * qc + add) >> qbits
    level = np.clip(level * np.sign(coef), -32768, 32767)
    return level.astype(np.int32)


def dequantize(level: np.ndarray, qp: int, is_intra: bool,
               scaling_lists: bool = False, bit_depth: int = 8) -> np.ndarray:
    """Inverse quant, bit-exact to spec 8.6.3."""
    n = level.shape[0]
    log2n = n.bit_length() - 1
    per, rem = qp // 6, qp % 6
    tshift = T.MAX_TR_DYNAMIC_RANGE - bit_depth - log2n
    dq = int(T.INV_QUANT_SCALE[rem]) * _scaling(n, is_intra, scaling_lists)
    shift = T.QUANT_IQUANT_SHIFT - T.QUANT_SHIFT - tshift + 4  # = log2n + 3 (8-bit)
    lv = level.astype(np.int64)
    if shift > per:
        s = shift - per
        out = (lv * dq + (1 << (s - 1))) >> s
    else:
        out = (lv * dq) << (per - shift)
    return np.clip(out, -32768, 32767).astype(np.int32)


def sign_bit_hiding(level: np.ndarray, coef: np.ndarray, qp: int,
                    is_intra: bool, scan_idx: int,
                    scaling_lists: bool = False, bit_depth: int = 8) -> np.ndarray:
    """Adjust quantized levels so each eligible 4x4 CG's level-sum parity
    encodes the sign of its first nonzero coefficient (spec 7.4.9.11 decoder
    inference; encoder strategy follows HM xSignBitHidingHDQ / reference
    hmr_quant.c:61: flip the coefficient with the smallest rounding error).
    """
    n = level.shape[0]
    log2n = n.bit_length() - 1
    scan = T.coeff_scan(log2n, scan_idx)
    flat_l = level.reshape(-1).copy()
    flat_c = coef.reshape(-1)

    # rounding deltas (like reference deltaU) for cost of +-1 adjustments
    per, rem = qp // 6, qp % 6
    tshift = T.MAX_TR_DYNAMIC_RANGE - bit_depth - log2n
    qbits = T.QUANT_SHIFT + per + tshift
    qc = ((int(T.QUANT_SCALE[rem]) << 4)
          // _scaling(n, is_intra, scaling_lists)).reshape(-1)
    abs_c = np.abs(flat_c.astype(np.int64))
    delta_u = ((abs_c * qc - (np.abs(flat_l.astype(np.int64)) << qbits))
               >> (qbits - 8))

    ncg = (n * n) // 16
    for cg in range(ncg):
        idx = scan[cg * 16:(cg + 1) * 16]
        lv = flat_l[idx]
        nz = np.nonzero(lv)[0]
        if nz.size == 0:
            continue
        first, last = int(nz[0]), int(nz[-1])
        if last - first < T.SBH_THRESHOLD:
            continue
        sign_first = 1 if lv[first] < 0 else 0
        parity = int(np.sum(np.abs(lv))) & 1
        if parity == sign_first:
            continue
        # Flip parity with the cheapest +-1 change that cannot alter which
        # coefficient is "first nonzero" nor its sign:
        #   - |level| += 1 on any nonzero coeff is always safe;
        #   - |level| -= 1 is safe unless it zeroes the first coeff.
        # Pick by rounding error (delta_u): increase where the quantizer
        # rounded down the most, decrease where it rounded up the most.
        best_pos, best_cost, best_dir = -1, 1 << 62, 0
        for k in range(first, last + 1):
            j = int(idx[k])
            l = int(flat_l[j])
            if l == 0:
                continue
            # cost of increasing |l| by 1: we move away by (2^8 - delta_u)
            cost_up = (1 << 8) - int(delta_u[j])
            if cost_up < best_cost:
                best_pos, best_cost, best_dir = j, cost_up, +1
            if not (k == first and abs(l) == 1):
                cost_dn = (1 << 8) + int(delta_u[j])
                if cost_dn < best_cost:
                    best_pos, best_cost, best_dir = j, cost_dn, -1
        if best_pos >= 0:
            l = int(flat_l[best_pos])
            flat_l[best_pos] = l + best_dir * (1 if l > 0 else -1)
    return flat_l.reshape(n, n).astype(np.int32)
