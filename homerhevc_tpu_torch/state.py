"""The encoder's "weights": an encoder has no learned parameters; its
parameters are the constant tables and the reference picture.

tables_to_torch builds, from the host numpy sources, every table the
slice's device programs read, on one device. reference_from_numpy turns a
reconstructed picture (e.g. the JAX package's recon, as numpy) into the
port's device reference, so both packages can code the same P frame from
the same reference.
"""

from __future__ import annotations

import numpy as np
import torch

from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.hevc import tables as T
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.hevc.intra_pred import Availability
from homerhevc_tpu_torch.ops import intra as dip
from homerhevc_tpu_torch.ops import quant as dq
from homerhevc_tpu_torch.ops import transform as dt

# per-QP intra mode-cost constants (derived from the I-slice lambda)
BITS_MPM = np.asarray(
    [int(float(np.sqrt(T.rd_lambda(q, "I"))) * 2) for q in range(52)],
    np.int32)
BITS_REM = np.asarray(
    [int(float(np.sqrt(T.rd_lambda(q, "I"))) * 6) for q in range(52)],
    np.int32)


def diag_layout(ps: ParamSets, w: int, h: int, cu: int) -> dict:
    """Static wavefront geometry of the CU-`cu` intra encoder (numpy):
    diagonal d = gx + 2*gy holds the CUs (gx, gy) that are mutually
    independent; slot s = gy. Per (diagonal, slot): validity, left/above
    mode availability, the luma/chroma reference availability masks in
    substitution order, and the flat block index (invalid -> gh*gw)."""
    gw, gh = w // cu, h // cu
    avail = Availability(w, h, ps.ctu_size)
    ndiag = (gw - 1) + 2 * (gh - 1) + 1

    def masks_for(comp_shift):
        n = cu >> comp_shift
        nn2 = 2 * n
        m = np.zeros((gh, gw, 2 * nn2 + 1), bool)
        wC, hC = w >> comp_shift, h >> comp_shift
        for gy in range(gh):
            for gx in range(gw):
                x0, y0 = gx * n, gy * n
                for j in range(nn2):
                    yy, xx = y0 + nn2 - 1 - j, x0 - 1
                    m[gy, gx, j] = (yy < hC and xx >= 0 and avail.available(
                        x0 << comp_shift, y0 << comp_shift,
                        xx << comp_shift, yy << comp_shift))
                m[gy, gx, nn2] = (x0 > 0 and y0 > 0)
                for i in range(nn2):
                    xx, yy = x0 + i, y0 - 1
                    m[gy, gx, nn2 + 1 + i] = (
                        xx < wC and yy >= 0 and avail.available(
                            x0 << comp_shift, y0 << comp_shift,
                            xx << comp_shift, yy << comp_shift))
        return m
    mask_y, mask_c = masks_for(0), masks_for(1)
    # above-mode availability for MPM: inside the frame AND same CTU row
    gy_all = np.arange(gh)[:, None] * cu
    above_ok = np.broadcast_to((gy_all > 0) & (gy_all % ps.ctu_size != 0),
                               (gh, gw))
    sl = np.arange(gh)[None, :]
    dd = np.arange(ndiag)[:, None]
    d_gx = dd - 2 * sl                                  # (ndiag, gh)
    d_valid = (d_gx >= 0) & (d_gx < gw)
    gx_c = np.clip(d_gx, 0, gw - 1)
    gy_b = np.broadcast_to(sl, d_gx.shape)
    return {
        "ndiag": ndiag,
        "d_valid": d_valid,
        "d_has_left": d_valid & (d_gx > 0),
        "d_above_ok": np.where(d_valid, above_ok[gy_b, gx_c], False),
        "d_mask_y": np.where(d_valid[..., None], mask_y[gy_b, gx_c], False),
        "d_mask_c": np.where(d_valid[..., None], mask_c[gy_b, gx_c], False),
        "d_flat": np.where(d_valid, gy_b * gw + gx_c, gh * gw)
        .astype(np.int64),
    }


def tables_to_torch(ps: ParamSets, cfg: EncoderConfig,
                    device: torch.device, cu: int = 16) -> dict:
    """Every table the CU16 slice reads, as tensors on `device`."""
    dev = torch.device(device)
    sl = ps.scaling_list_enabled
    tab = {}
    for n in (4, 8, 16, 32):
        tab[f"dct{n}"] = dt._mats(n, False, dev)
    tab["dst4"] = dt._mats(4, True, dev)
    for n, luma in ((cu, True), (cu // 2, False)):
        tab[f"pred_w{n}_{int(luma)}"], tab[f"pred_s{n}_{int(luma)}"] = \
            dip.pred_weights_t(n, luma, dev)
    for n in (cu, cu // 2):
        for intra in (True, False):
            tab[f"qc6_{n}_{int(intra)}"] = dq.qc6(n, intra, sl, dev)
            tab[f"dq6_{n}_{int(intra)}"] = dq.dq6(n, intra, sl, dev)
    for name, arr in (("chroma_qp_map", T.CHROMA_QP_MAP),
                      ("lambda_me_x16", T.LAMBDA_ME_X16_TAB),
                      ("rd_lambda_p", T.RD_LAMBDA_P_TAB),
                      ("mvd_bits", T.MVD_BITS),
                      ("bits_mpm", BITS_MPM), ("bits_rem", BITS_REM)):
        tab[name] = torch.as_tensor(np.asarray(arr), device=dev)
    lay = diag_layout(ps, cfg.width, cfg.height, cu)
    for k, v in lay.items():
        tab[k] = v if k == "ndiag" else torch.as_tensor(v, device=dev)
    return tab


def reference_from_numpy(planes, device) -> tuple:
    """(ry, ru, rv) numpy-coercible planes -> uint8 tensors on `device`."""
    return tuple(torch.as_tensor(np.asarray(p).astype(np.uint8),
                                 device=torch.device(device))
                 for p in planes)
