"""Host (numpy) all-intra frame encoder at a fixed CU size: closed-loop
reconstruction in raster CTU order. The port's copy of
homerhevc_tpu/golden/intra_frame.py, which the JAX package runs for every
I frame its device programs do not serve (engine/pipeline.py routes them
here by configuration: CU32 / CU64 without intra_rdo, intra_rdo at CU16,
per-CTB QP maps with deblocking on).

Parity with reference: the intra path of SURVEY.md §3.4 (motion_intra,
hmr_motion_intra.c:1993; encode_intra_cu :973) with a fixed CU size
instead of the CU-tree RDO (hevc/intra_tree.py).
"""

from __future__ import annotations

import numpy as np

from homerhevc_tpu_torch.hevc import intra_pred as ip
from homerhevc_tpu_torch.hevc import tables as T
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.hevc.quantize import (dequantize, quantize,
                                               sign_bit_hiding)
from homerhevc_tpu_torch.hevc.syntax import FrameDesc, mpm_candidates
from homerhevc_tpu_torch.hevc.transform import (forward_transform,
                                                inverse_transform)


def _mode_bits_estimate(mode: int, mpm: list[int]) -> int:
    return 2 if mode in mpm else 6


def encode_intra_frame(ps: ParamSets, src_y: np.ndarray, src_u: np.ndarray,
                       src_v: np.ndarray, qp: int, cu_size: int = 32,
                       qp_map=None):
    """Encode one frame all-intra with fixed CU size (boundary CUs shrink).

    qp_map: optional (ctus_y, ctus_x) int array of per-CTB luma QPs
    (adaptive quantization; serialized as cu_qp_delta). `qp` stays the
    slice QP (the delta predictor chain's origin).

    Returns (FrameDesc, recon_y, recon_u, recon_v).
    """
    h, w = src_y.shape
    desc = FrameDesc.alloc(w, h)
    recon_y = np.zeros((h, w), np.int32)
    recon_u = np.zeros((h // 2, w // 2), np.int32)
    recon_v = np.zeros((h // 2, w // 2), np.int32)
    avail = ip.Availability(w, h, ps.ctu_size)
    sl = ps.scaling_list_enabled
    if qp_map is not None:
        desc.qp_map = np.full((h // 8, w // 8), qp, np.int8)

    def encode_cu(x0: int, y0: int, size: int) -> None:
        if x0 >= w or y0 >= h:
            return
        if x0 + size > w or y0 + size > h or size > cu_size:
            half = size // 2
            for dy, dx in ((0, 0), (0, half), (half, 0), (half, half)):
                encode_cu(x0 + dx, y0 + dy, half)
            return
        if qp_map is None:
            cu_qp = qp
        else:
            cu_qp = int(qp_map[y0 // ps.ctu_size, x0 // ps.ctu_size])
            desc.qp_map[y0 // 8:(y0 + size) // 8,
                        x0 // 8:(x0 + size) // 8] = cu_qp
        qp_c = T.chroma_qp(cu_qp + ps.cb_qp_offset)
        lam_sqrt = np.sqrt(T.rd_lambda(cu_qp, "I"))
        # ---- luma mode decision ------------------------------------------
        top, left = ip.build_reference_samples(recon_y, x0, y0, size, avail)
        src_blk = src_y[y0:y0 + size, x0:x0 + size].astype(np.int32)
        # MPM from already-decided neighbor modes
        lmode = amode = 1  # DC when unavailable
        if x0 > 0 and avail.available(x0, y0, x0 - 1, y0):
            lmode = int(desc.luma_mode[y0 // 4, (x0 - 1) // 4])
        if y0 > 0 and (y0 % ps.ctu_size) != 0:
            amode = int(desc.luma_mode[(y0 - 1) // 4, x0 // 4])
        mpm = mpm_candidates(lmode, amode)
        best_mode, best_cost, best_pred = 1, None, None
        for mode in range(35):
            ft, fl = ip.filter_reference_samples(top, left, size, mode, True)
            pred = ip.predict(ft, fl, size, mode, True)
            sad = int(np.abs(src_blk - pred).sum())
            cost = sad + int(lam_sqrt * _mode_bits_estimate(mode, mpm))
            if best_cost is None or cost < best_cost:
                best_mode, best_cost, best_pred = mode, cost, pred
        mode = best_mode
        pred = best_pred
        # ---- luma TU pipeline --------------------------------------------
        resid = src_blk - pred
        is_dst = size == 4
        coef = forward_transform(resid, is_dst)
        lvl = quantize(coef, cu_qp, True, sl)
        if ps.sign_hiding and np.any(lvl):
            scan_idx = T.intra_scan_idx(mode, size.bit_length() - 1, True)
            lvl = sign_bit_hiding(lvl, coef, cu_qp, True, scan_idx, sl)
        if np.any(lvl):
            deq = dequantize(lvl, cu_qp, True, sl)
            r = inverse_transform(deq, is_dst)
            rec = np.clip(pred + r, 0, 255)
        else:
            rec = pred
        recon_y[y0:y0 + size, x0:x0 + size] = rec
        # ---- chroma (DM mode) --------------------------------------------
        cx, cy, csz = x0 // 2, y0 // 2, size // 2
        for (plane_src, plane_rec, plane_coef) in (
                (src_u, recon_u, desc.coef_u), (src_v, recon_v, desc.coef_v)):
            ct, cl = ip.build_reference_samples(plane_rec, cx, cy, csz, avail,
                                                comp_shift=1)
            cpred = ip.predict(ct, cl, csz, mode, False)
            cres = plane_src[cy:cy + csz, cx:cx + csz].astype(np.int32) - cpred
            ccoef = forward_transform(cres, False)
            clvl = quantize(ccoef, qp_c, True, sl)
            if ps.sign_hiding and np.any(clvl):
                cscan = T.intra_scan_idx(mode, csz.bit_length() - 1, False)
                clvl = sign_bit_hiding(clvl, ccoef, qp_c, True, cscan, sl)
            if np.any(clvl):
                cdeq = dequantize(clvl, qp_c, True, sl)
                cr = inverse_transform(cdeq, False)
                crec = np.clip(cpred + cr, 0, 255)
            else:
                crec = cpred
            plane_rec[cy:cy + csz, cx:cx + csz] = crec
            plane_coef[cy:cy + csz, cx:cx + csz] = clvl.astype(np.int16)
        # ---- bookkeeping ---------------------------------------------------
        depth = ps.log2_ctu - (size.bit_length() - 1)
        desc.cu_depth[y0 // 8:(y0 + size) // 8, x0 // 8:(x0 + size) // 8] = depth
        desc.tr_depth[y0 // 8:(y0 + size) // 8, x0 // 8:(x0 + size) // 8] = 0
        desc.luma_mode[y0 // 4:(y0 + size) // 4, x0 // 4:(x0 + size) // 4] = mode
        desc.chroma_mode[y0 // 8:(y0 + size) // 8, x0 // 8:(x0 + size) // 8] = mode
        desc.coef_y[y0:y0 + size, x0:x0 + size] = lvl.astype(np.int16)

    ctu = ps.ctu_size
    for cy in range(0, h, ctu):
        for cx in range(0, w, ctu):
            encode_cu(cx, cy, ctu)
    return desc, recon_y, recon_u, recon_v
