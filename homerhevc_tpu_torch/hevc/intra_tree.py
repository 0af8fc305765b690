"""Host (numpy) intra CU-tree RDO, the port's copy of
homerhevc_tpu/golden/intra_tree.py: the rate constants and TreeDecision its
device tree encoder (engine/intra_tree_encoder.py) reads, and the two host
passes the JAX package runs for every tree I frame its device program does
not serve (RD_FULL, per-CTB QP maps): engine/pipeline.py routes them here
by configuration.

  pass 1 (decide):  OPEN-LOOP — reference samples come from the SOURCE
                    frame (with the z-scan availability mask the decoder
                    enforces); every block at every depth is independent.
                    full_rd adds NxN 4x4 PUs, TU splits and the
                    five-candidate chroma RDO.
  pass 2 (encode):  CLOSED-LOOP — the decided tree and modes are fixed; one
                    prediction per block in decode order.

Per candidate CU the tree costs
  SSD(recon, src) + lambda * (coef_bits + mode_bits + overhead)
with coef_bits = A*nnz + B*sum|lvl| + C per TU that has nonzero levels.
All integer, so the decision arithmetic stays exact in int32.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from homerhevc_tpu_torch.hevc import intra_pred as ip
from homerhevc_tpu_torch.hevc import tables as T
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.hevc.quantize import (dequantize, quantize,
                                               sign_bit_hiding)
from homerhevc_tpu_torch.hevc.syntax import FrameDesc, mpm_candidates
from homerhevc_tpu_torch.hevc.transform import (forward_transform,
                                                inverse_transform)

# coefficient-rate model bits(nnz, sum|lvl|) ~= A*nnz + B*sum + C per TU
# with nonzero coefficients; fitted against CabacCounter-measured residual
# bits on textured content at QP 27-37 (tests/test_intra_tree.py keeps the
# fit honest within a stated tolerance). All INTEGER so golden and device
# cost arithmetic are bit-identical (device runs int32).
COEF_BITS_NNZ = 2
COEF_BITS_SUM = 1
COEF_BITS_TU = 4
# per-CU overhead bins: cbf luma + 2x chroma cbf + part/split context
CU_OVERHEAD_BITS = 5
MODE_BITS_MPM = 2
MODE_BITS_REM = 6
SPLIT_BITS = 4


@dataclasses.dataclass
class TreeDecision:
    """Chosen CU quadtree + per-CU modes at 8x8-unit granularity."""
    depth8: np.ndarray       # (H/8, W/8) uint8: quadtree depth of the CU
    mode8: np.ndarray        # (H/8, W/8) uint8: luma mode of the CU
    chroma8: np.ndarray      # (H/8, W/8) uint8: chroma mode of the CU
    # RD_FULL extensions (None under the fast decision):
    nxn8: np.ndarray = None      # (H/8, W/8) bool: 8x8 CU uses NxN
    mode4: np.ndarray = None     # (H/4, W/4) uint8: per-4x4 PU modes (NxN)
    tr8: np.ndarray = None       # (H/8, W/8) uint8: TU split depth (0/1)


def _coef_cost_bits(lvl: np.ndarray) -> int:
    nnz = int(np.count_nonzero(lvl))
    if nnz == 0:
        return 0
    return (COEF_BITS_NNZ * nnz + COEF_BITS_SUM * int(np.abs(lvl).sum())
            + COEF_BITS_TU)


def _tu_rd(src_blk, pred, qp, sl, sign_hiding, scan_idx, is_dst):
    """T->Q->(SBH)->IQ->IT->recon; returns (ssd, coef_bits, lvl, rec)."""
    resid = src_blk - pred
    coef = forward_transform(resid, is_dst)
    lvl = quantize(coef, qp, True, sl)
    if sign_hiding and np.any(lvl):
        lvl = sign_bit_hiding(lvl, coef, qp, True, scan_idx, sl)
    if np.any(lvl):
        deq = dequantize(lvl, qp, True, sl)
        rec = np.clip(pred + inverse_transform(deq, is_dst), 0, 255)
    else:
        rec = pred
    d = (rec - src_blk).astype(np.int64)
    return int((d * d).sum()), _coef_cost_bits(lvl), lvl, rec


def decide_intra_tree(ps: ParamSets, src_y: np.ndarray, src_u: np.ndarray,
                      src_v: np.ndarray, qp: int, ctb: int = 32,
                      min_cu: int = 8, full_rd: bool = False) -> TreeDecision:
    """Open-loop decision pass. All reference samples come from the source
    planes (masked by real decoder availability), so every block at every
    depth is independent — the device twin batches this wholesale."""
    h, w = src_y.shape
    avail = ip.Availability(w, h, ps.ctu_size)
    qp_c = T.chroma_qp(qp + ps.cb_qp_offset)
    lam = T.lambda_int(qp, "I")
    bits_mpm, bits_rem = T.intra_mode_bits(qp)
    sl = ps.scaling_list_enabled
    h8, w8 = h // 8, w // 8
    depth_levels = []
    s = ctb
    while s >= min_cu:
        depth_levels.append(s)
        s //= 2
    base_depth = ps.log2_ctu - (ctb.bit_length() - 1)

    # ---- per-depth mode choice + RD cost (open loop) ----------------------
    # pre-modes by pure SAD feed the MPM of the final mode decision (both
    # passes batch on device; sequential here only for clarity)
    costs = []       # per depth: (gh, gw) float
    modes = []       # per depth: (gh, gw) uint8
    for size in depth_levels:
        gh, gw = h // size, w // size
        cost_d = np.zeros((gh, gw), np.int64)
        mode_d = np.zeros((gh, gw), np.uint8)
        sad_all = np.zeros((gh, gw, 35), np.int64)
        pre = np.zeros((gh, gw), np.int32)
        for gy in range(gh):
            for gx in range(gw):
                x0, y0 = gx * size, gy * size
                top, left = ip.build_reference_samples(
                    src_y, x0, y0, size, avail)
                src_blk = src_y[y0:y0 + size, x0:x0 + size].astype(np.int32)
                for mode in range(35):
                    ft, fl = ip.filter_reference_samples(
                        top, left, size, mode, True)
                    pred = ip.predict(ft, fl, size, mode, True)
                    sad_all[gy, gx, mode] = np.abs(src_blk - pred).sum()
                pre[gy, gx] = int(np.argmin(sad_all[gy, gx]))
        for gy in range(gh):
            for gx in range(gw):
                x0, y0 = gx * size, gy * size
                lmode = int(pre[gy, gx - 1]) if gx > 0 else 1
                amode = int(pre[gy - 1, gx]) \
                    if (gy > 0 and (y0 % ps.ctu_size) != 0) else 1
                mpm = mpm_candidates(lmode, amode)
                mbits = np.where(np.isin(np.arange(35), mpm),
                                 bits_mpm, bits_rem).astype(np.int64)
                mode = int(np.argmin(sad_all[gy, gx] + mbits))
                mode_d[gy, gx] = mode
                # RD cost of this CU at this depth (open-loop recon)
                top, left = ip.build_reference_samples(
                    src_y, x0, y0, size, avail)
                ft, fl = ip.filter_reference_samples(top, left, size, mode,
                                                     True)
                pred = ip.predict(ft, fl, size, mode, True)
                src_blk = src_y[y0:y0 + size, x0:x0 + size].astype(np.int32)
                scan_idx = T.intra_scan_idx(mode, size.bit_length() - 1, True)
                ssd, cbits, _, _ = _tu_rd(src_blk, pred, qp, sl,
                                          ps.sign_hiding, scan_idx,
                                          size == 4)
                # chroma at DM mode rides along (decision-level estimate)
                csz = size // 2
                cx, cy = x0 // 2, y0 // 2
                for plane in (src_u, src_v):
                    ct, cl = ip.build_reference_samples(
                        plane, cx, cy, csz, avail, comp_shift=1)
                    cpred = ip.predict(ct, cl, csz, mode, False)
                    cblk = plane[cy:cy + csz, cx:cx + csz].astype(np.int32)
                    cscan = T.intra_scan_idx(mode, csz.bit_length() - 1,
                                             False)
                    cssd, ccbits, _, _ = _tu_rd(cblk, cpred, qp_c, sl,
                                                ps.sign_hiding, cscan, False)
                    ssd += cssd
                    cbits += ccbits
                mode_bits = MODE_BITS_MPM if mode in mpm else MODE_BITS_REM
                cost_d[gy, gx] = ssd + lam * (cbits + mode_bits
                                              + CU_OVERHEAD_BITS)
                assert cost_d[gy, gx] < (1 << 31), "int32 cost overflow"
        costs.append(cost_d)
        modes.append(mode_d)

    # ---- RD_FULL refinements: NxN 4x4 PUs + TU splits (luma-driven) -------
    # reference analog: NxN partition evaluation (hmr_motion_intra.c
    # encode_intra :1731 2Nx2N|NxNx4) and the TU-tree loop (:1443-1586).
    nxn_blk = None
    tr_flags = [None] * len(depth_levels)
    mode4 = None
    if full_rd:
        def luma_cost(x0, y0, size, mode):
            top, left = ip.build_reference_samples(src_y, x0, y0, size,
                                                   avail)
            ft, fl = ip.filter_reference_samples(top, left, size, mode, True)
            pred = ip.predict(ft, fl, size, mode, True)
            blk = src_y[y0:y0 + size, x0:x0 + size].astype(np.int32)
            scan = T.intra_scan_idx(mode, size.bit_length() - 1, True)
            ssd, cbits, _, _ = _tu_rd(blk, pred, qp, sl, ps.sign_hiding,
                                      scan, size == 4)
            return ssd + lam * cbits

        # 4x4 mode search (luma only; the NxN chroma rides at the 8 level)
        gh4, gw4 = h // 4, w // 4
        cost4 = np.zeros((gh4, gw4), np.int64)
        mode4 = np.zeros((gh4, gw4), np.uint8)
        for gy in range(gh4):
            for gx in range(gw4):
                x0, y0 = gx * 4, gy * 4
                top, left = ip.build_reference_samples(src_y, x0, y0, 4,
                                                       avail)
                blk = src_y[y0:y0 + 4, x0:x0 + 4].astype(np.int32)
                best = (1 << 62, 1)
                for mode in range(35):
                    ft, fl = ip.filter_reference_samples(top, left, 4,
                                                         mode, True)
                    pred = ip.predict(ft, fl, 4, mode, True)
                    sad = int(np.abs(blk - pred).sum())
                    if sad < best[0]:
                        best = (sad, mode)
                mode4[gy, gx] = best[1]
                cost4[gy, gx] = luma_cost(x0, y0, 4, best[1]) \
                    + lam * MODE_BITS_REM
        i8 = depth_levels.index(8)
        gh8, gw8 = h // 8, w // 8
        sum4 = (cost4[0::2, 0::2] + cost4[0::2, 1::2]
                + cost4[1::2, 0::2] + cost4[1::2, 1::2])
        nxn_blk = np.zeros((gh8, gw8), bool)
        for gy in range(gh8):
            for gx in range(gw8):
                l8 = luma_cost(gx * 8, gy * 8, 8, int(modes[i8][gy, gx]))
                gain = int(sum4[gy, gx]) + lam * 1 - l8
                if gain < 0:
                    nxn_blk[gy, gx] = True
                    costs[i8][gy, gx] += gain
        # TU split (depth 1) for 16/32 CUs: sub-TU prediction with the
        # CU's mode, open loop; chroma retiling cost difference ignored
        for di, size in enumerate(depth_levels):
            if size < 16:
                continue
            ghd, gwd = h // size, w // size
            fl = np.zeros((ghd, gwd), bool)
            half = size // 2
            for gy in range(ghd):
                for gx in range(gwd):
                    m = int(modes[di][gy, gx])
                    x0, y0 = gx * size, gy * size
                    c0 = luma_cost(x0, y0, size, m)
                    c1 = sum(luma_cost(x0 + dx, y0 + dy, half, m)
                             for dy, dx in ((0, 0), (0, half), (half, 0),
                                            (half, half)))
                    if c1 + lam * SPLIT_BITS < c0:
                        fl[gy, gx] = True
                        costs[di][gy, gx] += c1 + lam * SPLIT_BITS - c0
            tr_flags[di] = fl

    # ---- bottom-up consolidation (parent vs 4 children + split bits) ------
    # reference analog: consolidate_prediction_info (hmr_motion_inter.c:3372)
    nd = len(depth_levels)
    # default to the deepest level so any area not covered by a full CTB
    # (padded geometries only) still has a valid mode
    min_sz = depth_levels[-1]
    r = min_sz // 8
    depth8 = np.full((h8, w8), base_depth + nd - 1, np.uint8)
    mode8 = np.repeat(np.repeat(modes[-1], r, 0), r, 1)[:h8, :w8].copy()
    # best[d] = (gh, gw) best achievable cost for the subtree rooted at a
    # depth-d block, filled leaf-up
    best = [None] * nd
    best[nd - 1] = costs[nd - 1].copy()
    for d in range(nd - 2, -1, -1):
        ch = best[d + 1]
        csum = (ch[0::2, 0::2] + ch[0::2, 1::2]
                + ch[1::2, 0::2] + ch[1::2, 1::2]) + lam * SPLIT_BITS
        best[d] = np.minimum(costs[d], csum)
    nxn8 = np.zeros((h8, w8), bool) if full_rd else None
    tr8 = np.zeros((h8, w8), np.uint8) if full_rd else None

    # top-down realization of the argmin tree
    def realize(d, gy, gx):
        size = depth_levels[d]
        y0, x0 = gy * size, gx * size
        ch_cost = 1 << 62
        if d + 1 < nd:
            ch = best[d + 1]
            ch_cost = (ch[2 * gy, 2 * gx] + ch[2 * gy, 2 * gx + 1]
                       + ch[2 * gy + 1, 2 * gx]
                       + ch[2 * gy + 1, 2 * gx + 1]) + lam * SPLIT_BITS
        if costs[d][gy, gx] <= ch_cost:
            u0, u1 = y0 // 8, (y0 + size) // 8
            v0, v1 = x0 // 8, (x0 + size) // 8
            depth8[u0:u1, v0:v1] = base_depth + d
            mode8[u0:u1, v0:v1] = modes[d][gy, gx]
            if full_rd:
                if size == 8 and nxn_blk is not None and nxn_blk[gy, gx]:
                    nxn8[u0:u1, v0:v1] = True
                if tr_flags[d] is not None and tr_flags[d][gy, gx]:
                    tr8[u0:u1, v0:v1] = 1
        else:
            for dy in (0, 1):
                for dx in (0, 1):
                    realize(d + 1, 2 * gy + dy, 2 * gx + dx)
    for gy in range(h // ctb):
        for gx in range(w // ctb):
            realize(0, gy, gx)
    chroma8 = mode8.copy()
    if full_rd:
        # ---- chroma-mode RDO over the realized tree -----------------------
        # 5-candidate list {planar, vertical, horizontal, DC, DM} — the
        # reference's create_chroma_dir_list (hmr_motion_intra_chroma.c:
        # 92-110); open-loop cost like the luma decision
        seen = np.zeros((h8, w8), bool)
        for uy in range(h8):
            for ux in range(w8):
                if seen[uy, ux]:
                    continue
                size = ctb >> (int(depth8[uy, ux]) - base_depth)
                if (uy * 8) % size or (ux * 8) % size:
                    continue
                seen[uy:(uy * 8 + size) // 8, ux:(ux * 8 + size) // 8] = True
                dm = int(mode4[(uy * 8) // 4, (ux * 8) // 4]) \
                    if (nxn8 is not None and nxn8[uy, ux]
                        and mode4 is not None) else int(mode8[uy, ux])
                csz = size // 2
                cx, cy = ux * 8 // 2, uy * 8 // 2
                # candidate modes: DM first, then {planar, ver, hor, DC}
                # with luma-equal entries substituted by 34 (the decoder's
                # list construction rule)
                cand_modes = [dm] + [34 if c == dm else c
                                     for c in (0, 26, 10, 1)]
                bestc = None
                for k, cand in enumerate(cand_modes):
                    cost = 0
                    for plane in (src_u, src_v):
                        ct, cl = ip.build_reference_samples(
                            plane, cx, cy, csz, avail, comp_shift=1)
                        cpred = ip.predict(ct, cl, csz, cand, False)
                        cblk = plane[cy:cy + csz,
                                     cx:cx + csz].astype(np.int32)
                        cscan = T.intra_scan_idx(cand,
                                                 csz.bit_length() - 1,
                                                 False)
                        cssd, ccb, _, _ = _tu_rd(cblk, cpred, qp_c, sl,
                                                 ps.sign_hiding, cscan,
                                                 False)
                        cost += cssd + lam * ccb
                    cost += lam * (1 if k == 0 else 3)
                    if bestc is None or cost < bestc[0]:
                        bestc = (cost, cand)
                chroma8[uy:(uy * 8 + size) // 8,
                        ux:(ux * 8 + size) // 8] = bestc[1]
    return TreeDecision(depth8=depth8, mode8=mode8, chroma8=chroma8,
                        nxn8=nxn8, mode4=mode4, tr8=tr8)


def encode_intra_tree_frame(ps: ParamSets, src_y, src_u, src_v, qp: int,
                            dec: TreeDecision, ctb: int = 32):
    """Closed-loop encode honoring a decided tree: the golden oracle the
    device wavefront (pass 2) must match bit-exactly. Structure follows
    golden/intra_frame.py but sizes/modes are read from the decision."""
    h, w = src_y.shape
    desc = FrameDesc.alloc(w, h)
    recon_y = np.zeros((h, w), np.int32)
    recon_u = np.zeros((h // 2, w // 2), np.int32)
    recon_v = np.zeros((h // 2, w // 2), np.int32)
    avail = ip.Availability(w, h, ps.ctu_size)
    qp_c = T.chroma_qp(qp + ps.cb_qp_offset)
    sl = ps.scaling_list_enabled
    base_depth = ps.log2_ctu - (ctb.bit_length() - 1)

    def encode_cu(x0, y0, size, depth):
        if x0 >= w or y0 >= h:
            return
        want_depth = int(dec.depth8[y0 // 8, x0 // 8])
        if x0 + size > w or y0 + size > h or depth < want_depth:
            half = size // 2
            for dy, dx in ((0, 0), (0, half), (half, 0), (half, half)):
                encode_cu(x0 + dx, y0 + dy, half, depth + 1)
            return
        mode = int(dec.mode8[y0 // 8, x0 // 8])
        nxn = bool(dec.nxn8 is not None and size == 8
                   and dec.nxn8[y0 // 8, x0 // 8])
        tr_split = bool(dec.tr8 is not None and size >= 16
                        and dec.tr8[y0 // 8, x0 // 8])

        def code_luma_tu(tx, ty, n, m):
            top, left = ip.build_reference_samples(recon_y, tx, ty, n,
                                                   avail)
            ft, fl = ip.filter_reference_samples(top, left, n, m, True)
            pred = ip.predict(ft, fl, n, m, True)
            blk = src_y[ty:ty + n, tx:tx + n].astype(np.int32)
            scan = T.intra_scan_idx(m, n.bit_length() - 1, True)
            _, _, lvl, rec = _tu_rd(blk, pred, qp, sl, ps.sign_hiding,
                                    scan, n == 4)
            recon_y[ty:ty + n, tx:tx + n] = rec
            desc.coef_y[ty:ty + n, tx:tx + n] = lvl.astype(np.int16)

        if nxn:
            # four 4x4 PUs (own modes), each its own TU (intra_split
            # forces the TU split at depth 0); z-order = decode order so
            # each PU predicts from already-reconstructed neighbours
            for dy, dx in ((0, 0), (0, 4), (4, 0), (4, 4)):
                pm = int(dec.mode4[(y0 + dy) // 4, (x0 + dx) // 4])
                code_luma_tu(x0 + dx, y0 + dy, 4, pm)
                desc.luma_mode[(y0 + dy) // 4, (x0 + dx) // 4] = pm
        elif tr_split:
            half = size // 2
            for dy, dx in ((0, 0), (0, half), (half, 0), (half, half)):
                code_luma_tu(x0 + dx, y0 + dy, half, mode)
        else:
            code_luma_tu(x0, y0, size, mode)
        cmode = int(dec.chroma8[y0 // 8, x0 // 8])
        cx, cy, csz = x0 // 2, y0 // 2, size // 2
        # chroma TU tiling follows the luma tree: tr_split retiles the
        # chroma CB into four quadrant TUs, each predicted sequentially
        tu_c = csz // 2 if tr_split else csz
        for plane_src, plane_rec, plane_coef in (
                (src_u, recon_u, desc.coef_u), (src_v, recon_v, desc.coef_v)):
            for qy in range(0, csz, tu_c):
                for qx in range(0, csz, tu_c):
                    ct, cl = ip.build_reference_samples(
                        plane_rec, cx + qx, cy + qy, tu_c, avail,
                        comp_shift=1)
                    cpred = ip.predict(ct, cl, tu_c, cmode, False)
                    cblk = plane_src[cy + qy:cy + qy + tu_c,
                                     cx + qx:cx + qx + tu_c] \
                        .astype(np.int32)
                    cscan = T.intra_scan_idx(cmode, tu_c.bit_length() - 1,
                                             False)
                    _, _, clvl, crec = _tu_rd(cblk, cpred, qp_c, sl,
                                              ps.sign_hiding, cscan, False)
                    plane_rec[cy + qy:cy + qy + tu_c,
                              cx + qx:cx + qx + tu_c] = crec
                    plane_coef[cy + qy:cy + qy + tu_c,
                               cx + qx:cx + qx + tu_c] = \
                        clvl.astype(np.int16)
        u0, u1 = y0 // 8, (y0 + size) // 8
        v0, v1 = x0 // 8, (x0 + size) // 8
        desc.cu_depth[u0:u1, v0:v1] = ps.log2_ctu - (size.bit_length() - 1)
        desc.tr_depth[u0:u1, v0:v1] = 1 if tr_split else 0
        desc.part_nxn[u0:u1, v0:v1] = nxn
        if not nxn:
            desc.luma_mode[y0 // 4:(y0 + size) // 4,
                           x0 // 4:(x0 + size) // 4] = mode
        desc.chroma_mode[u0:u1, v0:v1] = cmode

    for cy in range(0, h, ps.ctu_size):
        for cx in range(0, w, ps.ctu_size):
            encode_cu(cx, cy, ps.ctu_size, 0)
    return desc, recon_y, recon_u, recon_v
