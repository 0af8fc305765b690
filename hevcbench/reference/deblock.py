# Frozen copy of homerhevc_tpu_torch/hevc/deblock.py, lines 1-390, for the
# benchmark's plain reference decoder: later changes to the program
# do not move it. Imports point at the other copies beside it.
"""Host (numpy) HEVC deblocking filter (spec 8.7.2), the port's copy of
what its host intra and inter programs need from
homerhevc_tpu/golden/deblock.py: the luma and chroma filters over whole
planes, the boundary strengths of an inter and of an all-intra frame, and
the decoder-view QP map that deblocking reads under cu_qp_delta. The host twin of the device ops/deblock.py, which reads
the spec tables from here.

Operates on reconstruction planes given block-structure maps (TU size per
8x8 unit, per-unit QP, boundary strengths). Vertical edges of the whole
picture are filtered first, then horizontal edges on the vertically
filtered output (normative order).

Parity with reference: hmr_deblocking_filter.c (bs :138, luma decision
:275, luma filter :287, chroma :478, drivers :737/:827), vectorized per
edge line instead of per-CU loops.
"""

from __future__ import annotations

import numpy as np

from hevcbench.reference.syntax import MODE_INTRA
from hevcbench.reference.tables import chroma_qp

# beta' and tc' tables (spec Table 8-11)
BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
    58, 60, 62, 64,
], np.int32)
TC_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
    4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24,
], np.int32)


def _clip3(lo, hi, v):
    return np.minimum(np.maximum(v, lo), hi)


def _filter_luma_lines(p, q, beta, tc):
    """Filter a batch of edge line groups.

    p: (N, 4, 4) samples left/above of the edge, p[:, line, k] = p_k
       (p0 adjacent to the edge); q likewise.
    Returns new (p, q) and which lines were modified.
    Each group of 4 lines shares the on/off + strong/normal decision
    (computed from lines 0 and 3) per spec.
    """
    p = p.astype(np.int32)
    q = q.astype(np.int32)
    dp = np.abs(p[:, :, 2] - 2 * p[:, :, 1] + p[:, :, 0])   # (N,4) per line
    dq = np.abs(q[:, :, 2] - 2 * q[:, :, 1] + q[:, :, 0])
    dp0, dp3 = dp[:, 0], dp[:, 3]
    dq0, dq3 = dq[:, 0], dq[:, 3]
    d = dp0 + dq0 + dp3 + dq3
    on = d < beta

    def strong_cond(k):
        return ((2 * (dp[:, k] + dq[:, k]) < (beta >> 2))
                & (np.abs(p[:, k, 3] - p[:, k, 0])
                   + np.abs(q[:, k, 0] - q[:, k, 3]) < (beta >> 3))
                & (np.abs(p[:, k, 0] - q[:, k, 0]) < ((5 * tc + 1) >> 1)))
    strong = on & strong_cond(0) & strong_cond(3)
    normal = on & ~strong

    # ---- strong filter (clamped +-2tc) ----
    p0, p1, p2, p3 = p[:, :, 0], p[:, :, 1], p[:, :, 2], p[:, :, 3]
    q0, q1, q2, q3 = q[:, :, 0], q[:, :, 1], q[:, :, 2], q[:, :, 3]
    t2 = (2 * tc)[:, None]
    sp0 = _clip3(p0 - t2, p0 + t2, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = _clip3(p1 - t2, p1 + t2, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = _clip3(p2 - t2, p2 + t2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = _clip3(q0 - t2, q0 + t2, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3)
    sq1 = _clip3(q1 - t2, q1 + t2, (q2 + q1 + q0 + p0 + 2) >> 2)
    sq2 = _clip3(q2 - t2, q2 + t2, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3)

    # ---- normal filter ----
    tcn = tc[:, None]
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    do_line = np.abs(delta) < 10 * tcn           # per line
    dlt = _clip3(-tcn, tcn, delta)
    np0 = np.clip(p0 + dlt, 0, 255)
    nq0 = np.clip(q0 - dlt, 0, 255)
    side_thresh = ((beta + (beta >> 1)) >> 3)[:, None]
    dEp = (dp0 + dp3)[:, None] < side_thresh      # per group
    dEq = (dq0 + dq3)[:, None] < side_thresh
    tc2 = tcn >> 1
    dp1v = _clip3(-tc2, tc2, (((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1)
    np1 = np.clip(p1 + dp1v, 0, 255)
    dq1v = _clip3(-tc2, tc2, (((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1)
    nq1 = np.clip(q1 + dq1v, 0, 255)

    sN = strong[:, None]
    nN = normal[:, None] & do_line
    out_p = p.copy()
    out_q = q.copy()
    out_p[:, :, 0] = np.where(sN, sp0, np.where(nN, np0, p0))
    out_p[:, :, 1] = np.where(sN, sp1, np.where(nN & dEp, np1, p1))
    out_p[:, :, 2] = np.where(sN, sp2, p2)
    out_q[:, :, 0] = np.where(sN, sq0, np.where(nN, nq0, q0))
    out_q[:, :, 1] = np.where(sN, sq1, np.where(nN & dEq, nq1, q1))
    out_q[:, :, 2] = np.where(sN, sq2, q2)
    return out_p, out_q


def deblock_plane_luma(recon: np.ndarray, tu_size8: np.ndarray,
                       qp_map8: np.ndarray, bs_v: np.ndarray,
                       bs_h: np.ndarray, beta_offset: int = 0,
                       tc_offset: int = 0) -> np.ndarray:
    """Deblock the luma plane in place (returns a copy).

    tu_size8: (h8, w8) luma TU size covering each 8x8 unit.
    qp_map8:  (h8, w8) luma QP per unit.
    bs_v/bs_h: (h8, w8) boundary strength of the unit's LEFT/TOP edge
               (0 = no filtering; edges off the TU/PU grid must be 0).
    """
    out = recon.astype(np.int32).copy()
    h, w = out.shape
    h8, w8 = h // 8, w // 8

    def run_plain(vertical: bool):
        bs = bs_v if vertical else bs_h
        mask = bs > 0
        if vertical:
            mask[:, 0] = False
        else:
            mask[0, :] = False
        uys, uxs = np.nonzero(mask)
        if uys.size == 0:
            return
        uys2 = np.repeat(uys, 2)
        uxs2 = np.repeat(uxs, 2)
        goff = np.tile(np.array([0, 4]), uys.size)
        lines = goff[:, None] + np.arange(4)[None, :]
        taps = np.arange(4)
        if vertical:
            rows = (uys2 * 8)[:, None, None] + lines[:, :, None]       # (N,4,1)
            pc = (uxs2 * 8)[:, None, None] - 1 - taps[None, None, :]   # (N,1,4)
            qc = (uxs2 * 8)[:, None, None] + taps[None, None, :]
            p = out[rows, pc]
            q = out[rows, qc]
            qp = (qp_map8[uys2, uxs2] + qp_map8[uys2, uxs2 - 1] + 1) >> 1
        else:
            cols = (uxs2 * 8)[:, None, None] + lines[:, :, None]
            pr = (uys2 * 8)[:, None, None] - 1 - taps[None, None, :]
            qr = (uys2 * 8)[:, None, None] + taps[None, None, :]
            p = out[pr, cols]
            q = out[qr, cols]
            qp = (qp_map8[uys2, uxs2] + qp_map8[uys2 - 1, uxs2] + 1) >> 1
        bsa = bs[uys2, uxs2]
        beta = BETA_TABLE[_clip3(0, 51, qp + beta_offset * 2)]
        tc = TC_TABLE[_clip3(0, 53, qp + 2 * (bsa - 1) + tc_offset * 2)]
        np_, nq_ = _filter_luma_lines(p, q, beta, tc)
        if vertical:
            rows_b = np.broadcast_to(rows, (rows.shape[0], 4, 4))
            pc_b = np.broadcast_to(pc, (pc.shape[0], 4, 4))
            qc_b = np.broadcast_to(qc, (qc.shape[0], 4, 4))
            out[rows_b[..., :3], pc_b[..., :3]] = np_[..., :3]
            out[rows_b[..., :3], qc_b[..., :3]] = nq_[..., :3]
        else:
            cols_b = np.broadcast_to(cols, (cols.shape[0], 4, 4))
            pr_b = np.broadcast_to(pr, (pr.shape[0], 4, 4))
            qr_b = np.broadcast_to(qr, (qr.shape[0], 4, 4))
            out[pr_b[..., :3], cols_b[..., :3]] = np_[..., :3]
            out[qr_b[..., :3], cols_b[..., :3]] = nq_[..., :3]

    run_plain(True)
    run_plain(False)
    return out


def deblock_plane_chroma(recon: np.ndarray, qp_map8: np.ndarray,
                         bs_v: np.ndarray, bs_h: np.ndarray,
                         chroma_qp_offset: int = 0,
                         tc_offset: int = 0) -> np.ndarray:
    """Chroma deblocking (4:2:0): only BS==2 edges, on the chroma 8-grid
    (luma 16-grid). qp_map8/bs maps are LUMA 8x8-unit maps.

    recon: chroma plane (h/2, w/2).
    """
    out = recon.astype(np.int32).copy()
    ch, cw = out.shape

    def run(vertical: bool):
        bs = bs_v if vertical else bs_h
        # chroma edges where luma coordinate is a multiple of 16
        for cy in range(0, ch, 4):
            for cx in range(0, cw, 4):
                # edge at (cx, cy): left edge in luma at x=2*cx
                if vertical:
                    if cx == 0 or (2 * cx) % 16 != 0:
                        continue
                    uy, ux = (2 * cy) // 8, (2 * cx) // 8
                    if bs[uy, ux] < 2:
                        continue
                    qpl = (qp_map8[uy, ux] + qp_map8[uy, ux - 1] + 1) >> 1
                else:
                    if cy == 0 or (2 * cy) % 16 != 0:
                        continue
                    uy, ux = (2 * cy) // 8, (2 * cx) // 8
                    if bs[uy, ux] < 2:
                        continue
                    qpl = (qp_map8[uy, ux] + qp_map8[uy - 1, ux] + 1) >> 1
                qpc = chroma_qp(qpl + chroma_qp_offset)
                tidx = min(max(0, qpc + 2 + tc_offset * 2), 53)
                tc = int(TC_TABLE[tidx])
                if tc == 0:
                    continue
                for line in range(4):
                    if vertical:
                        p1 = out[cy + line, cx - 2]; p0 = out[cy + line, cx - 1]
                        q0 = out[cy + line, cx]; q1 = out[cy + line, cx + 1]
                    else:
                        p1 = out[cy - 2, cx + line]; p0 = out[cy - 1, cx + line]
                        q0 = out[cy, cx + line]; q1 = out[cy + 1, cx + line]
                    delta = min(max((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc), tc)
                    np0 = min(max(p0 + delta, 0), 255)
                    nq0 = min(max(q0 - delta, 0), 255)
                    if vertical:
                        out[cy + line, cx - 1] = np0
                        out[cy + line, cx] = nq0
                    else:
                        out[cy - 1, cx + line] = np0
                        out[cy, cx + line] = nq0

    run(True)
    run(False)
    return out


def inter_bs_maps(desc, tu_size8: np.ndarray):
    """Boundary-strength maps for a P frame (spec 8.7.2.4): BS=2 when either
    side is intra; else BS=1 when either side's TU has nonzero luma levels or
    the MVs differ by >= 1 pel (4 quarter-pels); else 0. Edges only on the
    8-grid at TU/PU boundaries (uniform grid: TU == PU)."""
    h8, w8 = tu_size8.shape
    bs_v = np.zeros((h8, w8), np.int32)
    bs_h = np.zeros((h8, w8), np.int32)
    # per-unit: does the TU covering this unit have nonzero luma levels?
    nz = np.zeros((h8, w8), bool)
    for uy in range(h8):
        for ux in range(w8):
            ts = int(tu_size8[uy, ux])
            x0 = (ux * 8 // ts) * ts
            y0 = (uy * 8 // ts) * ts
            nz[uy, ux] = bool(desc.coef_y[y0:y0 + ts, x0:x0 + ts].any())
    intra = desc.pred_mode == MODE_INTRA
    mv = desc.mv
    mv1 = desc.mv_l1   # B frames; lists pair by reference picture
    dirs = desc.inter_dir
    if dirs is None:
        dirs = np.full(intra.shape, 3 if mv1 is not None else 1, np.uint8)

    def bs_between(uy, ux, vy, vx, tu_edge=True):
        if intra[uy, ux] or intra[vy, vx]:
            return 2
        # the nonzero-coefficient rule applies only to TRANSFORM block
        # edges (spec 8.7.2.4); a PU-only edge inside a TU uses just the
        # motion rules below
        if tu_edge and (nz[uy, ux] or nz[vy, vx]):
            return 1
        # spec 8.7.2.4 motion mismatch: different number of MVs -> 1;
        # else compare per list (the two lists reference distinct
        # pictures here, so vectors pair by list)
        da, db = int(dirs[uy, ux]), int(dirs[vy, vx])
        if bin(da).count("1") != bin(db).count("1") or da != db:
            return 1
        # multi-reference: different reference pictures -> BS 1
        if desc.ref_idx is not None and (
                int(desc.ref_idx[uy, ux]) != int(desc.ref_idx[vy, vx])):
            return 1
        if (da & 1) and (
                abs(int(mv[uy, ux, 0]) - int(mv[vy, vx, 0])) >= 4
                or abs(int(mv[uy, ux, 1]) - int(mv[vy, vx, 1])) >= 4):
            return 1
        if (da & 2) and mv1 is not None and (
                abs(int(mv1[uy, ux, 0]) - int(mv1[vy, vx, 0])) >= 4
                or abs(int(mv1[uy, ux, 1]) - int(mv1[vy, vx, 1])) >= 4):
            return 1
        return 0

    # PU boundaries (spec filterEdgeFlag includes prediction-block edges):
    # rectangular CUs carry an internal PU edge on the 8-grid that is not
    # a TU edge; mark those units so the loop below evaluates them
    pu_edge_v = np.zeros((h8, w8), bool)
    pu_edge_h = np.zeros((h8, w8), bool)
    if desc.inter_part is not None and desc.inter_part.any():
        for uy in range(h8):
            for ux in range(w8):
                part = int(desc.inter_part[uy, ux])
                if not part:
                    continue
                cu_n = 16 >> 0  # rect PUs are CU16-level in this encoder
                x0 = (ux * 8 // cu_n) * cu_n
                y0 = (uy * 8 // cu_n) * cu_n
                if part == 1 and uy * 8 == y0 + cu_n // 2:
                    pu_edge_h[uy, ux] = True
                if part == 2 and ux * 8 == x0 + cu_n // 2:
                    pu_edge_v[uy, ux] = True

    for uy in range(h8):
        for ux in range(w8):
            ts = int(tu_size8[uy, ux])
            if ux > 0:
                if (ux * 8) % ts == 0:
                    bs_v[uy, ux] = bs_between(uy, ux, uy, ux - 1)
                elif pu_edge_v[uy, ux]:
                    bs_v[uy, ux] = bs_between(uy, ux, uy, ux - 1,
                                              tu_edge=False)
            if uy > 0:
                if (uy * 8) % ts == 0:
                    bs_h[uy, ux] = bs_between(uy, ux, uy - 1, ux)
                elif pu_edge_h[uy, ux]:
                    bs_h[uy, ux] = bs_between(uy, ux, uy - 1, ux,
                                              tu_edge=False)
    return bs_v, bs_h


def intra_bs_maps(tu_size8: np.ndarray):
    """Boundary-strength maps for an all-intra frame: BS=2 on every TU
    boundary lying on the 8-grid; 0 elsewhere."""
    h8, w8 = tu_size8.shape
    bs_v = np.zeros((h8, w8), np.int32)
    bs_h = np.zeros((h8, w8), np.int32)
    for uy in range(h8):
        for ux in range(w8):
            ts = int(tu_size8[uy, ux])
            if ux > 0 and (ux * 8) % ts == 0:
                bs_v[uy, ux] = 2
            if uy > 0 and (uy * 8) % ts == 0:
                bs_h[uy, ux] = 2
    return bs_v, bs_h


def decoder_qp_map8(desc, ps, slice_qp: int, wpp: bool = False):
    """Decoder-view per-8x8 luma QP map for deblocking under cu_qp_delta.

    Replays the decoder's QP derivation (spec 8.6.1, QG = CTB): CUs in
    z-order; a CU's QP is the QG's predictor until the QG's first
    residual-coding CU signals the delta (desc.qp_map value), then the
    signalled QP for the rest of the QG. qPY_PREV chains across QGs in
    decode order; under WPP it resets to the slice QP at each CTB row.

    With desc.qp_map None (flag off) the map is flat slice_qp.
    """
    h8, w8 = desc.cu_depth.shape
    out = np.full((h8, w8), slice_qp, np.int32)
    if desc.qp_map is None:
        return out
    w, h = desc.width, desc.height
    ctu = ps.ctu_size
    state = {"pred": slice_qp, "qg": slice_qp, "coded": False}

    def region_cbf(x0, y0, size):
        return (np.any(desc.coef_y[y0:y0 + size, x0:x0 + size])
                or np.any(desc.coef_u[y0 // 2:(y0 + size) // 2,
                                      x0 // 2:(x0 + size) // 2])
                or np.any(desc.coef_v[y0 // 2:(y0 + size) // 2,
                                      x0 // 2:(x0 + size) // 2]))

    def walk(x0, y0, log2, depth):
        size = 1 << log2
        inside = x0 + size <= w and y0 + size <= h
        if x0 >= w or y0 >= h:
            return
        split = (int(desc.cu_depth[y0 // 8, x0 // 8]) > depth
                 if inside else log2 > ps.log2_min_cb)
        if split:
            half = size >> 1
            for dy, dx in ((0, 0), (0, half), (half, 0), (half, half)):
                walk(x0 + dx, y0 + dy, log2 - 1, depth + 1)
            return
        if not state["coded"] and region_cbf(x0, y0, size):
            state["qg"] = int(desc.qp_map[y0 // 8, x0 // 8])
            state["coded"] = True
        out[y0 // 8:(y0 + size) // 8, x0 // 8:(x0 + size) // 8] = state["qg"]

    log2_ctu = ps.log2_ctu
    for cy in range(0, h, ctu):
        if wpp:
            state["pred"] = slice_qp
        for cx in range(0, w, ctu):
            state["qg"] = state["pred"]
            state["coded"] = False
            walk(cx, cy, log2_ctu, 0)
            state["pred"] = state["qg"]
    return out
