# Frozen copy of homerhevc_tpu_torch/hevc/inter.py, lines 1-511, for the
# benchmark's plain reference decoder: later changes to the program
# do not move it. Imports point at the other copies beside it.
"""Inter prediction normative derivations: merge candidate list and AMVP
(spec 8.5.3.2), specialized for P slices, 2Nx2N PUs, single reference,
sps_temporal_mvp off (matching this encoder's SPS).

Parity with reference: hmr_motion_inter.c (get_merge_mvp_candidates :1937,
get_amvp_candidates :2342). Both the encoder decisions and the serializer
use these, so encoder assumptions always match what a decoder derives.
"""

from __future__ import annotations

import numpy as np

MERGE_MAX = 5


class MotionField:
    """Per-8x8-unit motion info for one frame: mv (quarter-pel), ref_idx
    (-1 = unavailable/intra). For B frames a second list (mv1/ref1) may be
    populated; this build's B path codes every inter CU bi-predicted, so
    AMVP derivation per list never hits the cross-list POC-scaling branch
    (spec 8.5.3.2.6 step 2) — each neighbour always carries same-list,
    same-ref motion."""

    def __init__(self, h8: int, w8: int):
        self.mv = np.zeros((h8, w8, 2), np.int32)
        self.ref = np.full((h8, w8), -1, np.int32)
        self.mv1 = None   # (h8, w8, 2) when bi
        self.ref1 = None

    def at(self, x: int, y: int):
        """L0 motion at luma pixel (x, y); None if outside/intra."""
        h8, w8 = self.ref.shape
        ux, uy = x >> 3, y >> 3
        if x < 0 or y < 0 or ux >= w8 or uy >= h8:
            return None
        if self.ref[uy, ux] < 0:
            return None
        return (int(self.mv[uy, ux, 0]), int(self.mv[uy, ux, 1]),
                int(self.ref[uy, ux]))

    def at_bi(self, x: int, y: int):
        """Full (L0, L1) motion; None if outside/intra."""
        h8, w8 = self.ref.shape
        ux, uy = x >> 3, y >> 3
        if x < 0 or y < 0 or ux >= w8 or uy >= h8:
            return None
        if self.ref[uy, ux] < 0:
            return None
        return (int(self.mv[uy, ux, 0]), int(self.mv[uy, ux, 1]),
                int(self.mv1[uy, ux, 0]), int(self.mv1[uy, ux, 1]))

    def l1_view(self) -> "MotionField":
        """A MotionField presenting list 1 as the primary list (for the
        shared per-list AMVP derivation)."""
        v = MotionField.__new__(MotionField)
        v.mv = self.mv1
        v.ref = self.ref1 if self.ref1 is not None else self.ref
        v.mv1 = None
        v.ref1 = None
        return v


def _coded_before(x: int, y: int, cur_x: int, cur_y: int, ctu: int,
                  pic_w: int) -> bool:
    """Raster-CTU z-scan precedence (same rule as intra availability)."""
    if x < 0 or y < 0:
        return False
    ctu_cur = (cur_y // ctu) * ((pic_w + ctu - 1) // ctu) + cur_x // ctu
    ctu_n = (y // ctu) * ((pic_w + ctu - 1) // ctu) + x // ctu
    if ctu_n != ctu_cur:
        return ctu_n < ctu_cur
    # same CTU: z-order compare at 4x4 granularity
    def z(px, py):
        zx, zy = (px % ctu) // 4, (py % ctu) // 4
        v = 0
        for b in range(8):
            v |= ((zx >> b) & 1) << (2 * b)
            v |= ((zy >> b) & 1) << (2 * b + 1)
        return v
    return z(x, y) < z(cur_x, cur_y)


def merge_candidates(mf: MotionField, x0: int, y0: int, n: int,
                     ctu: int, pic_w: int, pic_h: int,
                     max_cand: int = MERGE_MAX):
    """Merge list for a 2Nx2N PU at (x0, y0) size n (spec 8.5.3.2.3).
    Returns list of (mvx, mvy, ref)."""
    def nb(x, y):
        if x < 0 or y < 0 or x >= pic_w or y >= pic_h:
            return None
        if not _coded_before(x, y, x0, y0, ctu, pic_w):
            return None
        return mf.at(x, y)

    a1 = nb(x0 - 1, y0 + n - 1)
    b1 = nb(x0 + n - 1, y0 - 1)
    b0 = nb(x0 + n, y0 - 1)
    a0 = nb(x0 - 1, y0 + n)
    b2 = nb(x0 - 1, y0 - 1)
    cands = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and b1 != a1:
        cands.append(b1)
    if b0 is not None and b0 != b1:
        cands.append(b0)
    if a0 is not None and a0 != a1:
        cands.append(a0)
    if len(cands) < 4 and b2 is not None and b2 != a1 and b2 != b1:
        cands.append(b2)
    n_spatial = len(cands)
    # no TMVP (sps flag off); zero-MV fill (single ref -> all (0,0,0)).
    # NOTE: in B slices the fill candidates are bi-predictive per spec; the
    # encoder must not select them unless it implements bi MC — callers use
    # n_spatial to restrict matching (L0-uni B path).
    while len(cands) < max_cand:
        cands.append((0, 0, 0))
    return cands[:max_cand], n_spatial


def merge_candidates_bi(mf: MotionField, x0: int, y0: int, n: int,
                        ctu: int, pic_w: int, pic_h: int,
                        max_cand: int = MERGE_MAX):
    """B-slice merge list, spatial part (spec 8.5.3.2.3): every candidate
    carries both lists' motion; pruning compares the FULL motion. Combined
    and zero-fill candidates occupy indices >= n_spatial in the decoder's
    list, so callers restricting selection to the first n_spatial entries
    always agree with any conformant decoder. Returns (cands, n_spatial)
    with cands entries (mv0x, mv0y, mv1x, mv1y)."""
    def nb(x, y):
        if x < 0 or y < 0 or x >= pic_w or y >= pic_h:
            return None
        if not _coded_before(x, y, x0, y0, ctu, pic_w):
            return None
        return mf.at_bi(x, y)

    a1 = nb(x0 - 1, y0 + n - 1)
    b1 = nb(x0 + n - 1, y0 - 1)
    b0 = nb(x0 + n, y0 - 1)
    a0 = nb(x0 - 1, y0 + n)
    b2 = nb(x0 - 1, y0 - 1)
    cands = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and b1 != a1:
        cands.append(b1)
    if b0 is not None and b0 != b1:
        cands.append(b0)
    if a0 is not None and a0 != a1:
        cands.append(a0)
    if len(cands) < 4 and b2 is not None and b2 != a1 and b2 != b1:
        cands.append(b2)
    cands = cands[:max_cand]
    return cands, len(cands)


def scale_mv(mvx: int, mvy: int, tb: int, td: int):
    """Spec 8.5.3.2.6 / 8.5.3.2.8 POC-distance MV scaling.

    tb = POC(cur) - POC(target ref), td = POC(cur) - POC(neighbour ref);
    exact integer arithmetic of the spec (tx division truncates toward
    zero like C; >> is arithmetic). Twin implementations: native
    hevcenc.cpp scale_mv and hevc/parse.py."""
    if tb == td:
        return (mvx, mvy)
    td = max(-128, min(127, td))
    tb = max(-128, min(127, tb))
    q = 16384 + (abs(td) >> 1)
    tx = q // td if td > 0 else -(q // -td)
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))

    def one(v):
        p = dsf * v
        s = ((abs(p) + 127) >> 8)
        return max(-32768, min(32767, s if p >= 0 else -s))
    return (one(mvx), one(mvy))


def lists_at(mf: MotionField, x: int, y: int):
    """(has0, mv0, has1, mv1) of the 8x8 unit at luma pixel (x, y), or
    None when outside / intra / not coded. Mixed-direction aware: a list
    is present iff its ref index is >= 0."""
    h8, w8 = mf.ref.shape
    ux, uy = x >> 3, y >> 3
    if x < 0 or y < 0 or ux >= w8 or uy >= h8:
        return None
    h0 = mf.ref[uy, ux] >= 0
    r1 = mf.ref1 if mf.ref1 is not None else None
    h1 = (r1 is not None and r1[uy, ux] >= 0 and mf.mv1 is not None)
    if not (h0 or h1):
        return None
    mv0 = (int(mf.mv[uy, ux, 0]), int(mf.mv[uy, ux, 1])) if h0 else None
    mv1 = (int(mf.mv1[uy, ux, 0]), int(mf.mv1[uy, ux, 1])) if h1 else None
    return (h0, mv0, h1, mv1)


def amvp_candidates_2(mf: MotionField, x0: int, y0: int, n: int,
                      ctu: int, pic_w: int, pic_h: int,
                      lx: int, dists) -> list:
    """Two-list spatial AMVP with POC-distance scaling (spec 8.5.3.2.6,
    HM xEstimateMvPredAMVP order). Returns the 2-entry list for list
    `lx`; dists = (POC(cur)-POC(ref L0), POC(cur)-POC(ref L1)), one
    reference per list (refidx 0).

    Neighbour priority: A = first same-POC hit over (A0, A1) in (LX, LY)
    order; if none and any A neighbour is coded inter, the first motion
    over (A0, A1) scaled by distance ratio. B = same-POC over (B0, B1,
    B2). When NO A neighbour exists (isScaledFlagLX == 0, spec 8.5.3.2.7
    steps 4-5, HM fillMvpCand), that same-POC B takes A's place and B is
    derived again as the first B neighbour's motion, scaled: the list is
    [same-POC B, scaled B] before the duplicate check. (The JAX package's
    copy keeps only the same-POC B there, a list a decoder does not
    derive: ROADMAP Queue 3.) Reference analog: POC scaling at
    hmr_motion_inter.c:2218."""
    def nb(x, y):
        if x < 0 or y < 0 or x >= pic_w or y >= pic_h:
            return None
        if not _coded_before(x, y, x0, y0, ctu, pic_w):
            return None
        return lists_at(mf, x, y)

    A = [nb(x0 - 1, y0 + n), nb(x0 - 1, y0 + n - 1)]
    Bc = [nb(x0 + n, y0 - 1), nb(x0 + n - 1, y0 - 1), nb(x0 - 1, y0 - 1)]
    ly = 1 - lx

    def get(c, l):
        has = (c[0], c[2])[l]
        mv = (c[1], c[3])[l]
        return has, mv

    def same_poc(c):
        if c is None:
            return None
        hx, mx = get(c, lx)
        if hx:
            return mx                      # same list, refidx 0: same pic
        hy, my = get(c, ly)
        if hy and dists[ly] == dists[lx]:
            return my
        return None

    def scaled(c):
        if c is None:
            return None
        hx, mx = get(c, lx)
        if hx:
            return mx
        hy, my = get(c, ly)
        if hy:
            return scale_mv(my[0], my[1], dists[lx], dists[ly])
        return None

    mv_a = next((r for r in map(same_poc, A) if r is not None), None)
    avail_a = any(c is not None for c in A)
    if mv_a is None and avail_a:
        mv_a = next((r for r in map(scaled, A) if r is not None), None)
    mv_b = next((r for r in map(same_poc, Bc) if r is not None), None)
    if not avail_a:
        mv_a = mv_b
        mv_b = next((r for r in map(scaled, Bc) if r is not None), None)

    lst = []
    if mv_a is not None:
        lst.append(mv_a)
    if mv_b is not None and (mv_a is None or mv_b != mv_a):
        lst.append(mv_b)
    while len(lst) < 2:
        lst.append((0, 0))
    return lst[:2]


def merge_candidates_b(mf: MotionField, x0: int, y0: int, n: int,
                       ctu: int, pic_w: int, pic_h: int, dists,
                       max_cand: int = MERGE_MAX) -> list:
    """Full B-slice merge list with mixed prediction directions (spec
    8.5.3.2.3 spatial + 8.5.3.2.4 combined bi + zero fill). Entries are
    (dir, mv0, mv1) with dir a bitmask (1 = L0, 2 = L1, 3 = BI) and mvN
    an (x, y) tuple or None. Pruning compares the FULL motion. The
    encoder may select any index: the list is exactly what a conformant
    decoder derives (refidx 0 per list, no TMVP)."""
    def nb(x, y):
        if x < 0 or y < 0 or x >= pic_w or y >= pic_h:
            return None
        if not _coded_before(x, y, x0, y0, ctu, pic_w):
            return None
        c = lists_at(mf, x, y)
        if c is None:
            return None
        d = (1 if c[0] else 0) | (2 if c[2] else 0)
        return (d, c[1], c[3])

    a1 = nb(x0 - 1, y0 + n - 1)
    b1 = nb(x0 + n - 1, y0 - 1)
    b0 = nb(x0 + n, y0 - 1)
    a0 = nb(x0 - 1, y0 + n)
    b2 = nb(x0 - 1, y0 - 1)
    cands = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and b1 != a1:
        cands.append(b1)
    if b0 is not None and b0 != b1:
        cands.append(b0)
    if a0 is not None and a0 != a1:
        cands.append(a0)
    if len(cands) < 4 and b2 is not None and b2 != a1 and b2 != b1:
        cands.append(b2)
    cands = cands[:max_cand]
    # combined bi-predictive candidates (spec 8.5.3.2.4 l0/l1CandIdx)
    comb = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
            (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))
    nc = len(cands)
    for i0, i1 in comb:
        if len(cands) >= max_cand:
            break
        if i0 >= nc or i1 >= nc:
            continue
        c0, c1 = cands[i0], cands[i1]
        if not (c0[0] & 1) or not (c1[0] & 2):
            continue
        m0, m1 = c0[1], c1[2]
        # valid iff the two halves differ (different ref pic or mv)
        if dists[0] == dists[1] and m0 == m1:
            continue
        cand = (3, m0, m1)
        cands.append(cand)
    while len(cands) < max_cand:
        cands.append((3, (0, 0), (0, 0)))
    return cands[:max_cand]


def _cu_origin_rect(x0, y0, pw, ph, part, pu_idx):
    """Containing-CU rectangle of a rect PU (for the spec 6.4.2 same-CB
    availability rule: neighbours inside the current CU are unavailable)."""
    if part == "2NxN":
        return (x0, y0 - (ph if pu_idx else 0), pw)
    return (x0 - (pw if pu_idx else 0), y0, ph)


def merge_candidates_rect(mf: MotionField, x0: int, y0: int, pw: int,
                          ph: int, part: str, pu_idx: int, ctu: int,
                          pic_w: int, pic_h: int,
                          max_cand: int = MERGE_MAX):
    """Merge list for a rectangular PU (spec 8.5.3.2.3 with the second-PU
    exclusions: A1 unavailable for PU1 of Nx2N, B1 for PU1 of 2NxN) plus
    the 6.4.2 same-coding-block rule (any neighbour inside the current
    CU is unavailable). P slices, single reference.
    Returns (cands [(mvx, mvy, ref)], n_spatial)."""
    cux, cuy, cun = _cu_origin_rect(x0, y0, pw, ph, part, pu_idx)

    def nb(x, y):
        if x < 0 or y < 0 or x >= pic_w or y >= pic_h:
            return None
        if cux <= x < cux + cun and cuy <= y < cuy + cun:
            return None            # same coding block (6.4.2)
        if not _coded_before(x, y, x0, y0, ctu, pic_w):
            return None
        return mf.at(x, y)

    a1 = nb(x0 - 1, y0 + ph - 1)
    b1 = nb(x0 + pw - 1, y0 - 1)
    b0 = nb(x0 + pw, y0 - 1)
    a0 = nb(x0 - 1, y0 + ph)
    b2 = nb(x0 - 1, y0 - 1)
    if part == "Nx2N" and pu_idx == 1:
        a1 = None
    if part == "2NxN" and pu_idx == 1:
        b1 = None
    cands = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and b1 != a1:
        cands.append(b1)
    if b0 is not None and b0 != b1:
        cands.append(b0)
    if a0 is not None and a0 != a1:
        cands.append(a0)
    if len(cands) < 4 and b2 is not None and b2 != a1 and b2 != b1:
        cands.append(b2)
    n_spatial = len(cands)
    while len(cands) < max_cand:
        cands.append((0, 0, 0))
    return cands[:max_cand], n_spatial


def amvp_candidates_rect(mf: MotionField, x0: int, y0: int, pw: int,
                         ph: int, ctu: int, pic_w: int, pic_h: int,
                         part: str = "2Nx2N", pu_idx: int = 0):
    """AMVP list for a rectangular PU (spec 8.5.3.2.5-8, neighbour
    positions from the PU's own width/height). Unlike merge, AMVP has NO
    second-PU exclusion: the first PU's motion IS a valid predictor for
    the second (verified against FFmpeg's derivation).

    Availability inside the current CU follows PU decode order (PU0
    precedes PU1), NOT the 4x4 z-curve: the z-curve orders PU0's far
    half after PU1's near half, so the generic _coded_before test is
    wrong there. Any reachable same-CU position lies in PU0 ->
    available. P slices, single reference."""
    if part in ("2NxN", "Nx2N"):
        cux, cuy, cun = _cu_origin_rect(x0, y0, pw, ph, part, pu_idx)
    else:
        cux, cuy, cun = 0, 0, 0

    def nb(x, y):
        if x < 0 or y < 0 or x >= pic_w or y >= pic_h:
            return None
        if cun and cux <= x < cux + cun and cuy <= y < cuy + cun:
            return mf.at(x, y)     # same CU => PU0, decoded before PU1
        if not _coded_before(x, y, x0, y0, ctu, pic_w):
            return None
        return mf.at(x, y)

    a0 = nb(x0 - 1, y0 + ph)
    a1 = nb(x0 - 1, y0 + ph - 1)
    b0 = nb(x0 + pw, y0 - 1)
    b1 = nb(x0 + pw - 1, y0 - 1)
    b2 = nb(x0 - 1, y0 - 1)
    mv_a = next((c for c in (a0, a1) if c is not None), None)
    mv_b = next((c for c in (b0, b1, b2) if c is not None), None)
    lst = []
    if mv_a is not None:
        lst.append((mv_a[0], mv_a[1]))
    if mv_b is not None and (mv_a is None
                             or (mv_b[0], mv_b[1]) != (mv_a[0], mv_a[1])):
        lst.append((mv_b[0], mv_b[1]))
    while len(lst) < 2:
        lst.append((0, 0))
    return lst[:2]


def amvp_candidates(mf: MotionField, x0: int, y0: int, n: int,
                    ctu: int, pic_w: int, pic_h: int):
    """AMVP list (2 entries) for ref 0 (spec 8.5.3.2.5-8). Single-ref
    specialization: every inter neighbour has the same reference, so no
    scaling paths arise."""
    def nb(x, y):
        if x < 0 or y < 0 or x >= pic_w or y >= pic_h:
            return None
        if not _coded_before(x, y, x0, y0, ctu, pic_w):
            return None
        return mf.at(x, y)

    a0 = nb(x0 - 1, y0 + n)
    a1 = nb(x0 - 1, y0 + n - 1)
    b0 = nb(x0 + n, y0 - 1)
    b1 = nb(x0 + n - 1, y0 - 1)
    b2 = nb(x0 - 1, y0 - 1)
    mv_a = next((c for c in (a0, a1) if c is not None), None)
    mv_b = next((c for c in (b0, b1, b2) if c is not None), None)
    lst = []
    if mv_a is not None:
        lst.append((mv_a[0], mv_a[1]))
    if mv_b is not None and (mv_a is None or (mv_b[0], mv_b[1]) != (mv_a[0], mv_a[1])):
        lst.append((mv_b[0], mv_b[1]))
    while len(lst) < 2:
        lst.append((0, 0))
    return lst[:2]


def amvp_candidates_mref(mf: MotionField, x0: int, y0: int, n: int,
                         ctu: int, pic_w: int, pic_h: int,
                         cur_ref: int, ref_dists) -> list:
    """AMVP list for a multi-reference L0 (spec 8.5.3.2.5-8): neighbours
    carrying a DIFFERENT reference contribute through the POC-distance
    scaling branch. ref_dists[r] = POC(cur) - POC(ref r). A-candidate
    scaling runs whenever no same-ref A hit exists. When NO A neighbour
    exists (isScaledFlagLX == 0, spec 8.5.3.2.7 steps 4-5), the same-ref
    B takes A's place and B is derived again as the first B neighbour's
    motion, scaled, as in amvp_candidates_2. (The JAX package's copy keeps
    only the same-ref B there: ROADMAP Queue 3.) Reference analog:
    hmr_motion_inter.c:2218."""
    def nb(x, y):
        if x < 0 or y < 0 or x >= pic_w or y >= pic_h:
            return None
        if not _coded_before(x, y, x0, y0, ctu, pic_w):
            return None
        return mf.at(x, y)           # (mvx, mvy, ref)

    A = [nb(x0 - 1, y0 + n), nb(x0 - 1, y0 + n - 1)]
    Bc = [nb(x0 + n, y0 - 1), nb(x0 + n - 1, y0 - 1), nb(x0 - 1, y0 - 1)]
    tb = int(ref_dists[cur_ref])

    def same_ref(c):
        if c is None or c[2] != cur_ref:
            return None
        return (c[0], c[1])

    def scaled(c):
        if c is None:
            return None
        if c[2] == cur_ref:
            return (c[0], c[1])
        return scale_mv(c[0], c[1], tb, int(ref_dists[c[2]]))

    mv_a = next((r for r in map(same_ref, A) if r is not None), None)
    avail_a = any(c is not None for c in A)
    if mv_a is None and avail_a:
        mv_a = next((r for r in map(scaled, A) if r is not None), None)
    mv_b = next((r for r in map(same_ref, Bc) if r is not None), None)
    if not avail_a:
        mv_a = mv_b
        mv_b = next((r for r in map(scaled, Bc) if r is not None), None)
    lst = []
    if mv_a is not None:
        lst.append(mv_a)
    if mv_b is not None and (mv_a is None or mv_b != mv_a):
        lst.append(mv_b)
    while len(lst) < 2:
        lst.append((0, 0))
    return lst[:2]
