"""The port's multi-reference AMVP list (hevc/inter.py
amvp_candidates_mref) against a derivation written from the spec (H.265
8.5.3.2.7, the spatial candidates of one list, and 8.5.3.2.8's
POC-distance scaling): on a hand-built left-edge case, and at every CU16
of a 96x64 frame of random motion over three references. At the left
picture edge, where no A neighbour exists, the spec moves the same-POC B
candidate into A's place and derives B again, scaled; the JAX package's
copy keeps only the same-POC B there (ROADMAP Queue 3), and the test
shows that it still does."""

import numpy as np
import pytest

from homerhevc_tpu.hevc import inter as jax_inter
from homerhevc_tpu_torch.hevc.inter import (MotionField, _coded_before,
                                            amvp_candidates_mref)

W, H, CTU = 96, 64, 32
DISTS = (1, 2, 3)            # POC(cur) - POC(ref) of reference 0, 1, 2


def _scale(mv, tb, td):
    """8.5.3.2.8: the neighbour's motion over POC distance td, scaled to
    the target's tb (C division truncating toward zero)."""
    if tb == td:
        return mv
    tb, td = (max(-128, min(127, d)) for d in (tb, td))
    tx = int((16384 + abs(td) // 2) / td)
    f = max(-4096, min(4095, (tb * tx + 32) >> 6))

    def one(v):
        p = f * v
        return max(-32768, min(32767, (1 if p >= 0 else -1)
                               * ((abs(p) + 127) >> 8)))
    return tuple(one(v) for v in mv)


def spec_mvp_list(mf, x0, y0, n, ref_idx, dists):
    """mvpListLX of a 2Nx2N PU of size n at (x0, y0) predicting from
    reference ref_idx of list 0 (P slice, no temporal candidate)."""
    def nb(x, y):
        if not (0 <= x < W and 0 <= y < H) \
                or not _coded_before(x, y, x0, y0, CTU, W):
            return None
        ux, uy = x >> 3, y >> 3
        r = int(mf.ref[uy, ux])
        return None if r < 0 else (tuple(int(v) for v in mf.mv[uy, ux]), r)
    tb = dists[ref_idx]
    a = [nb(x0 - 1, y0 + n), nb(x0 - 1, y0 + n - 1)]       # A0, A1
    b = [nb(x0 + n, y0 - 1), nb(x0 + n - 1, y0 - 1),       # B0, B1, B2
         nb(x0 - 1, y0 - 1)]
    is_scaled = any(c is not None for c in a)
    mv_a = next((mv for mv, r in filter(None, a) if dists[r] == tb), None)
    if mv_a is None:                                      # step 7
        mv_a = next((_scale(mv, tb, dists[r]) for mv, r in filter(None, a)),
                    None)
    mv_b = next((mv for mv, r in filter(None, b) if dists[r] == tb), None)
    if not is_scaled:                                     # steps 4 and 5
        mv_a = mv_b
        mv_b = next((_scale(mv, tb, dists[r]) for mv, r in filter(None, b)),
                    None)
    lst = [mv for mv in (mv_a, mv_b) if mv is not None]
    if len(lst) == 2 and lst[0] == lst[1]:
        lst.pop()
    return (lst + [(0, 0), (0, 0)])[:2]


def _field():
    return MotionField(H // 8, W // 8)


def test_left_edge_list_is_the_spec_list_and_the_jax_copy_differs():
    """The CU16 at (0, 32) has no A neighbour; above it, B0 predicts from
    reference 1 and B1 from reference 0 (its own). The spec's list is
    [B1, B0 scaled from distance 2 to 1]; the JAX package's copy gives
    [B1, (0, 0)], a predictor a decoder does not have."""
    mf = _field()
    mf.ref[3, 2], mf.mv[3, 2] = 1, (-12, 6)           # B0 at (16, 31)
    mf.ref[3, 1], mf.mv[3, 1] = 0, (4, -8)            # B1 at (15, 31)
    want = [(4, -8), (-6, 3)]
    assert spec_mvp_list(mf, 0, 32, 16, 0, DISTS) == want
    assert amvp_candidates_mref(mf, 0, 32, 16, CTU, W, H, 0, DISTS) == want
    assert jax_inter.amvp_candidates_mref(mf, 0, 32, 16, CTU, W, H, 0,
                                          DISTS) == [(4, -8), (0, 0)]


@pytest.mark.parametrize("seed", [0, 1])
def test_mref_list_is_the_spec_list_everywhere(seed):
    """Random motion over three references (a quarter of the 8x8 units
    intra) at every CU16 of the frame and for every target reference: the
    port's list is the spec's, at the left edge too."""
    rng = np.random.RandomState(seed)
    mf = _field()
    mf.ref[:] = rng.randint(-1, 3, mf.ref.shape)
    mf.mv[:] = rng.randint(-64, 65, mf.mv.shape)
    edge_diffs = 0
    for y0 in range(0, H, 16):
        for x0 in range(0, W, 16):
            for r in range(3):
                got = amvp_candidates_mref(mf, x0, y0, 16, CTU, W, H, r,
                                           DISTS)
                assert got == spec_mvp_list(mf, x0, y0, 16, r, DISTS), \
                    (x0, y0, r)
                if x0 == 0:
                    edge_diffs += got != jax_inter.amvp_candidates_mref(
                        mf, x0, y0, 16, CTU, W, H, r, DISTS)
    assert edge_diffs > 0
