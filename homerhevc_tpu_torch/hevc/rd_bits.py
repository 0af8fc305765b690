"""Counted-bits RD estimation for inter decisions.

The reference costs every RD decision through a CABAC bit counter
environment (FAST_BIT_EST, hmr_binary_encoding.c:280-351, driven from
the hmr_motion_inter.c cost_rd loops): the same syntax routines run with
an encoder whose output is fractional entropy bits instead of a stream.
This module is that environment for the host inter path
(hevc/inter_frame.py; the port's copy of homerhevc_tpu/golden/rd_bits.py):
it reuses the REAL residual/mvd/merge syntax methods of SliceDataEncoder,
bound to a CabacCounter on cloned contexts, so a candidate's rate is the
measured CABAC cost of its exact bins rather than the 3*nnz+sum|lvl|
proxy.

Context handling: estimates run on clones of the slice-type/QP init
state (one 182-byte copy per estimate). The reference's counter follows
its sequential RD loop's context chain; the host path decides in
batched post-passes where no single chain exists, so the init state is
the consistent, order-independent choice — identical for every candidate
of one decision, which is all a comparison needs.
"""

from __future__ import annotations

import numpy as np

from homerhevc_tpu_torch.hevc.cabac import ENTROPY_BITS, CabacCounter
from homerhevc_tpu_torch.hevc.ctx_tables import OFF, init_contexts
from homerhevc_tpu_torch.hevc.syntax import SliceDataEncoder


class _CounterEnv:
    """Stand-in for SliceDataEncoder carrying a CabacCounter: borrows the
    real syntax methods so counted bins are exactly the coded bins."""

    _residual_coding = SliceDataEncoder._residual_coding
    _encode_last_xy = SliceDataEncoder._encode_last_xy
    _encode_remaining = SliceDataEncoder._encode_remaining
    _encode_mvd = SliceDataEncoder._encode_mvd
    _encode_eg_bypass = SliceDataEncoder._encode_eg_bypass
    _encode_merge_idx = SliceDataEncoder._encode_merge_idx
    _last_prefix = staticmethod(SliceDataEncoder._last_prefix)
    _sig_ctx = staticmethod(SliceDataEncoder._sig_ctx)

    def __init__(self, ps, slice_type: str, qp: int):
        self.ps = ps
        self._init_ctx = init_contexts(slice_type, qp)
        self.e = None

    def _fresh(self):
        self.e = CabacCounter(self._init_ctx.copy())
        return self.e


class RdBits:
    """Per-frame counted-bits estimator (one per encode call)."""

    def __init__(self, ps, slice_type: str, qp: int):
        self._env = _CounterEnv(ps, slice_type, qp)

    def tu_bits(self, lvl: np.ndarray, c_idx: int,
                scan_idx: int = 0) -> float:
        """Measured residual_coding bits of one TU's level array
        (0 for an all-zero TU — the cbf bin is costed by cu_bits)."""
        if not np.any(lvl):
            return 0.0
        env = self._env
        e = env._fresh()
        n = lvl.shape[0]
        env._residual_coding(lvl, n.bit_length() - 1, c_idx, scan_idx)
        return e.bits()

    def luma_bits(self, lvl: np.ndarray) -> float:
        """Luma residual bits of a CU (n<=32: one TU; n=64: the four
        forced-split TU32s), plus the luma cbf bin per TU."""
        n = lvl.shape[0]
        env = self._env
        if n <= 32:
            parts = (lvl,)
        else:
            parts = (lvl[:32, :32], lvl[:32, 32:], lvl[32:, :32],
                     lvl[32:, 32:])
        total = 0.0
        cbf_state = int(env._init_ctx[OFF["qt_cbf"]])
        for p in parts:
            total += _bin_bits(cbf_state, int(np.any(p)))
            total += self.tu_bits(p, 0)
        return total

    def mvd_bits(self, mvd_x: int, mvd_y: int) -> float:
        env = self._env
        e = env._fresh()
        env._encode_mvd(int(mvd_x), int(mvd_y))
        e.encode_bin(OFF["mvp_idx"], 0)           # mvp_l0_flag
        return e.bits()

    def merge_bits(self, idx: int, max_cand: int = 5) -> float:
        env = self._env
        e = env._fresh()
        e.encode_bin(OFF["merge_flag"], 1)
        env._encode_merge_idx(int(idx), max_cand)
        return e.bits()

    def amvp_flag_bits(self) -> float:
        """merge_flag=0 (the AMVP-vs-merge discriminator)."""
        return _bin_bits(int(self._env._init_ctx[OFF["merge_flag"]]), 0)


def _bin_bits(state: int, binval: int) -> float:
    """Fractional bits of one context bin at a given packed state."""
    return int(ENTROPY_BITS[state ^ binval]) / 32768.0
