"""Intra prediction constants and decoder-exact neighbour availability
(spec 8.4.4.2 tables, spec 6.4.1 z-scan rule): the port's copies of what
its device path reads from homerhevc_tpu/golden/intra_pred.py.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# intraPredAngle for modes 2..34 (spec Table 8-5)
PRED_ANGLE = np.array([
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32,
], np.int32)

# invAngle for modes 11..25 (spec Table 8-6)
INV_ANGLE = np.array([
    -4096, -1638, -910, -630, -482, -390, -315, -256,
    -315, -390, -482, -630, -910, -1638, -4096,
], np.int32)


@lru_cache(maxsize=None)
def _zorder_table(log2_ctu: int, log2_unit: int) -> np.ndarray:
    """z-scan address of each unit within a CTU: table[uy, ux] -> z index."""
    n = 1 << (log2_ctu - log2_unit)
    tab = np.zeros((n, n), np.int32)
    for uy in range(n):
        for ux in range(n):
            z = 0
            for b in range(16):
                z |= ((ux >> b) & 1) << (2 * b)
                z |= ((uy >> b) & 1) << (2 * b + 1)
            tab[uy, ux] = z
    return tab


class Availability:
    """Decoder-exact z-scan availability of a neighbour sample position
    relative to the block being predicted (spec 6.4.1; single slice/tile).

    Unit granularity is the minimum TU (4x4)."""

    def __init__(self, pic_w: int, pic_h: int, ctu_size: int):
        self.w, self.h = pic_w, pic_h
        self.ctu = ctu_size
        self.log2_ctu = ctu_size.bit_length() - 1
        self.z = _zorder_table(self.log2_ctu, 2)

    def available(self, x_cur: int, y_cur: int, x_n: int, y_n: int) -> bool:
        if x_n < 0 or y_n < 0 or x_n >= self.w or y_n >= self.h:
            return False
        ctu_cur = (y_cur // self.ctu) * ((self.w + self.ctu - 1) // self.ctu) \
            + (x_cur // self.ctu)
        ctu_n = (y_n // self.ctu) * ((self.w + self.ctu - 1) // self.ctu) \
            + (x_n // self.ctu)
        if ctu_n < ctu_cur:
            return True
        if ctu_n > ctu_cur:
            return False
        zc = self.z[(y_cur % self.ctu) // 4, (x_cur % self.ctu) // 4]
        zn = self.z[(y_n % self.ctu) // 4, (x_n % self.ctu) // 4]
        return zn < zc
