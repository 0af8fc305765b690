# Frozen copy of the parameter model of homerhevc_tpu_torch/hevc/sao.py
# (lines 1-63: SaoFrameParams), for the benchmark's plain reference decoder: the parser
# fills it. The filter is decode.py's own, written from the spec (8.7.3).
"""SAO parameters of a picture, per CTB, as its slice data codes them."""

from __future__ import annotations

import dataclasses

import numpy as np

SAO_OFF, SAO_BAND, SAO_EDGE = 0, 1, 2


@dataclasses.dataclass
class SaoFrameParams:
    """Per-CTU SAO decisions. Arrays indexed [ctu_y, ctu_x]."""
    merge_left: np.ndarray   # bool
    merge_up: np.ndarray     # bool
    type_luma: np.ndarray    # 0/1/2
    type_chroma: np.ndarray  # 0/1/2 (shared cb/cr)
    eo_class_luma: np.ndarray    # 0..3
    eo_class_chroma: np.ndarray  # 0..3
    band_pos: np.ndarray     # (cy, cx, 3) band position per component
    offsets: np.ndarray      # (cy, cx, 3, 4) signed offsets per component

    @classmethod
    def alloc(cls, cy: int, cx: int) -> "SaoFrameParams":
        return cls(
            merge_left=np.zeros((cy, cx), bool),
            merge_up=np.zeros((cy, cx), bool),
            type_luma=np.zeros((cy, cx), np.int32),
            type_chroma=np.zeros((cy, cx), np.int32),
            eo_class_luma=np.zeros((cy, cx), np.int32),
            eo_class_chroma=np.zeros((cy, cx), np.int32),
            band_pos=np.zeros((cy, cx, 3), np.int32),
            offsets=np.zeros((cy, cx, 3, 4), np.int32),
        )

    def copy_from(self, sy, sx, dy, dx):
        self.type_luma[dy, dx] = self.type_luma[sy, sx]
        self.type_chroma[dy, dx] = self.type_chroma[sy, sx]
        self.eo_class_luma[dy, dx] = self.eo_class_luma[sy, sx]
        self.eo_class_chroma[dy, dx] = self.eo_class_chroma[sy, sx]
        self.band_pos[dy, dx] = self.band_pos[sy, sx]
        self.offsets[dy, dx] = self.offsets[sy, sx]
