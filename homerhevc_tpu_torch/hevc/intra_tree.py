"""Intra CU-tree rate model and decision record: the port's copies of what
its tree encoder (engine/intra_tree_encoder.py) reads from
homerhevc_tpu/golden/intra_tree.py.

Per candidate CU the tree costs
  SSD(recon, src) + lambda * (coef_bits + mode_bits + overhead)
with coef_bits = A*nnz + B*sum|lvl| + C per TU that has nonzero levels.
All integer, so the decision arithmetic stays exact in int32.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
