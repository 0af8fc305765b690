"""The golden references the port's intra CU-tree tests share: the golden
tree decision + closed-loop encode (homerhevc_tpu.golden.intra_tree) with
the golden deblock, the references tests/test_intra_tree.py holds the JAX
tree to."""

import numpy as np

from homerhevc_tpu.golden import deblock as gdb
from homerhevc_tpu.golden.intra_tree import (decide_intra_tree,
                                             encode_intra_tree_frame)


def golden_tree(ps, y, u, v, qp):
    """Golden tree decision + closed-loop encode (CTB32 nodes under the
    CTU of ps) + golden deblock when ps has it on."""
    dec = decide_intra_tree(ps, y, u, v, qp, ctb=32)
    desc, ry, ru, rv = encode_intra_tree_frame(ps, y, u, v, qp, dec, ctb=32)
    if ps.deblocking_enabled:
        tu8 = ((ps.ctu_size >> desc.cu_depth) >> desc.tr_depth) \
            .astype(np.int32)
        qp8 = np.full_like(tu8, qp)
        bs_v, bs_h = gdb.intra_bs_maps(tu8)
        ry = gdb.deblock_plane_luma(ry, tu8, qp8, bs_v, bs_h)
        ru = gdb.deblock_plane_chroma(ru, qp8, bs_v, bs_h, ps.cb_qp_offset)
        rv = gdb.deblock_plane_chroma(rv, qp8, bs_v, bs_h, ps.cr_qp_offset)
    return desc, ry, ru, rv
