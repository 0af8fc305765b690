"""What the port's tests share: the golden intra tree reference (the
golden tree decision + closed-loop encode, homerhevc_tpu.golden.intra_tree,
with the golden deblock: the references tests/test_intra_tree.py holds the
JAX tree to), and the P-frame comparison against the JAX P program."""

import numpy as np

from homerhevc_tpu.golden import deblock as gdb
from homerhevc_tpu.golden.intra_tree import (decide_intra_tree,
                                             encode_intra_tree_frame)
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.state import reference_from_numpy

# the FrameDesc fields tests/test_tpu_inter.py holds the JAX P program to
P_FIELDS = ("cu_depth", "tr_depth", "pred_mode", "mv", "coef_y", "coef_u",
            "coef_v", "skip", "inter_mode", "merge_idx", "root_cbf",
            "mvp_flag")


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


def torch_p_frame(kw, src, ref, avg_dist=1000.0):
    """The port's P program on the CPU for EncoderConfig(**kw), from the
    numpy reference planes ref."""
    cfg = EncoderConfig(**kw)
    enc = TorchInterEncoder(ParamSets.from_config(cfg), cfg, device="cpu")
    return enc.encode_frame(src, reference_from_numpy(ref, "cpu"), avg_dist)


def assert_p_frames_equal(want, got):
    """(desc, y, u, v) of two P programs: every P_FIELDS field, the recon
    planes and the per-row luma SSD."""
    (wd, *wrec), (gd, *grec) = want, got
    for f in P_FIELDS:
        assert np.array_equal(getattr(wd, f), getattr(gd, f)), f
    for a, b in zip(wrec, grec):
        assert np.array_equal(np.asarray(a, np.int32),
                              np.asarray(b, np.int32)), "recon"
    assert np.array_equal(wd.row_ssd_y, gd.row_ssd_y)
