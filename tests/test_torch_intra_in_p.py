"""Intra-in-P in the port (the per-CU16 intra fallback of P frames): the
flat CU16 program and the CTU-32 tree program against the JAX
TpuInterEncoder from the same reference, bit-exact in every field
tests/test_intra_in_p.py compares (intra modes included), with
deblocking on (the BS-2 luma and chroma edges of intra CUs)."""

import numpy as np
import pytest
import torch

from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.engine.inter_encoder import TpuInterEncoder
from homerhevc_tpu.hevc.headers import ParamSets as JaxParamSets
from homerhevc_tpu_torch.hevc.syntax import MODE_INTRA
from tests.conftest import make_yuv
from tests.torch_golden import assert_p_frames_equal, torch_p_frame

torch.set_num_threads(1)    # one intra-op thread per test worker


def occlusion_pair(seed, w, h):
    """tests/test_intra_in_p.py's frames: a global 3-px shift and a
    smooth new region that motion cannot predict but intra can."""
    y, u, v = make_yuv(np.random.RandomState(seed), w, h)
    y2 = np.roll(y, 3, 1).astype(np.int32)
    yy, xx = np.mgrid[0:32, 0:64]
    y2[16:48, 32:96] = 200 - yy * 2 + xx // 4
    y2 = np.clip(y2, 0, 255).astype(np.uint8)
    return (y, u, v), (y2, np.roll(u, 1, 1), np.roll(v, 1, 1))


@pytest.mark.parametrize("cu", [16, 32])
def test_intra_fallback_matches_jax(cu):
    w, h = 128, 64
    ref, src = occlusion_pair(9, w, h)
    kw = dict(width=w, height=h, qp=32, gop_size=1, sao=False,
              deblocking=True, cu_size=cu, intra_in_p=True,
              sign_hiding=True)
    jcfg = JaxConfig(**kw)
    want = TpuInterEncoder(JaxParamSets.from_config(jcfg), jcfg) \
        .encode_frame(src, ref)
    got = torch_p_frame(kw, src, ref)
    assert_p_frames_equal(want, got)
    for f in ("luma_mode", "chroma_mode"):
        assert np.array_equal(getattr(want[0], f), getattr(got[0], f)), f
    assert (got[0].pred_mode == MODE_INTRA).any(), "no CU went intra"
    if cu == 32:
        assert (got[0].cu_depth == 0).any(), "no CU32 chosen"
