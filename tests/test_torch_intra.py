"""TorchIntraEncoder (the port's wavefront CU16 intra encoder) against
the JAX TpuIntraEncoder at 128x64: modes, levels and recon bit-exact."""

import numpy as np
import pytest
import torch

from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.engine.intra_encoder import TpuIntraEncoder
from homerhevc_tpu.hevc.headers import ParamSets as JaxParamSets
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.engine.intra_encoder import TorchIntraEncoder
from homerhevc_tpu_torch.hevc.headers import ParamSets
from tests.conftest import make_yuv

torch.set_num_threads(1)    # one intra-op thread per test worker


@pytest.mark.parametrize("deblock", [False, True])
def test_torch_intra_matches_jax(deblock):
    rng = np.random.RandomState(11)    # own stream, not the session rng
    w, h = 128, 64
    kw = dict(width=w, height=h, qp=30, gop_size=0, sao=False,
              deblocking=deblock, sign_hiding=True, cu_size=16)
    jcfg, cfg = JaxConfig(**kw), EncoderConfig(**kw)
    frames = [make_yuv(rng, w, h) for _ in range(2)]
    ys, us, vs = (list(x) for x in zip(*frames))
    qps = [30, 34]           # per-frame QPs in one batch
    want = TpuIntraEncoder(JaxParamSets.from_config(jcfg), jcfg) \
        .encode_frames(ys, us, vs, qps=qps)
    got = TorchIntraEncoder(ParamSets.from_config(cfg), cfg,
                            device="cpu").encode_frames(ys, us, vs, qps=qps)
    for (jd, jy, ju, jv), (td, ty, tu, tv) in zip(want, got):
        jd.densify()
        td.densify()
        assert np.array_equal(jd.luma_mode, td.luma_mode), "modes differ"
        assert np.array_equal(jd.chroma_mode, td.chroma_mode)
        for f in ("coef_y", "coef_u", "coef_v"):
            assert np.array_equal(getattr(jd, f), getattr(td, f)), f
        for a, b in ((jy, ty), (ju, tu), (jv, tv)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), "recon"
