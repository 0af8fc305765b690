"""TorchIntraEncoder (the port's wavefront CU16 intra encoder) against
the JAX TpuIntraEncoder at 128x64: modes, levels and recon bit-exact; and
on the CPU, where no CUDA graph exists, every dispatch runs eagerly."""

import numpy as np
import pytest
import torch

from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.engine.intra_encoder import TpuIntraEncoder
from homerhevc_tpu.hevc.headers import ParamSets as JaxParamSets
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.engine.intra_encoder import TorchIntraEncoder
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.utils.profiler import PROFILER
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


def test_cpu_dispatches_stay_eager():
    """On the CPU a batch shape seen again is not captured: each of four
    dispatches (three of one batch size, one with QP maps) runs the
    program and counts as `intra.eager`, and equals a fresh encoder's."""
    rng = np.random.RandomState(17)
    w, h = 64, 32
    cfg = EncoderConfig(width=w, height=h, qp=30, gop_size=0, sao=False,
                        deblocking=False, sign_hiding=True, cu_size=16)
    ps = ParamSets.from_config(cfg)
    enc = TorchIntraEncoder(ps, cfg, device="cpu")
    batches = [[make_yuv(rng, w, h) for _ in range(2)] for _ in range(4)]
    maps = [None] * 3 + [[np.full((h // 16, w // 16), q, np.int32)
                          for q in (29, 33)]]
    try:
        with PROFILER.enabled():
            PROFILER.reset()
            outs = [enc.dispatch_packed(enc.pack_upload(b), [30, 32], m)
                    for b, m in zip(batches, maps)]
            counters = PROFILER.counters
    finally:
        PROFILER.reset()
    assert counters["intra.eager"] == 4
    assert "intra.graph_captures" not in counters
    assert "intra.graph_replays" not in counters
    assert enc._graphs == {}
    for b, m, got in zip(batches, maps, outs):
        fresh = TorchIntraEncoder(ps, cfg, device="cpu")
        want = fresh.dispatch_packed(fresh.pack_upload(b), [30, 32], m)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
