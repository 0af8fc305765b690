"""The FAR (4x-decimated) motion search level in the port: me_range 64
over a 40-px pan at 128x64 (outside the +-32 reach of the two-level
search), TorchInterEncoder against the JAX TpuInterEncoder from the same
reference, bit-exact; and an IPPP stream of the pan through api.Encoder
that decodes (FFmpeg) to the port's recon with far motion vectors."""

import numpy as np
import torch

from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.engine.inter_encoder import TpuInterEncoder
from homerhevc_tpu.hevc.headers import ParamSets as JaxParamSets
from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import EncoderConfig
from tests.conftest import decode_annexb, make_yuv
from tests.torch_golden import assert_p_frames_equal, torch_p_frame

torch.set_num_threads(1)    # one intra-op thread per test worker


def test_far_level_matches_jax():
    """tests/test_me_far.py::test_device_far_matches_golden's frame: the
    reference panned by 40 px."""
    w, h = 128, 64
    kw = dict(width=w, height=h, qp=32, gop_size=1, intra_period=0,
              sao=False, deblocking=False, sign_hiding=True, cu_size=16,
              me_range=64)
    y, u, v = make_yuv(np.random.RandomState(3), w, h)
    ref = (np.roll(y, 40, axis=1), np.roll(u, 20, axis=1),
           np.roll(v, 20, axis=1))
    jcfg = JaxConfig(**kw)
    want = TpuInterEncoder(JaxParamSets.from_config(jcfg), jcfg) \
        .encode_frame((y, u, v), ref)
    got = torch_p_frame(kw, (y, u, v), ref)
    assert_p_frames_equal(want, got)
    # motion the two-level search cannot reach (+-32 px)
    assert (np.abs(got[0].mv[..., 0]) > 32 * 4).any()


def test_far_stream_decodes_to_recon(tmp_path):
    """tests/test_me_far.py::test_me_far_e2e_conformance's pan through the
    port: I + 2 P at 40 px per frame, deblocking on."""
    w, h = 128, 64
    cfg = EncoderConfig(width=w, height=h, qp=30, gop_size=1,
                        intra_period=0, sao=False, deblocking=True,
                        sign_hiding=True, cu_size=16, me_range=64,
                        reinit_gop_on_scene_change=False)
    enc = Encoder(cfg, device="cpu")
    base = make_yuv(np.random.RandomState(8), w + 256, h)[0]
    us = np.full((h // 2, w // 2), 120, np.uint8)
    vs = np.full((h // 2, w // 2), 136, np.uint8)
    descs = []
    emit = enc._pipeline._emit

    def spy(desc, *a, **k):
        descs.append(desc)
        return emit(desc, *a, **k)
    enc._pipeline._emit = spy
    efs = [e for t in range(3)
           for e in enc.encode(base[:, 40 * t:40 * t + w].copy(), us, vs)]
    efs += list(enc.flush())
    assert [e.frame_type for e in efs] == ["I", "P", "P"]
    assert all((np.abs(d.mv[..., 0]) > 32 * 4).any() for d in descs[1:])
    path = tmp_path / "far.265"
    path.write_bytes(b"".join(e.annex_b() for e in efs))
    dec = decode_annexb(path)
    assert len(dec) == 3
    for d, e in zip(dec, efs):
        assert np.array_equal(d, e.recon["y"])
