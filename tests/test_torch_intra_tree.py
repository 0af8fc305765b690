"""TorchIntraTreeEncoder (the port's intra CU-tree encoder) against the JAX
package: the decision pass equals TpuIntraTreeEncoder.decide; the encode
with deblocking equals the golden tree encode + golden deblock (the
references tests/test_intra_tree.py holds the JAX tree to) at CTU 32 and
64; the whole slice (tree + deblock + SAO through api.Encoder, all-intra
and IPPP) gives the JAX Encoder's Annex-B bytes and decodes to the port's
recon."""

import numpy as np
import pytest
import torch

from homerhevc_tpu.api import Encoder as JaxEncoder
from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.engine.intra_tree_encoder import TpuIntraTreeEncoder
from homerhevc_tpu.hevc.headers import ParamSets as JaxParamSets
from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.engine.intra_tree_encoder import \
    TorchIntraTreeEncoder
from homerhevc_tpu_torch.hevc.headers import ParamSets
from tests.conftest import decode_annexb
from tests.test_intra_tree import _mixed_frame
from tests.torch_golden import assert_p_frames_equal, golden_tree, \
    torch_p_frame

torch.set_num_threads(1)    # one intra-op thread per test worker


def _tree_kw(w, h, qp=32, cu=32, **kw):
    return dict(dict(width=w, height=h, qp=qp, gop_size=0, cu_size=cu,
                     sao=False, deblocking=False, sign_hiding=True,
                     intra_rdo=True), **kw)


def _torch_tree(kw):
    cfg = EncoderConfig(**kw)
    return TorchIntraTreeEncoder(ParamSets.from_config(cfg), cfg,
                                 device="cpu")


def test_tree_decision_matches_jax():
    w, h = 96, 64
    kw = _tree_kw(w, h)
    y, u, v = _mixed_frame(np.random.RandomState(40), w, h)
    jcfg = JaxConfig(**kw)
    want = TpuIntraTreeEncoder(JaxParamSets.from_config(jcfg), jcfg) \
        .decide(y, u, v, 32)
    got = _torch_tree(kw).decide(y, u, v, 32)
    assert np.array_equal(got.depth8, want.depth8)
    assert np.array_equal(got.mode8, want.mode8)
    assert np.array_equal(got.chroma8, want.chroma8)
    assert len(np.unique(got.depth8)) == 3      # CU32, CU16 and CU8 occur


@pytest.mark.parametrize("cu,qp,deblock", [(32, 32, False), (32, 27, True),
                                           (64, 32, True), (64, 27, False)])
def test_tree_encode_matches_golden(cu, qp, deblock):
    """Recon, maps and coefficients == golden. At CTU 64 a CTB32 that
    starts a CTU64 predicts from the below-left samples of the previous
    CTU64 (the decoder has them), which the CTU-64 step order provides."""
    w, h = 128, 64
    y, u, v = _mixed_frame(np.random.RandomState(cu + qp), w, h)
    kw = _tree_kw(w, h, qp=qp, cu=cu, deblocking=deblock)
    gdesc, gy, gu, gv = golden_tree(
        JaxParamSets.from_config(JaxConfig(**kw)), y, u, v, qp)
    desc, ry, ru, rv = _torch_tree(kw).encode_frame(y, u, v, qp)
    assert np.array_equal(desc.cu_depth, gdesc.cu_depth)
    assert np.array_equal(desc.luma_mode, gdesc.luma_mode)
    assert np.array_equal(desc.chroma_mode, gdesc.chroma_mode)
    for a, b in ((ry, gy), (ru, gu), (rv, gv)):
        assert np.array_equal(np.asarray(a), b.astype(np.uint8))
    desc.densify()
    for f in ("coef_y", "coef_u", "coef_v"):
        assert np.array_equal(getattr(desc, f), getattr(gdesc, f)), f
    assert len(np.unique(desc.cu_depth)) >= 2


def test_tree_ctu64_stream_decodes_to_recon(tmp_path):
    """At CTU 64 the CU32 node of a CTB32 that starts a CTU64 predicts
    from the below-left samples of the previous CTU64's last CTB32. On
    this frame the mode uses them: the port's stream decodes to its
    recon, where the JAX tree program (which schedules CTB32s by the CTU32
    wavefront and reads zeros there) gives one that does not (3977 luma
    samples differ on this frame)."""
    w, h = 128, 64
    kw = _tree_kw(w, h, cu=64)
    y, u, v = _mixed_frame(np.random.RandomState(2), w, h)
    enc = Encoder(EncoderConfig(**kw), device="cpu")
    efs = list(enc.encode(y, u, v)) + list(enc.flush())
    path = tmp_path / "tree64.265"
    path.write_bytes(efs[0].annex_b())
    assert np.array_equal(decode_annexb(path)[0], efs[0].recon["y"])
    # the same recon as golden (decode order over CTU64s)
    _, gy, _, _ = golden_tree(JaxParamSets.from_config(JaxConfig(**kw)),
                              y, u, v, 32)
    assert np.array_equal(efs[0].recon["y"], gy.astype(np.uint8))


# the stream tests' configuration: tests/test_intra_tree.py::
# test_device_tree_sao_pipeline_e2e's (96x64, CU32, intra_rdo, SAO +
# deblocking, one frame in flight)
_STREAM_KW = _tree_kw(96, 64, sao=True, deblocking=True)


@pytest.fixture(scope="module")
def jax_tree_encoder():
    """The JAX intra tree program at the stream tests' shape, traced once
    for both (tracing its vmapped scan takes minutes on a CPU). It reads
    only the width, height and QP of its config, which the all-intra and
    IPPP configurations share."""
    jcfg = JaxConfig(**_STREAM_KW)
    return TpuIntraTreeEncoder(JaxParamSets.from_config(jcfg), jcfg)


def _jax_encoder(kw, tree_encoder):
    enc = JaxEncoder(JaxConfig(**kw))
    enc._pipeline._tpu_intra = tree_encoder
    return enc


def test_tree_sao_stream_matches_jax_and_decodes(tmp_path,
                                                 jax_tree_encoder):
    """The slice as a whole, all-intra: identical Annex-B bytes through
    both Encoders, SAO on in the noisy frame, and an FFmpeg decode equal
    to the recon."""
    w, h = 96, 64
    kw = _STREAM_KW
    rng = np.random.RandomState(41)
    frames = [_mixed_frame(rng, w, h) for _ in range(2)]
    y2, u2, v2 = frames[1]
    frames[1] = (np.clip(y2.astype(int) + rng.randint(-8, 9, y2.shape),
                         0, 255).astype(np.uint8), u2, v2)

    def encode(enc):
        return [e for f in frames for e in enc.encode(*f)] + \
            list(enc.flush())
    want = encode(_jax_encoder(kw, jax_tree_encoder))
    torch_enc = Encoder(EncoderConfig(**kw), device="cpu")
    sao = []
    emit = torch_enc._pipeline._emit

    def spy(desc, *a, **k):
        sao.append(desc.sao_params)
        return emit(desc, *a, **k)
    torch_enc._pipeline._emit = spy
    got = encode(torch_enc)
    stream = b"".join(e.annex_b() for e in got)
    assert stream == b"".join(e.annex_b() for e in want)
    assert (sao[1].type_luma != 0).any() or (sao[1].type_chroma != 0).any()
    path = tmp_path / "tree_sao.265"
    path.write_bytes(stream)
    dec = decode_annexb(path)
    assert len(dec) == 2
    for d, e in zip(dec, got):
        assert np.array_equal(d, e.recon["y"])


def test_tree_ippp_stream_matches_jax_and_decodes(tmp_path,
                                                  jax_tree_encoder):
    """BASELINE config 4's shape at a small size, IPPP: the tree I frame
    and two CTU-32 P frames with deblocking and SAO through both Encoders
    give identical Annex-B bytes, which decode to the port's recon; the
    port's P program equals the JAX Encoder's from the same reference."""
    w, h = 96, 64
    kw = dict(_STREAM_KW, gop_size=1, intra_period=0,
              reinit_gop_on_scene_change=False)
    rng = np.random.RandomState(42)
    y, u, v = _mixed_frame(rng, w, h)
    frames = [(np.clip(np.roll(y, 2 * t, 1).astype(int)
                       + rng.randint(-3, 4, y.shape), 0, 255)
               .astype(np.uint8), np.roll(u, t, 1), np.roll(v, t, 1))
              for t in range(3)]

    def encode(enc):
        return [e for f in frames for e in enc.encode(*f)] + \
            list(enc.flush())
    jax_enc = _jax_encoder(kw, jax_tree_encoder)
    want = encode(jax_enc)
    got = encode(Encoder(EncoderConfig(**kw), device="cpu"))
    assert [e.frame_type for e in got] == ["I", "P", "P"]
    stream = b"".join(e.annex_b() for e in got)
    assert stream == b"".join(e.annex_b() for e in want)
    path = tmp_path / "tree_ippp.265"
    path.write_bytes(stream)
    dec = decode_annexb(path)
    assert len(dec) == 3
    for d, e in zip(dec, got):
        assert np.array_equal(d, e.recon["y"])
    # the P program alone: the JAX Encoder's (compiled above) and the
    # port's, from the first frame's recon
    ref = tuple(want[0].recon[c] for c in "yuv")
    jax_p = jax_enc._pipeline._get_tpu_inter().encode_frame(
        frames[1], ref, 900.0)
    torch_p = torch_p_frame(kw, frames[1], ref, 900.0)
    assert_p_frames_equal(jax_p, torch_p)
    assert (torch_p[0].cu_depth == 0).any(), "no CU32 chosen"
    assert (torch_p[0].sao_params.type_luma != 0).any()
