"""TorchIntraTreeEncoder (the port's intra CU-tree encoder) against the JAX
package: the decision pass equals TpuIntraTreeEncoder.decide; the encode
with deblocking equals the golden tree encode + golden deblock (the
references tests/test_intra_tree.py holds the JAX tree to) at CTU 32 and
64; the whole slice (tree + deblock + SAO through api.Encoder, all-intra,
IPPP, IBP, generalized-B and three references) gives the JAX Encoder's
Annex-B bytes and decodes to the port's recon. The streams share one JAX tree program and
one JAX P / B program (the B program is also held to the port's _impl_b
here, field by field)."""

import numpy as np
import pytest
import torch

from homerhevc_tpu.api import Encoder as JaxEncoder
from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.engine.inter_encoder import TpuInterEncoder
from homerhevc_tpu.engine.intra_tree_encoder import TpuIntraTreeEncoder
from homerhevc_tpu.hevc.headers import ParamSets as JaxParamSets
from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
from homerhevc_tpu_torch.engine.intra_tree_encoder import \
    TorchIntraTreeEncoder
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.state import reference_from_numpy
from tests.conftest import decode_annexb
from tests.test_intra_tree import _mixed_frame
from tests.test_multiref import _flicker_frames
from tests.torch_golden import (B_FIELDS, P_FIELDS, IntSums,
                                assert_p_frames_equal, golden_tree,
                                interpret_sweep, spec_amvp, spec_amvp_mref,
                                torch_p_frame)

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


# the inter streams' configuration: IPPP at the same shape
_INTER_KW = dict(_STREAM_KW, gop_size=1, intra_period=0,
                 reinit_gop_on_scene_change=False)


@pytest.fixture(scope="module")
def jax_inter_encoder():
    """The JAX P program, and on first use its B program, at the stream
    tests' shape with the IPPP search range (16), built once for the
    IPPP, IBP and generalized-B streams and the B program test. It reads
    the geometry, CTU, deblocking, SAO, sign hiding and QP of its config,
    which these configurations share. The tests that reach its B program
    run the coarse sweep in interpret mode (interpret_sweep): whichever
    of them traces the B program first, it is the same program."""
    jcfg = JaxConfig(**_INTER_KW)
    return TpuInterEncoder(JaxParamSets.from_config(jcfg), jcfg)


def _jax_encoder(kw, tree_encoder, inter_encoder=None):
    enc = JaxEncoder(JaxConfig(**kw))
    enc._pipeline._tpu_intra = tree_encoder
    if inter_encoder is not None:
        enc._pipeline._tpu_inter = inter_encoder
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
                                                  jax_tree_encoder,
                                                  jax_inter_encoder):
    """BASELINE config 4's shape at a small size, IPPP: the tree I frame
    and two CTU-32 P frames with deblocking and SAO through both Encoders
    give identical Annex-B bytes, which decode to the port's recon; the
    port's P program equals the JAX Encoder's from the same reference."""
    w, h = 96, 64
    kw = _INTER_KW
    rng = np.random.RandomState(42)
    y, u, v = _mixed_frame(rng, w, h)
    frames = [(np.clip(np.roll(y, 2 * t, 1).astype(int)
                       + rng.randint(-3, 4, y.shape), 0, 255)
               .astype(np.uint8), np.roll(u, t, 1), np.roll(v, t, 1))
              for t in range(3)]

    def encode(enc):
        return [e for f in frames for e in enc.encode(*f)] + \
            list(enc.flush())
    jax_enc = _jax_encoder(kw, jax_tree_encoder, jax_inter_encoder)
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
    jax_p = jax_inter_encoder.encode_frame(frames[1], ref, 900.0)
    torch_p = torch_p_frame(kw, frames[1], ref, 900.0)
    assert_p_frames_equal(jax_p, torch_p)
    assert (torch_p[0].cu_depth == 0).any(), "no CU32 chosen"
    assert (torch_p[0].sao_params.type_luma != 0).any()


def _bi_inputs(seed=1):
    """A source and two references, each the source moved by 2 px (one to
    each side) with heavy noise and a third of it replaced by unrelated
    noise (list 0's right third, list 1's left third): the noise makes
    bi-prediction win in the middle, each list alone wins where the other
    is unrelated, and CU32 and CU16 both occur."""
    w, h = 96, 64
    rng = np.random.RandomState(seed)
    y, u, v = _mixed_frame(rng, w, h)

    def ref(shift, junk):
        p = np.roll(y, shift, 1).astype(int) + rng.randint(-20, 21, y.shape)
        p[:, junk] = rng.randint(0, 256, (h, 32))
        return (np.clip(p, 0, 255).astype(np.uint8),
                np.roll(u, shift // 2, 1), np.roll(v, shift // 2, 1))
    return (y, u, v), ref(2, slice(64, 96)), ref(-2, slice(0, 32))


def _full_swing_inputs():
    """Full-swing noise and its negative as both references (every
    prediction 255 away from the source): at QP 51 with the zero-forcing
    cap, a 32x32 CU's SSD passes 2^24."""
    rng = np.random.RandomState(5)
    ref = tuple((rng.rand(*s) > 0.5).astype(np.uint8) * 255
                for s in ((64, 96), (32, 48), (32, 48)))
    return tuple(255 - p for p in ref), ref, ref


@pytest.mark.parametrize("case", ["mixed", "full-swing"])
def test_b_program_matches_jax(case, jax_inter_encoder, monkeypatch):
    """The bi-capable program (_impl_b) against the JAX TpuInterEncoder's
    encode_frame_b at CTU 32 with deblocking and SAO: both lists' MVs,
    the directions, tree, levels, recon, the per-row SSD, the SAO
    parameters and the merge / AMVP syntax (the JAX syntax selection with
    the spec's two-list AMVP list, spec_amvp). "mixed" codes uni-L0,
    uni-L1 and bi CUs at CU16 and CU32; "full-swing" takes 32x32 sums past
    2^24, where the port's exact SSD rounded once may part from JAX's
    float32 sum, and every field still agrees."""
    interpret_sweep(monkeypatch)
    spec_amvp(monkeypatch)
    kw = dict(_INTER_KW, gop_size=2)
    cfg = EncoderConfig(**kw)
    enc = TorchInterEncoder(ParamSets.from_config(cfg), cfg, device="cpu")
    if case == "mixed":
        src, r0, r1 = _bi_inputs()
        args = {}
    else:
        src, r0, r1 = _full_swing_inputs()
        args = dict(avg_dist=1e9, qp=51)
    want = jax_inter_encoder.encode_frame_b(src, r0, r1, **args)
    sums = IntSums()
    with sums:
        got = enc.encode_frame_b(src, reference_from_numpy(r0, "cpu"),
                                 reference_from_numpy(r1, "cpu"), **args)
    assert_p_frames_equal(want, got, P_FIELDS + B_FIELDS)
    wp, gp = want[0].sao_params, got[0].sao_params
    for f in vars(wp):
        assert np.array_equal(getattr(wp, f), getattr(gp, f)), f
    dirs, depth = got[0].inter_dir, got[0].cu_depth
    if case == "mixed":
        assert set(np.unique(dirs)) == {1, 2, 3}
        assert set(np.unique(depth)) == {0, 1}
        assert (gp.type_luma != 0).any()
    else:
        assert sums.largest[32 * 32] > 2 ** 24
        assert (dirs == 3).any()


def _stream_frames(n, seed, noise=3):
    """n frames of the mixed frame panning right by 2 px a frame, with
    noise of +-noise."""
    rng = np.random.RandomState(seed)
    y, u, v = _mixed_frame(rng, 96, 64)
    return [(np.clip(np.roll(y, 2 * t, 1).astype(int)
                     + rng.randint(-noise, noise + 1, y.shape), 0, 255)
             .astype(np.uint8), np.roll(u, t, 1), np.roll(v, t, 1))
            for t in range(n)]


def _decodes_to_recon(efs, tmp_path):
    """The 8x8 units where an FFmpeg decode of the frames' stream differs
    from their recon, by display index (empty where it agrees)."""
    path = tmp_path / "b.265"
    path.write_bytes(b"".join(e.annex_b() for e in efs))
    dec = decode_annexb(path)
    assert len(dec) == len(efs)
    return {e.poc: int(((dec[e.poc] != e.recon["y"]).reshape(
        dec[e.poc].shape[0] // 8, 8, -1, 8).any(axis=(1, 3))).sum())
        for e in efs if not np.array_equal(dec[e.poc], e.recon["y"])}


def _b_stream(kw, frames, tmp_path, tree_encoder, inter_encoder):
    """The stream of kw through both Encoders, the port's P / B programs
    at the JAX one's search range (16), the JAX package with the spec's
    two-list AMVP list (spec_amvp, applied by the caller); asserts
    identical Annex-B bytes and an FFmpeg decode equal to the port's recon
    (in display order). Returns the port's frames (decode order) and
    FrameDescs."""
    jax_enc = _jax_encoder(kw, tree_encoder, inter_encoder)
    port = Encoder(EncoderConfig(**kw), device="cpu")
    pipe = port._pipeline
    pipe._inter_enc = TorchInterEncoder(pipe.ps, pipe.cfg,
                                        search=inter_encoder.search,
                                        device="cpu")
    descs = []
    emit = pipe._emit

    def spy(desc, *a, **k):
        descs.append(desc)
        return emit(desc, *a, **k)
    pipe._emit = spy

    def encode(enc):
        return [e for f in frames for e in enc.encode(*f)] + \
            list(enc.flush())
    want = encode(jax_enc)
    got = encode(port)
    assert b"".join(e.annex_b() for e in got) == \
        b"".join(e.annex_b() for e in want)
    assert _decodes_to_recon(got, tmp_path) == {}
    return got, descs


def test_ibp_stream_matches_jax_and_decodes(tmp_path, jax_tree_encoder,
                                            jax_inter_encoder, monkeypatch):
    """IBP at CTU 32 with intra_rdo, deblocking and SAO, 8 frames: decode
    order I0 P2 B1 A4 B3 A6 B5 P7, the anchors from A4 on bi-predicted
    from the two anchors before (l1_swap), the B frames from both anchors
    around them, the last frame a trailing P. Both pipelines search +-24
    by default in IBP; here both run the JAX P / B programs' range so
    that the programs are built once for the module.

    The JAX package's own stream of these frames does not decode to its
    recon: A6 codes a bi CU16 at the left picture edge whose list-1 MV
    difference is taken from a list of AMVP candidates a decoder does not
    derive (the same-POC above candidate alone, where the spec adds the
    first above neighbour's scaled MV), and A6, B5 and P7 differ from the
    recon in 8x8 units of that CU and the next. The port codes the spec's
    list: its stream equals the JAX package's with that one derivation
    corrected (spec_amvp), and decodes to the port's recon."""
    kw = dict(_INTER_KW, gop_size=2)
    for enc in (Encoder(EncoderConfig(**kw), device="cpu"),
                JaxEncoder(JaxConfig(**kw))):
        assert enc._pipeline._inter_search_range() == 24
    frames = _stream_frames(8, 43)
    interpret_sweep(monkeypatch)
    faulty = _jax_encoder(kw, jax_tree_encoder, jax_inter_encoder)
    bad = _decodes_to_recon([e for f in frames for e in faulty.encode(*f)]
                            + list(faulty.flush()), tmp_path)
    assert set(bad) == {5, 6, 7}
    spec_amvp(monkeypatch)
    got, descs = _b_stream(kw, frames, tmp_path, jax_tree_encoder,
                           jax_inter_encoder)
    assert [e.frame_type for e in got] == ["I", "P", "B", "B", "B", "B",
                                           "B", "P"]
    assert [e.poc for e in got] == [0, 2, 1, 4, 3, 6, 5, 7]
    dirs = np.concatenate([d.inter_dir.ravel() for d in descs
                           if d.inter_dir is not None])
    assert (dirs == 3).any() and (dirs != 3).any()


def test_gpb_stream_matches_jax_and_decodes(tmp_path, jax_tree_encoder,
                                            jax_inter_encoder, monkeypatch):
    """Two references at CTU 32 (num_ref_frames 2, IPPP): every frame after
    the second is a generalized-B slice bi-predicted from t-1 and t-2 (t-2
    in list 1 by l1_swap), through the depth-2 P chain; against the JAX
    package with the spec's two-list AMVP list (spec_amvp). The frames are
    noisy enough that averaging the two references wins in every B
    frame."""
    interpret_sweep(monkeypatch)
    spec_amvp(monkeypatch)
    kw = dict(_INTER_KW, num_ref_frames=2)
    got, descs = _b_stream(kw, _stream_frames(5, 44, noise=10), tmp_path,
                           jax_tree_encoder, jax_inter_encoder)
    assert [e.frame_type for e in got] == ["I", "P", "B", "B", "B"]
    assert [e.poc for e in got] == [0, 1, 2, 3, 4]
    assert all((d.inter_dir == 3).any() for d in descs[2:])


@pytest.mark.parametrize("changes,types", [
    pytest.param(dict(intra_rdo=False), "IPP", id="ippp-cu32"),
    pytest.param(dict(rd_mode=1), "IPP", id="ippp-rd_full"),
    pytest.param(dict(rd_mode=1, gop_size=2), "IPBBB", id="ibp-rd_full")])
def test_host_i_frame_streams_match_jax_and_decode(changes, types, tmp_path,
                                                   jax_tree_encoder,
                                                   jax_inter_encoder,
                                                   monkeypatch):
    """CTU 32 with I frames on the host programs, their P and B frames on
    the device programs: IPPP without intra_rdo (fixed CU32 I frames),
    and RD_FULL (the host tree with NxN PUs, TU splits and the chroma
    RDO) in IPPP and IBP (decode order I0 P2 B1 A4 B3, the anchor A4
    bi-predicted, its I frame through _encode_gop2), with deblocking and
    SAO, against the JAX Encoder with the module's P / B program (search
    16 in both; the spec's two-list AMVP list, spec_amvp): identical bytes
    and an FFmpeg decode equal to the port's recon."""
    interpret_sweep(monkeypatch)
    spec_amvp(monkeypatch)
    kw = dict(_INTER_KW, **changes)
    frames = _stream_frames(len(types), 45, noise=6)
    got, descs = _b_stream(kw, frames, tmp_path, jax_tree_encoder,
                           jax_inter_encoder)
    assert "".join(e.frame_type for e in got) == types
    if kw.get("rd_mode"):
        assert descs[0].part_nxn.any() or descs[0].tr_depth.any()


def test_multireference_ctu32_stream_matches_jax_and_decodes(
        tmp_path, jax_tree_encoder, jax_inter_encoder, monkeypatch):
    """Three references at CTU 32 (num_ref_frames 3, IPPP, deblocking and
    SAO) with an IDR at frame 4: I0 on the tree program, P1 and the
    generalized-B B2 (t-1 and t-2) on the device chain, P3 a
    three-reference CU16 frame on the host program once the reference
    queue holds two pictures (the chain drained and dropped first, the
    host SAO after it), then I4 and P5 on the device again. Against the
    JAX Encoder on the module's programs (search 16 in both) with the
    spec's AMVP lists (spec_amvp, spec_amvp_mref): identical bytes and an
    FFmpeg decode equal to the port's recon; P3 codes CUs at ref_idx 1
    or 2."""
    interpret_sweep(monkeypatch)
    spec_amvp(monkeypatch)
    spec_amvp_mref(monkeypatch)
    kw = dict(_INTER_KW, num_ref_frames=3, intra_period=4)
    frames = _flicker_frames(np.random.RandomState(2), 96, 64, 6)
    got, descs = _b_stream(kw, frames, tmp_path, jax_tree_encoder,
                           jax_inter_encoder)
    assert "".join(e.frame_type for e in got) == "IPBPIP"
    assert [d.ref_idx is not None for d in descs] == [False, False, False,
                                                     True, False, False]
    assert (descs[3].ref_idx >= 1).any()
