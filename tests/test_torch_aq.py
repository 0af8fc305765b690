"""Per-CTB QP maps (AQ and row-RC) in the port against the JAX package, on
the CPU, bit-exact throughout: the quant tier with per-block QP vectors,
the CU16 intra program with a map (TpuIntraEncoder's
_encode_frame_impl_aq), the P program with a map at CU16 and CU64
(TpuInterEncoder._impl(qp_map=)), and whole streams through both
Encoders (all-intra AQ batched; IPPP AQ + row-RC under CBR with WPP off
and on; IPPP CBR and VBR without maps), each decoding in FFmpeg to the
port's recon. Each JAX program is built once, in a module fixture, and
injected into the JAX Encoders; the P programs' coarse sweep runs in
Pallas interpret mode (tests/torch_golden.interpret_sweep). The CU64 map
program also codes the P frames of an IPPP stream whose I frames take the
host tree (intra_rdo with maps). The module's I and P programs also code
an IBP stream with maps (its anchors with their maps, its B frames with
none) and the device frames of a three-reference stream (whose frames
with three references take the host program); a CTU-32 IBP stream with
maps builds its own P and B programs."""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from homerhevc_tpu.api import Encoder as JaxEncoder
from homerhevc_tpu.config import BitrateMode as JaxBitrateMode
from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.engine.inter_encoder import TpuInterEncoder
from homerhevc_tpu.engine.intra_encoder import TpuIntraEncoder
from homerhevc_tpu.hevc.headers import ParamSets as JaxParamSets
from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import BitrateMode, EncoderConfig
from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
from homerhevc_tpu_torch.engine.intra_encoder import TorchIntraEncoder
from homerhevc_tpu_torch.engine.rate_control import aq_qp_map
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.state import reference_from_numpy
from tests.conftest import decode_annexb, make_yuv
from tests.test_multiref import _flicker_frames
from tests.torch_golden import (P_FIELDS, assert_p_frames_equal,
                                interpret_sweep, spec_amvp, spec_amvp_mref,
                                spec_mref_rps)

torch.set_num_threads(1)    # one intra-op thread per test worker


@pytest.fixture(scope="module", autouse=True)
def _sweep_in_interpret_mode():
    """The JAX P programs' coarse sweep as its Pallas kernel in interpret
    mode (bit-identical to the unrolled sweep, faster to compile), for
    every program this module traces."""
    with pytest.MonkeyPatch.context() as mp:
        interpret_sweep(mp)
        yield


# ---- the quant tier --------------------------------------------------------

@pytest.mark.parametrize("n,sl", [(n, sl) for n in (4, 8, 16, 32)
                                  for sl in (False, True)])
def test_quant_tier_with_per_block_qp_matches_jax(n, sl):
    """quantize, dequantize and sign_bit_hiding with an int32 QP vector of
    the block dims (traced in JAX), intra and inter, and the intra SBH by
    per-block scan class: the port's one call with a scan-class tensor
    against the JAX encoder's three calls and select (_sbh_by_scan_q).
    Bit-exact."""
    import types

    import jax
    import jax.numpy as jnp

    from homerhevc_tpu.ops import quant as jq
    from homerhevc_tpu_torch.ops import quant as tq
    rng = np.random.RandomState(n + 100 * sl)
    B = 96
    # mostly small coefficients (SBH-eligible CGs), some large ones
    coef = (rng.laplace(0, 40 if n <= 8 else 120, (B, n, n))
            .clip(-32768, 32767).astype(np.int32))
    qp = rng.randint(0, 52, B).astype(np.int32)
    modes = rng.randint(0, 35, B).astype(np.int32)
    fake = types.SimpleNamespace(ps=types.SimpleNamespace(
        scaling_list_enabled=sl))
    tc, tqp, tm = (torch.as_tensor(a) for a in (coef, qp, modes))
    for intra in (True, False):
        jl = jax.jit(lambda c, q: jq.quantize(c, n, q, intra, sl))(coef, qp)
        tl = tq.quantize(tc, n, tqp, intra, sl)
        assert np.array_equal(np.asarray(jl), tl.numpy()), "quantize"
        jd = jax.jit(lambda lv, q: jq.dequantize(lv, n, q, intra, sl))(
            np.asarray(jl), qp)
        assert np.array_equal(np.asarray(jd),
                              tq.dequantize(tl, n, tqp, intra, sl).numpy()), \
            "dequantize"
        js = jax.jit(lambda lv, c, q: jq.sign_bit_hiding(
            lv, c, n, q, intra, 0, sl))(np.asarray(jl), coef, qp)
        ts = tq.sign_bit_hiding(tl, tc, n, tqp, intra, 0, sl)
        assert np.array_equal(np.asarray(js), ts.numpy()), "sbh"
        assert (ts != tl).any(), "no CG needed a parity fix"
    for luma in (True, False):
        jl = jq.quantize(coef, n, jnp.asarray(qp), True, sl)
        js = jax.jit(lambda lv, c, q, m: TpuIntraEncoder._sbh_by_scan_q(
            fake, lv, c, n, q, TpuIntraEncoder._scan_class(None, m, n, luma),
            luma))(np.asarray(jl), coef, qp, modes)
        ts = tq.sign_bit_hiding(tq.quantize(tc, n, tqp, True, sl), tc, n,
                                tqp, True, tq.scan_class(tm, n, luma), sl)
        assert np.array_equal(np.asarray(js), ts.numpy()), "sbh by scan"


# ---- the CU16 intra program with a map -------------------------------------

# chip_smoke.py's AQ cells (AQ_DIGESTS): the streams below are theirs
_INTRA_CELL, _IPPP_CELL = chip_smoke.AQ_CELLS
_INTRA_KW = {**chip_smoke.AQ_CFG, **chip_smoke.AQ_CELLS[_INTRA_CELL][0]}
_W_I, _H_I = _INTRA_KW["width"], _INTRA_KW["height"]


def _aq_frames(seed, w, h, n):
    """n frames of make_yuv content, each with a flat band over its top
    quarter, so that the AQ map carries deltas."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        y, u, v = make_yuv(rng, w, h)
        y[:h // 4] = 90
        out.append((y, u, v))
    return out


@pytest.fixture(scope="module")
def jax_intra_aq():
    """The JAX CU16 AQ program at 96x64 for batches of 3, traced once for
    the program test and the batched stream."""
    jcfg = JaxConfig(**_INTRA_KW)
    return TpuIntraEncoder(JaxParamSets.from_config(jcfg), jcfg)


def test_intra_aq_program_matches_jax(jax_intra_aq):
    """TorchIntraEncoder.encode_frames(qp_maps=) against
    TpuIntraEncoder.encode_frames(qp_maps=) on three frames with mixed
    QPs: modes, levels, recon and desc.qp_map, bit-exact."""
    frames = _aq_frames(19, _W_I, _H_I, 3)
    qps = [30, 27, 34]
    maps = [aq_qp_map(f[0], 16, q, 2.0) for f, q in zip(frames, qps)]
    assert all((m != q).any() for m, q in zip(maps, qps))
    ys, us, vs = zip(*frames)
    want = jax_intra_aq.encode_frames(ys, us, vs, qps=qps, qp_maps=maps)
    cfg = EncoderConfig(**_INTRA_KW)
    got = TorchIntraEncoder(ParamSets.from_config(cfg), cfg,
                            device="cpu").encode_frames(ys, us, vs, qps=qps,
                                                        qp_maps=maps)
    for (wd, *wrec), (gd, *grec) in zip(want, got):
        wd.densify()
        gd.densify()
        for f in ("luma_mode", "chroma_mode", "coef_y", "coef_u", "coef_v",
                  "qp_map"):
            assert np.array_equal(getattr(wd, f), getattr(gd, f)), f
        for a, b in zip(wrec, grec):
            assert np.array_equal(np.asarray(a), np.asarray(b)), "recon"


def _encode(enc, frames):
    return [e for f in frames for e in enc.encode(*f)] + list(enc.flush())


def _digests(efs):
    return chip_smoke.digests(b"".join(e.annex_b() for e in efs),
                              [e.recon[c] for e in efs for c in "yuv"])


def _assert_same_stream_and_decodes(want, got, path, n):
    """The same frame types, Annex-B bytes and recon planes, and an FFmpeg
    decode of the n frames equal to the port's recon (display order)."""
    stream = b"".join(e.annex_b() for e in got)
    assert [e.frame_type for e in got] == [e.frame_type for e in want]
    assert stream == b"".join(e.annex_b() for e in want)
    for a, b in zip(want, got):
        assert all(np.array_equal(a.recon[c], b.recon[c]) for c in "yuv")
    path.write_bytes(stream)
    dec = decode_annexb(path)
    assert len(dec) == n
    for e in got:
        assert np.array_equal(dec[e.poc], e.recon["y"]), e.poc


def test_intra_aq_batched_stream_matches_jax_and_decodes(tmp_path,
                                                         jax_intra_aq):
    """All-intra AQ, 3 frames in flight (the maps ride the batch and the
    background fetch), chip_smoke.py's cell: the Annex-B bytes of both
    Encoders are identical, hash to AQ_DIGESTS, and decode in FFmpeg to
    the port's recon. Bit-exact."""
    n = chip_smoke.AQ_CELLS[_INTRA_CELL][1]
    frames = chip_smoke.aq_frames(n, _W_I, _H_I)
    jenc = JaxEncoder(JaxConfig(**_INTRA_KW))
    jenc._pipeline._tpu_intra = jax_intra_aq
    want = _encode(jenc, frames)
    assert _digests(want) == chip_smoke.AQ_DIGESTS[_INTRA_CELL]
    enc = Encoder(EncoderConfig(**_INTRA_KW), device="cpu")
    descs = []
    emit = enc._pipeline._emit

    def spy(desc, *a, **k):
        descs.append(desc)
        return emit(desc, *a, **k)
    enc._pipeline._emit = spy
    got = _encode(enc, frames)
    assert len(got) == n and all((d.qp_map != 30).any() for d in descs)
    _assert_same_stream_and_decodes(want, got, tmp_path / "aq_batch.265", n)


# ---- the P program with a map, and the IPPP streams ------------------------

_IPPP_AQ_KW = {**chip_smoke.AQ_CFG, **chip_smoke.AQ_CELLS[_IPPP_CELL][0]}
_W_P, _H_P = _IPPP_AQ_KW["width"], _IPPP_AQ_KW["height"]


def _jax_pair(kw):
    """The JAX I and P programs of the configuration kw (the P program at
    the IPPP search range, 16)."""
    jcfg = JaxConfig(**kw)
    ps = JaxParamSets.from_config(jcfg)
    return TpuIntraEncoder(ps, jcfg), TpuInterEncoder(ps, jcfg)


@pytest.fixture(scope="module")
def jax_ippp_aq():
    """The JAX I (AQ) and P (with a map) programs at 128x64, shared by the
    CU16 P program test and the row-RC streams (WPP does not reach
    them)."""
    return _jax_pair(_IPPP_AQ_KW)


def _p_inputs(seed, w, h):
    """A source with a flat band (AQ deltas) and its reference three
    pixels to the left with noise (odd chroma shift: the half-pel chroma
    path)."""
    rng = np.random.RandomState(seed)
    y, u, v = make_yuv(rng, w, h)
    y[:16] = 80
    ref = (np.clip(np.roll(y, 3, 1).astype(int) + rng.randint(-3, 4, y.shape),
                   0, 255).astype(np.uint8), np.roll(u, 1, 1),
           np.roll(v, 1, 1))
    return (y, u, v), ref


def _split_motion(ref_y):
    """(source, reference) at 128x64 from the luma plane ref_y: the left
    CTB64 a flat gradient in both (one CU64 at a low AQ QP), the source's
    right CTB64 moving apart over the reference: three 32x32 quadrants
    each with its own motion and the fourth split into 16x16 blocks
    moving apart (CU32 and CU16 CUs)."""
    ref_y = ref_y.copy()
    ref_y[:, :64] = 100 + np.arange(64)[:, None] // 8
    y = ref_y.copy()
    blocks = [(96, 0, 32, 3, 0), (64, 32, 32, -4, 2), (96, 32, 32, 0, -3)]
    blocks += [(64 + 16 * i, 16 * j, 16, d, -d) for i in (0, 1)
               for j, d in zip((0, 1), (5 - 7 * i, 2 + 3 * i))]
    for x0, y0, n, dx, dy in blocks:
        y[y0:y0 + n, x0:x0 + n] = np.roll(ref_y, (dy, dx), (0, 1))[
            y0:y0 + n, x0:x0 + n]
    return y, ref_y


@functools.lru_cache(maxsize=None)
def _jax_p64_aq():
    """The JAX CTU-64 P program with a map at 128x64 (AQ, deblocking off),
    built once for the module: the CU64 P program test and the stream of
    tree I frames with maps share it."""
    kw = dict(_IPPP_AQ_KW, cu_size=64, intra_rdo=True, rc_ctu=False)
    jcfg = JaxConfig(**kw)
    return TpuInterEncoder(JaxParamSets.from_config(jcfg), jcfg)


@pytest.mark.parametrize("cu", [16, 64])
def test_p_program_with_map_matches_jax(cu, jax_ippp_aq):
    """TorchInterEncoder._impl(qp_map=) against
    TpuInterEncoder.encode_frame(qp_map=) from the same reference: MVs,
    coefficients, the syntax fields, recon, the row SSDs and desc.qp_map,
    bit-exact. At CU16 the map's QPs differ across the frame; at CU64 the
    left CTB64 is flat (a lower QP) and the right one textured, and the
    frame codes CU64, CU32 and CU16 CUs, so the quant reads all three QP
    vectors (and their chroma twins)."""
    (y, u, v), ref = _p_inputs(31 + cu, _W_P, _H_P)
    kw = dict(_IPPP_AQ_KW, cu_size=cu, intra_rdo=cu > 16, rc_ctu=False)
    if cu == 64:
        y, ry = _split_motion(ref[0])
        ref = (ry, u, v)
        jenc = _jax_p64_aq()
    else:
        jenc = jax_ippp_aq[1]
    qmap = aq_qp_map(y, cu, 30, 2.0)
    assert len(np.unique(qmap)) >= 2
    want = jenc.encode_frame((y, u, v), ref, qp=30, qp_map=qmap)
    cfg = EncoderConfig(**kw)
    enc = TorchInterEncoder(ParamSets.from_config(cfg), cfg, device="cpu")
    got = enc.encode_frame((y, u, v), reference_from_numpy(ref, "cpu"),
                           qp=30, qp_map=qmap)
    assert_p_frames_equal(want, got, P_FIELDS + ("qp_map",))
    if cu == 64:
        assert set(np.unique(got[0].cu_depth)) == {0, 1, 2}


def _ippp_frames(seed, w, h, n):
    """n frames of one make_yuv picture panning 2 px a frame, noisy, with a
    flat band over the top quarter."""
    rng = np.random.RandomState(seed)
    y, u, v = make_yuv(rng, w, h)
    out = []
    for t in range(n):
        yt = np.clip(np.roll(y, 2 * t, 1).astype(int)
                     + rng.randint(-2, 3, y.shape), 0, 255).astype(np.uint8)
        yt[:h // 4] = 60
        out.append((yt, np.roll(u, t, 1), np.roll(v, t, 1)))
    return out


@pytest.mark.parametrize("wpp", [False, True], ids=["wpp0", "wpp1"])
def test_row_rc_stream_matches_jax_and_decodes(wpp, tmp_path, jax_ippp_aq):
    """IPPP CU16 with AQ and row-RC under CBR (deblocking off),
    chip_smoke.py's cell: each P frame's map is the AQ map plus the row
    offsets of the last P frame's row shares, from its coefficient mass
    (WPP off) or the serializer's exact row sizes (WPP on). Both Encoders
    give identical bytes (with WPP off, AQ_DIGESTS), which decode to the
    port's recon; the row offsets move. Bit-exact. With intra-in-P on,
    the port's stream is the same: a P frame with a map runs no
    intra-in-P (the JAX P program skips it with a map, and its dispatch
    refuses the pair)."""
    n = chip_smoke.AQ_CELLS[_IPPP_CELL][1]
    frames = chip_smoke.aq_frames(n, _W_P, _H_P)
    kw = dict(_IPPP_AQ_KW, wpp=wpp)
    jenc = JaxEncoder(JaxConfig(**kw))
    jenc._pipeline._tpu_intra, jenc._pipeline._tpu_inter = jax_ippp_aq
    want = _encode(jenc, frames)
    if not wpp:
        assert _digests(want) == chip_smoke.AQ_DIGESTS[_IPPP_CELL]
    enc = Encoder(EncoderConfig(**kw), device="cpu")
    offsets = []
    row_offsets = enc._pipeline.rc.row_offsets

    def spy(rows, *a):
        offsets.append(row_offsets(rows, *a))
        return offsets[-1]
    enc._pipeline.rc.row_offsets = spy
    got = _encode(enc, frames)
    assert [e.frame_type for e in got] == ["I"] + ["P"] * (n - 1)
    assert any(o.any() for o in offsets), "no row offset moved"
    _assert_same_stream_and_decodes(want, got, tmp_path / "rowrc.265", n)
    if not wpp:
        ip = _encode(Encoder(EncoderConfig(**kw, intra_in_p=True),
                             device="cpu"), frames)
        assert b"".join(e.annex_b() for e in ip) == \
            b"".join(e.annex_b() for e in got)


_IPPP_RC_KW = dict(width=_W_P, height=_H_P, qp=32, gop_size=1,
                   intra_period=0, sao=False, deblocking=True,
                   sign_hiding=True, cu_size=16, bitrate_kbps=250,
                   reinit_gop_on_scene_change=False)


@pytest.fixture(scope="module")
def jax_ippp_plain():
    """The JAX I and P programs (no maps, deblocking on) at 128x64, shared
    by the CBR and VBR streams."""
    return _jax_pair(dict(_IPPP_RC_KW, bitrate_mode=JaxBitrateMode.CBR))


@pytest.mark.parametrize("mode", ["CBR", "VBR"])
def test_rate_controlled_stream_matches_jax_and_decodes(mode, tmp_path,
                                                        jax_ippp_plain):
    """IPPP CU16 under CBR and VBR without maps: the QP moves from frame to
    frame, fed back through the depth-2 P chain (two frames in flight) in
    both pipelines. Identical bytes, an FFmpeg decode equal to the port's
    recon. Bit-exact."""
    n = 6
    frames = _ippp_frames(29, _W_P, _H_P, n)
    want = _encode(_jax_encoder_rc(mode, jax_ippp_plain), frames)
    got = _encode(Encoder(EncoderConfig(
        **_IPPP_RC_KW, bitrate_mode=BitrateMode[mode]), device="cpu"),
        frames)
    assert len({e.avg_qp for e in got}) >= 3, [e.avg_qp for e in got]
    _assert_same_stream_and_decodes(want, got, tmp_path / f"{mode}.265", n)


def _jax_encoder_rc(mode, pair):
    enc = JaxEncoder(JaxConfig(**_IPPP_RC_KW,
                               bitrate_mode=JaxBitrateMode[mode]))
    enc._pipeline._tpu_intra, enc._pipeline._tpu_inter = pair
    return enc


def test_tree_i_frames_with_maps_stream_matches_jax_and_decodes(tmp_path):
    """IPPP at CTU 64 with intra_rdo, AQ and row-RC under CBR, deblocking
    off, chip_smoke.py's IPPP AQ cell at CTU 64: the I frame on the host
    tree (with no map, as the JAX package codes it), each P frame inline
    on the CU64 P program with its map. Both Encoders (the JAX one on the
    program above) give identical bytes, which decode to the port's
    recon; every P frame carries its map."""
    n = 3
    kw = dict(_IPPP_AQ_KW, cu_size=64, intra_rdo=True)
    frames = chip_smoke.aq_frames(n, _W_P, _H_P)
    jenc = JaxEncoder(JaxConfig(**kw))
    jenc._pipeline._tpu_inter = _jax_p64_aq()
    want = _encode(jenc, frames)
    enc = Encoder(EncoderConfig(**kw), device="cpu")
    maps = []
    emit = enc._pipeline._emit

    def spy(desc, *a, **k):
        maps.append(desc.qp_map)
        return emit(desc, *a, **k)
    enc._pipeline._emit = spy
    got = _encode(enc, frames)
    assert enc._pipeline._intra_enc is None
    assert maps[0] is None and all(m is not None for m in maps[1:])
    _assert_same_stream_and_decodes(want, got, tmp_path / "tree_aq.265", n)


# ---- IBP with maps and multi-reference P on the device programs -------------

def _stream_with_descs(kw, frames, search=None):
    """The port's stream of kw (the P program at the search range given,
    to match a JAX program built for IPPP), and the FrameDescs it emits."""
    enc = Encoder(EncoderConfig(**kw), device="cpu")
    pipe = enc._pipeline
    if search is not None:
        pipe._inter_enc = TorchInterEncoder(pipe.ps, pipe.cfg, search=search,
                                            device="cpu")
    descs = []
    emit = pipe._emit

    def spy(desc, *a, **k):
        descs.append(desc)
        return emit(desc, *a, **k)
    pipe._emit = spy
    return _encode(enc, frames), descs


def test_ibp_with_maps_stream_matches_jax_and_decodes(tmp_path, jax_ippp_aq):
    """IBP at CU16 with AQ and row-RC under CBR, deblocking off, on the
    device programs (Queue 1 item 4): the anchors coded inline with their
    per-CTB maps, the B frames (uni-L0 at CU16) with none, as the JAX
    package codes them; the row shares noted after every P and B frame.
    Both Encoders on the module's I and P programs (the P program at
    IPPP's search range, 16, in both): identical bytes and recon, and an
    FFmpeg decode equal to the port's recon in display order."""
    kw = dict(_IPPP_AQ_KW, gop_size=2, num_b=1)
    frames = chip_smoke.aq_frames(5, _W_P, _H_P)
    jenc = JaxEncoder(JaxConfig(**kw))
    jenc._pipeline._tpu_intra, jenc._pipeline._tpu_inter = jax_ippp_aq
    want = _encode(jenc, frames)
    got, descs = _stream_with_descs(kw, frames, search=16)
    assert [e.frame_type for e in got] == list("IPBPB")
    assert [d.qp_map is None for d in descs] == [False, False, True, False,
                                                True]
    _assert_same_stream_and_decodes(want, got, tmp_path / "ibp_aq.265", 5)


def test_ibp_ctu32_with_maps_stream_matches_jax_and_decodes(tmp_path,
                                                           monkeypatch):
    """IBP at CTU 32 with intra_rdo and AQ, deblocking off: the I frame on
    the host tree (no map), P2 on the CU32 P program with its map, the bi
    anchor A4 and the bi B frames on the B program without one (search
    24 in both pipelines; the JAX Encoder builds its own P and B programs
    here at 64x64). Against the JAX package with the spec's two-list AMVP
    list (spec_amvp: these B frames code a CU at the left picture edge
    that reaches its fault, ROADMAP Queue 3): identical bytes and recon,
    an FFmpeg decode equal to the port's recon in display order; some
    units bi."""
    kw = dict(chip_smoke.AQ_CFG, width=64, height=64, cu_size=32,
              intra_rdo=True, gop_size=2, num_b=1)
    frames = chip_smoke.aq_frames(5, 64, 64)
    spec_amvp(monkeypatch)
    want = _encode(JaxEncoder(JaxConfig(**kw)), frames)
    got, descs = _stream_with_descs(kw, frames)
    assert [e.frame_type for e in got] == list("IPBBB")
    assert [d.qp_map is None for d in descs] == [True, False, True, True,
                                                True]
    assert any((d.inter_dir == 3).any() for d in descs[2:])
    _assert_same_stream_and_decodes(want, got, tmp_path / "ibp32_aq.265", 5)


def test_multireference_stream_on_the_device_chain_matches_jax(
        tmp_path, jax_ippp_plain, monkeypatch):
    """Three references at CU16 (num_ref_frames 3, deblocking on, fixed QP)
    with an IDR at frame 5: I0 P1 P2 on the device P chain (depth 2), P3
    and P4 three-reference frames on the host once the reference queue
    holds two pictures (the chain drained first and dropped), I5, P6 and
    P7 on the device chain again; some CUs of P3 and P4 at ref_idx 1 or
    2. The JAX package's P2 lists P1 alone in its reference picture set,
    so a decoder drops I0, which P3 then predicts from: its stream does
    not decode past P2 (ROADMAP Queue 3). The port lists the whole
    reference queue there. Against the JAX Encoder on the module's I and
    P programs with that RPS (spec_mref_rps) and the spec's
    multi-reference AMVP list (spec_amvp_mref): identical bytes and
    recon, and an FFmpeg decode equal to the port's recon."""
    spec_amvp_mref(monkeypatch)
    kw = dict(_IPPP_RC_KW, num_ref_frames=3, intra_period=5)
    frames = _flicker_frames(np.random.RandomState(3), _W_P, _H_P, 8)

    def jax_stream():
        jenc = JaxEncoder(JaxConfig(**kw))
        jenc._pipeline._tpu_intra, jenc._pipeline._tpu_inter = \
            jax_ippp_plain
        return _encode(jenc, frames)
    faulty = jax_stream()
    path = tmp_path / "faulty.265"
    path.write_bytes(b"".join(e.annex_b() for e in faulty))
    assert len(decode_annexb(path)) < len(frames)
    spec_mref_rps(monkeypatch)
    want = jax_stream()
    got, descs = _stream_with_descs(kw, frames)
    assert [e.frame_type for e in got] == list("IPPPPIPP")
    mref = [d.ref_idx is not None for d in descs]
    assert mref == [False, False, False, True, True, False, False, False]
    assert all((descs[i].ref_idx >= 1).any() for i in (3, 4))
    _assert_same_stream_and_decodes(want, got, tmp_path / "mref.265", 8)
