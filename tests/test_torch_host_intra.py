"""The port's host intra programs (hevc/transform.py, hevc/quantize.py,
hevc/intra_pred.py, hevc/intra_frame.py, hevc/intra_tree.py,
hevc/deblock.py) against the JAX package's golden modules they were copied
from, bit for bit on the same seeded inputs; and the all-intra streams
those programs carry through api.Encoder (RD_FULL, intra_rdo at CU16,
CU64 without intra_rdo, per-CTB AQ maps with deblocking on and with the
tree) against the JAX Encoder's bytes, each decoding in FFmpeg to the
port's recon. Everything here is numpy on both sides: no JAX program is
built."""

import dataclasses

import numpy as np
import pytest
import torch

from homerhevc_tpu.api import Encoder as JaxEncoder
from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.golden import deblock as j_deblock
from homerhevc_tpu.golden import intra_frame as j_frame
from homerhevc_tpu.golden import intra_pred as j_pred
from homerhevc_tpu.golden import intra_tree as j_tree
from homerhevc_tpu.golden import quantize as j_quant
from homerhevc_tpu.golden import transform as j_xform
from homerhevc_tpu.hevc.headers import ParamSets as JaxParamSets
from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import EncoderConfig, RDMode
from homerhevc_tpu_torch.engine.rate_control import aq_qp_map
from homerhevc_tpu_torch.hevc import deblock as t_deblock
from homerhevc_tpu_torch.hevc import intra_frame as t_frame
from homerhevc_tpu_torch.hevc import intra_pred as t_pred
from homerhevc_tpu_torch.hevc import intra_tree as t_tree
from homerhevc_tpu_torch.hevc import quantize as t_quant
from homerhevc_tpu_torch.hevc import transform as t_xform
from homerhevc_tpu_torch.hevc.headers import ParamSets
from tests.conftest import decode_annexb, make_yuv

torch.set_num_threads(1)    # one intra-op thread per test worker

# the FrameDesc fields an intra frame fills
DESC_FIELDS = ("cu_depth", "pred_mode", "part_nxn", "luma_mode",
               "chroma_mode", "tr_depth", "coef_y", "coef_u", "coef_v",
               "qp_map")


def _ps(**kw):
    """(port ParamSets, JAX ParamSets) of one configuration."""
    kw = dict(dict(width=128, height=64, qp=32, sign_hiding=True), **kw)
    return (ParamSets.from_config(EncoderConfig(**kw)),
            JaxParamSets.from_config(JaxConfig(**kw)))


def _frame(seed, w=128, h=64, flat_band=False):
    """make_yuv's textured frame; flat_band: a flat top quarter, where AQ
    lowers the QP and quantization groups code no coefficient."""
    y, u, v = make_yuv(np.random.RandomState(seed), w, h)
    if flat_band:
        y[:h // 4] = 90
        u[:h // 8] = 128
        v[:h // 8] = 128
    return y, u, v


def _detail_frame(seed, w, h):
    """make_yuv's frame with concentric rings over its right half (locally
    straight edges: a mode per 8x8 or 4x4 block), bright lines every third
    row over the top-left eighth (NxN PUs, TU splits) and noisy chroma on
    the left quarter (the chroma RDO leaves DM)."""
    rng = np.random.RandomState(seed)
    y, u, v = make_yuv(rng, w, h)
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.sqrt((xx - w * 0.75) ** 2 + (yy - h * 0.5) ** 2)
    y[:, w // 2:] = np.clip(60 + 60 * np.sin(r * 0.8), 0, 255)[:, w // 2:]
    y[:h // 2:3, :w // 4] = 240
    u[:, :w // 8] = np.clip(u[:, :w // 8].astype(int)
                            + rng.randint(-20, 21, (h // 2, w // 8)), 0, 255)
    return y, u, v


def _assert_desc_equal(want, got):
    (wd, *wrec), (gd, *grec) = want, got
    for f in DESC_FIELDS:
        a, b = getattr(wd, f), getattr(gd, f)
        assert (a is None) == (b is None), f
        assert a is None or np.array_equal(a, b), f
    for a, b in zip(wrec, grec):
        assert a.dtype == b.dtype and np.array_equal(a, b), "recon"


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_prediction_matches_golden(size):
    """Reference samples at positions with every kind of availability
    (picture corner, top and left edges, the right and bottom edges, inside
    a CTU after and before its z-scan neighbours), luma and chroma; their
    filter; every mode's prediction."""
    rng = np.random.RandomState(size)
    w, h, ctu = 128, 64, 32
    recon = rng.randint(0, 256, (h, w)).astype(np.int32)
    chroma = rng.randint(0, 256, (h // 2, w // 2)).astype(np.int32)
    ta, ja = t_pred.Availability(w, h, ctu), j_pred.Availability(w, h, ctu)
    xs = sorted({0, size, 32, 48, w - size})
    ys = sorted({0, size, 32, h - size})
    n = 0
    for y0 in ys:
        for x0 in xs:
            if x0 % size or y0 % size:
                continue
            for plane, cs, is_luma in ((recon, 0, True), (chroma, 1, False)):
                if is_luma is False and (size > 16 or x0 % (2 * size)
                                         or y0 % (2 * size)):
                    continue
                cx, cy = x0 >> cs, y0 >> cs
                tt, tl = t_pred.build_reference_samples(plane, cx, cy, size,
                                                        ta, comp_shift=cs)
                jt, jl = j_pred.build_reference_samples(plane, cx, cy, size,
                                                        ja, comp_shift=cs)
                assert np.array_equal(tt, jt) and np.array_equal(tl, jl)
                for mode in range(35):
                    ft, fl = t_pred.filter_reference_samples(
                        tt, tl, size, mode, is_luma)
                    gt, gl = j_pred.filter_reference_samples(
                        jt, jl, size, mode, is_luma)
                    assert np.array_equal(ft, gt) and np.array_equal(fl, gl)
                    got = t_pred.predict(ft, fl, size, mode, is_luma)
                    want = j_pred.predict(gt, gl, size, mode, is_luma)
                    assert got.dtype == want.dtype
                    assert np.array_equal(got, want), (x0, y0, mode)
                    n += 1
    assert n >= 35 * 4


@pytest.mark.parametrize("size,dst", [(4, True), (4, False), (8, False),
                                      (16, False), (32, False)])
def test_transform_quantize_sbh_match_golden(size, dst):
    """Forward transform, quantization (intra and inter, flat and default
    scaling lists), sign-bit hiding in each scan and dequantization, then
    the inverse transform, on residuals from flat to full swing."""
    rng = np.random.RandomState(size + dst)
    for amp in (3, 40, 255):
        resid = rng.randint(-amp, amp + 1, (size, size)).astype(np.int32)
        coef = t_xform.forward_transform(resid, dst)
        assert np.array_equal(coef, j_xform.forward_transform(resid, dst))
        for qp, intra, sl in ((22, True, False), (32, True, True),
                              (37, False, False), (27, False, True)):
            lvl = t_quant.quantize(coef, qp, intra, sl)
            assert np.array_equal(lvl, j_quant.quantize(coef, qp, intra, sl))
            for scan in (0, 1, 2):
                got = t_quant.sign_bit_hiding(lvl, coef, qp, intra, scan, sl)
                want = j_quant.sign_bit_hiding(lvl, coef, qp, intra, scan,
                                               sl)
                assert np.array_equal(got, want)
            deq = t_quant.dequantize(lvl, qp, intra, sl)
            assert np.array_equal(deq, j_quant.dequantize(lvl, qp, intra, sl))
            assert np.array_equal(t_xform.inverse_transform(deq, dst),
                                  j_xform.inverse_transform(deq, dst))


@pytest.mark.parametrize("cu,qp_map", [(16, False), (16, True), (32, False),
                                       (32, True)])
def test_encode_intra_frame_matches_golden(cu, qp_map):
    """The fixed-CU frame encoder at CU 16 and 32, with a per-CTB AQ map of
    a frame with a flat band (CTBs at other QPs than the slice's) and
    without."""
    y, u, v = _frame(cu + qp_map, flat_band=qp_map)
    tps, jps = _ps(cu_size=cu, aq_strength=2.0 if qp_map else 0.0)
    m = aq_qp_map(y, cu, 32, 2.0) if qp_map else None
    if qp_map:
        assert len(np.unique(m)) >= 2
    got = t_frame.encode_intra_frame(tps, y, u, v, 32, cu_size=cu, qp_map=m)
    want = j_frame.encode_intra_frame(jps, y, u, v, 32, cu_size=cu,
                                      qp_map=m)
    _assert_desc_equal(want, got)


_DEC_FIELDS = ("depth8", "mode8", "chroma8", "nxn8", "mode4", "tr8")


@pytest.mark.parametrize("ctu,full_rd", [(32, False), (32, True),
                                         (64, False), (64, True)])
def test_intra_tree_matches_golden(ctu, full_rd):
    """decide_intra_tree (the fast decision and RD_FULL's NxN PUs, TU
    splits and chroma RDO) at CTB 32, on CTU-32 and CTU-64 frames, then
    encode_intra_tree_frame with that decision, as the host route calls
    them (CTB32 nodes under the CTU; at CTU 64 the last CTU is half
    outside the 96x64 frame); RD_FULL's tools occur."""
    y, u, v = _detail_frame(1, 96, 64)
    tps, jps = _ps(width=96, cu_size=ctu, intra_rdo=True)
    got = t_tree.decide_intra_tree(tps, y, u, v, 32, ctb=32, full_rd=full_rd)
    want = j_tree.decide_intra_tree(jps, y, u, v, 32, ctb=32,
                                    full_rd=full_rd)
    for f in _DEC_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        assert a is None or np.array_equal(a, b), f
    if full_rd:
        assert got.nxn8.any() and got.tr8.any()
        assert (got.chroma8 != got.mode8).any()
    _assert_desc_equal(
        j_tree.encode_intra_tree_frame(jps, y, u, v, 32, want, ctb=32),
        t_tree.encode_intra_tree_frame(tps, y, u, v, 32, got, ctb=32))
    blk = y[:8, :8].astype(np.int32)
    pred = np.full((8, 8), 100, np.int32)
    for a, b in zip(t_tree._tu_rd(blk, pred, 32, False, True, 0, False),
                    j_tree._tu_rd(blk, pred, 32, False, True, 0, False)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("wpp", [False, True], ids=["wpp0", "wpp1"])
def test_deblock_matches_golden(wpp):
    """The all-intra boundary strengths, the decoder-view QP map of a
    frame coded at QP 42 with a per-CTB AQ map (a flat top band and left
    column: quantization groups that code no coefficient keep the
    predictor's QP, which WPP resets at each CTU row), and the luma and
    chroma filters at that map and at a flat QP, on a CU16 frame and on
    an RD_FULL CU32 tree frame with TU splits."""
    y, u, v = _frame(5, flat_band=True)
    y[:, :16], u[:, :8], v[:, :8] = 90, 128, 128
    qp = 42
    tps, jps = _ps(cu_size=16, aq_strength=2.0, wpp=wpp, qp=qp)
    m = aq_qp_map(y, 16, qp, 2.0)
    desc, ry, ru, rv = j_frame.encode_intra_frame(jps, y, u, v, qp,
                                                  cu_size=16, qp_map=m)
    tps32, jps32 = _ps(width=96, cu_size=32, intra_rdo=True)
    tree_src = _detail_frame(1, 96, 64)
    dec = j_tree.decide_intra_tree(jps32, *tree_src, 32, ctb=32,
                                   full_rd=True)
    tdesc, *trec = j_tree.encode_intra_tree_frame(jps32, *tree_src, 32, dec,
                                                  ctb=32)
    assert tdesc.tr_depth.any()
    for d, rec, (tps_, jps_), sqp in ((desc, (ry, ru, rv), (tps, jps), qp),
                                      (tdesc, trec, (tps32, jps32), 32)):
        tu8 = ((jps_.ctu_size >> d.cu_depth) >> d.tr_depth).astype(np.int32)
        bs_t, bs_j = t_deblock.intra_bs_maps(tu8), \
            j_deblock.intra_bs_maps(tu8)
        assert all(np.array_equal(a, b) for a, b in zip(bs_t, bs_j))
        qp8s = [np.full_like(tu8, sqp)]
        if d.qp_map is not None:
            got = t_deblock.decoder_qp_map8(d, tps_, sqp, wpp=wpp)
            want = j_deblock.decoder_qp_map8(d, jps_, sqp, wpp=wpp)
            assert np.array_equal(got, want)
            # uncoded groups keep the predictor, not their map's QP, and
            # the predictor depends on WPP
            assert (got != np.repeat(np.repeat(m, 2, 0), 2, 1)).any()
            assert (got != t_deblock.decoder_qp_map8(d, tps_, sqp,
                                                     wpp=not wpp)).any()
            qp8s.append(got)
        for qp8 in qp8s:
            assert np.array_equal(
                t_deblock.deblock_plane_luma(rec[0], tu8, qp8, *bs_t),
                j_deblock.deblock_plane_luma(rec[0], tu8, qp8, *bs_j))
            for plane in rec[1:]:
                assert np.array_equal(
                    t_deblock.deblock_plane_chroma(plane, qp8, *bs_t, 2),
                    j_deblock.deblock_plane_chroma(plane, qp8, *bs_j, 2))


# all-intra configurations the host programs carry (the base: 128x64, QP
# 32, deblocking, no SAO, two frames in flight so that a device batch
# would be taken if the route were wrong)
_BASE = dict(width=128, height=64, qp=32, gop_size=0, sign_hiding=True,
             deblocking=True, sao=False, num_frames_in_flight=2)
_STREAMS = {
    "rd_full-ctu32": dict(cu_size=32, intra_rdo=True, rd_mode=RDMode.RD_FULL,
                          sao=True),
    "rd_full-ctu64": dict(cu_size=64, intra_rdo=True,
                          rd_mode=RDMode.RD_FULL),
    "intra_rdo-cu16": dict(cu_size=16, intra_rdo=True, sao=True),
    "cu64": dict(cu_size=64, sao=True),
    "aq-deblock-cu16": dict(cu_size=16, aq_strength=2.0),
    "aq-deblock-cu16-wpp": dict(cu_size=16, aq_strength=2.0, wpp=True,
                                sao=True),
    "aq-tree-deblock": dict(cu_size=32, intra_rdo=True, aq_strength=1.0),
    "aq-tree-no-deblock": dict(cu_size=64, intra_rdo=True, aq_strength=2.0,
                               deblocking=False),
}


@pytest.mark.parametrize("case", list(_STREAMS))
def test_host_intra_stream_matches_jax_and_decodes(case, tmp_path):
    """Two frames (the second moved and noisier) through both Encoders:
    identical Annex-B bytes, an FFmpeg decode equal to the port's recon,
    and no device encoder built on the port's side."""
    kw = dict(_BASE, **_STREAMS[case])
    y, u, v = _frame(17, flat_band=True)
    rng = np.random.RandomState(3)
    frames = [(y, u, v), (np.clip(np.roll(y, 3, 1).astype(int)
                                  + rng.randint(-6, 7, y.shape), 0, 255)
                          .astype(np.uint8), np.roll(u, 1, 1), v)]

    def encode(enc):
        return [e for f in frames for e in enc.encode(*f)] + \
            list(enc.flush())
    want = encode(JaxEncoder(JaxConfig(**kw)))
    port = Encoder(EncoderConfig(**kw), device="cpu")
    got = encode(port)
    assert port._pipeline._intra_enc is None
    stream = b"".join(e.annex_b() for e in got)
    assert stream == b"".join(e.annex_b() for e in want)
    path = tmp_path / f"{case}.265"
    path.write_bytes(stream)
    dec = decode_annexb(path)
    assert len(dec) == 2
    for d, e in zip(dec, got):
        assert np.array_equal(d, e.recon["y"])


def test_host_route_is_chosen_by_configuration():
    """The host programs take the I frames exactly where the JAX
    package's _tpu_ok() is false, on the padded config, and the P frames
    stay on the device programs where its _tpu_inter_ok() holds."""
    from homerhevc_tpu.engine.pipeline import EncoderPipeline
    from homerhevc_tpu_torch.engine import pipeline as tp
    n = 0
    for cu in (16, 32, 64):
        for kw in (dict(), dict(intra_rdo=True),
                   dict(intra_rdo=True, rd_mode=RDMode.RD_FULL),
                   dict(aq_strength=1.0), dict(rc_ctu=True),
                   dict(aq_strength=1.0, deblocking=False),
                   dict(aq_strength=1.0, deblocking=False, intra_in_p=True),
                   dict(intra_rdo=True, aq_strength=1.0, deblocking=False)):
            kw = dict(width=1920, height=1080, cu_size=cu, gop_size=1, **kw)
            jp = EncoderPipeline(JaxConfig(**kw))
            cfg = dataclasses.replace(EncoderConfig(**kw),
                                      width=jp.cfg.width,
                                      height=jp.cfg.height)
            assert tp.intra_device_ok(cfg) == jp._tpu_ok(), kw
            assert tp.inter_device_ok(cfg) == jp._tpu_inter_ok(), kw
            n += 1
    assert n == 24
