"""The port's host inter programs (hevc/interp.py, hevc/rd_bits.py,
hevc/inter_frame.py and hevc/deblock.py's inter_bs_maps) against the JAX
package's golden modules they were copied from, bit for bit on the same
seeded inputs; and the streams those programs carry through api.Encoder
(per-CTB QP maps with deblocking at CU16, CTU 32 and CTU 64, maps with
intra-in-P, intra_rdo at CU16 in FULL and FAST, three references with an
IDR inside the clip, IBP with maps and deblocking, IBP with rectangular
PUs in its B slices) against the JAX Encoder's bytes and recon, each
decoding in FFmpeg to the port's recon. Everything here is numpy on both
sides: no JAX program is built (the configurations whose JAX Encoder
needs a device program live beside the module fixtures that build them:
tests/test_torch_aq.py, tests/test_torch_intra_tree.py)."""

import numpy as np
import pytest
import torch

from homerhevc_tpu.api import Encoder as JaxEncoder
from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.golden import deblock as j_deblock
from homerhevc_tpu.golden import inter_frame as j_inter
from homerhevc_tpu.golden import interp as j_interp
from homerhevc_tpu.golden import rd_bits as j_rd
from homerhevc_tpu.hevc.headers import ParamSets as JaxParamSets
from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import EncoderConfig, PerformanceMode
from homerhevc_tpu_torch.engine.rate_control import aq_qp_map
from homerhevc_tpu_torch.hevc import deblock as t_deblock
from homerhevc_tpu_torch.hevc import inter_frame as t_inter
from homerhevc_tpu_torch.hevc import interp as t_interp
from homerhevc_tpu_torch.hevc import rd_bits as t_rd
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.hevc.syntax import MODE_INTRA
from tests.conftest import decode_annexb, make_yuv
from tests.test_multiref import _flicker_frames
from tests.torch_golden import spec_amvp_mref

torch.set_num_threads(1)    # one intra-op thread per test worker

W, H = 64, 64


def _ps(**kw):
    """(port ParamSets, JAX ParamSets) of one configuration."""
    kw = dict(dict(width=W, height=H, qp=32, sign_hiding=True, gop_size=1,
                   deblocking=True, sao=False), **kw)
    return (ParamSets.from_config(EncoderConfig(**kw)),
            JaxParamSets.from_config(JaxConfig(**kw)))


def _same(a, b, where="value"):
    """a equals b bit for bit: arrays (dtype included), numbers, None,
    and tuples / lists / FrameDescs of them."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
        assert np.array_equal(a, b), where
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif hasattr(a, "__dataclass_fields__"):
        assert vars(a).keys() == vars(b).keys(), where
        for k in vars(a):
            _same(getattr(a, k), getattr(b, k), f"{where}.{k}")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _split_pair(seed, w=W, h=H, noise=3):
    """(source, reference) planes, int32: make_yuv's texture, the source's
    left half moved (2, 1) and its right half (-3, 0) against the
    reference, a band where the halves meet moving a third way (blocks
    whose halves move apart: rectangular PUs), a 16x16 block of noise
    (intra in a P frame), and a flat band over the top rows (AQ deltas)."""
    rng = np.random.RandomState(seed)
    ry, ru, rv = (p.astype(np.int32) for p in make_yuv(rng, w, h))
    y = np.roll(ry, (1, 2), (0, 1))
    y[:, w // 2:] = np.roll(ry, -3, 1)[:, w // 2:]
    y[h // 2:h // 2 + 8] = np.roll(ry, (-2, 4), (0, 1))[h // 2:h // 2 + 8]
    y[16:32, 16:32] = rng.randint(0, 256, (16, 16))
    y = np.clip(y + rng.randint(-noise, noise + 1, y.shape), 0, 255)
    y[:8] = 90
    ry[:8] = 90
    src = (y, np.roll(ru, 1, 1), np.roll(rv, (1, 1), (0, 1)))
    return src, (ry, ru, rv)


# ---- hevc/interp.py --------------------------------------------------------

@pytest.mark.parametrize("fn", ["mc_luma", "mc_luma_14", "mc_chroma",
                                "mc_chroma_14"])
def test_interp_matches_golden(fn):
    """Every fractional phase, at the picture's corners and edges (the
    clamped fetch) and inside, for each block size; bi_average of the
    14-bit predictions."""
    rng = np.random.RandomState(len(fn))
    ref = rng.randint(0, 256, (40, 56)).astype(np.int32)
    chroma = fn.startswith("mc_chroma")
    frac = 8 if chroma else 4
    t, j = getattr(t_interp, fn), getattr(j_interp, fn)
    n = 0
    for size in (4, 8, 16):
        for x0, y0 in ((0, 0), (56 - size, 40 - size), (8, 24)):
            for fy in range(frac):
                for fx in range(frac):
                    mvx = int(rng.randint(-12, 13)) * frac + fx
                    mvy = int(rng.randint(-12, 13)) * frac + fy
                    want = j(ref, x0, y0, size, mvx, mvy)
                    got = t(ref, x0, y0, size, mvx, mvy)
                    _same(want, got, (size, x0, y0, mvx, mvy))
                    n += 1
                    if fn.endswith("_14"):
                        other = t(ref, y0, x0, size, mvy, mvx)
                        _same(j_interp.bi_average(want, other),
                              t_interp.bi_average(got, other))
    assert n == 3 * 3 * frac * frac


# ---- hevc/rd_bits.py -------------------------------------------------------

@pytest.mark.parametrize("slice_type,qp", [("P", 22), ("P", 37), ("B", 32)])
def test_rd_bits_matches_golden(slice_type, qp):
    """RdBits' residual bits (each TU size, luma and chroma, each scan),
    luma bits of a CU (n = 64: four TU32s), mvd, merge and AMVP-flag bits
    at the slice type's and QP's initial contexts."""
    rng = np.random.RandomState(qp)
    tps, jps = _ps()
    got, want = t_rd.RdBits(tps, slice_type, qp), \
        j_rd.RdBits(jps, slice_type, qp)
    for n in (4, 8, 16, 32):
        for amp in (1, 3, 30):
            lvl = (rng.laplace(0, amp, (n, n)) * (rng.rand(n, n) < 0.4)) \
                .astype(np.int32)
            for c_idx in (0, 1):
                for scan in ((0, 1, 2) if n <= 8 else (0,)):
                    _same(want.tu_bits(lvl, c_idx, scan),
                          got.tu_bits(lvl, c_idx, scan))
    for n in (8, 16, 32, 64):
        lvl = rng.randint(-2, 3, (n, n)) * (rng.rand(n, n) < 0.1)
        lvl[: n // 2, : n // 2] = 0
        _same(want.luma_bits(lvl), got.luma_bits(lvl))
    for mvd in ((0, 0), (1, -1), (-7, 3), (40, -300), (2, 0)):
        _same(want.mvd_bits(*mvd), got.mvd_bits(*mvd))
    for idx in range(5):
        _same(want.merge_bits(idx), got.merge_bits(idx))
        _same(want.merge_bits(idx, 2 + idx), got.merge_bits(idx, 2 + idx))
    _same(want.amvp_flag_bits(), got.amvp_flag_bits())


# ---- hevc/inter_frame.py: the motion search and the CU tools ---------------

def test_motion_search_matches_golden():
    """zero_force, mv_rate, full_pel_field, decimate2, hier_pel_field,
    hier_pel_fields (16 / 32 / 64 levels, and the FAR level), subpel
    refinement (half and quarter pel, clamped and not), _code_tu and
    _cu_cost (proxy and counted bits) on the split-motion pair."""
    (sy, _, _), (ry, _, _) = _split_pair(1)
    lam16 = 60
    for f in ("full_pel_field",):
        _same(getattr(j_inter, f)(sy, ry, 16, 6, lam16),
              getattr(t_inter, f)(sy, ry, 16, 6, lam16), f)
    _same(j_inter.decimate2(sy[:63, :61]), t_inter.decimate2(sy[:63, :61]))
    for n in (8, 16):
        _same(j_inter.hier_pel_field(sy, ry, n, 5, lam16),
              t_inter.hier_pel_field(sy, ry, n, 5, lam16), f"hier {n}")
    for kw in (dict(), dict(want32=True), dict(want32=True, want64=True),
               dict(want32=True, far=40)):
        _same(j_inter.hier_pel_fields(sy, ry, 6, lam16, **kw),
              t_inter.hier_pel_fields(sy, ry, 6, lam16, **kw), str(kw))
    q = np.arange(-40, 41)
    _same(j_inter.mv_rate(q, -q // 2, (4, -8)),
          t_inter.mv_rate(q, -q // 2, (4, -8)))
    blk = sy[16:32, 32:48]
    for step in (2, 1):
        for bounds in (None, ((-6, -6), (5, 4))):
            _same(j_inter.subpel_refine(blk, ry, 32, 16, (-12, 4), step,
                                        (0, 0), lam16, bounds),
                  t_inter.subpel_refine(blk, ry, 32, 16, (-12, 4), step,
                                        (0, 0), lam16, bounds))
    rng = np.random.RandomState(3)
    jrb, trb = j_rd.RdBits(_ps()[1], "P", 32), t_rd.RdBits(_ps()[0], "P", 32)
    for n in (8, 16, 32):
        for amp in (2, 20, 120):
            resid = rng.randint(-amp, amp + 1, (n, n)).astype(np.int32)
            for zf in (1.0, 40.0):
                want = j_inter._code_tu(resid, 32, False, True, zf, 30.0)
                got = t_inter._code_tu(resid, 32, False, True, zf, 30.0)
                _same(want, got)
                _same(j_inter.zero_force(resid, want[0], want[1], zf),
                      t_inter.zero_force(resid, got[0], got[1], zf))
                src = rng.randint(0, 256, (n, n)).astype(np.int32)
                rec = np.clip(src + resid // 4, 0, 255)
                _same(j_inter._cu_cost(src, rec, want[0], (5, -3), (0, 4),
                                       30.0),
                      t_inter._cu_cost(src, rec, got[0], (5, -3), (0, 4),
                                       30.0))
                if n <= 32:
                    _same(j_inter._cu_cost(src, rec, want[0], (5, -3),
                                           (0, 4), 30.0, jrb),
                          t_inter._cu_cost(src, rec, got[0], (5, -3),
                                           (0, 4), 30.0, trb))
    want = rng.rand(7, 9) < 0.5
    _same(j_inter.select_intra_independent(want),
          t_inter.select_intra_independent(want))
    for ctu in (16, 32, 64):
        _same(j_inter.merge_b0_avail(5, 8, ctu),
              t_inter.merge_b0_avail(5, 8, ctu))
    ref_c = ry[::2, ::2]
    for pw, ph in ((16, 8), (8, 16)):
        _same(j_inter._mc_luma_rect(ry, 16, 32, pw, ph, -7, 6),
              t_inter._mc_luma_rect(ry, 16, 32, pw, ph, -7, 6))
        _same(j_inter._mc_chroma_rect(ref_c, 8, 16, pw // 2, ph // 2, -7,
                                      6),
              t_inter._mc_chroma_rect(ref_c, 8, 16, pw // 2, ph // 2, -7, 6))


# ---- hevc/inter_frame.py: the frame programs -------------------------------

def _map(src, ctu, qp=32):
    """The AQ map of src (strength 2) where its CTBs differ, else a
    checkerboard of QPs 35 / 29 (one CTU64 in 64x64)."""
    m = aq_qp_map(np.asarray(src[0], np.uint8), ctu, qp, 2.0)
    if len(np.unique(m)) < 2:
        m = (qp + 3 - 6 * (np.indices(m.shape).sum(0) % 2)).astype(np.int32)
    return m


_FLAT = {
    "plain": dict(),
    "merge_rd-rect_pu": dict(merge_rd=True, rect_pu=True),
    "merge_rd-fast": dict(merge_rd="fast"),
    "qp_map": dict(merge_rd=True, rect_pu=True, map=True),
    "intra_in_p": dict(merge_rd=True, rect_pu=True, cfg=dict(intra_in_p=True)),
    "fast": dict(merge_rd=True, rect_pu=True,
                 cfg=dict(performance_mode=PerformanceMode.FAST)),
    "is_b": dict(merge_rd=True, rect_pu=True, is_b=True),
    "qpel-no-deblock": dict(merge_rd=True, rect_pu=True,
                            cfg=dict(deblocking=False,
                                     motion_estimation_precision=2)),
    "wpp-map": dict(map=True, cfg=dict(wpp=True, aq_strength=2.0)),
}


@pytest.mark.parametrize("case", list(_FLAT))
def test_encode_inter_frame_matches_golden(case):
    """encode_inter_frame at CU16 in each of its modes: merge-RD and
    rectangular PUs (counted bits), the device twin's merge-RD, a per-CTB
    QP map, the intra fallback, FAST, a B frame of uni-L0 CUs, quarter-pel
    without deblocking, WPP with a map (the decoder-view deblocking QP).
    Every FrameDesc field and the recon planes; the tools occur."""
    spec = _FLAT[case]
    tps, jps = _ps(**{"aq_strength": 2.0 if spec.get("map") else 0.0,
                      **spec.get("cfg", {})})
    src, ref = _split_pair(2)
    kw = dict(search=8, avg_dist=300.0, is_b=spec.get("is_b", False),
              merge_rd=spec.get("merge_rd", False),
              rect_pu=spec.get("rect_pu", False),
              qp_map=_map(src, 16) if spec.get("map") else None)
    want = j_inter.encode_inter_frame(jps, src, ref, 32, **kw)
    got = t_inter.encode_inter_frame(tps, src, ref, 32, **kw)
    _same(want, got)
    d = got[0]
    if case == "merge_rd-rect_pu":
        assert d.inter_part.any()
    if case == "intra_in_p":
        assert (d.pred_mode == MODE_INTRA).any()


@pytest.mark.parametrize("map_", [False, True], ids=["no-map", "map"])
def test_multireference_frame_matches_golden(map_):
    """encode_inter_frame with three references (ref_list, ref_dists 1, 2,
    3) on flickering frames, where references 1 and 2 win blocks; and the
    inter boundary strengths of that frame (different reference pictures:
    BS 1)."""
    frames = [tuple(p.astype(np.int32) for p in f)
              for f in _flicker_frames(np.random.RandomState(4), W, H, 4)]
    tps, jps = _ps(num_ref_frames=3, aq_strength=2.0 if map_ else 0.0)
    refs = [frames[2], frames[1], frames[0]]
    kw = dict(cu_size=16, search=8, ref_list=refs, ref_dists=(1, 2, 3),
              qp_map=_map(frames[3], 16) if map_ else None)
    want = j_inter.encode_inter_frame(jps, frames[3], refs[0], 30, **kw)
    got = t_inter.encode_inter_frame(tps, frames[3], refs[0], 30, **kw)
    _same(want, got)
    assert (got[0].ref_idx >= 1).any()
    tu8 = ((tps.ctu_size >> got[0].cu_depth) >> got[0].tr_depth) \
        .astype(np.int32)
    _same(j_deblock.inter_bs_maps(want[0], tu8),
          t_deblock.inter_bs_maps(got[0], tu8))


@pytest.mark.parametrize("ctu,perf,map_", [
    (32, PerformanceMode.FULL_COMPUTATION, False),
    (32, PerformanceMode.FULL_COMPUTATION, True),
    (64, PerformanceMode.FULL_COMPUTATION, True),
    (64, PerformanceMode.FAST, False),
    (64, PerformanceMode.UFAST, False)],
    ids=["32", "32-map", "64-map", "64-fast", "64-ufast"])
def test_encode_inter_frame_tree_matches_golden(ctu, perf, map_):
    """encode_inter_frame_tree (the CU32 / CU64 levels over CU16, merge-RD
    and rectangular PUs as the pipeline asks for them) with and without a
    per-CTB map, in FULL, FAST and UFAST."""
    tps, jps = _ps(cu_size=ctu, intra_rdo=True, performance_mode=perf,
                   aq_strength=2.0 if map_ else 0.0)
    src, ref = _split_pair(5, noise=1)
    kw = dict(search=8, avg_dist=500.0, merge_rd=True, rect_pu=True,
              qp_map=_map(src, ctu) if map_ else None)
    want = j_inter.encode_inter_frame_tree(jps, src, ref, 32, **kw)
    got = t_inter.encode_inter_frame_tree(tps, src, ref, 32, **kw)
    _same(want, got)
    assert (got[0].cu_depth < tps.log2_ctu - 4).any(), "no CU32 / CU64"


def test_encode_b_frame_tree_matches_golden():
    """encode_b_frame_tree at CTU 32 between two references (each CU
    uni-L0, uni-L1 or bi; AMVP's POC scaling at distances 1 and -1), with
    deblocking; its boundary strengths."""
    tps, jps = _ps(cu_size=32, intra_rdo=True, gop_size=2, num_b=1)
    src, ref0 = _split_pair(6)
    rng = np.random.RandomState(6)
    # list 1: the source moved the other way, both lists noisy (bi
    # averages the two noises away), list 1's left quarter unrelated
    # (uni-L0 there), list 0's right quarter (uni-L1 there)
    ref1 = tuple(np.clip(np.roll(s, -1, 1)
                         + rng.randint(-6, 7, s.shape), 0, 255)
                 for s in src)
    for p in ref1:
        p[:, :p.shape[1] // 4] = rng.randint(0, 256, (p.shape[0],
                                                      p.shape[1] // 4))
    ref0 = tuple(np.clip(p + rng.randint(-6, 7, p.shape), 0, 255)
                 for p in ref0)
    for p in ref0:
        p[:, -p.shape[1] // 4:] = rng.randint(0, 256, (p.shape[0],
                                                       p.shape[1] // 4))
    want = j_inter.encode_b_frame_tree(jps, src, ref0, ref1, 32, search=8)
    got = t_inter.encode_b_frame_tree(tps, src, ref0, ref1, 32, search=8)
    _same(want, got)
    assert (got[0].inter_dir == 3).any() and (got[0].inter_dir != 3).any()
    tu8 = ((tps.ctu_size >> got[0].cu_depth) >> got[0].tr_depth) \
        .astype(np.int32)
    _same(j_deblock.inter_bs_maps(want[0], tu8),
          t_deblock.inter_bs_maps(got[0], tu8))


@pytest.mark.parametrize("post", ["merge_rd_p", "rect_pu_p", "merge_rd_fast",
                                  "intra_fallback_p"])
def test_post_passes_match_golden(post):
    """Each RD post-pass alone on the level-16 encode of each package
    (_encode_level16, compared too), then _deblock_inter_luma / _chroma
    on its result: the pass's return value, the FrameDesc it edits and
    the recon planes."""
    tps, jps = _ps(intra_in_p=post == "intra_fallback_p")
    src, ref = _split_pair(7)
    out = []
    for mod, ps in ((j_inter, jps), (t_inter, tps)):
        desc, ry, ru, rv, prior = mod._encode_level16(ps, src, ref, 32, 8,
                                                      400.0)
        zf = mod.zf_multiplier(400.0, 32)
        args = (ps, desc, *src, *ref, ry, ru, rv, 32, zf, prior)
        if post == "rect_pu_p":
            ret = mod.rect_pu_p(*args, 0)
        elif post == "intra_fallback_p":
            ret = mod.intra_fallback_p(ps, desc, *src, ry, ru, rv, 32, prior)
        else:
            ret = getattr(mod, post)(*args)
        ry = mod._deblock_inter_luma(ps, desc, ry, 32)
        ru, rv = mod._deblock_inter_chroma(ps, desc, ru, rv, 32)
        out.append((ret, desc, ry, ru, rv, prior))
    _same(*out)
    assert out[1][0], f"{post} changed nothing"


def test_inter_bs_maps_matches_golden():
    """inter_bs_maps on a random FrameDesc: intra units, rectangular PUs
    (PU edges that are not TU edges), nonzero luma levels, per-list
    motion of each direction and reference indices, over TU sizes 8, 16
    and 32."""
    rng = np.random.RandomState(8)
    desc = t_inter.FrameDesc.alloc(W, H)
    h8, w8 = H // 8, W // 8
    desc.pred_mode[:] = rng.rand(h8, w8) < 0.2
    desc.coef_y[:] = rng.randint(-1, 2, (H, W)) * (rng.rand(H, W) < 0.02)
    desc.mv = rng.randint(-6, 7, (h8, w8, 2)).astype(np.int16)
    desc.mv_l1 = rng.randint(-6, 7, (h8, w8, 2)).astype(np.int16)
    desc.inter_dir = rng.randint(1, 4, (h8, w8)).astype(np.uint8)
    desc.ref_idx = rng.randint(0, 2, (h8, w8)).astype(np.uint8)
    desc.inter_part = rng.randint(0, 3, (h8, w8)).astype(np.uint8)
    for tu in (8, 16, 32):
        tu8 = np.full((h8, w8), tu, np.int32)
        _same(j_deblock.inter_bs_maps(desc, tu8),
              t_deblock.inter_bs_maps(desc, tu8))


# ---- the streams -----------------------------------------------------------

_BASE = dict(width=W, height=H, qp=32, gop_size=1, intra_period=0,
             sign_hiding=True, deblocking=True, sao=False,
             reinit_gop_on_scene_change=False)
_STREAMS = {
    # per-CTB QP maps with deblocking on, at CU16 (with SAO), CTU 32 and
    # CTU 64 (128 wide: whole CTU64s)
    "aq-deblock-cu16": (dict(cu_size=16, aq_strength=2.0, sao=True), "IPPP"),
    "aq-rc_ctu-deblock-ctu32": (dict(cu_size=32, intra_rdo=True,
                                     aq_strength=2.0, rc_ctu=True,
                                     bitrate_mode=1, bitrate_kbps=150),
                                "IPPP"),
    "aq-deblock-ctu64": (dict(cu_size=64, intra_rdo=True, aq_strength=2.0,
                              width=128, sao=True), "IPPP"),
    # maps with intra-in-P (deblocking off)
    "aq-intra_in_p-ctu32": (dict(cu_size=32, intra_rdo=True,
                                 aq_strength=2.0, deblocking=False,
                                 intra_in_p=True), "IPPP"),
    # intra_rdo at CU16: rectangular PUs and merge-RD, and FAST without
    "intra_rdo-cu16": (dict(cu_size=16, intra_rdo=True, sao=True), "IPPP"),
    "intra_rdo-cu16-fast": (dict(cu_size=16, intra_rdo=True,
                                 performance_mode=PerformanceMode.FAST),
                            "IPPP"),
    # IBP with maps and deblocking (host anchors; CU16: uni-L0 B frames,
    # CTU 32: the host bi B tree), and IBP at CU16 without maps (its B
    # slices carry rectangular PUs: the Python B-slice serializer)
    "ibp-aq-deblock-cu16": (dict(cu_size=16, gop_size=2, num_b=1,
                                 aq_strength=2.0, sao=True), "IPBPB"),
    "ibp-aq-deblock-ctu32": (dict(cu_size=32, intra_rdo=True, gop_size=2,
                                  num_b=1, aq_strength=2.0), "IPBPB"),
    "ibp-intra_rdo-cu16": (dict(cu_size=16, gop_size=2, num_b=1,
                                intra_rdo=True), "IPBPB"),
}


def _moving_frames(seed, n, w, noise=6):
    """n frames of make_yuv's texture panning 2 px a frame, with an 8-row
    band (rows 24-31: the lower halves of a row of CU16s) panning 3 px a
    frame the other way, noise of +-noise (bi-prediction averages it
    away), a 16x16 block of fresh noise in each frame (intra CUs) and a
    flat band over the top rows (AQ deltas)."""
    rng = np.random.RandomState(seed)
    y, u, v = make_yuv(rng, w, H)
    out = []
    for t in range(n):
        yt = np.roll(y, 2 * t, 1).astype(int)
        yt[24:32] = np.roll(y, -3 * t, 1)[24:32]
        yt[40:56, 16:32] = rng.randint(0, 256, (16, 16))
        yt = np.clip(yt + rng.randint(-noise, noise + 1, yt.shape), 0, 255)
        yt[:8] = 90
        out.append((yt.astype(np.uint8), np.roll(u, t, 1), np.roll(v, t, 1)))
    return out


def _encode(enc, frames):
    return [e for f in frames for e in enc.encode(*f)] + list(enc.flush())


def _decodes(efs, path):
    """The FFmpeg decode of efs' stream equals each frame's recon (in
    display order)."""
    path.write_bytes(b"".join(e.annex_b() for e in efs))
    dec = decode_annexb(path)
    assert len(dec) == len(efs)
    for e in efs:
        assert np.array_equal(dec[e.poc], e.recon["y"]), e.poc


def _port(kw):
    """The port's Encoder on the CPU and the FrameDescs it emits."""
    enc = Encoder(EncoderConfig(**kw), device="cpu")
    descs = []
    emit = enc._pipeline._emit

    def spy(desc, *a, **k):
        descs.append(desc)
        return emit(desc, *a, **k)
    enc._pipeline._emit = spy
    return enc, descs


@pytest.mark.parametrize("case", list(_STREAMS))
def test_host_inter_stream_matches_jax_and_decodes(case, tmp_path):
    """Each configuration whose P and B frames the JAX package codes on its
    host programs: identical Annex-B bytes and recon planes from both
    Encoders, an FFmpeg decode equal to the port's recon, no device
    encoder built; the tools of each configuration occur."""
    changes, types = _STREAMS[case]
    kw = dict(_BASE, **changes)
    frames = _moving_frames(11, len(types), kw["width"])
    want = _encode(JaxEncoder(JaxConfig(**{
        **kw, "performance_mode": int(kw.get("performance_mode", 0))})),
        frames)
    enc, descs = _port(kw)
    got = _encode(enc, frames)
    assert "".join(e.frame_type for e in got) == types
    assert enc._pipeline._intra_enc is None
    assert enc._pipeline._inter_enc is None
    assert b"".join(e.annex_b() for e in got) == \
        b"".join(e.annex_b() for e in want)
    for a, b in zip(want, got):
        for c in "yuv":
            assert np.array_equal(a.recon[c], b.recon[c]), (a.poc, c)
    _decodes(got, tmp_path / f"{case}.265")
    inter = descs[1:]
    # decode order I0 P2 B1 A4 B3: the B frames are the third and fifth
    b_frames = descs[2::2] if kw["gop_size"] == 2 else []
    if case == "ibp-aq-deblock-ctu32":
        # the host bi B tree takes no map, its anchors do
        assert all(d.qp_map is None for d in b_frames)
        assert all(d.qp_map is not None for d in descs[1::2])
        assert any((d.inter_dir == 3).any() for d in b_frames)
    elif "aq" in case:
        # the host P programs take the map for B frames too, as the JAX
        # package's do (its device P programs give B frames none)
        assert all(d.qp_map is not None for d in inter)
    if case == "aq-intra_in_p-ctu32":
        # a P frame with a map runs no intra-in-P, on the host as on the
        # device (the JAX package's golden tree skips it with a map);
        # without the map the same frames code intra CUs
        assert not any((d.pred_mode == MODE_INTRA).any() for d in inter)
        enc, plain = _port(dict(kw, aq_strength=0.0))
        _encode(enc, frames)
        assert any((d.pred_mode == MODE_INTRA).any() for d in plain[1:])
    if case == "intra_rdo-cu16":
        assert any(d.inter_part.any() for d in inter)
    if case == "ibp-intra_rdo-cu16":
        assert any(d.inter_part.any() for d in b_frames)
    if case == "intra_rdo-cu16-fast":
        assert not any(d.inter_part is not None and d.inter_part.any()
                       for d in inter)


def test_multireference_stream_matches_jax_and_decodes(tmp_path,
                                                       monkeypatch):
    """Three references (num_ref_frames 3) with AQ and deblocking on the
    host programs, an IDR at frame 4: I0 P1 P2 P3 I4 P5, frames 2 and 3
    predicting from every picture of the reference queue (per-CU
    ref_idx_l0, the Python serializer), which restarts at the IDR. The
    JAX package's multi-reference AMVP list keeps the same-reference
    above candidate where no left neighbour exists, a list a decoder does
    not derive (ROADMAP Queue 3): on these flickering frames frame 2 codes
    such a CU, and the JAX stream differs from the port's and does not
    decode to its own recon. With the spec's list (spec_amvp_mref) both
    Encoders give identical bytes and recon, and the port's stream
    decodes to its recon."""
    kw = dict(width=128, height=H, qp=30, cu_size=16, gop_size=1,
              intra_period=4, aq_strength=2.0, num_ref_frames=3, sao=False,
              reinit_gop_on_scene_change=False)
    frames = _flicker_frames(np.random.RandomState(10), 128, H, 6)
    faulty = _encode(JaxEncoder(JaxConfig(**kw)), frames)
    enc, descs = _port(kw)
    got = _encode(enc, frames)
    assert [e.frame_type for e in got] == list("IPPPIP")
    refs = [None if d.ref_idx is None else int(d.ref_idx.max())
            for d in descs]
    assert refs[:2] == [None, None] and refs[4:] == [None, None]
    assert refs[2] >= 1 and refs[3] >= 1
    differs = [i for i, (a, b) in enumerate(zip(faulty, got))
               if a.annex_b() != b.annex_b()]
    assert differs == [2]
    with pytest.raises(AssertionError):
        _decodes(faulty, tmp_path / "faulty.265")
    spec_amvp_mref(monkeypatch)
    want = _encode(JaxEncoder(JaxConfig(**kw)), frames)
    assert b"".join(e.annex_b() for e in got) == \
        b"".join(e.annex_b() for e in want)
    for a, b in zip(want, got):
        for c in "yuv":
            assert np.array_equal(a.recon[c], b.recon[c]), (a.poc, c)
    _decodes(got, tmp_path / "mref.265")
