"""The port's own host tier against the JAX package's modules it was copied
from: tables, CABAC context init, headers, availability, the inter syntax
selection (flat and CU tree), the FAR grid and intra-in-P constants, the
host SAO decision and filter, rate control and the native serializer give
identical values and bytes on the same inputs, so the copies cannot drift
apart."""

import dataclasses

import numpy as np
import pytest
import torch

from homerhevc_tpu import native as j_native
from homerhevc_tpu.config import BitrateMode as JBitrateMode
from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.engine.rate_control import RateControl as JRateControl
from homerhevc_tpu.golden import deblock as j_deblock
from homerhevc_tpu.golden import inter_frame as j_inter
from homerhevc_tpu.golden import interp as j_interp
from homerhevc_tpu.golden import intra_pred as j_intra
from homerhevc_tpu.hevc import ctx_tables as j_ctx
from homerhevc_tpu.hevc import headers as j_headers
from homerhevc_tpu.hevc import sao as j_sao
from homerhevc_tpu.hevc import syntax as j_syntax
from homerhevc_tpu.hevc import tables as j_tables
from homerhevc_tpu_torch import native as t_native
from homerhevc_tpu_torch.config import BitrateMode
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.engine.rate_control import RateControl
from homerhevc_tpu_torch.hevc import ctx_tables as t_ctx
from homerhevc_tpu_torch.hevc import headers as t_headers
from homerhevc_tpu_torch.hevc import inter_syntax as t_inter
from homerhevc_tpu_torch.hevc import sao as t_sao
from homerhevc_tpu_torch.hevc import intra_pred as t_intra
from homerhevc_tpu_torch.hevc import syntax as t_syntax
from homerhevc_tpu_torch.hevc import tables as t_tables
from homerhevc_tpu_torch.ops import deblock as t_deblock
from homerhevc_tpu_torch.ops import interp as t_interp

torch.set_num_threads(1)    # one intra-op thread per test worker


def _cfgs(**kw):
    return JaxConfig(**kw), EncoderConfig(**kw)


def test_spec_tables_equal_the_jax_package():
    for name in ("QUANT_SCALE", "INV_QUANT_SCALE", "CHROMA_QP_MAP",
                 "MVD_BITS", "LAMBDA_ME_X16_TAB", "RD_LAMBDA_P_TAB",
                 "RD_LAMBDA_I_TAB", "LPS_TABLE", "RENORM_TABLE",
                 "TRANS_IDX_LPS", "ENTROPY_BITS", "DST4", "DCT32"):
        assert np.array_equal(getattr(t_tables, name),
                              getattr(j_tables, name)), name
    for log2n in (2, 3, 4, 5):
        for scan in (0, 1, 2):
            assert np.array_equal(t_tables.coeff_scan(log2n, scan),
                                  j_tables.coeff_scan(log2n, scan))
    assert np.array_equal(t_intra.PRED_ANGLE, j_intra.PRED_ANGLE)
    assert np.array_equal(t_intra.INV_ANGLE, j_intra.INV_ANGLE)
    for log2_ctu in (4, 5, 6):
        assert np.array_equal(t_intra._zorder_table(log2_ctu, 2),
                              j_intra._zorder_table(log2_ctu, 2))
    assert t_interp.LUMA_FILT == j_interp.LUMA_FILT
    assert t_interp.CHROMA_FILT == j_interp.CHROMA_FILT
    assert np.array_equal(t_deblock.BETA_TABLE, j_deblock.BETA_TABLE)
    assert np.array_equal(t_deblock.TC_TABLE, j_deblock.TC_TABLE)
    assert t_inter.MERGE_FAST_BITS_BASE == j_inter.MERGE_FAST_BITS_BASE
    for st in ("I", "P", "B"):
        for qp in (0, 22, 32, 51):
            assert np.array_equal(t_ctx.init_contexts(st, qp),
                                  j_ctx.init_contexts(st, qp))


def test_zf_multiplier_and_availability_equal_the_jax_package():
    for avg in (0.0, 13.5, 400.0, 1000.0, 1e6):
        for qp in (12, 32, 45):
            assert t_inter.zf_multiplier(avg, qp) == \
                j_inter.zf_multiplier(avg, qp)
    rng = np.random.RandomState(4)
    ta, ja = t_intra.Availability(96, 64, 32), j_intra.Availability(96, 64, 32)
    for x, y, xn, yn in rng.randint(-4, 100, (400, 4)):
        assert ta.available(x, y, xn, yn) == ja.available(x, y, xn, yn)


@pytest.mark.parametrize("kw", [
    dict(width=128, height=64, cu_size=16, gop_size=1, sao=False),
    dict(width=128, height=48, cu_size=16, gop_size=0, sao=False, wpp=True,
         deblocking=False, sign_hiding=False, qp=27),
    dict(width=96, height=64, cu_size=32, gop_size=2, scaling_lists=True,
         aq_strength=1.0, num_ref_frames=2)])
def test_parameter_sets_equal_the_jax_package(kw):
    jcfg, tcfg = _cfgs(**kw)
    jps = j_headers.ParamSets.from_config(jcfg)
    tps = t_headers.ParamSets.from_config(tcfg)
    for ps in (jps, tps):
        ps.conf_win_right, ps.conf_win_bottom = 8, 14
    for w in ("write_vps", "write_sps", "write_pps"):
        assert getattr(t_headers, w)(tps) == getattr(j_headers, w)(jps), w
    for st, refs in ((t_headers.SLICE_I, ()), (t_headers.SLICE_P, (3,))):
        sp = dict(slice_type=st, nal_type=1, poc=4, qp=30,
                  ref_pocs_before=refs)
        assert (t_headers.write_slice_header(
                    tps, t_headers.SliceParams(**sp),
                    entry_point_offsets=[5, 9]).get_bytes()
                == j_headers.write_slice_header(
                    jps, j_headers.SliceParams(**sp),
                    entry_point_offsets=[5, 9]).get_bytes())


def _p_desc(mod, rng, w, h, cu):
    """A random all-inter P FrameDesc with sparse residuals."""
    d = mod.FrameDesc.alloc(w, h)
    d.pred_mode[:] = mod.MODE_INTER
    d.cu_depth[:] = 0
    gh, gw = -(-h // cu), -(-w // cu)
    mv = rng.randint(-6, 7, (gh, gw, 2)) * 4
    mv[rng.rand(gh, gw) < 0.4] = 0
    r = cu // 8
    d.mv[:] = np.repeat(np.repeat(mv, r, 0), r, 1)[:h // 8, :w // 8]
    for name, (ph, pw) in (("coef_y", (h, w)), ("coef_u", (h // 2, w // 2)),
                           ("coef_v", (h // 2, w // 2))):
        c = rng.randint(-3, 4, (ph, pw)) * (rng.rand(ph, pw) < 0.02)
        setattr(d, name, c.astype(np.int16))
    return d


@pytest.mark.parametrize("w,h,is_b", [(128, 64, False), (120, 56, False),
                                      (128, 64, True)])
def test_inter_syntax_and_native_slice_equal_the_jax_package(w, h, is_b):
    """Vectorized (aligned) and loop (ragged) syntax selection, then the
    native CABAC bytes of the resulting P slice."""
    jcfg, tcfg = _cfgs(width=w, height=h, cu_size=16, gop_size=1, sao=False)
    jps = j_headers.ParamSets.from_config(jcfg)
    tps = t_headers.ParamSets.from_config(tcfg)
    jd = _p_desc(j_syntax, np.random.RandomState(w + h), w, h, 16)
    td = _p_desc(t_syntax, np.random.RandomState(w + h), w, h, 16)
    j_inter.select_inter_syntax(jps, jd, 16, is_b=is_b)
    t_inter.select_inter_syntax(tps, td, 16, is_b=is_b)
    for f in ("skip", "inter_mode", "merge_idx", "mvp_flag", "root_cbf"):
        assert np.array_equal(getattr(td, f), getattr(jd, f)), f
    if is_b:
        return
    args = dict(slice_type=t_headers.SLICE_P, ref_dists=(1, 1), slice_qp=32)
    want = j_native.encode_slice_native(jps, jd, j_ctx.init_contexts("P", 32),
                                        True, **args)
    got = t_native.encode_slice_native(tps, td, t_ctx.init_contexts("P", 32),
                                       True, **args)
    assert want is not None and got == want


def _tree_desc(mod, rng, w, h, ctu):
    """A random P FrameDesc of a CU tree at CTU 32 or 64, as the tree P
    program leaves it: CU64 (forced TU32 split), CU32 or four CU16s per
    CTB, a few intra CU16s (mode in luma and chroma), sparse residuals."""
    d = _p_desc(mod, rng, w, h, 16)
    log2_ctu = ctu.bit_length() - 1
    d.cu_depth[:] = log2_ctu - 4
    for y0 in range(0, h - 31, 32):
        for x0 in range(0, w - 31, 32):
            if rng.rand() < 0.5:
                sl = (slice(y0 // 8, y0 // 8 + 4), slice(x0 // 8, x0 // 8 + 4))
                d.cu_depth[sl] = log2_ctu - 5
                d.mv[sl] = d.mv[y0 // 8, x0 // 8]
    if ctu == 64:
        for y0 in range(0, h - 63, 64):
            for x0 in range(0, w - 63, 64):
                if rng.rand() < 0.4:
                    sl = (slice(y0 // 8, y0 // 8 + 8),
                          slice(x0 // 8, x0 // 8 + 8))
                    d.cu_depth[sl] = 0
                    d.tr_depth[sl] = 1
                    d.mv[sl] = d.mv[y0 // 8, x0 // 8]
    intra16 = (rng.rand(h // 16, w // 16) < 0.1) & (
        d.cu_depth[::2, ::2] == log2_ctu - 4)
    m8 = np.repeat(np.repeat(intra16, 2, 0), 2, 1)
    modes = rng.randint(0, 35, intra16.shape)
    d.pred_mode[m8] = mod.MODE_INTRA
    d.mv[m8] = 0
    d.luma_mode[np.repeat(np.repeat(intra16, 4, 0), 4, 1)] = \
        np.repeat(np.repeat(modes, 4, 0), 4, 1)[
            np.repeat(np.repeat(intra16, 4, 0), 4, 1)]
    d.chroma_mode[m8] = np.repeat(np.repeat(modes, 2, 0), 2, 1)[m8]
    return d


@pytest.mark.parametrize("w,h,ctu", [(128, 64, 32), (128, 128, 64),
                                     (96, 80, 32)])
def test_inter_syntax_tree_and_native_slice_equal_the_jax_package(w, h, ctu):
    """select_inter_syntax_tree: its vectorized pass (whole CTUs) and the
    recursive walk (a ragged last CTU row), then the native CABAC bytes of
    the P slice."""
    kw = dict(width=w, height=h, cu_size=ctu, gop_size=1, sao=False,
              intra_rdo=True)
    jcfg, tcfg = _cfgs(**kw)
    jps = j_headers.ParamSets.from_config(jcfg)
    tps = t_headers.ParamSets.from_config(tcfg)
    jd = _tree_desc(j_syntax, np.random.RandomState(w + ctu), w, h, ctu)
    td = _tree_desc(t_syntax, np.random.RandomState(w + ctu), w, h, ctu)
    j_inter.select_inter_syntax_tree(jps, jd)
    t_inter.select_inter_syntax_tree(tps, td)
    for f in ("skip", "inter_mode", "merge_idx", "mvp_flag", "root_cbf"):
        assert np.array_equal(getattr(td, f), getattr(jd, f)), f
    assert (td.inter_mode == 0).any() and (td.inter_mode == 2).any()
    args = dict(slice_type=t_headers.SLICE_P, ref_dists=(1, 1), slice_qp=32)
    want = j_native.encode_slice_native(jps, jd, j_ctx.init_contexts("P", 32),
                                        True, **args)
    got = t_native.encode_slice_native(tps, td, t_ctx.init_contexts("P", 32),
                                       True, **args)
    assert want is not None and got == want


def test_far_grid_and_intra_p_constants_equal_the_jax_package():
    assert t_inter.INTRA_P_ROUNDS == j_inter.INTRA_P_ROUNDS
    for name in ("INTRA_P_MODE_BITS_MPM", "INTRA_P_MODE_BITS_REM"):
        a, b = getattr(t_inter, name), getattr(j_inter, name)
        assert a == b and a.dtype == b.dtype, name
    for rng_c, far in ((16, 64), (16, 128), (24, 96), (8, 36)):
        tg, tm = t_inter.far_grid(rng_c, far)
        jg, jm = j_inter.far_grid(rng_c, far)
        assert tg == jg and np.array_equal(tm, jm)
    for mr in (16, 32, 36, 64, 256):
        jcfg, tcfg = _cfgs(width=64, height=64, me_range=mr)
        for search in (8, 16, 24):
            assert t_inter.far_range(
                t_headers.ParamSets.from_config(tcfg), search) == \
                j_inter.far_range(j_headers.ParamSets.from_config(jcfg),
                                  search)


@pytest.mark.parametrize("ctu,qp", [(16, 27), (32, 32), (64, 37)])
def test_host_sao_equals_the_jax_package(ctu, qp):
    """sao_decide (stats, RD offsets, counted-bit type and merge choice)
    and sao_apply_component of the copy == the JAX package's module."""
    rng = np.random.RandomState(ctu + qp)
    h, w = 128, 128
    src = tuple(rng.randint(0, 256, s).astype(np.uint8)
                for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    # recon: smoothed source + structured error so offsets are worth it
    rec = tuple(np.clip((p.astype(np.int32) + np.roll(p, 1, 1)) // 2
                        + rng.randint(-3, 4, p.shape), 0, 255)
                .astype(np.uint8) for p in src)
    want = j_sao.sao_decide(src, rec, ctu, qp)
    got = t_sao.sao_decide(src, rec, ctu, qp)
    for f in ("merge_left", "merge_up", "type_luma", "type_chroma",
              "eo_class_luma", "eo_class_chroma", "band_pos", "offsets"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.type_luma != 0).any()
    for comp, n in ((0, ctu), (1, ctu // 2), (2, ctu // 2)):
        assert np.array_equal(
            t_sao.sao_apply_component(rec[comp], got, comp, n),
            j_sao.sao_apply_component(rec[comp], want, comp, n))


def test_rate_control_equals_the_jax_package():
    kw = dict(width=64, height=64, cu_size=16, gop_size=1, intra_period=8,
              bitrate_kbps=600)
    jcfg = JaxConfig(**kw, bitrate_mode=JBitrateMode.VBR)
    tcfg = EncoderConfig(**kw, bitrate_mode=BitrateMode.VBR)
    jrc, trc = JRateControl(jcfg), RateControl(tcfg)
    rng = np.random.RandomState(9)
    for i in range(24):
        intra = i % 8 == 0
        assert trc.pic_qp(intra) == jrc.pic_qp(intra)
        if i == 13:
            trc.scene_pivot()
            jrc.scene_pivot()
        bits = int(rng.randint(2000, 60000))
        trc.end_pic(bits, intra)
        jrc.end_pic(bits, intra)
    assert dataclasses.asdict(tcfg).keys() == dataclasses.asdict(jcfg).keys()


@pytest.mark.parametrize("wpp", [False, True])
def test_python_serializer_fallback_gives_native_bytes(wpp, monkeypatch):
    """Without the native library (no g++) the pipeline's Python CABAC
    path, WPP substreams included, writes the same stream."""
    from homerhevc_tpu_torch.api import Encoder
    from tests.conftest import make_yuv
    cfg = EncoderConfig(width=64, height=48, cu_size=16, gop_size=1, qp=30,
                        sao=False, wpp=wpp)
    rng = np.random.RandomState(21)
    y, u, v = make_yuv(rng, 64, 48)
    frames = [(y, u, v), (np.roll(y, 2, 1), np.roll(u, 1, 1), v)]

    def stream():
        enc = Encoder(cfg, device="cpu")
        efs = [ef for f in frames for ef in enc.encode(*f)]
        efs += list(enc.flush())
        return b"".join(ef.annex_b() for ef in efs)
    want = stream()
    monkeypatch.setattr(t_native, "get_lib", lambda: None)
    assert stream() == want
