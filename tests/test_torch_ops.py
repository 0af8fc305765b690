"""Every ported op of homerhevc_tpu_torch.ops against its
homerhevc_tpu.ops counterpart on the same numpy inputs. Bit-exact
(np.array_equal): the codec is integer-exact end to end."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from homerhevc_tpu.config import EncoderConfig
from homerhevc_tpu.hevc import tables as T
from homerhevc_tpu.hevc.headers import ParamSets
from homerhevc_tpu.ops import deblock as jdb
from homerhevc_tpu.ops import interp as jip
from homerhevc_tpu.ops import intra as jin
from homerhevc_tpu.ops import pack as jpk
from homerhevc_tpu.ops import quant as jq
from homerhevc_tpu.ops import transform as jt
from homerhevc_tpu_torch.ops import deblock as tdb
from homerhevc_tpu_torch.ops import interp as tip
from homerhevc_tpu_torch.ops import intra as tin
from homerhevc_tpu_torch.ops import pack as tpk
from homerhevc_tpu_torch.ops import quant as tq
from homerhevc_tpu_torch.ops import transform as tt

torch.set_num_threads(1)    # one intra-op thread per test worker


def _eq(j, t):
    return np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("n,dst", [(4, True), (4, False), (8, False),
                                   (16, False), (32, False)])
def test_transforms(n, dst):
    rng = np.random.RandomState(n + dst)
    res = rng.randint(-255, 256, (6, n, n)).astype(np.int32)
    assert _eq(jt.forward_transform(jnp.asarray(res), dst),
               tt.forward_transform(torch.from_numpy(res), dst))
    coef = rng.randint(-32768, 32768, (6, n, n)).astype(np.int32)
    assert _eq(jt.inverse_transform(jnp.asarray(coef), dst),
               tt.inverse_transform(torch.from_numpy(coef), dst))


def _coef(rng, n, B=12):
    c = (rng.laplace(0, 400, (B, n, n)) * (rng.rand(B, n, n) < 0.7))
    return np.clip(c, -32768, 32767).astype(np.int32)


@pytest.mark.parametrize("n,intra,per_block", [
    (4, True, False), (8, False, False), (16, True, True), (32, False, True)])
def test_quant_dequant(n, intra, per_block):
    rng = np.random.RandomState(n)
    coef = _coef(rng, n)
    qps = [0, 5, 22, 32, 40, 51]
    for qp in qps:
        q = rng.randint(0, 52, coef.shape[0]).astype(np.int32) \
            if per_block else qp
        qj = jnp.asarray(q) if per_block else q
        qt = torch.from_numpy(q) if per_block else q
        lj = jq.quantize(jnp.asarray(coef), n, qj, intra)
        lt = tq.quantize(torch.from_numpy(coef), n, qt, intra)
        assert _eq(lj, lt)
        assert _eq(jq.dequantize(lj, n, qj, intra),
                   tq.dequantize(lt, n, qt, intra))
        for a, b in zip(jq.quant_params(n, qp, intra, False),
                        tq.quant_params(n, qp, intra, False)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("n,scan,per_block", [
    (4, 0, False), (4, 1, False), (8, 2, True), (16, 0, True),
    (32, 0, False)])
def test_sign_bit_hiding(n, scan, per_block):
    rng = np.random.RandomState(100 + n + scan)
    coef = _coef(rng, n, 40)
    for qp in (22, 32, 37):
        q = rng.randint(18, 45, coef.shape[0]).astype(np.int32) \
            if per_block else qp
        qj = jnp.asarray(q) if per_block else q
        qt = torch.from_numpy(q) if per_block else q
        lvl = np.array(jq.quantize(jnp.asarray(coef), n, qj, True))
        want = jq.sign_bit_hiding(jnp.asarray(lvl), jnp.asarray(coef), n, qj,
                                  True, scan)
        got = tq.sign_bit_hiding(torch.from_numpy(lvl),
                                 torch.from_numpy(coef), n, qt, True, scan)
        assert _eq(want, got)
        assert not np.array_equal(np.asarray(want), lvl)   # SBH acted
        if n <= 8:
            # one call with a per-block scan == three calls and a select
            sel = rng.randint(0, 3, coef.shape[0])
            per = [np.asarray(jq.sign_bit_hiding(
                jnp.asarray(lvl), jnp.asarray(coef), n, qj, True, s))
                for s in (0, 1, 2)]
            got = tq.sign_bit_hiding(torch.from_numpy(lvl),
                                     torch.from_numpy(coef), n, qt, True,
                                     torch.from_numpy(sel))
            assert np.array_equal(np.choose(sel[:, None, None], per),
                                  got.numpy())


def _refs(rng, B, n, flat=False):
    if flat:   # ties everywhere: every mode predicts the same plane
        v = rng.randint(0, 256, (B, 1))
        return (np.repeat(v, 2 * n + 1, 1).astype(np.int32),) * 2
    return (rng.randint(0, 256, (B, 2 * n + 1)).astype(np.int32),
            rng.randint(0, 256, (B, 2 * n + 1)).astype(np.int32))


@pytest.mark.parametrize("n,luma,flat", [(4, True, False), (8, False, False),
                                         (16, True, False), (16, True, True),
                                         (32, True, False)])
def test_intra_predictors(n, luma, flat):
    rng = np.random.RandomState(n)
    top, left = _refs(rng, 5, n, flat)
    jt_, jl_ = jnp.asarray(top), jnp.asarray(left)
    tt_, tl_ = torch.from_numpy(top), torch.from_numpy(left)
    for a, b in zip(jin.filter_refs(jt_, jl_), tin.filter_refs(tt_, tl_)):
        assert _eq(a, b)
    pj = jin.predict_all_modes(jt_, jl_, n, luma)
    pt = tin.predict_all_modes(tt_, tl_, n, luma)
    assert _eq(pj, pt)
    assert _eq(jin.edge_fixes(pj, jt_, jl_, n, luma),
               tin.edge_fixes(pt, tt_, tl_, n, luma))


@pytest.mark.parametrize("n,luma", [(4, True), (8, True), (16, True),
                                    (32, True), (4, False), (8, False),
                                    (16, False), (32, False)])
def test_predict_mode(n, luma):
    """Single-mode prediction with a per-block mode vector, every one of
    the 35 modes twice (random and flat refs) against the JAX function."""
    rng = np.random.RandomState(200 + n + luma)
    top, left = _refs(rng, 70, n)
    ft, fl = _refs(rng, 70, n, flat=True)
    top[35:], left[35:] = ft[35:], fl[35:]
    mode = np.tile(np.arange(35, dtype=np.int32), 2)
    predict = jax.jit(jin.predict_mode, static_argnums=(2, 4))
    assert _eq(predict(jnp.asarray(top), jnp.asarray(left), n,
                       jnp.asarray(mode), luma),
               tin.predict_mode(torch.from_numpy(top), torch.from_numpy(left),
                                n, torch.from_numpy(mode), luma))


def test_ref_substitution_and_gather():
    rng = np.random.RandomState(3)
    n, B = 8, 9
    L = 4 * n + 1
    vals = rng.randint(0, 256, (B, L)).astype(np.int32)
    avail = rng.rand(B, L) < 0.4
    avail[0] = False                        # nothing available -> 128
    avail[1, 0] = False                     # first unavailable
    assert _eq(jin.substitute_refs(jnp.asarray(vals), jnp.asarray(avail)),
               tin.substitute_refs(torch.from_numpy(vals),
                                   torch.from_numpy(avail)))
    for a, b in zip(jin.seq_to_refs(jnp.asarray(vals), n),
                    tin.seq_to_refs(torch.from_numpy(vals), n)):
        assert _eq(a, b)
    planes = rng.randint(0, 256, (2, 32, 48)).astype(np.uint8)
    # one plane, and a leading frame axis (the tree decision's batch)
    got = tin.gather_ref_seq(torch.from_numpy(planes), n)
    for i in (0, 1):
        want = jin.gather_ref_seq(jnp.asarray(planes[i]), n)
        assert _eq(want, tin.gather_ref_seq(torch.from_numpy(planes[i]), n))
        assert _eq(want, got[i])
    xs, ys = np.arange(6)[None, :] * 8, np.arange(4)[:, None] * 8
    assert np.array_equal(jin.avail_masks(96, 64, 16, 8, 0, xs, ys),
                          tin.avail_masks(96, 64, 16, 8, 0, xs, ys))
    W, S = jin.pred_weights(8, True)
    W2, S2 = tin.pred_weights(8, True)
    assert np.array_equal(W, W2) and np.array_equal(S, S2)


@pytest.mark.parametrize("density,cap_qp", [(0.03, 32), (0.2, 32),
                                            (0.6, 12)])
def test_pack_sparse_cg(density, cap_qp):
    rng = np.random.RandomState(int(density * 100))
    h, w = 32, 64
    shapes = [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    planes = []
    for ph, pw in shapes:
        lv = rng.choice([1, -1, 2, -2, 3, -7, 300], (ph, pw),
                        p=[.4, .4, .06, .06, .04, .02, .02])
        planes.append((lv * (rng.rand(ph, pw) < density)).astype(np.int16))
    n = sum(a * b for a, b in shapes)
    C, cgC = tpk.pack_capacity(n, cap_qp), tpk.cg_cap(n, cap_qp)
    assert (C, cgC) == (jpk.pack_capacity(n, cap_qp), jpk.cg_cap(n, cap_qp))
    assert tpk.esc_capacity(n, C) == jpk.esc_capacity(n, C)
    j = [np.asarray(x) for x in
         jpk.pack_sparse_cg([jnp.asarray(p) for p in planes], C, cgC)]
    t = [x.numpy() for x in
         tpk.pack_sparse_cg([torch.from_numpy(p) for p in planes], C, cgC)]
    cnt, ec, cc = int(j[5]), int(j[6]), int(j[7])
    assert (cnt, ec, cc) == (int(t[5]), int(t[6]), int(t[7]))
    for k in (0, 2):                                    # bitmap, codes
        assert np.array_equal(j[k], t[k])
    assert np.array_equal(j[1][:cc], t[1][:cc])         # masks
    assert np.array_equal(j[3][:ec], t[3][:ec])         # escape idx/val
    assert np.array_equal(j[4][:ec], t[4][:ec])
    assert [x.dtype for x in t[:5]] == [x.dtype for x in j[:5]]
    if cnt <= C and cc <= cgC:
        got = tpk.unpack_sparse_cg(t[0], t[1], t[2], cnt, cc, t[3][:ec],
                                   t[4][:ec], shapes)
        for a, b in zip(got, planes):
            assert np.array_equal(a, b)


def _plane(rng, h, w):
    # blocky content so strong, normal and off filter decisions all occur
    base = rng.randint(60, 200, (h // 8, w // 8))
    p = np.repeat(np.repeat(base, 8, 0), 8, 1) + rng.randint(-3, 4, (h, w))
    return np.clip(p, 0, 255).astype(np.int32)


@pytest.mark.parametrize("qp", [22, 32, 45])
def test_deblock(qp):
    rng = np.random.RandomState(qp)
    y = _plane(rng, 64, 96)
    c = _plane(rng, 32, 48)
    # one compiled program per JAX function (eager dispatch is slow here)
    j_luma = jax.jit(jdb.deblock_luma_uniform, static_argnums=(1, 2))
    j_chroma = jax.jit(jdb.deblock_chroma_uniform, static_argnums=(1, 2, 3))
    j_luma_bs = jax.jit(jdb.deblock_luma_bs)
    j_chroma_bs = jax.jit(jdb.deblock_chroma_bs, static_argnums=(4,))
    assert _eq(j_luma(jnp.asarray(y), 16, qp),
               tdb.deblock_luma_uniform(torch.from_numpy(y), 16, qp))
    assert _eq(j_chroma(jnp.asarray(c), 16, qp, 2),
               tdb.deblock_chroma_uniform(torch.from_numpy(c), 16, qp, 2))
    bs_v = rng.randint(0, 3, (8, 12)).astype(np.int32)
    bs_h = rng.randint(0, 3, (8, 12)).astype(np.int32)
    assert _eq(j_luma_bs(jnp.asarray(y), jnp.asarray(bs_v),
                                   jnp.asarray(bs_h), jnp.int32(qp)),
               tdb.deblock_luma_bs(torch.from_numpy(y),
                                   torch.from_numpy(bs_v),
                                   torch.from_numpy(bs_h), qp))
    b2v, b2h = bs_v == 2, bs_h == 2
    assert _eq(j_chroma_bs(jnp.asarray(c), jnp.asarray(b2v),
                                     jnp.asarray(b2h), jnp.int32(qp), 2),
               tdb.deblock_chroma_bs(torch.from_numpy(c),
                                     torch.from_numpy(b2v),
                                     torch.from_numpy(b2h), qp, 2))
    # a frame batch with per-frame QPs == frame-by-frame
    ys = np.stack([y, _plane(rng, 64, 96)])
    qv = np.asarray([qp, qp - 4], np.int32)
    got = tdb.deblock_luma_uniform(torch.from_numpy(ys), 16,
                                   torch.from_numpy(qv))
    for i in range(2):
        assert _eq(j_luma(jnp.asarray(ys[i]), 16, int(qv[i])), got[i])


def test_interp():
    rng = np.random.RandomState(5)
    plane = rng.randint(0, 256, (40, 56)).astype(np.int32)
    B, n, pad = 7, 8, 6
    x0s = (np.arange(B) % 3 * 8).astype(np.int32)
    y0s = (np.arange(B) // 3 * 8).astype(np.int32)
    mvs = rng.randint(-20, 21, (B, 2)).astype(np.int32)
    ref_pad = np.pad(plane, pad, mode="edge")
    assert _eq(jip.mc_chroma_batch(jnp.asarray(ref_pad), pad,
                                   jnp.asarray(x0s), jnp.asarray(y0s), n,
                                   jnp.asarray(mvs)),
               tip.mc_chroma_batch(torch.from_numpy(ref_pad), pad,
                                   torch.from_numpy(x0s),
                                   torch.from_numpy(y0s), n,
                                   torch.from_numpy(mvs)))
    by = np.asarray([0, 3, 30, 17], np.int32)   # starts in range, edges
    bx = np.asarray([0, 5, 44, 46], np.int32)
    assert _eq(jip.extract_patches(jnp.asarray(plane), jnp.asarray(by),
                                   jnp.asarray(bx), 10),
               tip.extract_patches(torch.from_numpy(plane),
                                   torch.from_numpy(by),
                                   torch.from_numpy(bx), 10))
    assert np.array_equal(jip.LUMA_TAPS, tip.LUMA_TAPS)


def test_tables_match_jax_modules():
    from homerhevc_tpu.engine import intra_encoder as jie
    from homerhevc_tpu_torch.config import EncoderConfig as TorchConfig
    from homerhevc_tpu_torch.hevc.headers import ParamSets as TorchParamSets
    from homerhevc_tpu_torch.state import tables_to_torch
    kw = dict(width=96, height=64, cu_size=16, qp=30, gop_size=1)
    cfg = EncoderConfig(**kw)
    ps = ParamSets.from_config(cfg)
    tcfg = TorchConfig(**kw)
    tab = tables_to_torch(TorchParamSets.from_config(tcfg), tcfg,
                          torch.device("cpu"))
    for n in (4, 8, 16, 32):
        assert np.array_equal(tab[f"dct{n}"].numpy(), T.DCT[n])
    assert np.array_equal(tab["dst4"].numpy(), T.DST4)
    for n, luma in ((16, True), (8, False)):
        W, S = jin.pred_weights(n, luma)
        k = f"{n}_{int(luma)}"
        assert np.array_equal(tab["pred_w" + k].numpy().T.reshape(W.shape),
                              W.astype(np.float32))
        assert np.array_equal(tab["pred_s" + k].numpy(), S)
    for n in (16, 8):
        for intra in (True, False):
            assert np.array_equal(tab[f"qc6_{n}_{int(intra)}"].numpy(),
                                  jq._qc6(n, intra, False))
            assert np.array_equal(tab[f"dq6_{n}_{int(intra)}"].numpy(),
                                  jq._dq6(n, intra, False))
    for name, ref in (("chroma_qp_map", T.CHROMA_QP_MAP),
                      ("lambda_me_x16", T.LAMBDA_ME_X16_TAB),
                      ("rd_lambda_p", T.RD_LAMBDA_P_TAB),
                      ("mvd_bits", T.MVD_BITS), ("bits_mpm", jie._BITS_MPM),
                      ("bits_rem", jie._BITS_REM)):
        assert np.array_equal(tab[name].numpy(), ref), name
    enc = jie.TpuIntraEncoder.__new__(jie.TpuIntraEncoder)
    enc.ps, enc.w, enc.h, enc.cu = ps, 96, 64, 16
    enc.gw, enc.gh = 6, 4
    enc._build_static()
    assert tab["ndiag"] == enc.ndiag
    for k in ("d_valid", "d_has_left", "d_above_ok", "d_mask_y", "d_mask_c",
              "d_flat"):
        assert np.array_equal(tab[k].numpy(), getattr(enc, k)), k
