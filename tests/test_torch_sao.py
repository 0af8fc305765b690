"""SAO in the port against the JAX package: ops/sao_dev.sao_analyze_apply
equals the JAX function (filtered planes, every parameter, the packed and
unpacked wire) on content where OFF, band offset and all four edge
classes occur; the flat CU16 P program with SAO equals the same program
without SAO followed by the JAX SAO; chip_smoke.py's tree + SAO digest and
its IPPP tree digests are the golden encoders' followed by the JAX SAO.
The CU16 streams with SAO are held to the JAX Encoder in
test_torch_e2e.py."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.golden.inter_frame import encode_inter_frame_tree
from homerhevc_tpu.hevc import bitstream, cabac, ctx_tables, headers, syntax
from homerhevc_tpu.hevc import tables as jtables
from homerhevc_tpu.ops import sao_dev as jsd
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.ops import sao_dev as tsd
from homerhevc_tpu_torch.state import reference_from_numpy
from tests.conftest import make_yuv
from tests.torch_golden import golden_tree

torch.set_num_threads(1)    # one intra-op thread per test worker

# one compiled JAX program per (shape, ctu) in this process
_JAX_SAO = jax.jit(jsd.sao_analyze_apply, static_argnums=(6,))
_SAO_FIELDS = ("type_luma", "type_chroma", "eo_class_luma",
               "eo_class_chroma", "band_pos", "offsets", "merge_left",
               "merge_up")
# (dy0, dx0), (dy1, dx1) neighbours of the four EO classes
_EO = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1), (1, -1, -1, 1))


def _sao_pair(rng, h, w, ctu):
    """(src, recon) int32 planes whose CTBs ask, in raster order, for SAO
    off, a band offset, then edge offsets of class 0, 1, 2, 3: noisy
    texture sharpened along one direction (the EO corrects the overshoot)
    and a narrow-range patch shifted by +4 (the BO corrects it)."""
    src = np.zeros((h, w), np.int32)
    rec = np.zeros((h, w), np.int32)
    for i in range((h // ctu) * (w // ctu)):
        cy, cx = divmod(i, w // ctu)
        ys, xs = slice(cy * ctu, (cy + 1) * ctu), slice(cx * ctu,
                                                        (cx + 1) * ctu)
        kind = i % 6
        if kind == 1:
            s = 100 + rng.randint(0, 20, (ctu, ctu))
            r = s + 4
        else:
            s = 128 + rng.randint(-50, 51, (ctu, ctu))
            r = s
            if kind >= 2:
                dy0, dx0, dy1, dx1 = _EO[kind - 2]
                p = np.pad(s, 1, mode="edge")
                a = p[1 + dy0:1 + dy0 + ctu, 1 + dx0:1 + dx0 + ctu]
                b = p[1 + dy1:1 + dy1 + ctu, 1 + dx1:1 + dx1 + ctu]
                r = s + (2 * s - a - b) // 6
        src[ys, xs] = s
        rec[ys, xs] = np.clip(r, 0, 255)
    return src, rec


def _assert_params_equal(p, q):
    for f in _SAO_FIELDS:
        assert np.array_equal(getattr(p, f), getattr(q, f)), f


# the CTU-32 planes have the shape of chip_smoke's 128x64 tree frame, so
# that the tree + SAO digest below reuses this compile
@pytest.mark.parametrize("ctu,h,w", [(32, 64, 128), (64, 128, 192)])
def test_sao_analyze_apply_matches_jax(ctu, h, w):
    rng = np.random.RandomState(ctu)
    (sy, ry), (su, ru), (sv, rv) = (_sao_pair(rng, h, w, ctu),
                                    _sao_pair(rng, h // 2, w // 2, ctu // 2),
                                    _sao_pair(rng, h // 2, w // 2, ctu // 2))
    planes = (sy, su, sv, ry, ru, rv)
    qp = 32
    lam = tsd.sao_lambda_x256(qp)
    want = _JAX_SAO(*(jnp.asarray(p) for p in planes), ctu,
                    jnp.int32(int(lam)))
    got = tsd.sao_analyze_apply(*(torch.from_numpy(p) for p in planes), ctu,
                                lam)
    for a, b in zip(want[:3], got[:3]):
        assert np.array_equal(np.asarray(a), b.numpy())
    for k in want[3]:
        assert np.array_equal(np.asarray(want[3][k]), got[3][k].numpy()), k
    # OFF, BO and EO occur, and the EO CTBs use all four classes
    types = got[3]["type_l"].numpy()
    assert set(np.unique(types)) == {0, 1, 2}
    assert set(got[3]["ec_l"].numpy()[types == 2]) == {0, 1, 2, 3}
    assert set(np.unique(got[3]["type_c"].numpy())) == {0, 1, 2}
    # the wire: packed bytes, and the host parameters unpacked from them
    packed = tsd.pack_params(got[3])
    assert np.array_equal(packed.numpy(),
                          np.asarray(jsd.pack_params(want[3])))
    gh, gw = h // ctu, w // ctu
    assert packed.numel() == tsd.params_nbytes(gh, gw)
    _assert_params_equal(tsd.unpack_params(packed.numpy(), gh, gw),
                         jsd.unpack_params(np.asarray(packed), gh, gw))
    # a leading frame axis (the tree program's batch) == frame by frame
    rev = tuple(p[::-1, ::-1].copy() for p in planes)
    batch = tsd.sao_analyze_apply(
        *(torch.from_numpy(np.stack([a, b])) for a, b in zip(planes, rev)),
        ctu, torch.stack([lam, lam]))
    one = tsd.sao_analyze_apply(*(torch.from_numpy(p) for p in rev), ctu,
                                lam)
    assert torch.equal(batch[0][0], got[0]) and torch.equal(batch[0][1],
                                                            one[0])
    assert torch.equal(tsd.pack_params(batch[3])[1], tsd.pack_params(one[3]))


def test_p_frame_sao_matches_jax_sao():
    """The P program with SAO == the P program without SAO, followed by
    the JAX SAO on its recon: filtered planes, parameters, row SSD of the
    filtered luma; motion and levels unchanged."""
    rng = np.random.RandomState(31)
    w, h, qp = 64, 64, 32
    y, u, v = make_yuv(rng, w, h)
    ref = (np.clip(np.roll(y, 3, 1).astype(int)
                   + rng.randint(-6, 7, y.shape), 0, 255).astype(np.uint8),
           np.roll(u, 1, 1), np.roll(v, 1, 1))
    cfg = EncoderConfig(width=w, height=h, qp=qp, gop_size=1,
                        intra_period=0, sao=True, deblocking=True,
                        sign_hiding=True, cu_size=16)
    out = {}
    for sao in (False, True):
        c = dataclasses.replace(cfg, sao=sao)
        enc = TorchInterEncoder(ParamSets.from_config(c), c, device="cpu")
        out[sao] = enc.encode_frame((y, u, v), reference_from_numpy(ref,
                                                                    "cpu"))
    d0, *rec0 = out[False]
    d1, *rec1 = out[True]
    want = _JAX_SAO(*(jnp.asarray(np.asarray(p, np.int32))
                      for p in ((y, u, v) + tuple(rec0))), 16,
                    jnp.int32(int(tsd.sao_lambda_x256(qp))))
    for a, b in zip(want[:3], rec1):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    _assert_params_equal(d1.sao_params, jsd.unpack_params(
        np.asarray(jsd.pack_params(want[3])), h // 16, w // 16))
    assert (d1.sao_params.type_luma != 0).any()
    dy = np.asarray(want[0]).astype(np.int64) - y
    assert np.array_equal(d1.row_ssd_y, (dy * dy).sum(axis=1))
    for f in ("mv", "coef_y", "coef_u", "coef_v", "skip", "merge_idx"):
        assert np.array_equal(getattr(d0, f), getattr(d1, f)), f


def _jax_sao(ps, src, rec, qp):
    """The JAX SAO (decide + apply) of the frame rec coded from src: the
    filtered planes (numpy) and the host parameters of its wire."""
    lam = int(np.float32(jtables.RD_LAMBDA_I_TAB[qp]) * 256.0 + 0.5)
    *out, params = _JAX_SAO(*(jnp.asarray(np.asarray(p, np.int32))
                              for p in tuple(src) + tuple(rec)),
                            ps.ctu_size, jnp.int32(lam))
    h, w = np.asarray(rec[0]).shape
    sao = jsd.unpack_params(np.asarray(jsd.pack_params(params)),
                            h // ps.ctu_size, w // ps.ctu_size)
    return [np.asarray(p) for p in out], sao


_HEVC = types.SimpleNamespace(headers=headers, bitstream=bitstream,
                              cabac=cabac, ctx_tables=ctx_tables,
                              syntax=syntax)


def test_tree_sao_digest_is_golden():
    """chip_smoke.py's "I tree CU32 deblock+SAO" cell: the golden tree +
    golden deblock, then the JAX SAO on its recon, serialized by the JAX
    package with the SAO params, hashes to GOLDEN_DIGESTS."""
    name = "I tree CU32 deblock+SAO"
    cfg = JaxConfig(**chip_smoke.TREE_CFG, **chip_smoke.TREE_CELLS[name])
    ps = headers.ParamSets.from_config(cfg)
    y, u, v = chip_smoke.tree_parity_inputs()
    desc, *rec = golden_tree(ps, y, u, v, cfg.qp)
    rec, sao = _jax_sao(ps, (y, u, v), rec, cfg.qp)
    assert (sao.type_luma != 0).any()
    assert chip_smoke.digests(
        chip_smoke.slice_annexb(_HEVC, ps, desc, headers.SLICE_I, cfg.qp,
                                sao), rec) == chip_smoke.GOLDEN_DIGESTS[name]


@pytest.mark.parametrize("name", list(chip_smoke.IPPP_CELLS))
def test_ippp_tree_sao_digests_are_golden(name):
    """chip_smoke.py's IPPP tree cells (CTU 32 reuses the JAX SAO compile
    of the cell above): the golden tree I frame, then golden
    encode_inter_frame_tree P frames from the filtered recon with the I
    frame's zero-forcing threshold, each frame followed by the JAX SAO
    (the P program's SAO is that function), serialized by the JAX package,
    hash to GOLDEN_DIGESTS. The JAX device P program equals golden
    encode_inter_frame_tree (tests/test_tpu_inter.py, tests/test_cu64.py),
    and at CTU 32 the JAX Encoder's IPPP stream equals the port's
    (tests/test_torch_intra_tree.py); at CTU 64 golden is the reference
    (ROADMAP Queue 3)."""
    cfg = JaxConfig(**chip_smoke.IPPP_CFG, **chip_smoke.IPPP_CELLS[name])
    ps = headers.ParamSets.from_config(cfg)
    frames = chip_smoke.ippp_parity_inputs()
    desc, *rec = golden_tree(ps, *frames[0], cfg.qp)
    rec, sao = _jax_sao(ps, frames[0], rec, cfg.qp)
    stream = [chip_smoke.slice_annexb(_HEVC, ps, desc, headers.SLICE_I,
                                      cfg.qp, sao)]
    planes = list(rec)
    avg = chip_smoke.i_frame_avg_dist(frames[0][0], rec[0])
    depths = []
    for poc in (1, 2):
        desc, *rec = encode_inter_frame_tree(
            ps, frames[poc], tuple(p.astype(np.int32) for p in rec), cfg.qp,
            avg_dist=avg)
        depths.append(desc.cu_depth)
        rec, sao = _jax_sao(ps, frames[poc], rec, cfg.qp)
        stream.append(chip_smoke.slice_annexb(_HEVC, ps, desc,
                                              headers.SLICE_P, cfg.qp, sao,
                                              poc))
        planes += rec
    # some CTB coded as one CU32 / CU64
    assert any((d < ps.log2_ctu - 4).any() for d in depths)
    assert chip_smoke.digests(b"".join(stream), planes) == \
        chip_smoke.GOLDEN_DIGESTS[name]
