"""The pieces of the B slice that need no whole JAX program, against the
JAX package: the coarse sweep on a wide source (the bi target
2 * src - pred0, in [-255, 510]) against JAX's int16 sweep (its oracle
and the Pallas kernel in interpret mode), including a source whose uint8
wrap would move the chosen MV; the hierarchical search on such a target
with the FAR level on (its 4x-decimated source comes from the true
values); and the four interpolation helpers of ops/interp.py. The B
program itself (_impl_b) and the IBP / generalized-B streams are held to
the JAX package in test_torch_intra_tree.py (CTU 32, beside the JAX
programs the IPPP stream test builds) and test_torch_inter_tree.py
(IBP at CTU 64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.engine.inter_encoder import TpuInterEncoder
from homerhevc_tpu.hevc.headers import ParamSets as JaxParamSets
from homerhevc_tpu.ops import interp as jax_interp
from homerhevc_tpu.ops.pallas.me_sad import (coarse_sweep_sads,
                                             coarse_sweep_sads_ref)
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.device import LAUNCHES
from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.ops import interp
from homerhevc_tpu_torch.ops import me_sad as tms

torch.set_num_threads(1)    # one intra-op thread per test worker


def _wide_inputs(seed, gh, gw, R, m):
    """A bi target's decimated source in [-255, 510] (twice a texture less
    a noisy prediction of it) and an edge-padded uint8 reference."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, 256, (gh * m, gw * m))
    pred = np.clip(src + rng.randint(-255, 256, src.shape), 0, 255)
    sd = (2 * src - pred).astype(np.int16)
    ref = rng.randint(0, 256, (gh * m, gw * m))
    return sd, np.pad(ref, R, mode="edge").astype(np.uint8)


@pytest.mark.parametrize("gh,gw,R,m,pallas", [
    (4, 6, 8, 8, True), (3, 5, 16, 8, True), (2, 3, 24, 8, True),
    (2, 3, 24, 16, False)])
def test_wide_sweep_matches_jax(gh, gw, R, m, pallas):
    sd, rp = _wide_inputs(gh * 100 + gw * 10 + R, gh, gw, R, m)
    assert sd.min() < 0 and sd.max() > 255
    want = np.asarray(coarse_sweep_sads_ref(jnp.asarray(sd),
                                            jnp.asarray(rp.astype(np.int16)),
                                            R, m))
    before = dict(LAUNCHES)
    got = tms.coarse_sweep_sads(torch.from_numpy(sd), torch.from_numpy(rp),
                                R, m)
    assert LAUNCHES == before            # the plain CPU version
    assert np.array_equal(got.numpy(), want)
    if pallas:
        kern = np.asarray(coarse_sweep_sads(
            jnp.asarray(sd), jnp.asarray(rp.astype(np.int16)), R, m,
            interpret=True))
        assert np.array_equal(got.numpy(), kern)


def test_wide_sweep_a_uint8_wrap_moves_the_mv():
    """The offsets of least SAD from the true wide source (port == JAX)
    against those from the same source wrapped modulo 256: the wrap moves
    the chosen MV of some blocks. Any other source dtype raises, so the
    wrapper never casts."""
    R, m = 8, 8
    sd, rp = _wide_inputs(7, 3, 4, R, m)
    got = tms.coarse_sweep_sads(torch.from_numpy(sd), torch.from_numpy(rp),
                                R, m).numpy()
    want = np.asarray(coarse_sweep_sads_ref(jnp.asarray(sd),
                                            jnp.asarray(rp.astype(np.int16)),
                                            R, m))
    assert np.array_equal(got, want)
    wrapped = tms.coarse_sweep_sads(torch.from_numpy(sd.astype(np.uint8)),
                                    torch.from_numpy(rp), R, m).numpy()
    assert (got.argmin(axis=0) != wrapped.argmin(axis=0)).any()
    with pytest.raises(TypeError):
        tms.coarse_sweep_sads(torch.from_numpy(sd.astype(np.int32)),
                              torch.from_numpy(rp), R, m)


def test_hier_me_on_a_wide_target_matches_jax():
    """_hier_me on a bi target in [-255, 510] with the FAR level on
    (me_range 40 > 2 x search 8): the coarse sweep, the FAR level's
    4x-decimated source and the full-resolution sweeps read its true
    values, as JAX's int16 planes do; the same target wrapped to uint8
    chooses other MVs."""
    w, h = 64, 64
    kw = dict(width=w, height=h, qp=32, gop_size=1, cu_size=16,
              me_range=40, sao=False)
    jcfg = JaxConfig(**kw)
    jax_enc = TpuInterEncoder(JaxParamSets.from_config(jcfg), jcfg,
                              search=8)
    cfg = EncoderConfig(**kw)
    enc = TorchInterEncoder(ParamSets.from_config(cfg), cfg, search=8,
                            device="cpu")
    assert enc.far == jax_enc.far == 40
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:h, 0:w]
    ref = np.clip(128 + 100 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
                  + rng.randint(-20, 21, (h, w)), 0, 255).astype(np.int32)
    src = np.roll(ref, (3, 40), (0, 1))
    pred = np.clip(src + rng.randint(-200, 201, (h, w)), 0, 255)
    tgt = 2 * src - pred
    assert tgt.min() < 0 and tgt.max() > 255
    want = jax_enc._hier_me(jnp.asarray(tgt, jnp.int32),
                            jnp.asarray(ref), 300)
    got = enc._eager(enc._hier_me(torch.from_numpy(tgt.astype(np.int16)),
                                  torch.from_numpy(ref), 300))
    for a, b in zip(want[:2], got[:2]):               # mvs and the prior
        assert np.array_equal(np.asarray(a), b.numpy())
    wrapped = enc._eager(enc._hier_me(
        torch.from_numpy(tgt.astype(np.uint8).astype(np.int16)),
        torch.from_numpy(ref), 300))
    assert not np.array_equal(wrapped[0].numpy(), got[0].numpy())
    with pytest.raises(AssertionError):               # no int32 planes
        enc._eager(enc._hier_me(torch.from_numpy(tgt.astype(np.int32)),
                                torch.from_numpy(ref), 300))


def _mc_inputs(seed, n, pad, chroma=False):
    rng = np.random.RandomState(seed)
    B = 24
    hh, ww = (20, 28) if chroma else (40, 56)
    ref = rng.randint(0, 256, (hh, ww))
    x0 = rng.randint(0, ww - n + 1, B).astype(np.int32)
    y0 = rng.randint(0, hh - n + 1, B).astype(np.int32)
    mv = rng.randint(-4 * (pad - 4), 4 * (pad - 4) + 1,
                     (B, 2)).astype(np.int32)
    return np.pad(ref, pad, mode="edge").astype(np.int32), x0, y0, mv


def _as(conv, args):
    return [conv(a) if isinstance(a, np.ndarray) else a for a in args]


@pytest.mark.parametrize("fn", ["mc_luma_batch", "luma_phase_planes",
                                "mc_luma_batch_planes",
                                "mc_chroma_batch_14"])
def test_interp_matches_jax(fn):
    if fn == "mc_chroma_batch_14":
        rp, x0, y0, mv = _mc_inputs(5, 4, 6, chroma=True)
        args = (rp, 6, x0, y0, 4, mv)
    else:
        rp, x0, y0, mv = _mc_inputs(4, 8, 12)
        args = (rp, 12, x0, y0, 8, mv)
    if fn == "luma_phase_planes":
        want = np.asarray(jax_interp.luma_phase_planes(jnp.asarray(rp)))
        got = interp.luma_phase_planes(torch.from_numpy(rp))
        assert got.dtype == torch.uint8 and got.shape[0] == 16
    elif fn == "mc_luma_batch_planes":
        want = np.asarray(jax_interp.mc_luma_batch_planes(
            jax_interp.luma_phase_planes(jnp.asarray(rp)),
            *_as(jnp.asarray, args[1:])))
        got = interp.mc_luma_batch_planes(
            interp.luma_phase_planes(torch.from_numpy(rp.astype(np.uint8))),
            *_as(torch.from_numpy, args[1:]))
        # sampling the phase planes equals filtering each block
        assert torch.equal(got, interp.mc_luma_batch(
            *_as(torch.from_numpy, args)))
    else:
        want = np.asarray(getattr(jax_interp, fn)(*_as(jnp.asarray, args)))
        got = getattr(interp, fn)(*_as(torch.from_numpy, args))
        assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if fn == "mc_chroma_batch_14":
        # the 14-bit intermediate, not rounded to 8 bits
        assert want.max() > 255
