"""TorchInterEncoder (the port's flat CU16 P program) against the JAX
TpuInterEncoder at 128x64 from the same reference picture, bit-exact in
every field tests/test_tpu_inter.py compares."""

import dataclasses

import numpy as np
import pytest
import torch

from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.engine.inter_encoder import TpuInterEncoder
from homerhevc_tpu.hevc.headers import ParamSets as JaxParamSets
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.state import reference_from_numpy
from tests.conftest import make_yuv

torch.set_num_threads(1)    # one intra-op thread per test worker

_FIELDS = ("mv", "coef_y", "coef_u", "coef_v", "skip", "inter_mode",
           "merge_idx", "mvp_flag")


@pytest.fixture(scope="module")
def jax_programs():
    """The JAX P programs by (sign hiding, deblocking), each traced once
    for the module (the ties test shares the SBH + deblocking one)."""
    return {}


def _compare(cfg, src, ref, programs):
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    key = (cfg.sign_hiding, cfg.deblocking)
    if key not in programs:
        programs[key] = TpuInterEncoder(JaxParamSets.from_config(jcfg), jcfg)
    jd, jy, ju, jv = programs[key].encode_frame(src, ref)
    enc = TorchInterEncoder(ParamSets.from_config(cfg), cfg, device="cpu")
    td, ty, tu, tv = enc.encode_frame(src, reference_from_numpy(ref, "cpu"))
    for f in _FIELDS:
        assert np.array_equal(getattr(jd, f), getattr(td, f)), f
    for a, b in ((jy, ty), (ju, tu), (jv, tv)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), "recon"
    assert np.array_equal(jd.row_ssd_y, td.row_ssd_y)


@pytest.mark.parametrize("sbh,deblock", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_torch_inter_matches_jax(sbh, deblock, jax_programs):
    rng = np.random.RandomState(12)    # own stream, not the session rng
    w, h = 128, 64
    cfg = EncoderConfig(width=w, height=h, qp=32, gop_size=1, intra_period=0,
                        sao=False, deblocking=deblock, sign_hiding=sbh,
                        cu_size=16)
    y, u, v = make_yuv(rng, w, h)
    # shifted + noisy reference (odd shift: half-pel chroma paths)
    ref = (np.clip(np.roll(y, 3, 1).astype(int)
                   + rng.randint(-3, 4, y.shape), 0, 255).astype(np.uint8),
           np.roll(u, 1, 1), np.roll(v, 1, 1))
    _compare(cfg, (y, u, v), ref, jax_programs)


def test_torch_inter_ties_match_jax(jax_programs):
    """Flat content: every coarse offset, vote count and fine SAD ties,
    so every argmin/argmax must take the first extremum as JAX does."""
    w, h = 128, 64
    cfg = EncoderConfig(width=w, height=h, qp=32, gop_size=1, intra_period=0,
                        sao=False, deblocking=True, sign_hiding=True,
                        cu_size=16)
    y = np.full((h, w), 100, np.uint8)
    y[:, 64:] = 120                                  # one vertical edge
    u = np.full((h // 2, w // 2), 128, np.uint8)
    _compare(cfg, (y, u, u), (y, u, u), jax_programs)
