"""Coarse SAD sweep of the torch port (ops/me_sad.py) against the JAX
package: the oracle coarse_sweep_sads_ref and the Pallas kernel in
interpret mode. Bit-exact (integer SADs). The port takes uint8 planes, the
JAX functions the same values as int16. The CUDA kernel itself runs only
on a card (tests/test_torch_cuda.py and chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from homerhevc_tpu.ops.pallas.me_sad import (coarse_sweep_sads,
                                             coarse_sweep_sads_ref)
from homerhevc_tpu_torch.device import LAUNCHES
from homerhevc_tpu_torch.ops import me_sad as tms

torch.set_num_threads(1)    # one intra-op thread per test worker


def _inputs(seed, gh, gw, R, m):
    rng = np.random.RandomState(seed)
    sd = rng.randint(0, 256, (gh * m, gw * m)).astype(np.uint8)
    ref = rng.randint(0, 256, (gh * m, gw * m))
    rp = np.pad(ref, R, mode="edge").astype(np.uint8)
    return sd, rp


def _jax_ref(sd, rp, R, m):
    return np.asarray(coarse_sweep_sads_ref(
        jnp.asarray(sd.astype(np.int16)), jnp.asarray(rp.astype(np.int16)),
        R, m))


# the shapes of tests/test_pallas.py, the slice's m=8/R=16, unaligned
# cases the Pallas kernel's sublane contract refuses, and the CUDA
# tiling's edges: gw past one 16-column tile and ragged, gh = 1, R not a
# multiple of the 8-dx run, m = 16 with R = 24
@pytest.mark.parametrize("gh,gw,R,m,pallas", [
    (4, 6, 8, 8, True), (3, 3, 4, 8, True), (2, 8, 16, 16, True),
    (3, 5, 16, 8, True), (3, 5, 3, 5, False), (2, 3, 24, 8, False),
    (2, 21, 4, 8, False), (1, 5, 8, 8, False), (2, 3, 13, 8, False),
    (2, 3, 24, 16, False)])
def test_plain_sweep_matches_jax(gh, gw, R, m, pallas):
    sd, rp = _inputs(gh * 100 + gw * 10 + R, gh, gw, R, m)
    want = _jax_ref(sd, rp, R, m)
    before = LAUNCHES["coarse_sweep_sads"]
    got = tms.coarse_sweep_sads(torch.from_numpy(sd), torch.from_numpy(rp),
                                R, m)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the plain CPU version is not a kernel launch
    assert LAUNCHES["coarse_sweep_sads"] == before
    if pallas:
        kern = np.asarray(coarse_sweep_sads(
            jnp.asarray(sd.astype(np.int16)), jnp.asarray(rp.astype(np.int16)),
            R, m, interpret=True))
        assert np.array_equal(got.numpy(), kern)


@pytest.mark.parametrize("s_val,r_val", [(0, 255), (255, 0)])
def test_plain_sweep_extremes_match_jax(s_val, r_val):
    """All-0 against all-255 planes: every block SAD is 255 * m * m."""
    gh, gw, R, m = 2, 3, 8, 8
    sd = np.full((gh * m, gw * m), s_val, np.uint8)
    rp = np.full((gh * m + 2 * R, gw * m + 2 * R), r_val, np.uint8)
    got = tms.coarse_sweep_sads(torch.from_numpy(sd), torch.from_numpy(rp),
                                R, m).numpy()
    assert np.array_equal(got, _jax_ref(sd, rp, R, m))
    assert (got == 255 * m * m).all()


def test_wrapper_rejects_bad_inputs():
    sd, rp = _inputs(1, 2, 2, 4, 8)
    sd_t, rp_t = torch.from_numpy(sd), torch.from_numpy(rp)
    with pytest.raises(TypeError):
        tms.coarse_sweep_sads(sd_t.to(torch.int32), rp_t, 4, 8)
    with pytest.raises(TypeError):
        tms.coarse_sweep_sads(sd_t, rp_t.to(torch.int16), 4, 8)
    with pytest.raises(ValueError):
        tms.coarse_sweep_sads(sd_t.t(), rp_t, 4, 8)          # non-contiguous
    with pytest.raises(ValueError):
        tms.coarse_sweep_sads(sd_t, rp_t[1:, 1:].contiguous(), 4, 8)
    with pytest.raises(ValueError):
        tms.coarse_sweep_sads(sd_t, rp_t, 0, 8)
