"""The inter programs split at their coarse sweeps, on the CPU: driven by
hand, the P program asks for one sweep and the B program for three (two
on the source, one on the wide bi target), and fed SADs computed outside
the program they give TorchInterEncoder.dispatch's outputs bit for bit;
between its sweeps a program makes no tensor from host data and reads no
device value on the host (what a CUDA graph's capture would refuse), once
a first dispatch filled the encoder's tables; a CPU dispatch counts
`inter.eager` alone. The graphs themselves are held on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.hevc.inter_syntax import zf_multiplier
from homerhevc_tpu_torch.ops.me_sad import coarse_sweep_sads_plain
from homerhevc_tpu_torch.state import reference_from_numpy
from homerhevc_tpu_torch.utils.profiler import PROFILER

HOST_DATA = ("as_tensor", "tensor", "from_numpy", "asarray")
SYNC_OPS = {getattr(torch.ops.aten, name).default for name in (
    "_local_scalar_dense", "nonzero", "masked_select", "_unique2")}


def _record_host_data(monkeypatch, seen):
    """Make torch's tensor factories record each call on host data."""
    for name in HOST_DATA:
        def factory(data, *a, _f=getattr(torch, name), _n=name, **k):
            if not isinstance(data, torch.Tensor):
                seen.append(_n)
            return _f(data, *a, **k)
        monkeypatch.setattr(torch, name, factory)


class _NoSync(TorchDispatchMode):
    """Records aten operations whose result the host must wait for (an
    item, a bool or an index read from a tensor, a data-dependent
    shape)."""

    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in SYNC_OPS:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _frame(rng, w, h):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    y = np.clip(60 + 25 * np.sin(xx / 11.0) + 15 * np.cos(yy / 7.0)
                + rng.rand(h, w) * 12, 0, 255).astype(np.uint8)
    u = np.clip(128 + 20 * np.sin(xx[::2, ::2] / 23.0), 0, 255) \
        .astype(np.uint8)
    return y, u, u[::-1].copy()


@pytest.mark.parametrize("program", ["p", "b"])
def test_a_program_fed_its_sweeps_from_outside_equals_dispatch(
        program, monkeypatch):
    """P: 128x64 CU16; B: 64x64 CTU 32 (the bi-capable program); both
    with deblocking and SAO. After two dispatches (counted eager 2 and
    no graph), the hand-driven program gives dispatch's seven outputs
    while nothing was recorded."""
    bi = program == "b"
    w, h = (64, 64) if bi else (128, 64)
    rng = np.random.RandomState(5)
    y, u, v = _frame(rng, w, h)
    cfg = EncoderConfig(width=w, height=h, qp=32, gop_size=2 if bi else 1,
                        intra_period=0, sao=True, deblocking=True,
                        sign_hiding=True, cu_size=32 if bi else 16,
                        intra_rdo=bi)
    enc = TorchInterEncoder(ParamSets.from_config(cfg), cfg, device="cpu")
    src = (np.roll(y, 3, 1), np.roll(u, 1, 1), np.roll(v, 1, 1))
    refs = [reference_from_numpy(p, "cpu")
            for p in ((y, u, v), tuple(np.roll(q, -2, 1) for q in src))]
    with PROFILER.enabled():
        PROFILER.reset()
        try:
            for _ in range(2):
                want = (enc.dispatch_b(src, *refs, 700.0) if bi
                        else enc.dispatch(src, refs[0], 700.0))
            counters = PROFILER.counters
        finally:
            PROFILER.reset()
    assert {k: v for k, v in counters.items() if k.startswith("inter.")} \
        == {"inter.frames": 2, "inter.eager": 2}

    planes = [torch.from_numpy(np.ascontiguousarray(p))
              for p in (*src, *refs[0], *(refs[1] if bi else ()))]
    zf = torch.tensor(zf_multiplier(700.0, 32), dtype=torch.float32)
    steps = (enc._impl_b if bi else enc._impl)(*planes, zf, 32)
    seen, dtypes = [], []
    _record_host_data(monkeypatch, seen)
    try:
        with _NoSync(seen):
            request = next(steps)
        while True:
            dtypes.append(request[0].dtype)
            sads = coarse_sweep_sads_plain(*request, enc.search, enc.cu // 2)
            with _NoSync(seen):
                request = steps.send(sads)
    except StopIteration as done:
        got = done.value
    assert seen == []
    assert dtypes == ([torch.uint8, torch.uint8, torch.int16] if bi
                      else [torch.uint8])
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
