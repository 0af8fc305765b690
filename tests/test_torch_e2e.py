"""The port end to end on the CPU: homerhevc_tpu_torch.api.Encoder gives
Annex-B bytes identical to homerhevc_tpu.api.Encoder (with SAO and
without), the stream decodes in FFmpeg to the port's own luma recon, and
the port runs without jax and without the JAX package."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from homerhevc_tpu.api import Encoder as JaxEncoder
from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu_torch.api import Encoder as TorchEncoder
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.hevc.parse import SerializedSlices
from tests.conftest import decode_annexb, make_yuv

torch.set_num_threads(1)    # one intra-op thread per test worker

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(rng, w, h, n, noise=2):
    y, u, v = make_yuv(rng, w, h)
    out = []
    for i in range(n):
        yi = np.clip(np.roll(y, 3 * i, 1).astype(int)
                     + rng.randint(-noise, noise + 1, y.shape), 0, 255) \
            .astype(np.uint8)
        out.append((yi, np.roll(u, i, 1), np.roll(v, i, 1)))
    return out


def _encode(enc, frames):
    efs = []
    for f in frames:
        efs.extend(enc.encode(*f))
    efs.extend(enc.flush())
    return efs


# the config fields the JAX CU16 intra program reads (SAO of its frames
# is decided on the host), and those the P program reads besides (the
# rest is host GOP and rate-control state)
_INTRA_FIELDS = ("width", "height", "cu_size", "qp", "sign_hiding",
                 "deblocking")
_INTER_FIELDS = _INTRA_FIELDS + ("sao", "merge_rd_device")


@pytest.fixture(scope="module")
def jax_programs():
    """The JAX intra and P programs by the fields they read, each built
    once for the module's JAX Encoders (tracing a program takes seconds
    on a CPU; several tests share a configuration's programs)."""
    return {}


def _jax_encoder(kw, programs):
    """A JAX Encoder for kw whose intra and P programs come from (and go
    into) programs, the jax_programs cache."""
    enc = JaxEncoder(JaxConfig(**kw))
    pipe = enc._pipeline
    ki = ("intra",) + tuple(kw.get(f) for f in _INTRA_FIELDS)
    kp = ("inter",) + tuple(kw.get(f) for f in _INTER_FIELDS)
    pipe._tpu_intra = programs.setdefault(ki, pipe._get_tpu())
    pipe._tpu_inter = programs.setdefault(kp, pipe._get_tpu_inter())
    return enc


@pytest.mark.parametrize("gop,batch,sao", [
    pytest.param(1, 1, False, id="1-1"), pytest.param(0, 2, False, id="0-2"),
    pytest.param(1, 1, True, id="1-1-sao"),
    pytest.param(0, 2, True, id="0-2-sao")])
def test_torch_stream_matches_jax_and_decodes(gop, batch, sao, tmp_path,
                                             jax_programs):
    """gop 1: the 4-frame IPPP CU16 slice; gop 0: batched all-intra. With
    SAO, on noisy frames: the I frames' SAO decided on the host and the P
    frames' in the P program, each P frame predicting from the filtered
    recon and its zero-forcing threshold read from it; SAO is on in some
    CTB of every frame."""
    w, h = 128, 64
    kw = dict(width=w, height=h, cu_size=16, gop_size=gop, qp=32,
              sign_hiding=True, deblocking=True, sao=sao,
              num_frames_in_flight=batch)
    frames = _frames(np.random.RandomState(13), w, h, 4,
                     noise=25 if sao else 2)
    want = _encode(_jax_encoder(kw, jax_programs), frames)
    enc = TorchEncoder(EncoderConfig(**kw), device="cpu")
    with SerializedSlices() as spy:
        got = _encode(enc, frames)
    seen = [sao for _, _, sao, _ in spy.slices]
    assert [e.frame_type for e in got] == \
        (["I", "P", "P", "P"] if gop else ["I"] * 4)
    if sao:
        assert len(seen) == 4 and all(
            (p.type_luma != 0).any() or (p.type_chroma != 0).any()
            for p in seen)
    else:
        assert seen == [None] * 4
    stream = b"".join(e.annex_b() for e in got)
    assert stream == b"".join(e.annex_b() for e in want)
    path = tmp_path / "port.265"
    path.write_bytes(stream)
    dec = decode_annexb(path)
    assert len(dec) == 4
    for d, e in zip(dec, got):
        assert np.array_equal(d, e.recon["y"])


def test_merge_rd_off_stream_matches_jax_and_decodes(tmp_path,
                                                     monkeypatch):
    """merge_rd_device=False (the P program without its merge-RD stage,
    a knob no CLI flag sets): the IPPP CU16 stream equals the JAX
    Encoder's byte for byte and decodes to the port's recon."""
    from tests.torch_golden import interpret_sweep
    interpret_sweep(monkeypatch)
    w, h = 128, 64
    kw = dict(width=w, height=h, cu_size=16, gop_size=1, qp=32,
              sign_hiding=True, deblocking=True, sao=False,
              merge_rd_device=False)
    frames = _frames(np.random.RandomState(16), w, h, 4)
    want = _encode(JaxEncoder(JaxConfig(**kw)), frames)
    enc = TorchEncoder(EncoderConfig(**kw), device="cpu")
    got = _encode(enc, frames)
    assert not enc._pipeline._inter_enc.merge_rd
    assert [e.frame_type for e in got] == ["I", "P", "P", "P"]
    stream = b"".join(e.annex_b() for e in got)
    assert stream == b"".join(e.annex_b() for e in want)
    path = tmp_path / "merge_rd_off.265"
    path.write_bytes(stream)
    dec = decode_annexb(path)
    assert len(dec) == 4
    for d, e in zip(dec, got):
        assert np.array_equal(d, e.recon["y"])


def test_reconfigure_keeps_torch_pipeline():
    from homerhevc_tpu_torch.engine.pipeline import TorchPipeline
    w, h = 64, 32
    cfg = EncoderConfig(width=w, height=h, cu_size=16, gop_size=1, qp=32,
                        sao=False)
    enc = TorchEncoder(cfg, device="cpu")
    frames = _frames(np.random.RandomState(14), w, h, 3)
    efs = list(enc.encode(*frames[0])) + list(enc.encode(*frames[1]))
    intra = enc._pipeline._intra_enc
    efs += enc.reconfigure(qp=36)            # drains, keeps the encoders
    assert isinstance(enc._pipeline, TorchPipeline)
    assert enc._pipeline._intra_enc is intra
    efs += list(enc.encode(*frames[2])) + list(enc.flush())
    assert [e.frame_type for e in efs] == ["I", "P", "I"]
    assert efs[-1].avg_qp == 36


def test_port_runs_without_jax():
    code = (
        "import sys, numpy as np\n"
        "from homerhevc_tpu_torch.config import EncoderConfig\n"
        "from homerhevc_tpu_torch.api import Encoder\n"
        "cfg = EncoderConfig(width=64, height=32, cu_size=16, gop_size=1,\n"
        "                    qp=32, sao=False)\n"
        "enc = Encoder(cfg, device='cpu')\n"
        "yy, xx = np.mgrid[0:32, 0:64]\n"
        "y = (100 + 60 * np.sin(xx / 5.0) + yy).astype(np.uint8)\n"
        "c = np.full((16, 32), 128, np.uint8)\n"
        "efs = list(enc.encode(y, c, c))\n"
        "efs += list(enc.encode(np.roll(y, 2, 1), c, c))\n"
        "efs += list(enc.flush())\n"
        "assert [e.frame_type for e in efs] == ['I', 'P']\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'homerhevc_tpu' not in sys.modules, 'homerhevc_tpu'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


def test_torch_idr_and_scene_cut_match_jax(jax_programs):
    """Scene-change IDRs (a hard cut into frame 2 and back out of it at
    frame 3) break and restart the port's device reference chain exactly
    as in the JAX pipeline: identical frame types and Annex-B bytes."""
    w, h = 128, 64
    kw = dict(width=w, height=h, cu_size=16, gop_size=1, qp=32,
              intra_period=0, sign_hiding=True, deblocking=True, sao=False)
    frames = _frames(np.random.RandomState(15), w, h, 4)
    y, u, v = frames[2]
    frames[2] = (255 - y, v, u)
    want = _encode(_jax_encoder(kw, jax_programs), frames)
    got = _encode(TorchEncoder(EncoderConfig(**kw), device="cpu"), frames)
    assert [e.frame_type for e in got] == ["I", "P", "I", "I"]
    assert [e.frame_type for e in want] == [e.frame_type for e in got]
    assert b"".join(e.annex_b() for e in got) == \
        b"".join(e.annex_b() for e in want)


def _fade_frames(w, h, n, step, gain=1.2, seed=16):
    """A noisy texture rolling 4 px a frame whose contrast steps up by
    `gain` from frame `step` on: a fade, no cut."""
    rng = np.random.RandomState(seed)
    tex = rng.randint(-30, 30, (h, 2 * w))
    c = np.full((h // 2, w // 2), 128, np.uint8)
    out = []
    for t in range(n):
        y = 90 + tex[:, 4 * t % w:][:, :w] * (gain if t >= step else 1.0) \
            + rng.normal(0, 2, (h, w))
        out.append((np.clip(y, 0, 255).astype(np.uint8), c, c))
    return out


def test_reinit_stream_with_the_port_detector_matches_jax(jax_programs,
                                                          monkeypatch):
    """With reinit on, a contrast step at frame 14: the JAX detector
    freezes its level there and cuts on every frame from it, while the
    port's declares no cut. Given the port's detector for the run
    (torch_golden.port_scene_change), the JAX Encoder gives the port's
    frame types and Annex-B bytes."""
    from homerhevc_tpu.engine.pipeline import EncoderPipeline
    from tests.torch_golden import port_scene_change
    w, h = 128, 64
    kw = dict(width=w, height=h, cu_size=16, gop_size=1, qp=32,
              intra_period=0, sign_hiding=True, deblocking=True, sao=False)
    frames = _fade_frames(w, h, 17, 14)
    state = types.SimpleNamespace()
    assert [t for t, (y, _, _) in enumerate(frames)
            if EncoderPipeline._scene_change(state, y)] == [14, 15, 16]
    got = _encode(TorchEncoder(EncoderConfig(**kw), device="cpu"), frames)
    assert [e.frame_type for e in got] == ["I"] + ["P"] * 16
    port_scene_change(monkeypatch)
    want = _encode(_jax_encoder(kw, jax_programs), frames)
    assert [e.frame_type for e in want] == [e.frame_type for e in got]
    assert b"".join(e.annex_b() for e in got) == \
        b"".join(e.annex_b() for e in want)
