"""The port's multi-device scale-out (homerhevc_tpu_torch/parallel/mesh.py)
on CPU slots, held byte for byte to the JAX mesh functions on the virtual
CPU mesh (tests/conftest.py): the frame-sharded all-intra encode over 8
slots (deblocking off and on) and the GOP-segment IPPP encode over 2
(deblocking on, the dry run's drifting frames), each stream decoded by
FFmpeg to the port's recon and each segment equal to the port's sequential
Encoder; 1 slot gives the streams of many; the dry run passes; the
default mesh raises without a card; the counters the slot threads share
(launch counts, profiler scopes, the native library's first load) lose
nothing under threads; and at CU32 the port carries the JAX function's
fault (ROADMAP Queue 3). The tolerance is zero everywhere: these are
bytes. Each JAX mesh program is compiled once per module."""

import sys
import threading

import numpy as np
import pytest
import torch

from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.parallel import mesh as jax_mesh
from homerhevc_tpu_torch import native
from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.device import LAUNCHES, count_launch, reset_launches
from homerhevc_tpu_torch.hevc.bitstream import annex_b
from homerhevc_tpu_torch.parallel.mesh import (encode_frames_sharded,
                                               encode_frames_sharded_dryrun,
                                               gop_parallel_encode,
                                               make_mesh)
from homerhevc_tpu_torch.utils.profiler import Profiler
from tests.conftest import decode_annexb, make_yuv

torch.set_num_threads(1)    # one intra-op thread per test worker

W, H = 64, 32
SHARDED = dict(width=W, height=H, qp=30, gop_size=0, sao=False,
               sign_hiding=True, cu_size=16, num_devices=8)
SEG_LEN = 3
GOP = dict(width=W, height=H, qp=32, gop_size=1, sao=False,
           deblocking=True, sign_hiding=True, cu_size=16, num_devices=2,
           reinit_gop_on_scene_change=False)


def _sharded_frames():
    rng = np.random.RandomState(21)
    return [make_yuv(rng, W, H) for _ in range(8)]


def _gop_frames():
    """The dry run's drifting frames: segment d, frame t is the base luma
    rolled by d + t."""
    base = make_yuv(np.random.RandomState(22), W, H)
    return [(np.roll(base[0], d + t, axis=1), base[1], base[2])
            for d in range(2) for t in range(SEG_LEN)]


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX encode_frames_sharded streams of _sharded_frames on the
    virtual 8-device mesh, by deblocking (one program each)."""
    frames = _sharded_frames()
    return {db: jax_mesh.encode_frames_sharded(
        JaxConfig(**SHARDED, deblocking=db), frames)
        for db in (False, True)}


@pytest.fixture(scope="module")
def jax_gop():
    """The JAX gop_parallel_encode segments of _gop_frames on
    make_mesh(2)."""
    return jax_mesh.gop_parallel_encode(JaxConfig(**GOP), _gop_frames(),
                                        jax_mesh.make_mesh(2))


def _assert_decodes_to(nals, recons, path):
    path.write_bytes(annex_b(nals))
    dec = decode_annexb(path)
    assert len(dec) == len(recons)
    for d, r in zip(dec, recons):
        assert np.array_equal(d, r)


@pytest.mark.parametrize("deblocking", [False, True],
                         ids=["deblock-off", "deblock-on"])
def test_sharded_streams_match_jax_and_decode(deblocking, jax_sharded,
                                              tmp_path):
    """8 frames over 8 CPU slots: the JAX function's NAL lists, frame for
    frame; each stream decodes to the recon of the port's single-device
    Encoder, whose bytes it equals too."""
    cfg = EncoderConfig(**SHARDED, deblocking=deblocking)
    frames = _sharded_frames()
    streams = encode_frames_sharded(cfg, frames, make_mesh(8, "cpu"))
    assert streams == jax_sharded[deblocking]
    for i, (fr, nals) in enumerate(zip(frames, streams)):
        enc = Encoder(cfg, device="cpu")
        efs = list(enc.encode(*fr)) + list(enc.flush())
        assert len(efs) == 1 and efs[0].nals == nals
        _assert_decodes_to(nals, [efs[0].recon["y"]], tmp_path / f"{i}.265")


def test_gop_parallel_matches_jax_and_the_sequential_encoder(jax_gop,
                                                             tmp_path):
    """2 segments of IDR + 2 P (deblocking on) over 2 CPU slots: the JAX
    function's NAL lists on make_mesh(2); each segment equals the port's
    sequential Encoder on the same frames and decodes to its recon."""
    cfg = EncoderConfig(**GOP)
    frames = _gop_frames()
    segs = gop_parallel_encode(cfg, frames, make_mesh(2, "cpu"))
    assert segs == jax_gop
    for d, nals in enumerate(segs):
        enc = Encoder(cfg, device="cpu")
        efs = [e for f in frames[d * SEG_LEN:(d + 1) * SEG_LEN]
               for e in enc.encode(*f)] + list(enc.flush())
        assert [e.frame_type for e in efs] == ["I", "P", "P"]
        assert [n for e in efs for n in e.nals] == nals
        _assert_decodes_to(nals, [e.recon["y"] for e in efs],
                           tmp_path / f"seg{d}.265")


@pytest.mark.parametrize("fn", ["sharded", "gop"])
def test_one_slot_gives_the_streams_of_many(fn):
    """The slot threads do not change a byte: all-intra, 8 frames over 8
    slots against the same over 1 slot (one batch of 8); IPPP, 2 segments
    over 2 slots against each segment alone over 1 slot."""
    if fn == "sharded":
        cfg = EncoderConfig(**SHARDED, deblocking=True)
        frames = _sharded_frames()
        assert encode_frames_sharded(cfg, frames, make_mesh(8, "cpu")) == \
            encode_frames_sharded(cfg, frames, make_mesh(1, "cpu"))
        return
    cfg = EncoderConfig(**GOP)
    frames = _gop_frames()
    many = gop_parallel_encode(cfg, frames, make_mesh(2, "cpu"))
    one = [gop_parallel_encode(cfg, frames[d * SEG_LEN:(d + 1) * SEG_LEN],
                               make_mesh(1, "cpu"))[0] for d in range(2)]
    assert many == one


def test_dryrun_on_eight_cpu_slots():
    """The dry run (sharded all-intra and GOP-segment IPPP, each held to
    the single-device pipeline) passes on 8 CPU slots."""
    encode_frames_sharded_dryrun(8, "cpu")


def test_make_mesh_default_raises_without_a_card(monkeypatch):
    """make_mesh defaults to the cards and raises where there are fewer
    than asked (jax.devices()[:n] would shrink the mesh); a list of
    devices gives those slots, repeats allowed, and must match n."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, found 1"):
        make_mesh(2)
    assert make_mesh(1) == (torch.device("cuda", 0),)
    assert make_mesh(4, ["cuda:0"] * 4) == (torch.device("cuda", 0),) * 4
    assert make_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        make_mesh(2, ["cpu"])


def _hammer(n_threads, fn):
    """fn() in n_threads threads at once, with a short switch interval;
    every thread joined within 60 s."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(n_threads)
        out = [None] * n_threads

        def run(i):
            start.wait()
            out[i] = fn()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return out


def test_counters_lose_nothing_under_threads(monkeypatch):
    """16 threads (more than the cores) add to the launch counts and to one
    profiler scope at once: every launch and every scope is counted. 16
    threads asking for the native CABAC library at once all get the one
    library, never the Python serializer's None."""
    n, reps = 16, 2000
    reset_launches()
    prof = Profiler()
    prof.enable()

    def work():
        for _ in range(reps):
            count_launch("coarse_sweep_sads")
            with prof.scope("slot"):
                pass
    try:
        _hammer(n, work)
        assert LAUNCHES["coarse_sweep_sads"] == n * reps
    finally:
        reset_launches()
    assert prof.counts["slot"] == n * reps

    assert native.get_lib() is not None            # built once, up front
    monkeypatch.setattr(native, "_lib", None)
    libs = _hammer(n, native.get_lib)
    assert all(lib is not None for lib in libs)
    assert all(lib is libs[0] for lib in libs)


def test_sharded_ctu32_stream_carries_the_jax_fault(tmp_path):
    """A fault of the reference, copied as the port copies the function
    (ROADMAP Queue 3): with cu_size 32 the JAX encode_frames_sharded codes
    the CU16 wavefront (min(cu_size, 16)) into a CTU-32 sequence, and
    FFmpeg decodes its stream away from the program's recon. The port's
    function gives the JAX function's bytes and the same mismatch."""
    from homerhevc_tpu_torch.engine.intra_encoder import TorchIntraEncoder
    from homerhevc_tpu_torch.engine.pipeline import TorchPipeline
    kw = dict(SHARDED, cu_size=32, deblocking=False, num_devices=2)
    frames = _sharded_frames()[:2]
    want = jax_mesh.encode_frames_sharded(JaxConfig(**kw), frames,
                                          jax_mesh.make_mesh(2))
    cfg = EncoderConfig(**kw)
    streams = encode_frames_sharded(cfg, frames, make_mesh(2, "cpu"))
    assert streams == want
    pipe = TorchPipeline(cfg, "cpu")
    res = TorchIntraEncoder(pipe.ps, pipe.cfg, cu=16, device="cpu") \
        .encode_frames(*zip(*frames), qps=[cfg.qp] * 2)
    for i, nals in enumerate(streams):
        path = tmp_path / f"ctu32_{i}.265"
        path.write_bytes(annex_b(nals))
        dec = decode_annexb(path)
        assert len(dec) == 1
        assert not np.array_equal(dec[0], np.asarray(res[i][1]))
