"""The port's CU-tree P program (TorchInterEncoder at CTU 32 and 64)
against the JAX TpuInterEncoder from the same reference picture, bit-exact
in every field tests/test_tpu_inter.py compares and in the per-row luma
SSD, in the FULL, FAST and UFAST modes; the CTU-64 IPPP stream through
api.Encoder, whose P frames equal golden encode_inter_frame_tree from the
same reference and which decodes (FFmpeg) to the port's recon; and the
CTU-64 IBP stream (uni-L0 B frames) against the JAX Encoder with its
golden I frame. (The JAX CTU-64 tree I frame is not a reference: it does
not decode to its own recon, ROADMAP Queue 3.) Without intra_rdo the I
frames take the host fixed-CU32 program in both packages, and the CTU-64
IPPP stream equals the JAX Encoder's and the JAX CLI's."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from homerhevc_tpu.api import Encoder as JaxEncoder
from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.engine.inter_encoder import TpuInterEncoder
from homerhevc_tpu.golden.inter_frame import encode_inter_frame_tree
from homerhevc_tpu.hevc.headers import ParamSets as JaxParamSets
from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import EncoderConfig, PerformanceMode
from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.state import reference_from_numpy
from tests.conftest import decode_annexb
from tests.torch_golden import (P_FIELDS, IntSums, assert_p_frames_equal,
                                cli_matches_the_jax_cli, torch_p_frame)

torch.set_num_threads(1)    # one intra-op thread per test worker

def _sine_pair(seed, w, h, seam=None):
    """tests/test_tpu_inter.py's sine texture and a copy moved by 5 px,
    or (seam) moved by +5 left of the seam column and by -3 right of it,
    as in tests/test_perf_mode.py: CTBs across the seam have sub-CU
    motion that the fast-skip predicate rejects."""
    rng = np.random.RandomState(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y0 = (128 + 60 * np.sin(xx / 19.0) + 40 * np.cos(yy / 13.0)
          + rng.randint(-6, 7, (h, w))).astype(np.uint8)
    u0 = (100 + 30 * np.sin(xx[:h // 2, :w // 2] / 11.0)).astype(np.uint8)
    v0 = u0[::-1].copy()
    y1 = np.roll(y0, 5, 1)
    if seam is not None:
        y1[:, seam:] = np.roll(y0, -3, 1)[:, seam:]
    y1 = np.clip(y1.astype(int) + rng.randint(-2, 3, y0.shape), 0, 255) \
        .astype(np.uint8)
    return (y1, u0, v0), (y0, u0, v0)


def _gradient_pair(seed, w, h, seam=None):
    """tests/test_cu64.py's CTU-64 content: a smooth gradient (CU64 wins)
    with a noise corner (it splits), moved by 2 px, or (seam) by +2 left of
    the seam column and by -3 right of it: on the gradient the sub-CU
    motion of a CTB64 across the seam spreads, and the fast-skip
    predicate rejects consolidations FULL takes."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    y0 = np.clip(60 + 0.4 * xx + 0.3 * yy, 0, 255).astype(np.uint8)
    y0[:24, :24] = (rng.rand(24, 24) * 255).astype(np.uint8)
    u0 = np.full((h // 2, w // 2), 120, np.uint8)
    v0 = np.full((h // 2, w // 2), 136, np.uint8)
    y1 = np.roll(y0, 2, 1)
    if seam is not None:
        y1[:, seam:] = np.roll(y0, -3, 1)[:, seam:]
    y1 = np.clip(y1.astype(int) + rng.randint(-2, 3, y0.shape), 0, 255) \
        .astype(np.uint8)
    return (y1, u0, v0), (y0, u0, v0)


def _tree_kw(w, h, cu, qp, **kw):
    return dict(dict(width=w, height=h, qp=qp, gop_size=1, intra_period=0,
                     sao=False, deblocking=False, sign_hiding=True,
                     cu_size=cu, reinit_gop_on_scene_change=False), **kw)


@functools.lru_cache(maxsize=None)
def _jax_encoder_for(items):
    kw = dict(items)
    jcfg = JaxConfig(**{**kw, "performance_mode":
                        int(kw["performance_mode"])})
    return TpuInterEncoder(JaxParamSets.from_config(jcfg), jcfg)


def _jax_encoder(**kw):
    """The JAX P program for EncoderConfig(**kw), traced once per
    configuration in this module (QP and avg_dist are its inputs)."""
    return _jax_encoder_for(tuple(sorted(kw.items())))


# (cu, performance mode, size, content, deblocking, SAO). CTU 32 runs at
# 128x80, whose last CU16 row lies outside every CTB32 (JAX's SAO needs
# whole CTBs, so SAO is on at CTU 64 only). "split" content has two
# motions: a sine texture split at a CTB32 edge, a gradient split inside
# a CTB64. UFAST at CTU 32 is the FAST program (CTU 32 has no CU64 layer
# to drop).
CASES = {
    "32-full": (32, PerformanceMode.FULL_COMPUTATION, 128, 80, "sine", True,
                False),
    "64-full": (64, PerformanceMode.FULL_COMPUTATION, 128, 64, "gradient",
                True, True),
    "32-fast": (32, PerformanceMode.FAST, 128, 80, "split", False, False),
    "64-fast": (64, PerformanceMode.FAST, 128, 64, "split", False, False),
    "64-ufast": (64, PerformanceMode.UFAST, 128, 64, "split", False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tree_p_program_matches_jax(case):
    cu, perf, w, h, content, deblock, sao = CASES[case]
    if content == "sine":
        src, ref = _sine_pair(11, w, h)
    elif content == "gradient":
        src, ref = _gradient_pair(1234, w, h)
    elif cu == 32:
        src, ref = _sine_pair(11, w, h, seam=w // 2)
    else:
        src, ref = _gradient_pair(3, w, h, seam=w // 4)
    kw = _tree_kw(w, h, cu, 30 if cu == 32 else 32, deblocking=deblock,
                  sao=sao, performance_mode=perf)
    want = _jax_encoder(**kw).encode_frame(src, ref)
    got = torch_p_frame(kw, src, ref)
    assert_p_frames_equal(want, got)
    depth = got[0].cu_depth
    cu16 = 1 if cu == 32 else 2                  # the CU16 depth
    assert (depth < cu16).any(), "no CU32 / CU64 chosen"
    if perf == PerformanceMode.UFAST and cu == 64:
        assert not (depth == 0).any(), "UFAST must skip the CU64 layer"
    if cu == 64 and perf == PerformanceMode.FULL_COMPUTATION:
        assert len(np.unique(depth)) == 3        # CU64, CU32 and CU16
    if perf == PerformanceMode.FAST:
        # the fast-skip mask rejects a consolidation FULL takes
        full = torch_p_frame({**kw, "performance_mode":
                              PerformanceMode.FULL_COMPUTATION}, src, ref)
        assert (full[0].cu_depth < depth).any()


def test_tree_p_program_matches_jax_past_exact_float32_sums():
    """The port sums a block's SSD exactly and rounds it once; JAX sums
    it in float32, exact only below 2^24. Full-swing noise against its
    negative at QP 51 with the zero-forcing cap (avg_dist 1e9) takes the
    uncoded SSD of a TU32 and the SSD of a CU64's cost above 2^24, and
    every field still equals JAX's (the 64-full program)."""
    w, h = 128, 64
    rng = np.random.RandomState(5)
    ref = tuple((rng.rand(*s) > 0.5).astype(np.uint8) * 255
                for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    src = tuple(255 - p for p in ref)
    kw = _tree_kw(w, h, 64, 32, deblocking=True, sao=True,
                  performance_mode=PerformanceMode.FULL_COMPUTATION)
    want = _jax_encoder(**kw).encode_frame(src, ref, avg_dist=1e9, qp=51)
    cfg = EncoderConfig(**kw)
    enc = TorchInterEncoder(ParamSets.from_config(cfg), cfg, device="cpu")
    sums = IntSums()
    with sums:
        got = enc.encode_frame(src, reference_from_numpy(ref, "cpu"),
                               avg_dist=1e9, qp=51)
    assert sums.largest[32 * 32] > 2 ** 24       # a TU32's uncoded SSD
    assert sums.largest[64 * 64] > 2 ** 24       # a CU64's cost
    assert_p_frames_equal(want, got)


def test_ctu64_stream_p_frames_equal_golden_and_decode(tmp_path):
    """api.Encoder at CTU 64 (intra_rdo, deblocking, I + 2 P): each P frame
    equals golden encode_inter_frame_tree from the reference and the
    avg_dist the pipeline gave the P program, and the stream decodes to
    the port's recon."""
    w, h = 128, 64
    (y1, u, v), (y0, _, _) = _gradient_pair(7, w, h)
    frames = [(y0, u, v), (y1, u, v),
              (np.roll(y1, 2, 1), np.roll(u, 1, 1), v)]
    kw = _tree_kw(w, h, 64, 32, deblocking=True, intra_rdo=True)
    enc = Encoder(EncoderConfig(**kw), device="cpu")
    pipe = enc._pipeline
    calls = []
    dispatch = pipe._inter().dispatch

    def spy(src, ref, avg_dist=1000.0, qp=None, qp_map=None):
        calls.append((src, tuple(np.asarray(p, np.int32) for p in ref),
                      avg_dist, qp))
        return dispatch(src, ref, avg_dist, qp=qp, qp_map=qp_map)
    pipe._inter().dispatch = spy
    descs = []
    emit = pipe._emit

    def spy_emit(desc, *a, **k):
        descs.append(desc)
        return emit(desc, *a, **k)
    pipe._emit = spy_emit
    efs = [e for f in frames for e in enc.encode(*f)] + list(enc.flush())
    assert [e.frame_type for e in efs] == ["I", "P", "P"]
    ps = JaxParamSets.from_config(JaxConfig(**kw))
    for (src, ref, avg, qp), desc, ef in zip(calls, descs[1:], efs[1:]):
        gd, gy, gu, gv = encode_inter_frame_tree(ps, src, ref, qp,
                                                 avg_dist=avg)
        for f in P_FIELDS:
            assert np.array_equal(getattr(gd, f), getattr(desc, f)), f
        assert np.array_equal(ef.recon["y"], gy.astype(np.uint8))
        assert np.array_equal(ef.recon["u"], gu.astype(np.uint8))
    assert any((d.cu_depth == 0).any() for d in descs[1:])
    path = tmp_path / "ippp64.265"
    path.write_bytes(b"".join(e.annex_b() for e in efs))
    dec = decode_annexb(path)
    assert len(dec) == 3
    for d, e in zip(dec, efs):
        assert np.array_equal(d, e.recon["y"])


def test_ibp_ctu64_stream_matches_jax_and_decodes(tmp_path):
    """IBP at CTU 64 (intra_rdo, FAST, no deblocking or SAO), 5 frames:
    decode order I0 P2 B1 P4 B3, each B a non-reference slice of uni-L0
    CUs from the anchor before it (the JAX package bi-predicts at CTU 32
    only). The JAX Encoder codes its I frame on its golden path, which the
    port's CTU-64 tree equals, and both run the "64-fast" P program above
    (built once for the module; IBP's own search range is 24, a constant
    of the program): identical Annex-B bytes, and an FFmpeg decode equal
    to the port's recon in display order."""
    w, h = 128, 64
    p_kw = _tree_kw(w, h, 64, 32, deblocking=False, sao=False,
                    performance_mode=PerformanceMode.FAST)
    kw = dict(p_kw, gop_size=2, intra_rdo=True)
    (_, u, v), (y, _, _) = _gradient_pair(8, w, h)
    rng = np.random.RandomState(9)
    frames = [(np.clip(np.roll(y, 2 * t, 1).astype(int)
                       + rng.randint(-2, 3, y.shape), 0, 255)
               .astype(np.uint8), u, v) for t in range(5)]
    jax_enc = JaxEncoder(JaxConfig(**{**kw, "performance_mode":
                                      int(kw["performance_mode"])}))
    jax_enc._pipeline._tpu_tree_ok = lambda: False
    jax_enc._pipeline._tpu_inter = _jax_encoder(**p_kw)
    port = Encoder(EncoderConfig(**kw), device="cpu")
    pipe = port._pipeline
    assert pipe._inter_search_range() == 24
    pipe._inter_enc = TorchInterEncoder(pipe.ps, pipe.cfg, device="cpu")

    def encode(enc):
        return [e for f in frames for e in enc.encode(*f)] + \
            list(enc.flush())
    want, got = encode(jax_enc), encode(port)
    assert [e.frame_type for e in got] == ["I", "P", "B", "P", "B"]
    assert [e.poc for e in got] == [0, 2, 1, 4, 3]
    stream = b"".join(e.annex_b() for e in got)
    assert stream == b"".join(e.annex_b() for e in want)
    path = tmp_path / "ibp64.265"
    path.write_bytes(stream)
    dec = decode_annexb(path)
    assert len(dec) == 5
    for e in got:
        assert np.array_equal(dec[e.poc], e.recon["y"]), e.poc


def test_ippp_ctu64_host_i_frames_match_jax_and_decode(tmp_path,
                                                      monkeypatch, capsys):
    """IPPP at CTU 64 without intra_rdo, deblocking and SAO: both packages
    code the I frame on their host fixed-CU32 program and the P frames on
    the CTU-64 P program (the JAX Encoder on the "64-full" program above,
    built once for the module). 3 frames through both Encoders give
    identical Annex-B bytes, which decode to the port's recon, with CU64s
    in the P frames; then 4 frames through both CLIs (-cu_size 64 with
    their defaults) give identical bytes too."""
    w, h = 128, 64
    p_kw = _tree_kw(w, h, 64, 32, deblocking=True, sao=True,
                    performance_mode=PerformanceMode.FULL_COMPUTATION)
    kw = dict(p_kw, intra_rdo=False)
    (_, u, v), (y, _, _) = _gradient_pair(12, w, h)
    rng = np.random.RandomState(13)
    frames = [(np.clip(np.roll(y, 2 * t, 1).astype(int)
                       + rng.randint(-2, 3, y.shape), 0, 255)
               .astype(np.uint8), u, v) for t in range(3)]
    jax_enc = JaxEncoder(JaxConfig(**{**kw, "performance_mode": 0}))
    jax_enc._pipeline._tpu_inter = _jax_encoder(**p_kw)
    port = Encoder(EncoderConfig(**kw), device="cpu")
    descs = []
    emit = port._pipeline._emit

    def spy(desc, *a, **k):
        descs.append(desc)
        return emit(desc, *a, **k)
    port._pipeline._emit = spy

    def encode(enc):
        return [e for f in frames for e in enc.encode(*f)] + \
            list(enc.flush())
    want, got = encode(jax_enc), encode(port)
    assert [e.frame_type for e in got] == ["I", "P", "P"]
    assert port._pipeline._intra_enc is None
    assert any((d.cu_depth == 0).any() for d in descs[1:])
    stream = b"".join(e.annex_b() for e in got)
    assert stream == b"".join(e.annex_b() for e in want)
    path = tmp_path / "ippp64_host_i.265"
    path.write_bytes(stream)
    dec = decode_annexb(path)
    assert len(dec) == 3
    for d, e in zip(dec, got):
        assert np.array_equal(d, e.recon["y"])
    cli_matches_the_jax_cli(["-cu_size", "64"], tmp_path, monkeypatch,
                            capsys, jax_inter=_jax_encoder(**p_kw))


def test_tree_p_program_reads_the_padded_geometry():
    """The P program's tree geometry: CTU 64 needs both dimensions
    divisible by 64 (the pipeline pads to whole CTUs), CTU 32 codes a
    height that is only divisible by 16 with its last CU16 row outside
    the CU32 layer."""
    kw = _tree_kw(128, 80, 64, 32)
    with pytest.raises(AssertionError, match="divisible by 64"):
        TorchInterEncoder(ParamSets.from_config(EncoderConfig(**kw)),
                          EncoderConfig(**kw), device="cpu")
    enc = TorchInterEncoder(ParamSets.from_config(EncoderConfig(
        **{**kw, "cu_size": 32})), EncoderConfig(**{**kw, "cu_size": 32}),
        device="cpu")
    assert (enc.gh, enc.gh2, enc.tree, enc.tree64) == (5, 2, True, False)
    ufast = dataclasses.replace(EncoderConfig(**_tree_kw(128, 64, 64, 32)),
                                performance_mode=PerformanceMode.UFAST)
    enc = TorchInterEncoder(ParamSets.from_config(ufast), ufast,
                            device="cpu")
    assert enc.tree and not enc.tree64
