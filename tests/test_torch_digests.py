"""Pins chip_smoke.py's parity digests to the JAX package: the seeded
128x64 I frame (deblocking off and on), P frame and intra CU-tree frames
(CTU 32 and 64 with deblocking), encoded by homerhevc_tpu.golden and
serialized by homerhevc_tpu.hevc, hash to GOLDEN_DIGESTS; the port's CPU
path hashes to the same. The cells with SAO (the tree frame and the IPPP
tree streams) are pinned in test_torch_sao.py, where the JAX SAO is
compiled at their shape anyway. The B cells (B_DIGESTS: 128x96 IBP
and generalized-B streams through the Encoder) were computed from the
JAX package's Encoder by tests/torch_golden.py jax_b_stream_digests
(minutes of JAX tracing and compiling, not a tier-1 test); the port's CPU
path hashes to them here, as it does to the AQ cells (AQ_DIGESTS: 96x64
all-intra AQ and 128x64 IPPP AQ + row-RC under CBR, the JAX Encoder's
digests, computed and held by tests/test_torch_aq.py). The host intra
cells (HOST_DIGESTS: 128x64 IPPP at CTU 32 with a fixed-CU32 I frame,
RD_FULL all-intra at CTU 32, all-intra CU16 AQ with deblocking) are the
JAX Encoder's digests, computed here (its CTU-32 P program built once,
the sweep in Pallas interpret mode), and the port's CPU path hashes to
them; that P program also serves the JAX CLI's -rd_mode 1 -cu_size 32
-intra_rdo 1 stream, which the port's CLI equals. The host P cells
(HOST_P_DIGESTS: 128x64 streams whose P and B frames the JAX package codes
on its host programs: intra_rdo at CU16, AQ with deblocking, AQ with
intra-in-P at CTU 32, IBP CTU 32 with AQ and deblocking, three
references) are the JAX Encoder's digests with the spec's AMVP lists
(tests/torch_golden.jax_host_p_stream_digests, numpy only), computed here,
and the port's CPU path hashes to them. On the card, chip_smoke.py holds
the port's CUDA path to these constants."""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from homerhevc_tpu.config import EncoderConfig
from homerhevc_tpu.golden import deblock as gdb
from homerhevc_tpu.golden.inter_frame import encode_inter_frame
from homerhevc_tpu.golden.intra_frame import encode_intra_frame
from homerhevc_tpu.hevc import bitstream, cabac, ctx_tables, headers, syntax
from tests.torch_golden import (cli_matches_the_jax_cli, golden_tree,
                                interpret_sweep, jax_host_p_stream_digests)

torch.set_num_threads(1)    # one intra-op thread per test worker

SAO_CELLS = ("I tree CU32 deblock+SAO",) + tuple(chip_smoke.IPPP_CELLS)

_HEVC = types.SimpleNamespace(headers=headers, bitstream=bitstream,
                              cabac=cabac, ctx_tables=ctx_tables,
                              syntax=syntax)


def golden_digests():
    (y, u, v), ref = chip_smoke.parity_inputs()
    out = {}
    for deblock in (False, True):
        cfg = EncoderConfig(**chip_smoke.PARITY_CFG, gop_size=0,
                            deblocking=deblock)
        ps = headers.ParamSets.from_config(cfg)
        desc, ry, ru, rv = encode_intra_frame(ps, y, u, v, cfg.qp,
                                              cu_size=16)
        if deblock:
            tu8 = np.full((cfg.height // 8, cfg.width // 8), 16, np.int32)
            qp8 = np.full_like(tu8, cfg.qp)
            bs_v, bs_h = gdb.intra_bs_maps(tu8)
            ry = gdb.deblock_plane_luma(ry, tu8, qp8, bs_v, bs_h)
            ru = gdb.deblock_plane_chroma(ru, qp8, bs_v, bs_h,
                                          ps.cb_qp_offset)
            rv = gdb.deblock_plane_chroma(rv, qp8, bs_v, bs_h,
                                          ps.cr_qp_offset)
        out[f"I deblock={int(deblock)}"] = chip_smoke.digests(
            chip_smoke.slice_annexb(_HEVC, ps, desc, headers.SLICE_I,
                                    cfg.qp), (ry, ru, rv))
    cfg = EncoderConfig(**chip_smoke.PARITY_CFG, gop_size=1, intra_period=0,
                        deblocking=False)
    ps = headers.ParamSets.from_config(cfg)
    ref32 = tuple(p.astype(np.int32) for p in ref)
    desc, ry, ru, rv = encode_inter_frame(ps, (y, u, v), ref32, cfg.qp,
                                          merge_rd="fast")
    out["P"] = chip_smoke.digests(
        chip_smoke.slice_annexb(_HEVC, ps, desc, headers.SLICE_P, cfg.qp),
        (ry, ru, rv))
    y, u, v = chip_smoke.tree_parity_inputs()
    for name, cell in chip_smoke.TREE_CELLS.items():
        if name in SAO_CELLS:
            continue
        cfg = EncoderConfig(**chip_smoke.TREE_CFG, **cell)
        ps = headers.ParamSets.from_config(cfg)
        desc, ry, ru, rv = golden_tree(ps, y, u, v, cfg.qp)
        out[name] = chip_smoke.digests(
            chip_smoke.slice_annexb(_HEVC, ps, desc, headers.SLICE_I,
                                    cfg.qp), (ry, ru, rv))
    return out


def test_chip_smoke_digests_are_the_golden_encoders():
    want = {k: v for k, v in chip_smoke.GOLDEN_DIGESTS.items()
            if k not in SAO_CELLS}
    assert golden_digests() == want


def test_port_cpu_path_gives_the_golden_digests():
    assert chip_smoke.port_digests("cpu") == chip_smoke.GOLDEN_DIGESTS


@pytest.mark.parametrize("cell", list(chip_smoke.AQ_CELLS))
def test_port_reproduces_the_aq_stream_digests(cell):
    """The AQ cells (AQ_DIGESTS: the JAX Encoder's, computed and held by
    tests/test_torch_aq.py) on the port's CPU path."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.config import EncoderConfig as TorchConfig
    kw, n = chip_smoke.AQ_CELLS[cell]
    kw = {**chip_smoke.AQ_CFG, **kw}
    efs = chip_smoke.encode_all(
        Encoder(TorchConfig(**kw), device="cpu"),
        chip_smoke.aq_frames(n, kw["width"], kw["height"]))
    assert chip_smoke.digests(
        b"".join(e.annex_b() for e in efs),
        [e.recon[c] for e in efs for c in "yuv"]) == \
        chip_smoke.AQ_DIGESTS[cell]


@pytest.mark.parametrize("cell", list(chip_smoke.B_CELLS))
def test_port_reproduces_the_b_stream_digests(cell):
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.config import EncoderConfig as TorchConfig
    kw, n = chip_smoke.B_CELLS[cell]
    efs = chip_smoke.encode_all(
        Encoder(TorchConfig(**chip_smoke.B_CFG, **kw), device="cpu"),
        chip_smoke.bench_frames(n, w=128, h=96))
    assert chip_smoke.digests(
        b"".join(e.annex_b() for e in efs),
        [e.recon[c] for e in efs for c in "yuv"]) == \
        chip_smoke.B_DIGESTS[cell]


@pytest.fixture(scope="module")
def jax_host_streams():
    """The host intra cells through the JAX package's Encoder on the CPU:
    their digests, and the CTU-32 P program its IPPP cell built (the
    sweep in Pallas interpret mode)."""
    from homerhevc_tpu.api import Encoder as JaxEncoder
    programs = []

    def encode(kw, frames):
        enc = JaxEncoder(EncoderConfig(**kw))
        efs = chip_smoke.encode_all(enc, frames)
        if enc._pipeline._tpu_inter is not None:
            programs.append(enc._pipeline._tpu_inter)
        return efs
    with pytest.MonkeyPatch.context() as mp:
        interpret_sweep(mp)
        got = chip_smoke.host_stream_digests(encode)
    assert len(programs) == 1
    return got, programs[0]


def test_chip_smoke_host_digests_are_the_jax_encoders(jax_host_streams):
    assert jax_host_streams[0] == chip_smoke.HOST_DIGESTS


@pytest.mark.parametrize("cell", list(chip_smoke.HOST_CELLS))
def test_port_reproduces_the_host_stream_digests(cell):
    """The host intra cells on the port's CPU path: no device intra
    encoder is built."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.config import EncoderConfig as TorchConfig
    kw, n = chip_smoke.HOST_CELLS[cell]
    kw = {**chip_smoke.HOST_CFG, **kw}
    enc = Encoder(TorchConfig(**kw), device="cpu")
    efs = chip_smoke.encode_all(
        enc, chip_smoke.aq_frames(n, kw["width"], kw["height"]))
    assert enc._pipeline._intra_enc is None
    assert chip_smoke.digests(
        b"".join(e.annex_b() for e in efs),
        [e.recon[c] for e in efs for c in "yuv"]) == \
        chip_smoke.HOST_DIGESTS[cell]


def test_cli_rd_full_tree_matches_the_jax_cli(jax_host_streams, tmp_path,
                                              monkeypatch, capsys):
    """-rd_mode 1 -cu_size 32 -intra_rdo 1 at the CLIs' other defaults
    (IPPP, deblocking, SAO; 128x64, 4 frames): the RD_FULL host tree I
    frame and the CTU-32 P frames, the JAX CLI's on the P program the
    digests built; the same config, bytes and an FFmpeg decode equal to
    the port's -o-raw."""
    cli_matches_the_jax_cli(["-rd_mode", "1", "-cu_size", "32",
                             "-intra_rdo", "1"], tmp_path, monkeypatch,
                            capsys, jax_inter=jax_host_streams[1])


def test_chip_smoke_host_p_digests_are_the_jax_encoders():
    assert jax_host_p_stream_digests() == chip_smoke.HOST_P_DIGESTS


@pytest.mark.parametrize("cell", list(chip_smoke.HOST_P_CELLS))
def test_port_reproduces_the_host_p_stream_digests(cell):
    """The host P cells on the port's CPU path: no device encoder is
    built."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.config import EncoderConfig as TorchConfig
    kw, n = chip_smoke.HOST_P_CELLS[cell]
    kw = {**chip_smoke.HOST_CFG, **kw}
    enc = Encoder(TorchConfig(**kw), device="cpu")
    efs = chip_smoke.encode_all(
        enc, chip_smoke.aq_frames(n, kw["width"], kw["height"]))
    assert enc._pipeline._intra_enc is None
    assert enc._pipeline._inter_enc is None
    assert chip_smoke.digests(
        b"".join(e.annex_b() for e in efs),
        [e.recon[c] for e in efs for c in "yuv"]) == \
        chip_smoke.HOST_P_DIGESTS[cell]
