"""What the port's tests share: the golden intra tree reference (the
golden tree decision + closed-loop encode, homerhevc_tpu.golden.intra_tree,
with the golden deblock: the references tests/test_intra_tree.py holds the
JAX tree to), the P-frame comparison against the JAX P program, and the
port's CLI against the JAX CLI (cli_matches_the_jax_cli)."""

import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from homerhevc_tpu.golden import deblock as gdb
from homerhevc_tpu.golden.intra_tree import (decide_intra_tree,
                                             encode_intra_tree_frame)
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.state import reference_from_numpy

# the FrameDesc fields tests/test_tpu_inter.py holds the JAX P program to
P_FIELDS = ("cu_depth", "tr_depth", "pred_mode", "mv", "coef_y", "coef_u",
            "coef_v", "skip", "inter_mode", "merge_idx", "root_cbf",
            "mvp_flag")
# and those a bi-capable frame adds (tests/test_unibi.py)
B_FIELDS = ("mv_l1", "inter_dir", "mvp_flag_l1")


def golden_tree(ps, y, u, v, qp):
    """Golden tree decision + closed-loop encode (CTB32 nodes under the
    CTU of ps) + golden deblock when ps has it on."""
    dec = decide_intra_tree(ps, y, u, v, qp, ctb=32)
    desc, ry, ru, rv = encode_intra_tree_frame(ps, y, u, v, qp, dec, ctb=32)
    if ps.deblocking_enabled:
        tu8 = ((ps.ctu_size >> desc.cu_depth) >> desc.tr_depth) \
            .astype(np.int32)
        qp8 = np.full_like(tu8, qp)
        bs_v, bs_h = gdb.intra_bs_maps(tu8)
        ry = gdb.deblock_plane_luma(ry, tu8, qp8, bs_v, bs_h)
        ru = gdb.deblock_plane_chroma(ru, qp8, bs_v, bs_h, ps.cb_qp_offset)
        rv = gdb.deblock_plane_chroma(rv, qp8, bs_v, bs_h, ps.cr_qp_offset)
    return desc, ry, ru, rv


def torch_p_frame(kw, src, ref, avg_dist=1000.0):
    """The port's P program on the CPU for EncoderConfig(**kw), from the
    numpy reference planes ref."""
    cfg = EncoderConfig(**kw)
    enc = TorchInterEncoder(ParamSets.from_config(cfg), cfg, device="cpu")
    return enc.encode_frame(src, reference_from_numpy(ref, "cpu"), avg_dist)


def assert_p_frames_equal(want, got, fields=P_FIELDS):
    """(desc, y, u, v) of two P programs: every field of `fields`, the
    recon planes and the per-row luma SSD."""
    (wd, *wrec), (gd, *grec) = want, got
    for f in fields:
        assert np.array_equal(getattr(wd, f), getattr(gd, f)), f
    for a, b in zip(wrec, grec):
        assert np.array_equal(np.asarray(a, np.int32),
                              np.asarray(b, np.int32)), "recon"
    assert np.array_equal(wd.row_ssd_y, gd.row_ssd_y)


def interpret_sweep(monkeypatch):
    """Run the JAX package's coarse sweep as its Pallas kernel in interpret
    mode, as tests/test_pallas.py runs it on the CPU (bit-identical to the
    unrolled XLA sweep its probe picks here): a program with three
    searches compiles in about half the time."""
    import homerhevc_tpu.ops.pallas.me_sad as pallas_me_sad
    monkeypatch.setattr(pallas_me_sad, "pallas_ok", lambda: True)
    monkeypatch.setattr(pallas_me_sad, "coarse_sweep_sads",
                        functools.partial(pallas_me_sad.coarse_sweep_sads,
                                          interpret=True))


def spec_amvp(monkeypatch):
    """Give the JAX package the spec's two-list AMVP candidate list (the
    port's amvp_candidates_2) in its syntax selection and its Python
    serializer, and turn its native serializer (which derives the old
    list) off. The JAX package keeps only the same-POC B candidate where
    no left neighbour exists, a list a decoder does not derive (ROADMAP
    Queue 3); everything else of the reference stays as it is."""
    import homerhevc_tpu.hevc.inter as jax_inter
    import homerhevc_tpu.native as jax_native
    from homerhevc_tpu_torch.hevc.inter import amvp_candidates_2
    monkeypatch.setattr(jax_inter, "amvp_candidates_2", amvp_candidates_2)
    monkeypatch.setattr(jax_native, "encode_slice_native",
                        lambda *a, **k: None)


def spec_amvp_mref(monkeypatch):
    """Give the JAX package the spec's multi-reference AMVP candidate list
    (the port's amvp_candidates_mref) in its golden P path and its Python
    serializer, which import it at call time, and turn its native
    serializer off. The JAX package's list keeps the same-reference above
    candidate where no left neighbour exists and derives no scaled one
    for the left's place, a list a decoder does not derive (ROADMAP Queue
    3); everything else of the reference stays as it is."""
    import homerhevc_tpu.hevc.inter as jax_inter
    import homerhevc_tpu.native as jax_native
    from homerhevc_tpu_torch.hevc.inter import amvp_candidates_mref
    monkeypatch.setattr(jax_inter, "amvp_candidates_mref",
                        amvp_candidates_mref)
    monkeypatch.setattr(jax_native, "encode_slice_native",
                        lambda *a, **k: None)


def port_scene_change(monkeypatch):
    """Give the JAX package's pipeline the port's scene-change detector
    (TorchPipeline._scene_change): its level re-seeded after a cut and its
    threshold at least 1.25x the level. The JAX detector freezes its level
    at its first cut, so a clip whose MAD then stays a little higher cuts
    on every frame, each an IDR with reinit on (ROADMAP Queue 3);
    everything else of the reference stays as it is."""
    from homerhevc_tpu.engine.pipeline import EncoderPipeline
    from homerhevc_tpu_torch.engine.pipeline import TorchPipeline
    monkeypatch.setattr(EncoderPipeline, "_scene_change",
                        TorchPipeline._scene_change)


def spec_mref_rps(monkeypatch):
    """Give the JAX package's IPPP P slices with num_ref_frames > 2 the
    reference picture set the port writes: every picture of the
    reference queue, not the previous picture alone. Its depth-2 device
    chain emits the second P frame after an IDR once the queue holds two
    pictures, and an RPS of the previous picture alone drops the I frame
    from the decoder's buffer while the next, multi-reference frame
    predicts from it (ROADMAP Queue 3). Only the slice header's RPS
    changes; the coding does not."""
    from homerhevc_tpu.engine.pipeline import EncoderPipeline
    from homerhevc_tpu.hevc.headers import SLICE_I, SLICE_P
    emit = EncoderPipeline._emit

    def with_queue_refs(self, desc, ry, ru, rv, src=None,
                        slice_type=SLICE_I, refs_before=None, **kw):
        if (slice_type == SLICE_P and refs_before is None
                and self.cfg.gop_size == 1 and self.cfg.num_ref_frames > 2):
            n = len(getattr(self, "_ref_queue", ()))
            refs_before = tuple(self.gop_poc - 1 - i
                                for i in range(max(1, n)))
        return emit(self, desc, ry, ru, rv, src=src, slice_type=slice_type,
                    refs_before=refs_before, **kw)
    monkeypatch.setattr(EncoderPipeline, "_emit", with_queue_refs)


def jax_b_stream_digests():
    """The B cells of chip_smoke.py (B_CELLS) through the JAX package's
    Encoder on the CPU, its coarse sweep in interpret mode
    (interpret_sweep); at CTU 64 the I frame comes from its golden path
    (decide + encode, golden deblock), which the port's CTU-64 tree
    equals and the JAX tree program does not (ROADMAP Queue 3). No CU of these streams
    reaches the JAX package's two-list AMVP fault (spec_amvp), so they
    need no correction. Takes minutes (the JAX tree program's trace, the
    P and B programs' compiles):

        JAX_PLATFORMS=cpu python -c "from tests.torch_golden import \\
            jax_b_stream_digests as d; print(d())"
    """
    import chip_smoke
    from homerhevc_tpu.api import Encoder
    from homerhevc_tpu.config import EncoderConfig as JaxConfig

    def encode(kw, frames):
        enc = Encoder(JaxConfig(**kw))
        if kw["cu_size"] == 64:
            enc._pipeline._tpu_tree_ok = lambda: False
        return chip_smoke.encode_all(enc, frames)
    with pytest.MonkeyPatch.context() as mp:
        interpret_sweep(mp)
        return chip_smoke.b_stream_digests(encode)


def jax_host_p_stream_digests():
    """The host P cells of chip_smoke.py (HOST_P_CELLS) through the JAX
    package's Encoder on the CPU, with the spec's AMVP lists and
    multi-reference RPS (spec_amvp, spec_amvp_mref, spec_mref_rps; where
    a cell does not reach the JAX package's faults they change nothing):
    their digests. Numpy only, no JAX program (the cells' I, P and B
    frames are all host frames)."""
    import chip_smoke
    from homerhevc_tpu.api import Encoder
    from homerhevc_tpu.config import EncoderConfig as JaxConfig

    def encode(kw, frames):
        return chip_smoke.encode_all(Encoder(JaxConfig(**kw)), frames)
    with pytest.MonkeyPatch.context() as mp:
        spec_amvp(mp)
        spec_amvp_mref(mp)
        spec_mref_rps(mp)
        return chip_smoke.host_p_stream_digests(encode)


class IntSums(TorchDispatchMode):
    """The largest int32 sum seen, by the number of elements summed."""

    def __init__(self):
        super().__init__()
        self.largest = {}

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func is torch.ops.aten.sum.dim_IntList
                and (kwargs or {}).get("dtype") == torch.int32):
            n = int(np.prod([args[0].shape[d] for d in args[1]]))
            self.largest[n] = max(self.largest.get(n, 0), int(out.max()))
        return out


# the CLI comparison: 4 frames of the 128x64 clip
W, H, N = 128, 64, 4


def _argv(tmp_path, tag, extra):
    return (["-i", str(tmp_path / "in.yuv"),
             "-o", str(tmp_path / f"{tag}.265"),
             "-o-raw", str(tmp_path / f"{tag}.yuv"),
             "-widthxheight", f"{W}x{H}", "-n_frames", str(N)] + extra)


def cli_matches_the_jax_cli(extra, tmp_path, monkeypatch, capsys,
                            jax_inter=None):
    """Both CLIs with the arguments extra on the 128x64 clip: the same
    config, the same bytes, an FFmpeg decode equal to the port's -o-raw.
    jax_inter: a JAX P program of the same configuration built by the
    caller, given to the JAX CLI's Encoder in place of its own."""
    import dataclasses

    import homerhevc_tpu.cli as jax_cli
    from homerhevc_tpu_torch import cli
    from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip, write_yuv
    from tests.conftest import decode_annexb
    write_yuv(tmp_path / "in.yuv", bench_clip(W, H, N, 7))
    seen = []
    jax_encoder = jax_cli.Encoder

    def capture(cfg):
        seen.append(cfg)
        enc = jax_encoder(cfg)
        if jax_inter is not None:
            enc._pipeline._tpu_inter = jax_inter
        return enc
    monkeypatch.setattr(jax_cli, "Encoder", capture)
    assert jax_cli.main(_argv(tmp_path, "jax", extra)) == 0
    port_argv = _argv(tmp_path, "port", extra) + ["-device", "cpu", "-psnr"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(port_argv))
    assert len(seen) == 1
    assert dataclasses.asdict(cfg) == dataclasses.asdict(seen[0])
    capsys.readouterr()
    assert cli.main(port_argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith(f"{N} frames in ")
    assert lines[-1].startswith("average PSNR Y ")
    stream = (tmp_path / "port.265").read_bytes()
    assert stream == (tmp_path / "jax.265").read_bytes()
    dec = decode_annexb(tmp_path / "port.265")
    rec = np.fromfile(tmp_path / "port.yuv", np.uint8).reshape(
        N, H * 3 // 2, W)
    assert len(dec) == N
    for i in range(N):
        assert np.array_equal(dec[i], rec[i, :H]), f"frame {i}"
