"""The port's CLI (homerhevc_tpu_torch/cli.py) against the JAX package's
(homerhevc_tpu/cli.py) on the CPU at 128x64, 4 frames: for each argument
set the port's config_from_args equals the config the JAX CLI builds,
field by field; the port's .265 equals the JAX CLI's byte for byte and
decodes in FFmpeg to the port's -o-raw luma. The argument sets hold the
knobs no other port test sets: full-pel ME with scaling lists, half-pel
ME with WPP (no per-CTB maps) under VBR, and all-intra without SAO and
sign hiding. Argument sets of the other knobs map to the JAX CLI's
config too."""

import dataclasses

import numpy as np
import pytest
import torch

import homerhevc_tpu.cli as jax_cli
from homerhevc_tpu_torch import cli
from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip, write_yuv
from tests.conftest import decode_annexb
from tests.torch_golden import interpret_sweep

torch.set_num_threads(1)    # one intra-op thread per test worker

W, H, N = 128, 64, 4


def _argv(tmp_path, tag, extra):
    return (["-i", str(tmp_path / "in.yuv"),
             "-o", str(tmp_path / f"{tag}.265"),
             "-o-raw", str(tmp_path / f"{tag}.yuv"),
             "-widthxheight", f"{W}x{H}", "-n_frames", str(N)] + extra)


_CASES = {
    "fullpel-scaling": ["-motion_estimation_precision", "0",
                        "-scaling_lists", "1"],
    "halfpel-wpp-vbr": ["-motion_estimation_precision", "1", "-wpp", "1",
                        "-bitrate_mode", "2", "-bitrate", "300",
                        "-chroma_qp_offset", "0"],
    "allintra": ["-gop_size", "0", "-n_frames_in_flight", "2", "-sao", "0",
                 "-sign_hiding", "0"],
}


@pytest.mark.parametrize("case", list(_CASES))
def test_cli_matches_the_jax_cli_and_decodes(case, tmp_path, monkeypatch,
                                             capsys):
    interpret_sweep(monkeypatch)
    write_yuv(tmp_path / "in.yuv", bench_clip(W, H, N, 7))
    extra = _CASES[case]
    seen = []
    jax_encoder = jax_cli.Encoder

    def capture(cfg):
        seen.append(cfg)
        return jax_encoder(cfg)
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


@pytest.mark.parametrize("extra", [
    ["-rd_mode", "1"], ["-cu_size", "64", "-intra_rdo", "1", "-gpb", "1",
                        "-performance_mode", "2", "-me_range", "64"],
    ["-aq", "1.5", "-rc_ctu", "1", "-bitrate_mode", "1", "-deblocking", "0",
     "-intra_in_p", "1", "-scene_change", "0", "-vbv_size", "0.5",
     "-vbv_init", "0.5", "-frame_rate", "30", "-intra_period", "8"],
    ["-gop_size", "2", "-num_b", "1", "-num_ref_frames", "2",
     "-skipped_frames", "1", "-qp", "27"]],
    ids=["rd_mode1", "tree-gpb-ufast-far", "aq-rc-cbr", "ibp"])
def test_config_from_args_equals_the_jax_cli(extra, monkeypatch):
    """Argument sets of the other knobs map to the JAX CLI's config field
    by field (no encode: the JAX CLI stops at its Encoder)."""
    seen = []

    class Stop(Exception):
        pass

    def capture(cfg):
        seen.append(cfg)
        raise Stop
    monkeypatch.setattr(jax_cli, "Encoder", capture)
    argv = ["-i", "in.yuv", "-o", "out.265"] + extra
    with pytest.raises(Stop):
        jax_cli.main(argv)
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(seen[0])

