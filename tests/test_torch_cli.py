"""The port's CLI (homerhevc_tpu_torch/cli.py) against the JAX package's
(homerhevc_tpu/cli.py) on the CPU at 128x64, 4 frames: for each argument
set the port's config_from_args equals the config the JAX CLI builds,
field by field; the port's .265 equals the JAX CLI's byte for byte and
decodes in FFmpeg to the port's -o-raw luma. The argument sets hold the
knobs no other port test sets: full-pel ME with scaling lists, half-pel
ME with WPP (no per-CTB maps) under VBR, and all-intra without SAO and
sign hiding. Argument sets of the other knobs map to the JAX CLI's
config too. The CU-tree configurations the host intra programs opened
(-cu_size 64; -rd_mode 1 with -intra_rdo 1 at CU32) are held to the JAX
CLI where their JAX P program is built anyway (test_torch_inter_tree.py,
test_torch_digests.py), through torch_golden.cli_matches_the_jax_cli."""

import dataclasses

import pytest
import torch

import homerhevc_tpu.cli as jax_cli
from homerhevc_tpu_torch import cli
from tests.torch_golden import cli_matches_the_jax_cli, interpret_sweep

torch.set_num_threads(1)    # one intra-op thread per test worker

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
    cli_matches_the_jax_cli(_CASES[case], tmp_path, monkeypatch, capsys)


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

