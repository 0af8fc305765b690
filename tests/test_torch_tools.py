"""The port's measuring tools on the CPU at small sizes:
tools/measure_rd.py reports the kbps and PSNR of the port's Encoder over
the same frames; a pipeline that takes the device encoders of one built
at another QP (as measure_rd's -qps sweep and -warmup hand them on) gives
a fresh pipeline's bytes, QP up and down; tools/prof_device.py prints one
JSON line per probe."""

import json

import numpy as np
import pytest
import torch

from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.engine.pipeline import TorchPipeline
from homerhevc_tpu_torch.tools import measure_rd, prof_device
from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip, write_yuv
from homerhevc_tpu_torch.utils.metrics import psnr

torch.set_num_threads(1)    # one intra-op thread per test worker


def _lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()
            if s.startswith("{")]


def test_measure_rd_reports_the_encoders_kbps_and_psnr(tmp_path, capsys):
    frames = bench_clip(64, 64, 4, 9)
    write_yuv(tmp_path / "in.yuv", frames)
    measure_rd.main(["-i", str(tmp_path / "in.yuv"), "-w", "64", "-ht",
                     "64", "-n", "4", "-cu", "16", "-sao", "-me_prec", "1",
                     "-qps", "30,36", "-device", "cpu"])
    rows = _lines(capsys)
    assert [r["label"] for r in rows] == ["rd_qp30", "rd_qp36"]
    for row, qp in zip(rows, (30, 36)):
        cfg = EncoderConfig(width=64, height=64, qp=qp, gop_size=1,
                            cu_size=16, sao=True, sign_hiding=True,
                            intra_period=0, motion_estimation_precision=1,
                            reinit_gop_on_scene_change=False)
        enc = Encoder(cfg, device="cpu")
        efs = [e for f in frames for e in enc.encode(*f)]
        efs += list(enc.flush())
        kbps = sum(e.bits for e in efs) * 25.0 / len(efs) / 1000.0
        assert row["frames"] == len(efs) == 4
        assert row["kbps"] == round(kbps, 1)
        for i, c in enumerate("yuv"):
            want = np.mean([min(psnr(e.recon[c], frames[e.poc][i]), 99.0)
                            for e in efs])
            assert row[f"psnr_{c}"] == round(float(want), 2)


@pytest.mark.parametrize("kw", [
    pytest.param(dict(cu_size=16, gop_size=1, sao=True), id="ippp-cu16"),
    pytest.param(dict(cu_size=16, gop_size=0, num_frames_in_flight=3),
                 id="allintra-cu16"),
    pytest.param(dict(cu_size=32, gop_size=1, intra_rdo=True),
                 id="ippp-ctu32")])
def test_encoders_reused_at_another_qp_give_fresh_bytes(kw):
    """Encoders built at QP 32 serve QP 37 and QP 22 (where the wire
    capacities sized from QP 32 overflow to full planes) with the bytes
    of encoders built at that QP."""
    frames = bench_clip(64, 64, 3, 11)

    def stream(pipe):
        efs = [e for f in frames for e in pipe.push(*f)] + list(pipe.flush())
        return b"".join(e.annex_b() for e in efs)

    first = TorchPipeline(EncoderConfig(width=64, height=64, qp=32, **kw),
                          "cpu")
    stream(first)
    for qp in (37, 22):
        cfg = EncoderConfig(width=64, height=64, qp=qp, **kw)
        reused = TorchPipeline(cfg, "cpu")
        reused._intra_enc = first._intra_enc
        reused._inter_enc = first._inter_enc
        assert stream(reused) == stream(TorchPipeline(cfg, "cpu")), qp


def test_prof_device_prints_each_probe(capsys):
    prof_device.main(["-w", "64", "-ht", "64", "-cu", "32", "-n", "1",
                      "-probe", "me,impl,fetch,decide,intra", "-device",
                      "cpu"])
    rows = _lines(capsys)
    assert [r["probe"] for r in rows] == ["hier_me", "impl_p",
                                          "dispatch_fetch", "intra_decide",
                                          "intra_tree"]
    assert all(r["ms"] > 0 and r["device"] == "cpu" for r in rows)

