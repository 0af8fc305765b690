"""The cell ippp720_fpel.seg4s_qp32 on the CPU at a test's size: it loads
with one frame a batch and an IDR every 100 frames, a rehearsal is correct
over whole GOPs, a planted fault fails it, and a traced rehearsal reads
the scene-change detector's time and the P-frame layer's metrics; every
shipped cell loads and wraps the layers its metrics read."""

import json
import re
import types

import pytest

from hevcbench import cells, run, spans
from hevcbench.metrics import scene_detect_ms
from hevcbench.progtrace import Program
from hevcbench.reference import config as ref_config
from hevcbench.tests.helpers import MANIFEST, small_cell
from homerhevc_tpu_torch.utils.profiler import Span

CELL = "ippp720_fpel.seg4s_qp32"
SEED = 2 ** 31 + 161


def _run(trace=False, fault=None):
    import torch
    torch.set_num_threads(1)
    return run.run_cell(small_cell(CELL), SEED, 1.0, trace, device="cpu",
                        fault=fault)


def test_the_cell_loads_with_its_gop():
    cell = cells.load_cell(CELL, MANIFEST)
    assert (cell.batch, cell.idr_period, cell.period) == (1, 100, 100)
    cfg = cells.encoder_config(cell, ref_config)
    assert (cfg.width, cfg.height, cfg.qp, cfg.intra_period) == \
        (1280, 720, 32, 100)
    assert not cfg.reinit_gop_on_scene_change
    assert cell.traffic["warmup_periods"] == 2
    assert {m["name"] for m in cell.per_layer} >= {
        "scene_detect_ms", "inter_ms", "inter_ops_per_frame",
        "me_sad_roofline_pct"}


def test_every_shipped_cell_loads_and_wraps_its_layers():
    """Each cell of the manifest builds its configuration and installs the
    layers its metrics read: the I-frame layer in the all-intra cells, the
    P-frame layer in this one, host CABAC in every one."""
    layers, periods = {}, {}
    for w in json.load(open(MANIFEST))["workloads"]:
        cell = cells.load_cell(w["name"], MANIFEST)
        cells.encoder_config(cell, ref_config)
        sp = spans.Spans()
        sp.install([cells.metric_module(m["name"]) for m in cell.per_layer])
        sp.uninstall()
        layers[w["name"]], periods[w["name"]] = set(sp.layers), cell.period
    assert periods == {"ai720_cu16.qp32": 32, "ai720_cu16.qp22": 32,
                       CELL: 100}
    assert layers == {"ai720_cu16.qp32": {"intra", "serialize"},
                      "ai720_cu16.qp22": {"intra", "serialize"},
                      CELL: {"inter", "serialize"}}


def test_a_rehearsal_is_correct_over_whole_gops(capsys):
    res = _run()
    assert res["correct"] is True and res["failed"] == 0
    idr = small_cell(CELL).period
    frames, intra = map(int, re.search(
        r"\[run\] set-up .* (\d+) frames \((\d+) I\)",
        capsys.readouterr().err).groups())
    assert res["attempted"] == frames and frames % idr == 0
    assert intra == frames // idr


@pytest.mark.parametrize("fault", ["stale", "altered"])
def test_a_planted_fault_is_not_correct(fault):
    assert _run(fault=fault)["correct"] is False


def test_a_traced_rehearsal_reads_the_detector_and_the_p_layer():
    got = _run(trace=True)["metrics"]
    assert {"scene_detect_ms", "inter_ms", "inter_ops_per_frame"} <= set(got)
    assert all(got[m]["value"] > 0 for m in ("scene_detect_ms", "inter_ms",
                                             "inter_ops_per_frame"))
    # the sweep's roofline reads the device trace: the card's alone
    assert "me_sad_roofline_pct" not in got


def test_the_detector_metric_is_per_window_frame_and_silent_without_it():
    t = types.SimpleNamespace(window=[object()] * 4, records={})
    assert scene_detect_ms.read(t) is None           # no tracer
    prog = t.records["program"] = Program([
        Span("main", "scene.detect", 0.0, 0.003, 0.002),
        Span("main", "scene.detect", 1.0, 1.003, 0.002),
        Span("fetch", "scene.detect", 0.0, 1.0, 1.0),
        Span("main", "inter.dispatch", 0.0, 1.0, 1.0)])
    assert scene_detect_ms.read(t) == pytest.approx(1.0)
    prog.spans[:] = [s for s in prog.spans if s.name != "scene.detect"]
    assert scene_detect_ms.read(t) is None           # a program without it
