"""The harness finds a configuration, a traffic mix and a per-layer metric,
with the layer its spans wrap, by name, with no edit of its code."""

import json
import sys
import types

from hevcbench import cells, spans
from hevcbench.reference import config as ref_config


def test_dropped_in_files_are_found(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(
        {"source": "a test", "width": 64, "height": 32, "gop_size": 0,
         "cu_size": 16, "num_frames_in_flight": 2}))
    (tmp_path / "traffic" / "burst.json").write_text(json.dumps(
        {"encoder": {"qp": 27}, "warmup_periods": 2, "check_frames": 1}))
    (tmp_path / "metrics" / "frames_seen.py").write_text(
        "def read(t):\n    return float(len(t))\n")
    manifest = tmp_path / "BENCHMARK.json"
    manifest.write_text(json.dumps({
        "workloads": [{"name": "tiny.burst", "config": "tiny",
                       "traffic": "burst", "chips": 1}],
        "end_to_end": [{"name": "fps", "unit": "frames/s"},
                       {"name": "only_elsewhere", "unit": "s",
                        "workloads": ["other"]}],
        "per_layer": [{"name": "frames_seen", "unit": "1"}]}))
    cell = cells.load_cell("tiny.burst", str(manifest), root=str(tmp_path))
    assert [m["name"] for m in cell.end_to_end] == ["fps"]
    assert cell.batch == 2 and cell.period == 2
    cfg = cells.encoder_config(cell, ref_config)
    assert (cfg.width, cfg.height, cfg.qp) == (64, 32, 27)
    mod = cells.metric_module("frames_seen", str(tmp_path))
    assert mod.read([1, 2, 3]) == 3.0


def test_a_dropped_in_metric_names_its_layer(tmp_path, monkeypatch):
    """A metric of a new layer wraps the calls its file names; the
    pipeline's self time leaves that layer out, and uninstall undoes it."""
    prog = types.ModuleType("hevcbench_test_prog")

    class Stage:
        def work(self, x):
            return x + 1
    prog.Stage = Stage
    monkeypatch.setitem(sys.modules, "hevcbench_test_prog", prog)
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "stage_ms.py").write_text(
        'SPANS = {"stage": ("hevcbench_test_prog", "Stage", ("work",))}\n'
        "def read(t):\n    return 1.0\n")
    sp = spans.Spans()
    sp.install([cells.metric_module("stage_ms", str(tmp_path))])
    sp.recording = True
    with sp.span("pipeline"):
        assert Stage().work(1) == 2
    sp.uninstall()
    assert Stage().work(1) == 2 and len(sp.spans) == 2
    assert set(sp.layers) == {"stage"}
    inner = [s for s in sp.spans if s.layer == "stage"][0]
    outer = [s for s in sp.spans if s.layer == "pipeline"][0]
    got = spans.self_time(sp.spans, "pipeline", set(sp.layers))
    assert abs(got - ((outer.t1 - outer.t0) - (inner.t1 - inner.t0))) < 1e-9


def test_the_shipped_cells_and_files_load():
    from hevcbench.tests.helpers import MANIFEST, any_cell
    bench = json.load(open(MANIFEST))
    periods = {}
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"], MANIFEST)
        cells.encoder_config(cell, ref_config)
        periods[w["name"]] = cell.period
        sp = spans.Spans()
        sp.install([cells.metric_module(m["name"]) for m in cell.per_layer])
        sp.uninstall()
        assert set(sp.layers) == {"intra", "serialize"}
    assert periods == {"ai720_cu16.qp32": 32, "ai720_cu16.qp22": 32}
    # the IPPP files, kept for the cells PERF.md lists for later
    assert any_cell("ippp720_fpel.ldp_qp32").period == 1
    assert any_cell("ippp720_fpel.seg2s_qp32").period == 50
    assert cells.encoder_config(any_cell("ippp720_fpel.ldp_qp32"),
                                ref_config).reinit_gop_on_scene_change
