"""The metrics that read the program's own tracer (progtrace.py): a traced
CPU rehearsal reads the six that need no card, its four frame_* waits
summing to the window's mean latency; the profiled ranges' attribution
and idle split on synthetic events; and a program without the tracer
reads nothing and raises nothing."""

import types

import pytest

from hevcbench import cells, devtrace, drive, progtrace, run, spans
from hevcbench.tests.helpers import small_cell
from homerhevc_tpu_torch.utils.profiler import PROFILER

SEED = 2 ** 31 + 91
OURS = ["intra_launch_ms", "intra_device_ms", "d2h_kb_per_frame",
        "frame_queue_ms", "frame_parked_ms", "frame_fetch_ms",
        "frame_emit_ms"]
FRAME = ["frame_queue_ms", "frame_parked_ms", "frame_fetch_ms",
         "frame_emit_ms"]


def test_a_traced_rehearsal_reads_the_tracers_metrics(monkeypatch):
    import torch
    torch.set_num_threads(1)
    kept = []
    traced = run._traced_phases
    monkeypatch.setattr(run, "_traced_phases",
                        lambda *a: kept.append(traced(*a)) or kept[-1])
    res = run.run_cell(small_cell("ai720_cu16.qp32"), SEED, 1.0, True,
                       device="cpu")
    assert res["correct"] is True
    got = res["metrics"]
    # the device trace's needs the card; the rest read here
    assert set(OURS) - set(got) == {"intra_device_ms"}
    assert all(got[m]["value"] > 0 for m in OURS if m in got)
    window = kept[0].window
    latency = sum(f.t_emit - f.t_submit for f in window) / len(window) * 1e3
    parts = sum(got[m]["value"] for m in FRAME)
    assert parts == pytest.approx(latency, rel=0.05)
    assert not PROFILER.on and PROFILER.sink is None   # uninstalled


def _ev(name, a, b, parent=None, cid=0, kernels=(), card=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        cpu_parent=parent, id=cid,
        device_type="DeviceType.CUDA" if card else "DeviceType.CPU",
        kernels=[types.SimpleNamespace(name=k, duration=d)
                 for k, d in kernels])


def test_kernels_go_to_the_innermost_range_that_launched_them():
    disp = _ev("intra.dispatch", 0, 100, cid=1)
    ser = _ev("serialize", 100, 300, cid=2)
    cabac = _ev("serialize.cabac", 120, 200, parent=ser, cid=3)
    bench = _ev("hevcbench.intra", 0, 100, parent=disp, cid=4)
    add = _ev("aten::add", 10, 20, parent=bench, cid=5,
              kernels=[("k_add", 30)])
    mm = _ev("aten::mm", 30, 40, parent=disp, cid=6, kernels=[("k_mm", 50)])
    # an id two host events carry: its kernels count once
    cp = _ev("aten::copy_", 130, 140, parent=cabac, cid=7,
             kernels=[("memcpy", 5)])
    cabac.id, cabac.kernels = 7, cp.kernels
    lone = _ev("aten::fill_", 400, 410, cid=8, kernels=[("k_fill", 7)])
    card = [_ev("k_add", 20, 50, card=True), _ev("k_mm", 50, 100, card=True),
            _ev("memcpy", 150, 155, card=True),
            _ev("k_fill", 410, 417, card=True),
            _ev("k_fetch", 500, 511, card=True),          # another thread
            _ev("hevcbench.intra", 20, 100, card=True)]   # a span's twin
    prog = progtrace.Program([])
    progtrace._read(prog, [disp, ser, cabac, bench, add, mm, cp, lone]
                    + card, {"intra.dispatch", "serialize",
                             "serialize.cabac"})
    by = {r.name: r.device_s for r in prog.ranges}
    assert by == {"intra.dispatch": pytest.approx(80e-6), "serialize": 0.0,
                  "serialize.cabac": pytest.approx(5e-6)}
    assert prog.kernel_s == pytest.approx(103e-6)
    assert prog.unattributed_s == pytest.approx(18e-6)
    assert prog.span_us == (0, 410)
    kernels = [devtrace.Kernel(e.name, e.time_range.start, e.time_range.end)
               for e in card[:5]]
    idle = progtrace.idle_by_range(kernels, prog.ranges, (0, 600))
    assert idle == {"intra.dispatch": pytest.approx(20e-6),
                    "serialize.cabac": pytest.approx(50e-6),
                    "serialize": pytest.approx(255e-6),
                    "none": pytest.approx(83e-6 + 89e-6)}


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    import homerhevc_tpu_torch.utils.profiler as prof_mod
    monkeypatch.setattr(prof_mod, "PROFILER", types.SimpleNamespace())
    profile = devtrace.profile
    sp = spans.Spans()
    sp.install([cells.metric_module(m) for m in OURS])
    assert "program" not in sp.records and devtrace.profile is profile
    sp.uninstall()
    ef = types.SimpleNamespace()              # an EncodedFrame with no trace
    window = [drive.Emitted(0, "I", 8, 0.0, 1.0, "window", ef)]
    t = run.TraceData([], window, {}, {}, None, sp.records, {}, None, None)
    assert all(cells.metric_module(m).read(t) is None for m in OURS)
