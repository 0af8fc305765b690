"""The port's tracer (homerhevc_tpu_torch/utils/profiler.py) on the CPU at
64x64: off, it reads no clock, takes no lock and opens no profiler range,
and frames carry no trace; on, the streams keep their bytes, every frame
of the all-intra batch path and of the IPPP chain carries its five stamps
in order and its wire bytes, self time is kept per thread, the program's
scopes reach torch.profiler's timeline nested as they ran, and a wire
overflow adds the fallback planes' bytes to the counter."""

import threading

import numpy as np
import pytest
import torch

from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.engine.intra_encoder import TorchIntraEncoder
from homerhevc_tpu_torch.engine.pipeline import TorchPipeline
from homerhevc_tpu_torch.utils import profiler
from homerhevc_tpu_torch.utils.profiler import PROFILER, Profiler

torch.set_num_threads(1)    # one intra-op thread per test worker

W = H = 64
CONFIGS = {
    "allintra-b2": dict(gop_size=0, num_frames_in_flight=2),
    "ippp": dict(gop_size=1),
}
STAGES = ("push", "dispatch", "fetch", "fetched", "emit")


def _frames(n, seed=5):
    """A smooth moving picture: the wire holds it (no overflow)."""
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for i in range(n):
        y = (96 + 40 * np.sin((xx + 3 * i) / 9.0) + yy).astype(np.uint8)
        c = np.full((H // 2, W // 2), 128 + seed, np.uint8)
        out.append((y, c, c))
    return out


def _encode(kw, frames):
    enc = Encoder(EncoderConfig(width=W, height=H, cu_size=16, qp=32,
                                sao=False, **kw), device="cpu")
    efs = []
    for f in frames:
        efs.extend(enc.encode(*f))
    efs.extend(enc.flush())
    return efs


@pytest.fixture(autouse=True)
def _tracer_off():
    PROFILER.disable()
    PROFILER.reset()
    yield
    PROFILER.disable()
    PROFILER.reset()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def streams(request):
    """(frames off, frames on, the sink's spans, the stats) of one
    configuration, 5 frames."""
    frames = _frames(5)
    kw = CONFIGS[request.param]
    off = _encode(kw, frames)
    sink = []
    PROFILER.reset()
    with PROFILER.enabled(sink):
        on = _encode(kw, frames)
    stats, counters = PROFILER.stats(), PROFILER.counters
    PROFILER.reset()
    return off, on, sink, stats, counters


def test_off_reads_no_clock_takes_no_lock_and_opens_no_range(monkeypatch):
    class Refuse:
        def __enter__(self):
            raise AssertionError("the lock was taken")

        def __exit__(self, *exc):
            return False

    def no_clock():
        raise AssertionError("the clock was read")

    def no_range(name):
        raise AssertionError(f"a range opened: {name}")
    monkeypatch.setattr(profiler, "clock", no_clock)
    monkeypatch.setattr(profiler, "_RANGE", no_range)
    monkeypatch.setattr(PROFILER, "_lock", Refuse())
    with PROFILER.scope("any"):
        PROFILER.count("d2h_bytes", 5)
    assert PROFILER.scope("a") is PROFILER.scope("b")    # one shared no-op
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        efs = _encode(CONFIGS["allintra-b2"], _frames(2))
    assert all(ef.trace is None for ef in efs) and len(efs) == 2
    names = {name for _, name in PROFILER._stats}
    assert not names and not PROFILER._counters
    assert not any(e.name.startswith(("intra.", "serialize"))
                   for e in prof.events())


def test_streams_are_equal_with_tracing_on_and_off(streams):
    off, on, *_ = streams
    assert [ef.poc for ef in on] == [ef.poc for ef in off] == list(range(5))
    assert b"".join(ef.annex_b() for ef in on) == \
        b"".join(ef.annex_b() for ef in off)
    assert all(ef.trace is None for ef in off)


def test_every_frame_has_its_stamps_in_order(streams):
    _, on, sink, stats, counters = streams
    for ef in on:
        t = [getattr(ef.trace, s) for s in STAGES]
        assert None not in t and t == sorted(t), (ef.poc, ef.trace)
        assert ef.trace.d2h_bytes > 0
    assert counters["d2h_bytes"] >= sum(ef.trace.d2h_bytes for ef in on)
    assert counters.get("wire_overflows", 0) == 0
    assert counters["intra.frames"] + counters.get("inter.frames", 0) == 5
    assert {"intra.dispatch", "intra.fetch", "serialize",
            "serialize.cabac"} <= {name for _, name in stats}
    roles = {role for role, _ in stats}
    # the all-intra batches' background fetch runs as its own role
    assert roles == ({"main", "fetch"} if counters["intra.frames"] == 5
                     else {"main"})


def test_the_sink_holds_every_scope_the_stats_count(streams):
    *_, sink, stats, _ = streams
    assert len(sink) == sum(st.calls for st in stats.values())
    for (role, name), st in stats.items():
        mine = [s for s in sink if (s.role, s.name) == (role, name)]
        assert len(mine) == st.calls
        assert sum(s.t1 - s.t0 for s in mine) == pytest.approx(st.total)
        assert sum(s.self_s for s in mine) == pytest.approx(st.self_s)
        assert 0 <= st.self_s <= st.total + 1e-12


def test_self_time_is_kept_per_thread(monkeypatch):
    """main: outer [0, 10] with inner [1, 4]; meanwhile a fetch thread's
    scope [5, 8] inside main's outer, and in it its own inner [6, 7]. The
    other thread's scopes take nothing from main's self time."""
    ticks = iter([0.0, 1.0, 4.0, 5.0, 6.0, 7.0, 8.0, 10.0])
    monkeypatch.setattr(profiler, "clock", lambda: next(ticks))
    prof = Profiler()
    sink = []
    prof.enable(sink)

    def fetch():
        prof.set_role("fetch")
        with prof.scope("outer"):
            with prof.scope("inner"):
                pass
    with prof.scope("outer"):
        with prof.scope("inner"):
            pass
        t = threading.Thread(target=fetch)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert prof.stats() == {
        ("main", "inner"): (3.0, 3.0, 1), ("main", "outer"): (10.0, 7.0, 1),
        ("fetch", "inner"): (1.0, 1.0, 1), ("fetch", "outer"): (3.0, 2.0, 1)}
    assert [(s.role, s.name, s.t0, s.t1, s.self_s) for s in sink] == [
        ("main", "inner", 1.0, 4.0, 3.0), ("fetch", "inner", 6.0, 7.0, 1.0),
        ("fetch", "outer", 5.0, 8.0, 2.0), ("main", "outer", 0.0, 10.0, 7.0)]
    assert prof.totals["outer"] == 13.0 and prof.counts["inner"] == 2


def test_spans_reach_the_profilers_timeline_nested():
    with PROFILER.enabled():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _encode(CONFIGS["ippp"], _frames(2))
    ev = list(prof.events())
    by = {}
    for e in ev:
        by.setdefault(e.name, []).append(e)
    for name in ("intra.dispatch", "intra.fetch", "inter.dispatch",
                 "inter.fetch", "inter.syntax", "serialize",
                 "serialize.cabac"):
        assert name in by, name
        # a function-scope range: no twin on a device timeline
        assert not any(e.is_user_annotation for e in by[name])

    def inside(e, outer):
        p = e.cpu_parent
        while p is not None and p.name != outer:
            p = p.cpu_parent
        return p is not None and (p.time_range.start <= e.time_range.start
                                  and e.time_range.end <= p.time_range.end)
    assert all(inside(e, "serialize") for e in by["serialize.cabac"])
    assert all(inside(e, "inter.fetch") for e in by["inter.syntax"])
    assert any(inside(e, "intra.dispatch") for e in ev
               if e.name.startswith("aten::"))
    assert any(inside(e, "inter.dispatch") for e in ev
               if e.name.startswith("aten::"))


def test_a_wire_overflow_counts_the_fallback_planes():
    cfg = EncoderConfig(width=W, height=H, cu_size=16, qp=32, gop_size=0,
                        sao=False)
    ps = TorchPipeline(cfg, "cpu").ps
    frames = _frames(2)
    ys, us, vs = zip(*frames)
    got = {}
    for cap in ("default", "tiny"):
        enc = TorchIntraEncoder(ps, cfg, device="cpu")
        if cap == "tiny":
            enc.pack_C = 8                   # fewer levels than the frame's
        PROFILER.reset()
        with PROFILER.enabled():
            out = enc.fetch_frames(enc.dispatch_frames(ys, us, vs), 2)
        got[cap] = (PROFILER.counters, out)
    planes = (H * W + 2 * (H // 2) * (W // 2)) * 2     # int16 y, u, v
    c_def, out_def = got["default"]
    c_tiny, out_tiny = got["tiny"]
    rows_def = [d.d2h_bytes for d, *_ in out_def]
    rows_tiny = [d.d2h_bytes for d, *_ in out_tiny]
    assert c_def.get("wire_overflows", 0) == 0
    assert c_def["d2h_bytes"] == sum(rows_def)
    assert all(r < planes for r in rows_def)        # the wire is compact
    assert c_tiny["wire_overflows"] == 2
    assert c_tiny["d2h_bytes"] == sum(rows_tiny)
    assert all(r > planes for r in rows_tiny)       # its row + the planes
    for (d0, *_), (d1, *_) in zip(out_def, out_tiny):
        assert d1.cg_wire is None
        assert np.array_equal(d0.densify().coef_y, d1.coef_y)


def test_the_scene_detector_is_traced_and_reported():
    """The pipeline's scene-change detector runs inside `scene.detect` on
    every IPPP frame, and `scene.cuts` counts the cuts it declares: a hard
    cut into frame 2 and back out of it at frame 3, each an IDR with
    reinit on."""
    frames = _frames(4)
    y, u, v = frames[2]
    frames[2] = (255 - y, u, v)
    with PROFILER.enabled():
        efs = _encode(CONFIGS["ippp"], frames)
    assert [ef.frame_type for ef in efs] == ["I", "P", "I", "I"]
    assert PROFILER.stats()[("main", "scene.detect")].calls == 4
    assert PROFILER.counters["scene.cuts"] == 2
    lines = PROFILER.report().splitlines()
    assert any(ln.startswith("main scene.detect: ") for ln in lines)
    assert "scene.cuts: 2" in lines
