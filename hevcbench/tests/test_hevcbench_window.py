"""The p95 rank rule and the window of whole periods, on a synthetic
encoder and clock."""

import itertools

import pytest

from hevcbench import drive


def test_p95_is_the_nearest_rank():
    assert drive.p95(range(1, 101)) == 95
    assert drive.p95(range(1, 21)) == 19
    assert drive.p95([7.0]) == 7.0
    assert drive.p95([3, 1, 2]) == 3
    with pytest.raises(ValueError):
        drive.p95([])


class _Frame:
    def __init__(self, poc, ftype):
        self.poc, self.frame_type, self.bits = poc, ftype, 1000


class _BatchEncoder:
    """Emits a batch of `batch` frames once the next batch is full (the
    all-intra pipeline's depth), every `idr`-th frame an I frame."""

    def __init__(self, batch, idr):
        self.batch, self.idr, self.queue, self.held = batch, idr, [], []
        self.n = 0

    def encode(self, y, u, v):
        self.queue.append(self.n)
        self.n += 1
        if len(self.queue) == self.batch:
            out, self.held = self.held, self.queue
            self.queue = []
            for p in out:
                yield _Frame(p, "I" if p % self.idr == 0 else "P")


class _Clip:
    def frame(self, t):
        return None, None, None


@pytest.mark.parametrize("batch,idr,period", [(4, 1, 4), (1, 5, 5)])
def test_the_window_holds_whole_periods(monkeypatch, batch, idr, period):
    clock = itertools.count(0.0, 0.1)
    monkeypatch.setattr(drive.time, "perf_counter", lambda: next(clock))
    c = drive.Client(_BatchEncoder(batch, idr), _Clip())
    c.run(2 * period, "setup")
    t0, t1 = c.window(1.0, period)
    assert c.next % period == 0 and t1 - t0 >= 1.0
    win = c.in_phase("window")
    assert len(win) % period == 0 and len(win) >= 1.0 / 0.1 - period
    pocs = [f.poc for f in win]
    assert pocs == list(range(pocs[0], pocs[0] + len(pocs)))
    if idr > 1:      # whole segments: each starts at an I frame
        assert sum(f.ftype == "I" for f in win) == len(win) // idr
    m = drive.end_to_end(win, t0, t1, 25.0)
    assert m["fps"] == pytest.approx(len(win) / (t1 - t0))
    assert m["kbps"] == pytest.approx(25.0)
