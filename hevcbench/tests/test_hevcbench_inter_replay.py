"""inter_replay_pct: the share of the P/B-frame programs' dispatches in
the profiled sub-window that replayed their CUDA graphs, read from the
program's counters; nothing where the program counts no such dispatch
(a program before the graphs, or no profiled sub-window)."""

import pytest

from hevcbench import cells, progtrace, run


def _traced(records):
    return run.TraceData([], [], {}, {}, None, records, {}, None, None)


@pytest.mark.parametrize("counters,want", [
    ({"inter.graph_replays": 4}, 100.0),
    ({"inter.eager": 1, "inter.graph_captures": 1,
      "inter.graph_replays": 2}, 50.0),
    ({"inter.eager": 4, "inter.frames": 4}, 0.0),
    ({"inter.frames": 4, "intra.graph_replays": 1}, None),
    ({}, None)])
def test_the_share_of_replayed_dispatches(counters, want):
    prog = progtrace.Program([], counters=counters)
    got = cells.metric_module("inter_replay_pct").read(
        _traced({"program": prog}))
    assert got == (None if want is None else pytest.approx(want))


def test_no_program_record_reads_nothing():
    assert cells.metric_module("inter_replay_pct").read(_traced({})) is None
