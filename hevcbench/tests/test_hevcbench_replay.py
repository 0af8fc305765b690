"""intra_replay_pct: the share of the CU16 intra program's dispatches in
the profiled sub-window that replayed its CUDA graph, read from the
program's counters; nothing where the program counts no such dispatch
(a program before the graph, or no profiled sub-window)."""

import pytest

from hevcbench import cells, progtrace, run


def _traced(records):
    return run.TraceData([], [], {}, {}, None, records, {}, None, None)


@pytest.mark.parametrize("counters,want", [
    ({"intra.graph_replays": 32}, 100.0),
    ({"intra.eager": 1, "intra.graph_captures": 1,
      "intra.graph_replays": 2}, 50.0),
    ({"intra.eager": 3, "intra.frames": 96}, 0.0),
    ({"intra.frames": 32, "d2h_bytes": 9}, None),
    ({}, None)])
def test_the_share_of_replayed_dispatches(counters, want):
    prog = progtrace.Program([], counters=counters)
    got = cells.metric_module("intra_replay_pct").read(
        _traced({"program": prog}))
    assert got == (None if want is None else pytest.approx(want))


def test_no_program_record_reads_nothing():
    assert cells.metric_module("intra_replay_pct").read(_traced({})) is None
