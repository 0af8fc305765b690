"""The device-trace arithmetic and its readers, on a synthetic trace."""

import pytest

from hevcbench import devtrace
from hevcbench.metrics import device_idle_pct, me_sad_roofline_pct
from hevcbench.roofline import sweep_bound
from hevcbench.run import TraceData

K = devtrace.Kernel


def _trace():
    kernels = [K("a", 0, 100), K("b", 50, 150), K("coarse_sweep_kernel",
                                                  400, 410),
               K("a", 1000, 1100)]
    ranges = [("pipeline", 0, 2000), ("serialize", 500, 900)]
    return devtrace.DeviceTrace(kernels, ranges, wall_s=0.002)


def test_busy_is_the_union_and_gaps_are_named_by_the_innermost_span():
    tr = _trace()
    assert tr.busy_s == pytest.approx(260e-6)
    gaps = devtrace.idle_gaps(tr)
    assert gaps[0] == ["serialize", pytest.approx(590e-6)]
    assert gaps[1] == ["pipeline", pytest.approx(250e-6)]
    assert devtrace.top_kernels(tr)[0] == ["a", pytest.approx(200e-6)]


def test_the_readers_of_the_trace():
    shape = ((360, 640), 1, 392 * 672, 16, 8)
    t = TraceData([], [], {}, {}, _trace(), {"me_sad": [shape]}, {}, 132,
                  1.98e9)
    assert device_idle_pct.read(t) == pytest.approx(100 * (2000 - 260)
                                                    / 2000)
    bound_ms = sweep_bound(360 * 640, 1, 392 * 672, 16, 8, 132, 1.98e9)[0]
    assert me_sad_roofline_pct.read(t) == pytest.approx(bound_ms / 0.010
                                                        * 100)
    # a sweep call with no kernel in the trace reads nothing
    t.records["me_sad"] = [shape, shape]
    assert me_sad_roofline_pct.read(t) is None
    assert device_idle_pct.read(TraceData([], [], {}, {}, None, {}, {},
                                          None, None)) is None
