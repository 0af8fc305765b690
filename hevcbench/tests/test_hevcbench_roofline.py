"""The frozen sweep bound: 720p at R = 16 moves 16.2 MB, 0.0048 ms at
3.35 TB/s (PERF.md's kernel table), bound by bytes."""

import pytest

from hevcbench.roofline import sweep_bound


def test_sweep_bound_at_720p_r16():
    gh, gw, m, R = 45, 80, 8, 16
    sd = gh * m * gw * m                      # the decimated 720p plane
    rp = (gh * m + 2 * R) * (gw * m + 2 * R)  # its padded reference
    ms, what, nbytes = sweep_bound(sd, 1, rp, R, m, sms=132,
                                   clock_hz=1.98e9)
    assert nbytes / 1e6 == pytest.approx(16.2, abs=0.05)
    assert ms == pytest.approx(0.0048, abs=0.00005)
    assert what == "bytes"
