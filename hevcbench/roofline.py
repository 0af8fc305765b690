"""The sweep kernel's least time on the card, from the shapes of a call.

Frozen copy of `sweep_bound` in chip_smoke.py (lines 424-444) and of its
constants (lines 137-139): the larger of the bytes time (each input byte
read and each int32 output written once, at the HBM rate) and the
operations time (2 operations, |a - b| and the add, per 8-bit sample pair,
at the integer lanes' rate for packed bytes: SMs x 64 lanes x the maximum
SM clock x 8 operations per vabsdiff4 .add). A SAD cannot use the tensor
cores, so their int8 peak is no rate for it. Here the shapes arrive as
numbers (from the benchmark's wrapper of the call) and the card's SM count
and clock as arguments, so the arithmetic runs, and is tested, without a
card.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
INT32_LANES_PER_SM = 64       # Hopper SM: 64 INT32 lanes per clock
OPS_PER_PACKED_LANE = 8       # vabsdiff4 .add: 4 pairs of |a - b| + add


def sweep_bound(sd_numel: int, sd_itemsize: int, rp_numel: int, R: int,
                m: int, sms: int, clock_hz: float, extra_bytes: int = 0):
    """(least ms, "bytes" or "operations", bytes) of one sweep of a source
    of sd_numel samples against a padded reference of rp_numel bytes, at
    search radius R over m x m blocks."""
    side = 2 * R + 1
    nbytes = (sd_numel * sd_itemsize + rp_numel + extra_bytes
              + 4 * side * side * sd_numel // (m * m))
    ops = 2 * side * side * sd_numel
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / (sms * INT32_LANES_PER_SM * clock_hz
                    * OPS_PER_PACKED_LANE) * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes)
