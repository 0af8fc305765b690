# Frozen copy of `_ebsp_positions` in homerhevc_tpu_torch/hevc/bitstream.py
# (lines 74-96), for the benchmark's plain reference decoder: where a
# slice's escaped bytes lie, to find its data after the header.
"""Emulation-prevention positions of an RBSP (H.265 7.4.2)."""

from __future__ import annotations


def _ebsp_positions(rbsp) -> list:
    """Byte indexes i where an emulation_prevention_three_byte must be
    inserted *before* rbsp[i] (H.265 7.4.2): the sequential scan escapes
    whenever two counted zeros precede a byte <= 3, and each escape resets
    the zero counter. Vectorized: candidate positions (00 00 0x patterns)
    come from one numpy pass; the escape-resets-the-run rule then thins
    candidates with a tiny loop (an escape at i consumes the run, so the
    next escape needs two fresh zero bytes: j - i >= 2). CABAC payloads
    are high-entropy, so candidates are rare and the loop is O(escapes),
    not O(bytes) — the previous per-byte Python scan dominated the host
    serialize time at 720p."""
    import numpy as np
    b = np.frombuffer(bytes(rbsp), np.uint8)
    if b.size < 3:
        return []
    cand = np.flatnonzero((b[2:] <= 3) & (b[1:-1] == 0) & (b[:-2] == 0)) + 2
    out = []
    last = -2
    for i in cand.tolist():
        if i - last >= 2:
            out.append(i)
            last = i
    return out
