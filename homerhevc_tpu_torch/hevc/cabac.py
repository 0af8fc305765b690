"""CABAC binary arithmetic encoder (HM-style) + RDO bit counter.

Python reference implementation of the engine the production path runs in
C++ (homerhevc_tpu/native/). Parity with reference: hmr_binary_encoding.c —
be_encode_bin :173, bypass :98, terminate :209, carry write-out :63,
finish :238; counter twin bc_* :342 — re-derived from spec 9.3.4.3.
"""

from __future__ import annotations

import numpy as np

from homerhevc_tpu_torch.hevc.bitstream import BitWriter
from homerhevc_tpu_torch.hevc.tables import (
    ENTROPY_BITS, LPS_TABLE, NEXT_STATE_LPS, NEXT_STATE_MPS, RENORM_TABLE,
)

_M32 = 0xFFFFFFFF


class CabacEncoder:
    """Binary arithmetic encoder writing into a BitWriter.

    Context states are held externally (numpy uint8 array from
    ctx_tables.init_contexts) so they can be snapshotted/forked for WPP.
    """

    __slots__ = ("bw", "ctx", "low", "range", "bits_left",
                 "num_buffered", "buffered_byte", "bins_coded")

    def __init__(self, bw: BitWriter, ctx: np.ndarray):
        self.bw = bw
        self.ctx = ctx
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.num_buffered = 0
        self.buffered_byte = 0xFF
        self.bins_coded = 0

    # -- engine ------------------------------------------------------------

    def _write_out(self) -> None:
        lead = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= _M32 >> self.bits_left
        if lead == 0xFF:
            self.num_buffered += 1
        elif self.num_buffered > 0:
            carry = lead >> 8
            self.bw.write((self.buffered_byte + carry) & 0xFF, 8)
            self.buffered_byte = lead & 0xFF
            fill = (0xFF + carry) & 0xFF
            for _ in range(self.num_buffered - 1):
                self.bw.write(fill, 8)
            self.num_buffered = 1
        else:
            self.num_buffered = 1
            self.buffered_byte = lead

    def encode_bin(self, ctx_idx: int, binval: int) -> None:
        state = self.ctx[ctx_idx]
        lps = int(LPS_TABLE[state >> 1, (self.range >> 6) & 3])
        self.range -= lps
        self.bins_coded += 1
        if binval != (state & 1):
            nbits = int(RENORM_TABLE[lps >> 3])
            self.low = ((self.low + self.range) << nbits) & _M32
            self.range = lps << nbits
            self.ctx[ctx_idx] = NEXT_STATE_LPS[state]
            self.bits_left -= nbits
        else:
            self.ctx[ctx_idx] = NEXT_STATE_MPS[state]
            if self.range >= 256:
                return
            self.low = (self.low << 1) & _M32
            self.range <<= 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bypass(self, binval: int) -> None:
        self.bins_coded += 1
        self.low = (self.low << 1) & _M32
        if binval:
            self.low = (self.low + self.range) & _M32
        self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bypass_bins(self, value: int, nbins: int) -> None:
        """Multiple bypass bins MSB-first."""
        self.bins_coded += nbins
        while nbins > 8:
            nbins -= 8
            pattern = value >> nbins
            self.low = ((self.low << 8) + self.range * pattern) & _M32
            value -= pattern << nbins
            self.bits_left -= 8
            if self.bits_left < 12:
                self._write_out()
        self.low = ((self.low << nbins) + self.range * value) & _M32
        self.bits_left -= nbins
        if self.bits_left < 12:
            self._write_out()

    def encode_terminate(self, binval: int) -> None:
        self.range -= 2
        self.bins_coded += 1
        if binval:
            self.low = ((self.low + self.range) << 7) & _M32
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low = (self.low << 1) & _M32
            self.range <<= 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def finish(self) -> None:
        """Flush engine state (spec EncodeFlush); leaves bw NOT yet
        rbsp-trailing-aligned — caller writes the stop bit / alignment."""
        if (self.low >> (32 - self.bits_left)) & ((1 << self.bits_left) - 1):
            self.bw.write(self.buffered_byte + 1, 8)
            for _ in range(self.num_buffered - 1):
                self.bw.write(0x00, 8)
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered > 0:
                self.bw.write(self.buffered_byte, 8)
            for _ in range(self.num_buffered - 1):
                self.bw.write(0xFF, 8)
        self.bw.write((self.low >> 8) & ((1 << (24 - self.bits_left)) - 1),
                      24 - self.bits_left)

    # -- helpers -----------------------------------------------------------

    def bit_count(self) -> int:
        return self.bw.bitpos + 8 * self.num_buffered + 23 - self.bits_left


class CabacCounter:
    """RDO bit counter twin: same interface, accumulates fractional bits
    (15-bit fixed point) without producing a bitstream.

    Parity: reference bc_* family (hmr_binary_encoding.c:342, FAST_BIT_EST).
    """

    __slots__ = ("ctx", "frac_bits")

    def __init__(self, ctx: np.ndarray):
        self.ctx = ctx
        self.frac_bits = 0

    def encode_bin(self, ctx_idx: int, binval: int) -> None:
        state = int(self.ctx[ctx_idx])
        self.frac_bits += int(ENTROPY_BITS[state ^ binval])
        if binval != (state & 1):
            self.ctx[ctx_idx] = NEXT_STATE_LPS[state]
        else:
            self.ctx[ctx_idx] = NEXT_STATE_MPS[state]

    def encode_bypass(self, binval: int) -> None:
        self.frac_bits += 1 << 15

    def encode_bypass_bins(self, value: int, nbins: int) -> None:
        self.frac_bits += nbins << 15

    def encode_terminate(self, binval: int) -> None:
        self.frac_bits += int(ENTROPY_BITS[126 ^ binval])

    def bits(self) -> float:
        return self.frac_bits / 32768.0
