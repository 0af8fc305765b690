# Frozen copy of homerhevc_tpu_torch/hevc/cabac_dec.py, lines 1-108, for the
# benchmark's plain reference decoder: later changes to the program
# do not move it. Imports point at the other copies beside it.
"""CABAC arithmetic decoder (spec 9.3.4.3.2) + RBSP bit reader (the port's
copy of homerhevc_tpu/hevc/cabac_dec.py).

Test/debug oracle: parses slice data produced by this encoder (or any
conformant HEVC encoder) so chroma and syntax can be verified bit-exactly
without an external decoder. Not a performance path.
"""

from __future__ import annotations

import numpy as np

from hevcbench.reference.tables import (
    LPS_TABLE, NEXT_STATE_LPS, NEXT_STATE_MPS,
)


def unescape_ebsp(data: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    i = 0
    while i < len(data):
        b = data[i]
        if zeros >= 2 and b == 3 and i + 1 < len(data) and data[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            idx = self.pos >> 3
            # arithmetic-decoder renorm reads a few bits past the written
            # stream near the end; pad with zeros (standard decoder slack)
            byte = self.data[idx] if idx < len(self.data) else 0
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def read_ue(self) -> int:
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
        return (1 << zeros) - 1 + (self.read(zeros) if zeros else 0)

    def read_se(self) -> int:
        k = self.read_ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7


class CabacDecoder:
    def __init__(self, br: BitReader, ctx: np.ndarray):
        self.br = br
        self.ctx = ctx
        self.range = 510
        self.offset = br.read(9)

    def decode_bin(self, ctx_idx: int) -> int:
        state = self.ctx[ctx_idx]
        lps = int(LPS_TABLE[state >> 1, (self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            binval = 1 - int(state & 1)
            self.offset -= self.range
            self.range = lps
            self.ctx[ctx_idx] = NEXT_STATE_LPS[state]
        else:
            binval = int(state & 1)
            self.ctx[ctx_idx] = NEXT_STATE_MPS[state]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.br.read(1)
        return binval

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self.br.read(1)
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bins(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.br.read(1)
        return 0
