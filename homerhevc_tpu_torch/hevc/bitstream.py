"""Raw bitstream writer: Exp-Golomb, byte alignment, EBSP escaping, NAL units.

Parity with reference: hmr_bitstream.c (hmr_bitstream_write_bits :62,
ue(v)/se(v) :78-97, alignment :101-118, EBSP emulation prevention :123-152,
NALU header :155-161) — re-implemented from the H.265 spec (clauses 7.3/7.4,
Annex B); byte-oriented accumulator instead of the reference's word buffer.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit packer accumulating into a bytearray."""

    __slots__ = ("buf", "_acc", "_nbits")

    def __init__(self) -> None:
        self.buf = bytearray()
        self._acc = 0  # bit accumulator, MSB-aligned within _nbits
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        assert 0 <= value < (1 << nbits), (value, nbits)
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self.buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_ue(self, value: int) -> None:
        """ue(v): unsigned Exp-Golomb."""
        assert value >= 0
        code = value + 1
        length = code.bit_length()
        self.write(0, length - 1)
        self.write(code, length)

    def write_se(self, value: int) -> None:
        """se(v): signed Exp-Golomb (0,1,-1,2,-2,... -> 0,1,2,3,4,...)."""
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    def write_byte_alignment(self) -> None:
        """rbsp_trailing_bits: stop bit then zero-pad to byte boundary."""
        self.write(1, 1)
        self.align_zero()

    def align_zero(self) -> None:
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def align_one(self) -> None:
        while self._nbits:
            self.write(1, 1)

    @property
    def bitpos(self) -> int:
        return len(self.buf) * 8 + self._nbits

    def append_bytes(self, data: bytes) -> None:
        assert self._nbits == 0, "append_bytes requires byte alignment"
        self.buf.extend(data)

    def get_bytes(self) -> bytes:
        assert self._nbits == 0, "unaligned bitstream"
        return bytes(self.buf)


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


def ebsp_escape(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte per H.265 7.4.2 / Annex B.

    Any 0x000000 / 0x000001 / 0x000002 / 0x000003 pattern in the RBSP becomes
    0x000003xx. (reference: hmr_bitstream.c:123-152)
    """
    pos = _ebsp_positions(rbsp)
    if not pos:
        return bytes(rbsp)
    out = bytearray()
    prev = 0
    for i in pos:
        out.extend(rbsp[prev:i])
        out.append(3)
        prev = i
    out.extend(rbsp[prev:])
    return bytes(out)


def ebsp_row_escapes(payload: bytes, row_sizes: list) -> list:
    """Per-row emulation-prevention byte counts for WPP entry points.

    entry_point_offset_minus1 counts bytes of the *escaped* slice data
    (spec 7.4.7.1), so each raw substream size must be corrected by the
    number of 0x03 escapes inserted inside its span (reference:
    count_needed_start_codes, hmr_headers.c:626). The scan runs over the
    whole concatenated payload so zero-runs crossing a row boundary are
    attributed to the row containing the triggering byte. The slice header
    always ends with a nonzero byte (alignment stop bit), so the initial
    zero-run is 0.
    """
    import numpy as np
    pos = _ebsp_positions(payload)
    bounds = np.cumsum(np.asarray(row_sizes, np.int64))
    counts = [0] * len(row_sizes)
    for r in np.searchsorted(bounds, np.asarray(pos, np.int64),
                             side="right").tolist():
        counts[r] += 1
    return counts


# H.265 NAL unit types (Table 7-1)
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_TSA_N = 2
NAL_TSA_R = 3
NAL_STSA_N = 4
NAL_STSA_R = 5
NAL_RADL_N = 6
NAL_RADL_R = 7
NAL_RASL_N = 8
NAL_RASL_R = 9
NAL_BLA_W_LP = 16
NAL_BLA_W_RADL = 17
NAL_BLA_N_LP = 18
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_EOS = 36
NAL_EOB = 37
NAL_FD = 38
NAL_SEI_PREFIX = 39
NAL_SEI_SUFFIX = 40


def make_nal(nal_type: int, rbsp: bytes, layer_id: int = 0, temporal_id: int = 0) -> bytes:
    """2-byte NAL header + EBSP-escaped payload (no start code)."""
    hdr = bytes([
        (nal_type << 1) | (layer_id >> 5),
        ((layer_id & 0x1F) << 3) | (temporal_id + 1),
    ])
    return hdr + ebsp_escape(rbsp)


def annex_b(nals: list[bytes]) -> bytes:
    """Concatenate NAL units with Annex-B start codes.

    4-byte start code before parameter sets / first NAL of an AU, 3-byte
    otherwise (reference behaviour: hmr_encoder_lib.c HOMER_enc_write_annex_b_output).
    We use 4-byte codes everywhere for robustness.
    """
    out = bytearray()
    for nal in nals:
        out.extend(b"\x00\x00\x00\x01")
        out.extend(nal)
    return bytes(out)
