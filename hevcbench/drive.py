"""The closed-loop client: one stream, the next frame submitted as soon as
`Encoder.encode` returns (a file or VOD transcode), and the arithmetic of
the window's end-to-end metrics."""

from __future__ import annotations

import dataclasses
import math
import time


@dataclasses.dataclass
class Emitted:
    poc: int
    ftype: str
    bits: int
    t_submit: float
    t_emit: float
    phase: str
    ef: object          # the EncodedFrame (its NALs and lazy recon)


class Client:
    """Submits clip frames in order to an Encoder and keeps what it
    emits, by POC. spans: a spans.Spans to record each encode call in
    (traced runs), or None."""

    def __init__(self, enc, clip, spans=None):
        self.enc, self.clip, self.spans = enc, clip, spans
        self.next = 0
        self.t_submit: dict[int, float] = {}
        self.frames: dict[int, Emitted] = {}
        self.order: list[int] = []       # POCs in emission order

    def _take(self, it, phase):
        for ef in it:
            t = time.perf_counter()
            self.frames[ef.poc] = Emitted(
                ef.poc, ef.frame_type, ef.bits,
                self.t_submit.get(ef.poc, float("nan")), t, phase, ef)
            self.order.append(ef.poc)

    def submit(self, phase: str) -> None:
        i = self.next
        y, u, v = self.clip.frame(i)
        self.t_submit[i] = time.perf_counter()
        if self.spans is None:
            self._take(self.enc.encode(y, u, v), phase)
        else:
            with self.spans.span("pipeline"):
                self._take(self.enc.encode(y, u, v), phase)
        self.next = i + 1

    def run(self, n: int, phase: str) -> None:
        for _ in range(n):
            self.submit(phase)

    def window(self, seconds: float, period: int):
        """Submit until `seconds` have passed, the frames submitted fill
        whole periods and some frame has come out; returns (t0, t1) of
        the window."""
        t0 = time.perf_counter()
        n0 = len(self.order)
        while True:
            self.submit("window")
            if (self.next % period == 0 and len(self.order) > n0
                    and time.perf_counter() - t0 >= seconds):
                break
        return t0, time.perf_counter()

    def flush(self, phase: str = "drain") -> None:
        self._take(self.enc.flush(), phase)

    def in_phase(self, phase: str) -> list[Emitted]:
        return [self.frames[p] for p in self.order
                if self.frames[p].phase == phase]


def p95(values) -> float:
    """The 95th percentile by the nearest-rank rule: the smallest value
    with at least 95 % of the values at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def end_to_end(frames: list[Emitted], t0: float, t1: float,
               frame_rate: float) -> dict:
    """fps, frame_p95_ms and kbps of the frames emitted in the window."""
    n = len(frames)
    return {
        "fps": n / (t1 - t0),
        "frame_p95_ms": p95([(f.t_emit - f.t_submit) * 1e3 for f in frames]),
        "kbps": sum(f.bits for f in frames) / n * frame_rate / 1e3,
    }
