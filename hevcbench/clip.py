"""The benchmark's source clip, made from a seed.

Frozen copy of the recipe of `gen_clip` in tools/make_clips.py (lines
23-47), BASELINE.md's RD clip: a random texture rolling 4 px a frame to the
right, a horizontal gradient and a vertical one, a sinusoid drifting with
time, a moving box, and 2-sigma sensor noise on luma (1 sigma on chroma).
Made cheap: the roll is a slice of a texture laid twice side by side, the
sinusoids are one row or column a frame, and the noise cycles through a
few planes drawn once at set-up, so a 720p frame costs a few milliseconds
in place of the original's ~54 ms. The box is 160 x 120 as there, or a
quarter of the picture's width and height where that is smaller, and it
wraps round the picture as there.
"""

from __future__ import annotations

import numpy as np

NOISE_PLANES = 16


class Clip:
    """Frame t of the clip of (w, h) drawn from `seed`: `frame(t)` gives
    uint8 (y, u, v) planes, the same for the same seed and t."""

    def __init__(self, w: int, h: int, seed: int):
        rng = np.random.default_rng(seed)
        self.w, self.h = w, h
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        self.base = (60 + 0.06 * xx + 0.04 * yy).astype(np.float32)
        tex = (rng.random((h, w), dtype=np.float32) * 60).astype(np.float32)
        self.tex2 = np.concatenate([tex, tex], axis=1)
        self.bw, self.bh = min(160, w // 4), min(120, h // 4)
        self.box = (200 - 0.2 * xx[:self.bh, :self.bw]).astype(np.float32)
        self.noise_y = rng.standard_normal((NOISE_PLANES, h, w),
                                           dtype=np.float32) * 2.0
        self.noise_u = rng.standard_normal((NOISE_PLANES, h // 2, w // 2),
                                           dtype=np.float32)
        self.noise_v = rng.standard_normal((NOISE_PLANES, h // 2, w // 2),
                                           dtype=np.float32)
        self.xs = np.arange(w, dtype=np.float32)
        self.cxs = np.arange(w // 2, dtype=np.float32)
        self.cys = np.arange(h // 2, dtype=np.float32)
        self._y = np.empty((h, w), np.float32)
        self._c = np.empty((h // 2, w // 2), np.float32)

    def frame(self, t: int):
        w, h = self.w, self.h
        k = t % NOISE_PLANES
        y = self._y
        s = (-4 * t) % w                      # np.roll(tex, 4 t, axis=1)
        np.add(self.base, self.tex2[:, s:s + w], out=y)
        y += (25 * np.sin(self.xs / 41.0 + t * 0.25))[None, :]
        bx = int(w * 0.2 + t * 6) % (w - self.bw)
        by = int(h * 0.3 + t * 2) % (h - self.bh)
        y[by:by + self.bh, bx:bx + self.bw] = self.box
        y += self.noise_y[k]
        out_y = np.clip(y, 0, 255).astype(np.uint8)
        c = self._c
        np.add(self.noise_u[k],
               (128 + 18 * np.sin(self.cxs / 53.0 + t * 0.2))[None, :], out=c)
        out_u = np.clip(c, 0, 255).astype(np.uint8)
        np.add(self.noise_v[k],
               (128 + 18 * np.cos(self.cys / 47.0 - t * 0.15))[:, None],
               out=c)
        out_v = np.clip(c, 0, 255).astype(np.uint8)
        return out_y, out_u, out_v
