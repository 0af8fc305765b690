"""The clip is a function of the seed and the frame index."""

import numpy as np

from hevcbench.clip import Clip


def test_same_seed_same_clip_other_seed_other_clip():
    big = 2 ** 31 + 12345
    a, b, c = Clip(96, 64, big), Clip(96, 64, big), Clip(96, 64, big + 1)
    for t in (0, 1, 17):
        fa, fb, fc = a.frame(t), b.frame(t), c.frame(t)
        for pa, pb in zip(fa, fb):
            assert np.array_equal(pa, pb)
        assert not np.array_equal(fa[0], fc[0])
    assert [p.shape for p in a.frame(3)] == [(64, 96), (32, 48), (32, 48)]
    assert all(p.dtype == np.uint8 for p in a.frame(3))


def test_frames_move_and_repeat_on_request():
    clip = Clip(96, 64, 5)
    f3 = clip.frame(3)[0].copy()
    assert not np.array_equal(clip.frame(4)[0], f3)
    assert np.array_equal(clip.frame(3)[0], f3)
