"""The port's scene-change detector (TorchPipeline._scene_change) against
the JAX package's, whose level freezes at its first cut (ROADMAP, faults of
the reference that the port does not copy): on the benchmark's 720p clip,
whose box wraps round the picture, the port declares no cut where the JAX
detector declares one on most frames after the box's jumps; on a small
synthetic scene a jumping box is no cut and a hard cut is one, with none
after it in the new scene."""

import types

import numpy as np
import pytest

from hevcbench.clip import Clip
from homerhevc_tpu.engine.pipeline import EncoderPipeline
from homerhevc_tpu_torch.engine.pipeline import TorchPipeline


def _cuts(detect, frames):
    """The indices of the frames on which `detect` declares a cut, run
    from a fresh state."""
    state = types.SimpleNamespace()
    return [t for t, y in enumerate(frames) if detect(state, y)]


@pytest.mark.parametrize("seed", [1, 2])
def test_the_benchmark_clip_has_no_cut(seed):
    clip = Clip(1280, 720, seed)
    port, ref = types.SimpleNamespace(), types.SimpleNamespace()
    port_cuts, ref_cuts = [], []
    for t in range(420):
        y = clip.frame(t)[0]
        if TorchPipeline._scene_change(port, y):
            port_cuts.append(t)
        if EncoderPipeline._scene_change(ref, y):
            ref_cuts.append(t)
    assert port_cuts == []
    # the reference's level froze at the box's first wrap (frame 144)
    assert min(ref_cuts) == 144
    assert sum(200 <= t < 400 for t in ref_cuts) >= 50


def _scene(seed, n, w=256, h=144):
    """A texture rolling 4 px a frame with noise that slowly grows (a MAD
    of about 19.6 that creeps up) and a box of 2 % of the picture that
    jumps every 8 frames, raising the MAD by about 8 %, as the 720p clip's
    box does when it wraps."""
    rng = np.random.RandomState(seed)
    tex = rng.randint(60, 120, (h, 2 * w))
    bw, bh = w // 8, h // 6
    out = []
    for t in range(n):
        s = (4 * t) % w
        y = tex[:, s:s + w] + rng.normal(0, 2 + 0.01 * t, (h, w))
        bx = (119 * (t // 8)) % (w - bw)
        by = (55 * (t // 8)) % (h - bh)
        y[by:by + bh, bx:bx + bw] = 135
        out.append(np.clip(y, 0, 255).astype(np.uint8))
    return out


def test_a_jumping_box_is_no_cut_and_a_hard_cut_is_one():
    steady = _scene(5, 40)
    after = [255 - y for y in _scene(6, 11)]      # a new, inverted scene
    assert _cuts(TorchPipeline._scene_change, steady + after) == [40]
    # the reference cuts on the box's jumps once its deviation has decayed
    assert {24, 32} <= set(_cuts(EncoderPipeline._scene_change, steady))
