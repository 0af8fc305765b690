"""Count the aten operations one P frame (or bi frame) of the port
dispatches.

    python3 -m homerhevc_tpu_torch.tools.p_frame_ops [--device cuda]
        [--size 256x128] [--cu 64] [--perf 0] [--no-sao] [--no-deblock]
        [--bi] [--aq]

A TorchDispatchMode sees every aten operation that
TorchInterEncoder.dispatch runs for one P frame (IPPP, intra_rdo,
deblocking, SAO and sign hiding at QP 32, the configuration of
chip_smoke.py's path C; --no-sao and --no-deblock turn SAO and
deblocking off), or with --bi
TorchInterEncoder.dispatch_b for one bi-capable frame (IBP at CTU 32,
search 24: chip_smoke.py's path D), or with --aq one P frame with a
per-CTB QP map (deblocking off, as a map needs; the map aq_qp_map gives
the frame at strength 2: chip_smoke.py's path E), after one frame that
warms the caches, on chip_smoke.py's bench clip. On a CUDA device most
operations that are not views launch one kernel (a view launches none, a
few operations none or two), so their count approximates the launches of
a P frame before it runs on the card. The device is the card unless
--device cpu is given. One JSON line: the configuration, the device, all
operations and those that are not views.
"""

from __future__ import annotations

import argparse
import json
from collections import Counter

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


class OpCounter(TorchDispatchMode):
    """Counts aten operations under `stage` (all, and those not views)."""

    def __init__(self):
        super().__init__()
        self.stage = "other"
        self.ops = Counter()
        self.compute = Counter()

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops[self.stage] += 1
        if not func.is_view:
            self.compute[self.stage] += 1
        return func(*args, **(kwargs or {}))


def p_frame_config(w: int, h: int, cu: int, perf: int = 0,
                   sao: bool = True, gop_size: int = 1,
                   deblocking: bool = True):
    """chip_smoke.py path C's configuration at w x h (path D's with
    gop_size 2)."""
    from homerhevc_tpu_torch.config import EncoderConfig
    return EncoderConfig(width=w, height=h, cu_size=cu, gop_size=gop_size,
                         intra_period=0, qp=32, intra_rdo=True,
                         sign_hiding=True, deblocking=deblocking, sao=sao,
                         me_range=32, performance_mode=perf)


def bench_clip(w: int, h: int, n: int, seed: int = 42):
    """n frames (y, u, v) of a moving texture over gradients, with moving
    chroma waves: the clip every phase of chip_smoke.py encodes."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tex = (rng.rand(h, w) * 40).astype(np.float32)
    out = []
    for t in range(n):
        y = np.clip(60 + 0.08 * xx + 0.05 * yy
                    + 30 * np.sin(xx / 37.0 + t * 0.3)
                    + np.roll(tex, t * 4, axis=1), 0, 255).astype(np.uint8)
        u = np.clip(128 + 20 * np.sin(xx[::2, ::2] / 53.0 + t * 0.2),
                    0, 255).astype(np.uint8)
        v = np.clip(128 + 20 * np.cos(yy[::2, ::2] / 41.0 - t * 0.1),
                    0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


def write_yuv(path, frames) -> None:
    """Write frames (y, u, v) as raw 8-bit YUV 4:2:0."""
    with open(path, "wb") as f:
        for y, u, v in frames:
            f.write(y.tobytes() + u.tobytes() + v.tobytes())


def read_yuv(src, w: int, h: int, n: int | None = None):
    """Yield up to n frames (y, u, v) of raw 8-bit YUV 4:2:0, one frame
    read at a time; src is a path or a binary file open at the first
    frame to read. Stops at the end or at a partial frame."""
    if not hasattr(src, "read"):
        with open(src, "rb") as f:
            yield from read_yuv(f, w, h, n)
        return
    fsz = w * h * 3 // 2
    k = 0
    while n is None or k < n:
        buf = src.read(fsz)
        if len(buf) < fsz:
            return
        raw = np.frombuffer(buf, np.uint8)
        yield (raw[:w * h].reshape(h, w),
               raw[w * h:w * h * 5 // 4].reshape(h // 2, w // 2),
               raw[w * h * 5 // 4:].reshape(h // 2, w // 2))
        k += 1


def count_p_frame(enc, src, ref, qp_map=None):
    """(all aten operations, those not views) of one enc.dispatch."""
    return _count(enc, lambda: enc.dispatch(src, ref, qp_map=qp_map))


def count_b_frame(enc, src, ref0, ref1):
    """(all aten operations, those not views) of one enc.dispatch_b."""
    return _count(enc, lambda: enc.dispatch_b(src, ref0, ref1))


def _count(enc, dispatch):
    counter = OpCounter()
    with counter:
        dispatch()
    if enc.device.type == "cuda":
        torch.cuda.synchronize()
    return sum(counter.ops.values()), sum(counter.compute.values())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="256x128")
    ap.add_argument("--cu", type=int, default=64)
    ap.add_argument("--perf", type=int, default=0)
    ap.add_argument("--no-sao", action="store_true")
    ap.add_argument("--bi", action="store_true")
    ap.add_argument("--no-deblock", action="store_true")
    ap.add_argument("--aq", action="store_true")
    a = ap.parse_args()
    from homerhevc_tpu_torch.device import resolve_device
    from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
    from homerhevc_tpu_torch.engine.rate_control import aq_qp_map
    from homerhevc_tpu_torch.hevc.headers import ParamSets
    from homerhevc_tpu_torch.state import reference_from_numpy
    device = resolve_device(a.device)
    w, h = (int(s) for s in a.size.split("x"))
    cfg = p_frame_config(w, h, a.cu, a.perf, sao=not a.no_sao,
                         gop_size=2 if a.bi else 1,
                         deblocking=not (a.aq or a.no_deblock))
    enc = TorchInterEncoder(ParamSets.from_config(cfg), cfg,
                            search=24 if a.bi else 16, device=device)
    frames = bench_clip(w, h, 4)
    ref = reference_from_numpy(frames[0], device)
    if a.bi:
        ref1 = reference_from_numpy(frames[3], device)
        enc.dispatch_b(frames[1], ref, ref1)           # warm-up
        ops, compute = count_b_frame(enc, frames[2], ref, ref1)
    else:
        qp_map = (aq_qp_map(frames[2][0], cfg.ctu_size, cfg.qp, 2.0)
                  if a.aq else None)
        enc.dispatch(frames[1], ref, qp_map=qp_map)    # warm-up
        ops, compute = count_p_frame(enc, frames[2], ref, qp_map)
    print(json.dumps({"size": a.size, "cu": a.cu, "perf": a.perf,
                      "sao": not a.no_sao, "deblocking": cfg.deblocking,
                      "bi": a.bi, "aq": a.aq,
                      "device": str(device), "aten_ops": ops,
                      "not_views": compute}), flush=True)


if __name__ == "__main__":
    main()
