"""Headline benchmark of the port: 720p all-intra encode fps (the full
pipeline: device analysis and host entropy coding), the twin of the
repo's bench.py.

    python3 -m homerhevc_tpu_torch.tools.bench [--device cuda|cpu]
        [--frames 256] [--in-flight 32] [--size 1280x720] [--stages]

720p all-intra CU16 at QP 32, sign hiding on, SAO and deblocking off,
32 frames in flight; two batches warm the encoder (CUDA context, the
native CABAC library, caches), then 256 frames of the bench clip are
timed from the first submitted frame to the last emitted one, with the
card synchronised before each clock read. --frames, --in-flight and
--size shrink the run (the metric keeps its name). Runs on the card
unless --device cpu is given.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline"}.
vs_baseline divides by 3.59 fps, the reference C encoder (HomerHEVC,
all-intra 720p) on one CPU core with SSE4.2 (BASELINE.md): a CPU number
of that encoder, neither this card's nor a TPU's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

BASELINE_FPS = 3.59  # reference all-intra 720p on one CPU core (BASELINE.md)


def run(device: str = "cuda", frames: int = 256, in_flight: int = 32,
        size: str = "1280x720", stages: bool = False) -> dict:
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.config import EncoderConfig
    from homerhevc_tpu_torch.device import resolve_device
    from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    dev = resolve_device(device)
    w, h = (int(t) for t in size.split("x"))
    clip = bench_clip(w, h, frames, 42)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = EncoderConfig(width=w, height=h, qp=32, gop_size=0, sao=False,
                        deblocking=False, sign_hiding=True, cu_size=16,
                        num_frames_in_flight=in_flight)
    enc = Encoder(cfg, device=dev)
    # warm-up: two batches through the same encoder
    for f in clip[:2 * in_flight]:
        list(enc.encode(*f))
    list(enc.flush())
    sync()
    PROFILER.reset()
    t0 = time.perf_counter()
    total_bits = 0
    nf = 0
    for f in clip:
        for ef in enc.encode(*f):
            total_bits += ef.bits
            nf += 1
    for ef in enc.flush():
        total_bits += ef.bits
        nf += 1
    sync()
    dt = time.perf_counter() - t0
    fps = nf / dt
    if stages:
        print(PROFILER.report(), file=sys.stderr)
        print(f"bits/frame: {total_bits / nf:.0f}", file=sys.stderr)
    return {"metric": "720p_allintra_encode_fps", "value": round(fps, 3),
            "unit": "fps", "vs_baseline": round(fps / BASELINE_FPS, 3)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--in-flight", type=int, default=32)
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--stages", action="store_true",
                    help="print the host stage profile and bits/frame to "
                         "stderr")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.frames, a.in_flight, a.size,
                         a.stages)), flush=True)


if __name__ == "__main__":
    main()
