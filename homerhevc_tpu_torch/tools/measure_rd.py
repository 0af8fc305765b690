"""RD measurement harness of the port (the twin of tools/measure_rd.py):
encode a raw YUV420 clip with a given config, report fps / kbps /
PSNR(Y,U,V) as one JSON line, and optionally dump the stream.

    python3 -m homerhevc_tpu_torch.tools.measure_rd -i clip.yuv -w 1280 \\
        -ht 720 -n 50 -qp 32 -gop 1 -cu 16 [-sao] [-aq S] [-gpb] \\
        [-nref N] [-me_prec 0|1|2] [-o out.265] [-qps 27,32,37] \\
        [-device cuda|cpu]

Runs on the card unless -device cpu is given (the port picks its host
intra programs by configuration alone, so the JAX tool's -backend has no
counterpart). -me_prec sets the
motion estimation precision (0 full-pel, 1 half, 2 quarter: the CLI's
-motion_estimation_precision). Times are host clock reads with the card
synchronised before each. -qps encodes the clip once per QP in one
process, each pipeline taking the device encoder objects of the one
before (QP is a per-frame input of every device program; nothing built
at construction depends on it but the wire capacities, whose overflow
falls back to full planes with the same bytes).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from homerhevc_tpu_torch.tools.p_frame_ops import read_yuv


def psnr(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = (d * d).mean()
    return 99.0 if mse == 0 else 10 * np.log10(255.0 * 255.0 / mse)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-i", required=True)
    ap.add_argument("-w", type=int, default=1280)
    ap.add_argument("-ht", type=int, default=720)
    ap.add_argument("-n", type=int, default=50)
    ap.add_argument("-qp", type=int, default=32)
    ap.add_argument("-gop", type=int, default=1)
    ap.add_argument("-cu", type=int, default=32)
    ap.add_argument("-fps", type=float, default=25.0)
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-sao", action="store_true")
    ap.add_argument("-no-deblock", action="store_true")
    ap.add_argument("-aq", type=float, default=0.0)
    ap.add_argument("-gpb", action="store_true")
    ap.add_argument("-cqo", type=int, default=2,
                    help="chroma QP offset (pps cb/cr_qp_offset)")
    ap.add_argument("-nref", type=int, default=1)
    ap.add_argument("-intra-in-p", action="store_true")
    ap.add_argument("-intra-rdo", action="store_true")
    ap.add_argument("-scaling-lists", action="store_true")
    ap.add_argument("-num-b", type=int, default=0)
    ap.add_argument("-me_range", type=int, default=32)
    ap.add_argument("-me_prec", type=int, default=2,
                    help="motion estimation precision: 0 full-pel, 1 half, "
                         "2 quarter")
    ap.add_argument("-bitrate", type=int, default=0,
                    help="kbps; >0 selects VBR (bitrate_mode=2) and also "
                         "enables reinit_gop_on_scene_change (the "
                         "reference's VBR default); pass -no-scene-reinit "
                         "to opt out")
    ap.add_argument("-no-scene-reinit", action="store_true",
                    help="disable scene-change GOP reinit under -bitrate")
    ap.add_argument("-cbr", action="store_true",
                    help="with -bitrate: CBR (bitrate_mode=1) instead of VBR")
    ap.add_argument("-rc-ctu", action="store_true",
                    help="row-granular rate control (cfg.rc_ctu)")
    ap.add_argument("-warmup", type=int, default=0,
                    help="encode the first N frames through a throwaway "
                         "pipeline first and hand its device encoder "
                         "objects to the timed one, so that the timed run "
                         "excludes the kernels' builds and first-use costs")
    ap.add_argument("-o", default=None)
    ap.add_argument("-no-metrics", action="store_true",
                    help="skip the recon download and PSNR (pure encode "
                         "throughput)")
    ap.add_argument("-profile", action="store_true",
                    help="trace the timed run's stages and print the "
                         "profiler report to stderr")
    ap.add_argument("-label", default="rd")
    ap.add_argument("-qps", default=None,
                    help="comma list; run each QP reusing the device "
                         "encoder objects")
    return ap


def config(args, qp=None):
    """The EncoderConfig of the arguments (qp: one point of -qps, fixed QP
    with no scene-change reinit, as the JAX tool's sweep)."""
    from homerhevc_tpu_torch.config import (BitrateMode, EncoderConfig,
                                            MEPrecision)
    kw = dict(width=args.w, height=args.ht, gop_size=args.gop,
              cu_size=args.cu, sao=args.sao,
              deblocking=not args.no_deblock, sign_hiding=True,
              intra_period=0 if args.gop else 100,
              aq_strength=args.aq, gpb=args.gpb,
              chroma_qp_offset=args.cqo, num_ref_frames=args.nref,
              intra_in_p=args.intra_in_p, intra_rdo=args.intra_rdo,
              scaling_lists=args.scaling_lists, num_b=args.num_b,
              me_range=args.me_range,
              motion_estimation_precision=MEPrecision(args.me_prec))
    if qp is not None:
        return EncoderConfig(qp=qp, reinit_gop_on_scene_change=False, **kw)
    return EncoderConfig(
        qp=args.qp, rc_ctu=args.rc_ctu,
        bitrate_mode=((BitrateMode.CBR if args.cbr else BitrateMode.VBR)
                      if args.bitrate else BitrateMode.FIXED_QP),
        bitrate_kbps=args.bitrate or 1250, frame_rate=args.fps,
        reinit_gop_on_scene_change=bool(args.bitrate)
        and not args.no_scene_reinit, **kw)


_SHARED = ("_intra_enc", "_inter_enc")


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.qps:
        if args.bitrate:
            ap.error("-qps (fixed-QP sweep) and -bitrate (rate control) "
                     "are mutually exclusive")
        run_multi(args)
        return
    from homerhevc_tpu_torch.device import resolve_device
    from homerhevc_tpu_torch.engine.pipeline import TorchPipeline
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    dev = resolve_device(args.device)
    w, h = args.w, args.ht
    cfg = config(args)
    pipe = TorchPipeline(cfg, dev)
    frames = list(read_yuv(args.i, w, h, max(args.n, args.warmup)))
    if args.warmup > 0:
        # first-use pass: run N frames through a twin pipeline, then hand
        # its device encoder objects to the timed pipeline
        wp = pipe
        pipe = TorchPipeline(cfg, dev)
        for f in frames[:args.warmup]:
            for _ in wp.push(*f):
                pass
        for _ in wp.flush():
            pass
        for k in _SHARED:
            if getattr(wp, k) is not None:
                setattr(pipe, k, getattr(wp, k))
    total_bits = 0
    ps = np.zeros(3)
    nf = 0
    srcs = frames[:args.n]
    with contextlib.ExitStack() as files:
        out = files.enter_context(open(args.o, "wb")) if args.o else None

        def consume(ef):
            nonlocal total_bits, nf
            total_bits += ef.bits
            if out is not None:
                out.write(ef.annex_b())
            if not args.no_metrics:
                with PROFILER.scope("measure_rd.recon"):
                    r = ef.recon
                s = srcs[ef.poc]
                with PROFILER.scope("measure_rd.psnr"):
                    ps[:] += [psnr(r["y"], s[0]), psnr(r["u"], s[1]),
                              psnr(r["v"], s[2])]
            nf += 1

        if args.profile:
            files.enter_context(PROFILER.enabled())
        _sync(dev)
        t0 = time.time()
        for f in srcs:
            for ef in pipe.push(*f):
                consume(ef)
        for ef in pipe.flush():
            consume(ef)
        _sync(dev)
        dt = time.time() - t0
    print(json.dumps(_row(args.label, nf, dt, total_bits, ps, args.fps)),
          flush=True)
    if args.profile:
        print(PROFILER.report(), file=sys.stderr)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _row(label, nf, dt, total_bits, ps, fps):
    n = max(nf, 1)
    return {"label": label, "frames": nf, "fps": round(nf / dt, 2),
            "kbps": round(total_bits * fps / n / 1000.0, 1),
            "psnr_y": round(ps[0] / n, 2), "psnr_u": round(ps[1] / n, 2),
            "psnr_v": round(ps[2] / n, 2)}


def run_multi(args):
    """Encode the clip once per QP in one process, each pipeline taking
    the device encoder objects of the one before (QP is a per-frame
    input, so the first pipeline's kernel builds and caches serve every
    QP)."""
    from homerhevc_tpu_torch.device import resolve_device
    from homerhevc_tpu_torch.engine.pipeline import TorchPipeline
    dev = resolve_device(args.device)
    frames = list(read_yuv(args.i, args.w, args.ht, args.n))
    shared = {}
    for qp in (int(q) for q in args.qps.split(",")):
        pipe = TorchPipeline(config(args, qp), dev)
        for k, v in shared.items():
            setattr(pipe, k, v)
        total_bits = 0
        ps = np.zeros(3)
        nf = 0

        def consume(ef):
            nonlocal total_bits, nf
            total_bits += ef.bits
            r = ef.recon
            s = frames[ef.poc]
            ps[:] += [psnr(r["y"], s[0]), psnr(r["u"], s[1]),
                      psnr(r["v"], s[2])]
            nf += 1

        _sync(dev)
        t0 = time.time()
        for f in frames:
            for ef in pipe.push(*f):
                consume(ef)
        for ef in pipe.flush():
            consume(ef)
        _sync(dev)
        dt = time.time() - t0
        shared = {k: getattr(pipe, k) for k in _SHARED if getattr(pipe, k)}
        print(json.dumps(_row(f"{args.label}_qp{qp}", nf, dt, total_bits,
                              ps, args.fps)), flush=True)


if __name__ == "__main__":
    main()
