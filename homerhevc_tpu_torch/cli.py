"""Command-line encoder app of the port: the twin of homerhevc_tpu/cli.py
(parity with the reference homer_app, src/homer_app/homer_app.c:
parse_args :126, main :363, defaults :307-337), with the same arguments,
defaults and output lines, plus -device.

Usage:
    python -m homerhevc_tpu_torch.cli -i in.yuv -o out.265 \\
        -widthxheight 1280x720 ... [-device cuda|cpu]

The encoder runs on the card unless -device cpu is given. Every
configuration these arguments can express encodes (the port refuses only
more than one device, which the CLI cannot ask for).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import (BitrateMode, EncoderConfig,
                                        MEPrecision, PerformanceMode, RDMode)
from homerhevc_tpu_torch.tools.p_frame_ops import read_yuv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="homerhevc_tpu_torch",
        description="HEVC encoder on an NVIDIA card (PyTorch + CUDA port of "
                    "homerhevc_tpu; HomerHEVC-compatible CLI). The fps line "
                    "counts from the first frame read, so in a fresh "
                    "process it includes the first P frame's nvcc build of "
                    "csrc/me_sad.cu (once per process) and, when "
                    "homerhevc_tpu_torch/_build/ holds no library yet, the "
                    "first frame's g++ build of the native CABAC.")
    p.add_argument("-i", dest="infile", required=True, help="input yuv file")
    p.add_argument("-o", dest="outfile", required=True, help="output 265 file")
    p.add_argument("-o-raw", dest="rawfile", default=None,
                   help="output reconstructed frames (yuv)")
    p.add_argument("-widthxheight", dest="size", default="1280x720")
    p.add_argument("-frame_rate", type=float, default=25.0)
    p.add_argument("-cu_size", type=int, default=16,
                   help="CTB size (16/32/64); 32 and 64 need -intra_rdo 1")
    p.add_argument("-intra_period", type=int, default=100)
    p.add_argument("-gop_size", type=int, default=1,
                   help="0=all intra, 1=IPPP")
    p.add_argument("-num_b", type=int, default=0,
                   help="B frames between references (0 or 1; 1 = IBP)")
    p.add_argument("-num_ref_frames", type=int, default=1)
    p.add_argument("-qp", type=int, default=32)
    p.add_argument("-motion_estimation_precision", type=int, default=2,
                   help="0=pel 1=half 2=quarter")
    p.add_argument("-me_range", type=int, default=32,
                   help="full-pel ME reach; >32 adds the 4x-decimated FAR "
                        "pyramid level (reference window +-128x64, "
                        "hmr_private.h:76)")
    p.add_argument("-chroma_qp_offset", type=int, default=2)
    p.add_argument("-sign_hiding", type=int, default=1)
    p.add_argument("-sao", type=int, default=1,
                   help="sample adaptive offset (reference default on)")
    p.add_argument("-deblocking", type=int, default=1)
    p.add_argument("-aq", type=float, default=0.0,
                   help="adaptive quantization strength (per-CTB "
                        "cu_qp_delta; 0 = off; needs -deblocking 0)")
    p.add_argument("-rc_ctu", type=int, default=0,
                   help="row-granular rate-control QP via cu_qp_delta "
                        "(reference per-CTU RC analog, "
                        "hmr_rate_control.c:266-347); needs CBR/VBR")
    p.add_argument("-rd_mode", type=int, default=2,
                   help="0=dist only, 1=full (NxN+TU tree+chroma RDO; not "
                        "ported), 2=fast")
    p.add_argument("-intra_rdo", type=int, default=0,
                   help="intra CU-tree RDO (cu_size >= 32)")
    p.add_argument("-intra_in_p", type=int, default=0,
                   help="per-CU intra fallback inside P frames")
    p.add_argument("-wpp", type=int, default=0,
                   help="wavefront parallel processing: one CABAC "
                        "substream per CTU row (reference "
                        "wfpp_enable, homer_app.c)")
    p.add_argument("-scaling_lists", type=int, default=0,
                   help="default quantization scaling lists "
                        "(reference scaling_list_enabled_flag)")
    p.add_argument("-gpb", type=int, default=0,
                   help="generalized-B P frames: two-list t-1/t-2 "
                        "prediction with per-CU uni/bi")
    p.add_argument("-performance_mode", type=int, default=0,
                   help="0=full computation 1=fast (early skip) "
                        "2=ufast (early skip + min CU depth 1)")
    p.add_argument("-bitrate_mode", type=int, default=0,
                   help="0=FIXED_QP 1=CBR 2=VBR")
    p.add_argument("-scene_change", type=int, default=1,
                   help="1=reinit GOP (IDR) + RC pivot on scene change "
                        "(reference -scene_change, homer_app.c:274)")
    p.add_argument("-bitrate", type=int, default=1250, help="kbps")
    p.add_argument("-vbv_size", type=float, default=1.0)
    p.add_argument("-vbv_init", type=float, default=0.35)
    p.add_argument("-n_frames", type=int, default=1000)
    p.add_argument("-skipped_frames", type=int, default=0)
    p.add_argument("-n_frames_in_flight", type=int, default=8,
                   help="device frame batch (all-intra only)")
    p.add_argument("-device", default="cuda",
                   help="torch device of the encoder: cuda (default; "
                        "raises without a card) or cpu (the plain path)")
    p.add_argument("-profile", action="store_true",
                   help="print a host pipeline stage breakdown at exit "
                        "(reference PROFILER_PRINT analog, hmr_profiler.h:29)")
    p.add_argument("-psnr", action="store_true",
                   help="compute per-frame and average Y/U/V PSNR "
                        "(reference COMPUTE_METRICS analog, hmr_metics.c:53;"
                        " reads every reconstruction back, slows encoding)")
    p.add_argument("-trace", action="store_true",
                   help="per-frame result trace line (reference "
                        "DBG_TRACE_RESULTS analog, hmr_encoder_lib.c:3337)")
    return p


def config_from_args(args) -> EncoderConfig:
    """The EncoderConfig of parsed arguments (the JAX CLI's mapping)."""
    w, h = (int(t) for t in args.size.split("x"))
    return EncoderConfig(
        width=w, height=h, frame_rate=args.frame_rate, cu_size=args.cu_size,
        intra_period=args.intra_period, gop_size=args.gop_size,
        num_b=args.num_b, num_ref_frames=args.num_ref_frames, qp=args.qp,
        motion_estimation_precision=MEPrecision(
            args.motion_estimation_precision),
        me_range=args.me_range,
        chroma_qp_offset=args.chroma_qp_offset,
        sign_hiding=bool(args.sign_hiding), sao=bool(args.sao),
        deblocking=bool(args.deblocking), intra_rdo=bool(args.intra_rdo),
        intra_in_p=bool(args.intra_in_p), rd_mode=RDMode(args.rd_mode),
        bitrate_mode=BitrateMode(args.bitrate_mode),
        bitrate_kbps=args.bitrate, vbv_size=args.vbv_size,
        vbv_init=args.vbv_init, aq_strength=args.aq,
        rc_ctu=bool(args.rc_ctu),
        wpp=bool(args.wpp), scaling_lists=bool(args.scaling_lists),
        gpb=bool(args.gpb),
        performance_mode=PerformanceMode(args.performance_mode),
        reinit_gop_on_scene_change=bool(args.scene_change),
        num_frames_in_flight=args.n_frames_in_flight)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    w, h = cfg.width, cfg.height
    enc = Encoder(cfg, device=args.device)
    total_bits = 0
    n_done = 0
    tracker = None
    if args.psnr:
        from homerhevc_tpu_torch.utils.metrics import PsnrTracker
        tracker = PsnrTracker()
    srcs = {}    # display poc -> source planes (PSNR mode only)
    t0 = None
    with contextlib.ExitStack() as files:
        rawf = (files.enter_context(open(args.rawfile, "wb"))
                if args.rawfile else None)
        fin = files.enter_context(open(args.infile, "rb"))
        fout = files.enter_context(open(args.outfile, "wb"))
        fin.seek(args.skipped_frames * w * h * 3 // 2)
        if args.profile:
            from homerhevc_tpu_torch.utils.profiler import PROFILER
            files.enter_context(PROFILER.enabled())

        def handle(ef):
            nonlocal total_bits, n_done
            fout.write(ef.annex_b())
            total_bits += ef.bits
            if rawf is not None:
                rawf.write(ef.recon["y"].tobytes())
                rawf.write(ef.recon["u"].tobytes())
                rawf.write(ef.recon["v"].tobytes())
            if tracker is not None:
                sp = srcs.pop(ef.poc)
                vals = tracker.add(sp, (ef.recon["y"], ef.recon["u"],
                                        ef.recon["v"]))
                print(f"POC {ef.poc} {ef.frame_type} PSNR "
                      f"Y {vals[0]:.2f} U {vals[1]:.2f} V {vals[2]:.2f}")
            if args.trace:
                from homerhevc_tpu_torch.utils.metrics import frame_trace
                print(frame_trace(ef, enc._pipeline.rc.fullness))
            n_done += 1

        for k, (y, u, v) in enumerate(read_yuv(fin, w, h, args.n_frames)):
            if tracker is not None:
                srcs[k] = (y, u, v)
            if t0 is None:
                t0 = time.time()
            for ef in enc.encode(y, u, v):
                handle(ef)
        for ef in enc.flush():
            handle(ef)
        if enc.device.type == "cuda":
            torch.cuda.synchronize(enc.device)
        dt = max(time.time() - (t0 or time.time()), 1e-9)
    kbps = total_bits * cfg.frame_rate / max(n_done, 1) / 1000.0
    print(f"{n_done} frames in {dt*1000:.0f} ms: {n_done/dt:.2f} fps, "
          f"{kbps:.0f} kbps")
    if tracker is not None and tracker.n:
        ay, au, av = tracker.average
        print(f"average PSNR Y {ay:.2f} U {au:.2f} V {av:.2f}")
    if args.profile:
        print(PROFILER.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
