"""Time the port's device programs in isolation (the twin of
tools/prof_device.py).

    python3 -m homerhevc_tpu_torch.tools.prof_device [-w 1920] [-ht 1088]
        [-cu 32] [-n 5] [-sao] [-no-deblock] [-intra-in-p] [-perf 0]
        [-probe me,impl,fetch,decide,intra] [-device cuda|cpu]

Each probe runs once to warm up, then n times; on the card the n calls
are timed with CUDA events after torch.cuda.synchronize(), on the CPU
with the host clock. Probes, each on one random frame against a random
reference:
  - me: TorchInterEncoder._hier_me alone (the hierarchical full-pel
    search, the coarse sweep kernel included);
  - impl: the whole P program (TorchInterEncoder.dispatch; on the card
    replayed from its CUDA graphs: an extra eager call comes first, so
    the warm-up call captures);
  - fetch: dispatch and fetch (the wire download and the host syntax);
  - decide: the intra CU-tree decision pass (TorchIntraTreeEncoder.decide,
    its result read back);
  - intra: one intra CU-tree frame (TorchIntraTreeEncoder.encode_frame).
One JSON line per probe: {"probe", "ms", "device", "w", "h", "cu"}.
Runs on the card unless -device cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch


def timeit(fn, n, dev) -> float:
    """Mean ms of fn() over n calls after one warm-up call."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize(dev)
        return t0.elapsed_time(t1) / n
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t) / n * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-w", type=int, default=1920)
    ap.add_argument("-ht", type=int, default=1088)
    ap.add_argument("-cu", type=int, default=32)
    ap.add_argument("-n", type=int, default=5)
    ap.add_argument("-sao", action="store_true")
    ap.add_argument("-no-deblock", action="store_true")
    ap.add_argument("-intra-in-p", action="store_true")
    ap.add_argument("-perf", type=int, default=0,
                    help="performance_mode 0/1/2")
    ap.add_argument("-probe", default="me,impl,fetch")
    ap.add_argument("-device", default="cuda")
    args = ap.parse_args(argv)

    from homerhevc_tpu_torch.config import EncoderConfig, PerformanceMode
    from homerhevc_tpu_torch.device import resolve_device
    from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
    from homerhevc_tpu_torch.hevc import tables as T
    from homerhevc_tpu_torch.hevc.headers import ParamSets

    dev = resolve_device(args.device)
    w, h = args.w, args.ht
    cfg = EncoderConfig(width=w, height=h, qp=32, gop_size=1,
                        cu_size=args.cu, sao=args.sao,
                        deblocking=not args.no_deblock, sign_hiding=True,
                        intra_in_p=args.intra_in_p,
                        performance_mode=PerformanceMode(args.perf))
    ps = ParamSets.from_config(cfg)
    rng = np.random.default_rng(0)
    sy = rng.integers(0, 256, (h, w), np.uint8)
    su = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    sv = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    ry = rng.integers(0, 256, (h, w), np.uint8)
    ru = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    rv = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    probes = set(args.probe.split(","))

    def up(a):
        return torch.as_tensor(a, device=dev)
    src = (up(sy), up(su), up(sv))
    ref = (up(ry), up(ru), up(rv))

    def report(name, fn):
        print(json.dumps({"probe": name, "ms": timeit(fn, args.n, dev),
                          "device": str(dev), "w": w, "h": h,
                          "cu": args.cu}), flush=True)

    if probes & {"me", "impl", "fetch"}:
        enc = TorchInterEncoder(ps, cfg, search=16, device=dev)
    if "me" in probes:
        lam16 = int(T.LAMBDA_ME_X16_TAB[32])
        ry32 = ref[0].to(torch.int32)
        # the source stays uint8: _hier_me takes uint8 or int16 planes
        report("hier_me",
               lambda: enc._eager(enc._hier_me(src[0], ry32, lam16)))
    if "impl" in probes:
        enc.dispatch(src, ref, 1000.0, qp=32)
        report("impl_p", lambda: enc.dispatch(src, ref, 1000.0, qp=32))
    if "fetch" in probes:
        report("dispatch_fetch",
               lambda: enc.fetch(enc.dispatch(src, ref, 1000.0, qp=32)))
    if probes & {"decide", "intra"}:
        from homerhevc_tpu_torch.engine.intra_tree_encoder import \
            TorchIntraTreeEncoder
        cfg_i = dataclasses.replace(cfg, intra_rdo=True)
        ienc = TorchIntraTreeEncoder(ParamSets.from_config(cfg_i), cfg_i,
                                     device=dev)
    if "decide" in probes:
        report("intra_decide", lambda: ienc.decide(sy, su, sv, 32))
    if "intra" in probes:
        report("intra_tree", lambda: ienc.encode_frame(sy, su, sv, 32))


if __name__ == "__main__":
    main()
