"""Multi-device scale-out: frame and GOP-segment sharding over a mesh of
device slots. Written from homerhevc_tpu/parallel/mesh.py.

The reference's frame engines were threads encoding frames side by side
(hmr_encoder_lib.c:3132, :1646-1648, SURVEY.md §2.6); the JAX package made
them devices of a jax.sharding.Mesh, one sharded vmapped program per step.
Here a mesh is a tuple of torch.device slots. Each slot owns its encoder
objects and reference planes on its device, and its work runs on a host
thread of its own inside that device, on a CUDA stream of its own. The
threads take turns (_Slots): the port's programs are bound by the host's
kernel launches, and CPython runs one thread's Python at a time, so
slot threads cannot launch side by side; left to compete, they hand the
interpreter lock over at nearly every op and run several times slower
than one thread (PERF.md § 6, path I). A slot's launches therefore run back
to back in its turn, while the streams of the slots before it still run
on their devices. Slot d takes the contiguous block
frames[d*k:(d+1)*k], as P("frame") cuts the leading axis. The results come
back in slot order and every frame is emitted (rate control, SAO on the
host, CABAC) on the calling thread in the JAX order, so no byte depends on
the threads' timing. There is no collective: all-intra frames and GOP
segments are independent, so the only traffic is placement and gather,
and no torch.distributed process group is needed.

  - encode_frames_sharded: all-intra, frame-parallel; each frame a
    standalone IDR stream, bit-exact to the single-device pipeline.
  - gop_parallel_encode: IPPP, segment d = frames[d*L:(d+1)*L] coded
    IDR + (L-1) P frames; at step t every slot dispatches frame t of its
    segment and fetches frame t-1, then frame t-1 of every segment is
    emitted: the depth-2 lag of the sequential P chain, which makes each
    segment bit-exact to the sequential pipeline.
  - encode_frames_sharded_dryrun: both, checked against the single-device
    TorchPipeline at 64x32.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading

import numpy as np
import torch

from homerhevc_tpu_torch.device import resolve_device
from homerhevc_tpu_torch.utils.profiler import PROFILER


def make_mesh(n_devices: int, device="cuda") -> tuple:
    """A mesh of n_devices slots, each a torch.device.

    device="cuda": the cards cuda:0 .. cuda:n-1; raises where fewer cards
    exist (jax.devices()[:n] would give a smaller mesh without a word).
    device="cpu": n slots on the CPU (the tests' twin of the virtual
    8-device CPU mesh). A list of n devices, repeats allowed: those slots,
    e.g. ["cuda:0"] * 4 puts four slots on one card; each slot still runs
    on its own host thread and its own CUDA stream.
    """
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one slot, got {n_devices}")
    if isinstance(device, (list, tuple)):
        if len(device) != n_devices:
            raise ValueError(f"{len(device)} devices for a mesh of "
                             f"{n_devices} slots")
        return tuple(resolve_device(d) for d in device)
    d = torch.device(device)
    if d.type == "cpu":
        return (resolve_device("cpu"),) * n_devices
    if d.type != "cuda" or d.index is not None:
        raise ValueError(f"make_mesh takes 'cuda', 'cpu' or a list of "
                         f"devices, got {device!r}")
    resolve_device("cuda")                  # raises without CUDA
    found = torch.cuda.device_count()
    if found < n_devices:
        raise RuntimeError(f"a mesh of {n_devices} cards needs "
                           f"{n_devices} CUDA devices, found {found}")
    return tuple(torch.device("cuda", i) for i in range(n_devices))


class _Slots:
    """One host thread per slot; run(fn) calls fn(d) for every slot d inside
    its device and on its own CUDA stream, waits for all, and returns the
    results in slot order (the first slot's error raised, after every
    slot has finished). Each call of fn runs in its turn, under one lock:
    threads that each release and retake the interpreter lock around
    every small torch op hand it over at nearly every op (4 slot threads
    on one H100 took 16x one thread's time for the same frames), while a
    thread that waits for its turn blocks without asking for it."""

    def __init__(self, mesh):
        self.mesh = tuple(mesh)
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in self.mesh]
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=len(self.mesh), thread_name_prefix="mesh-slot")
        self._turn = threading.Lock()

    def _in_slot(self, fn, d):
        stream = self.streams[d]
        PROFILER.set_role(f"slot{d}")
        with self._turn:
            if stream is None:                   # a CPU slot
                return fn(d)
            with torch.cuda.device(self.mesh[d]), torch.cuda.stream(stream):
                return fn(d)

    def run(self, fn) -> list:
        futs = [self._pool.submit(self._in_slot, fn, d)
                for d in range(len(self.mesh))]
        concurrent.futures.wait(futs)
        return [f.result() for f in futs]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._pool.shutdown(wait=True)


def _mesh_of(cfg, mesh):
    return make_mesh(cfg.num_devices) if mesh is None else tuple(mesh)


def encode_frames_sharded(cfg, frames, mesh=None):
    """Frame-parallel all-intra encode over a mesh (default: the first
    cfg.num_devices cards).

    frames: list of (y, u, v) uint8 plane triples, a multiple of the mesh's
    slots; slot d codes the block frames[d*k:(d+1)*k] as one batch of the
    CU16 wavefront (min(cfg.cu_size, 16), as the JAX function takes) at
    cfg.qp. Returns a list of standalone Annex-B-ready NAL lists (VPS /
    SPS / PPS + IDR slice per frame), each from a fresh pipeline, bit-exact
    to the single-device encoder.
    """
    from homerhevc_tpu_torch.engine.intra_encoder import TorchIntraEncoder
    from homerhevc_tpu_torch.engine.pipeline import TorchPipeline

    mesh = _mesh_of(cfg, mesh)
    n_dev = len(mesh)
    if len(frames) % n_dev:
        raise ValueError(f"frame batch ({len(frames)}) must fill the mesh "
                         f"({n_dev})")
    k = len(frames) // n_dev

    proto = TorchPipeline(cfg, mesh[0])   # handles CTU padding / conf window
    frames = [proto._pad_frame(*f) for f in frames]

    def shard(d):
        enc = TorchIntraEncoder(proto.ps, proto.cfg, cu=min(cfg.cu_size, 16),
                                device=mesh[d])
        ys, us, vs = zip(*frames[d * k:(d + 1) * k])
        out = enc.dispatch_frames(ys, us, vs, qps=[cfg.qp] * k)
        return enc.fetch_frames(out, k)

    with _Slots(mesh) as slots:
        results = [r for rs in slots.run(shard) for r in rs]

    streams = []
    for i, ((desc, ry, ru, rv), src) in enumerate(zip(results, frames)):
        pipe = TorchPipeline(cfg, mesh[i // k])
        ef = pipe._emit(desc, ry, ru, rv, src=src, qp=cfg.qp)
        streams.append(ef.nals)
    return streams


def gop_parallel_encode(cfg, frames, mesh=None):
    """IPPP GOP-segment scale-out over a mesh (default: the first
    cfg.num_devices cards).

    frames: list of (y, u, v) triples, length = n_slots * seg_len. Segment
    d = frames[d*seg_len:(d+1)*seg_len], coded IDR + (seg_len-1) P frames
    on slot d. Returns a list of per-segment NAL lists, each an independent
    conformant stream, bit-exact to the single-device sequential encode of
    the same segment.

    Step 0 codes every segment's IDR frame on the CU16 wavefront; its recon
    (the intra program's output) is the first reference. Step t >= 1
    reads each segment's avg_dist (its zero-forcing feedback, after the
    emission of frame t-2), then every slot dispatches frame t of its
    segment against its device-resident reference and fetches frame t-1;
    only then is frame t-1 of every segment emitted, in segment order: the
    same depth-2 device/host lag as the sequential P chain.
    """
    from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
    from homerhevc_tpu_torch.engine.intra_encoder import TorchIntraEncoder
    from homerhevc_tpu_torch.engine.pipeline import TorchPipeline

    mesh = _mesh_of(cfg, mesh)
    n_dev = len(mesh)
    if len(frames) % n_dev:
        raise ValueError("frames must fill the mesh evenly")
    seg_len = len(frames) // n_dev

    pipes = [TorchPipeline(cfg, mesh[d]) for d in range(n_dev)]
    frames = [pipes[0]._pad_frame(*f) for f in frames]
    ps, cfg_p = pipes[0].ps, pipes[0].cfg
    search = pipes[0]._inter_search_range()

    with _Slots(mesh) as slots:
        # ---- step 0: every segment's IDR frame (the CU16 wavefront) ----
        def intra(d):
            enc = TorchIntraEncoder(ps, cfg_p, cu=min(cfg.cu_size, 16),
                                    device=mesh[d])
            y, u, v = frames[d * seg_len]
            return enc.fetch_frames(
                enc.dispatch_frames([y], [u], [v], qps=[cfg.qp]), 1)[0]

        res_i = slots.run(intra)
        streams = []
        refs = []                  # each slot's reference: its recon planes
        for d, (desc, ry, ru, rv) in enumerate(res_i):
            ef = pipes[d]._emit(desc, ry, ru, rv, src=frames[d * seg_len],
                                qp=cfg.qp)
            streams.append(list(ef.nals))
            refs.append((ry, ru, rv))
        if seg_len == 1:
            return streams

        # ---- P chain: one dispatch per slot per time step ----
        encs = [None] * n_dev
        pend = [None] * n_dev      # each slot's dispatched, unfetched frame

        def p_step(d, t, zf_dist):
            if encs[d] is None:
                encs[d] = TorchInterEncoder(ps, cfg_p, search=search,
                                            device=mesh[d])
            out = encs[d].dispatch(frames[d * seg_len + t], refs[d],
                                   zf_dist[d], qp=cfg.qp)
            refs[d] = encs[d].last_dev
            prev = None if pend[d] is None else encs[d].fetch(pend[d])
            pend[d] = out
            return prev

        for t in range(1, seg_len):
            dists = [p.avg_dist for p in pipes]
            fetched = slots.run(lambda d, t=t: p_step(d, t, dists))
            if t > 1:
                _emit_p_step(pipes, streams, frames, fetched, t - 1,
                             seg_len, cfg.qp)
        fetched = slots.run(lambda d: encs[d].fetch(pend[d]))
        _emit_p_step(pipes, streams, frames, fetched, seg_len - 1, seg_len,
                     cfg.qp)
    return streams


def _emit_p_step(pipes, streams, frames, fetched, t, seg_len, qp):
    """Serialize frame `t` of every segment from its fetched output, in
    segment order."""
    from homerhevc_tpu_torch.hevc.headers import SLICE_P
    for d, (desc, ry, ru, rv) in enumerate(fetched):
        ef = pipes[d]._emit(desc, ry, ru, rv, src=frames[d * seg_len + t],
                            slice_type=SLICE_P, qp=qp)
        streams[d].extend(ef.nals)


def _check(cond, msg):
    """Fail the dry run (kept under python -O, unlike assert)."""
    if not cond:
        raise AssertionError(msg)


def encode_frames_sharded_dryrun(n_devices: int, device="cuda",
                                 mesh=None) -> None:
    """The multi-device gate: a sharded encode of n_devices random 64x32
    frames on a mesh of n_devices slots (make_mesh(n_devices, device)
    unless a mesh is given), each stream checked bit-exact against the
    single-device TorchPipeline's encode of that frame; then a GOP-segment
    IPPP encode (one segment per slot, IDR + 2 P each, deblocking on,
    drifting frames) checked bit-exact against the sequential pipeline.
    The references run on the mesh's first slot."""
    from homerhevc_tpu_torch.config import EncoderConfig
    from homerhevc_tpu_torch.engine.pipeline import TorchPipeline

    if mesh is None:
        mesh = make_mesh(n_devices, device)
    _check(len(mesh) == n_devices, f"a mesh of {len(mesh)} slots for "
           f"{n_devices} devices")
    ref_dev = mesh[0]
    cfg = EncoderConfig(width=64, height=32, qp=32, gop_size=0, sao=False,
                        deblocking=False, sign_hiding=True, cu_size=16,
                        num_devices=n_devices)
    rng = np.random.RandomState(7)
    frames = [
        (rng.randint(0, 256, (32, 64), np.uint8),
         rng.randint(0, 256, (16, 32), np.uint8),
         rng.randint(0, 256, (16, 32), np.uint8))
        for _ in range(n_devices)
    ]
    streams = encode_frames_sharded(cfg, frames, mesh)
    _check(len(streams) == n_devices, f"{len(streams)} streams")
    # single-device reference encode, same serializer: must be bit-exact
    for fr, nals in zip(frames, streams):
        pipe = TorchPipeline(cfg, ref_dev)
        ref = list(pipe.push(*fr)) + list(pipe.flush())
        _check(len(ref) == 1, f"{len(ref)} frames out of one")
        _check(ref[0].nals == nals, "sharded stream != single-device stream")

    # ---- GOP-segment IPPP scale-out (the P-frame path) ----
    seg_len = 3
    cfg_p = dataclasses.replace(cfg, gop_size=1, deblocking=True,
                                reinit_gop_on_scene_change=False)
    base = frames[0]
    pframes = []
    for d in range(n_devices):
        for t in range(seg_len):
            # gentle per-frame drift so P frames have real motion/residual
            y = np.roll(base[0], d + t, axis=1)
            pframes.append((y, base[1], base[2]))
    segs = gop_parallel_encode(cfg_p, pframes, mesh)
    _check(len(segs) == n_devices, f"{len(segs)} segments")
    for d in range(n_devices):
        pipe = TorchPipeline(cfg_p, ref_dev)
        ref_nals = []
        for t in range(seg_len):
            for ef in pipe.push(*pframes[d * seg_len + t]):
                ref_nals.extend(ef.nals)
        for ef in pipe.flush():
            ref_nals.extend(ef.nals)
        _check(segs[d] == ref_nals,
               f"gop-parallel segment {d} != single-device sequential "
               f"stream")
