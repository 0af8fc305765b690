"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each fails loudly; the last stdout line is printed only when all
passed):
  1. build csrc/me_sad.cu with nvcc (sm_90a) and the port's native CABAC
     library (g++);
  2. the coarse SAD sweep kernel's two entry points against their plain
     PyTorch version on the card, bit-exact: the 8-bit source at the 720p
     slice shapes (m=8, R=16 and R=24), at the 1080p shapes of paths C and
     D (1088 coded lines: gh 68, gw 120, R=16 and R=24; and gh 72), at
     path G1's (416x240 padded to 256 lines: gh 16, gw 26, R=16), on
     ragged grids, at m=16 and at the 0/255 extremes; the wide source (the
     B program's bi target, in [-255, 510]) at 720p and 1088 lines R=24,
     ragged, at m=16 and at its extremes; times from CUDA events with the
     L2 cache warm and cold, plain times, and the bound;
  3. the port on the card against SHA-256 digests of the JAX package's
     golden encoder at 128x64 (Annex-B bytes and recon planes of an I
     frame with deblocking off and on, of a P frame, of intra CU-tree
     frames at CTU 32 and 64 with deblocking and at CTU 32 with deblocking
     and SAO, and of IPPP tree streams (I + 2 P) at CTU 32 and 64 with
     deblocking and SAO; pinned to the JAX package by
     tests/test_torch_digests.py and tests/test_torch_sao.py), and of the
     JAX package's Encoder at 128x96 (IBP at CTU 32 with bi anchors, IBP
     at CTU 64 with uni-L0 B frames, generalized-B at CTU 32 with two
     references) and of its AQ streams (96x64 all-intra AQ, 3 frames in
     flight; 128x64 IPPP AQ + row-RC under CBR; tests/test_torch_aq.py),
     and of its host intra streams at 128x64 (IPPP CTU 32 with a
     fixed-CU32 I frame, RD_FULL all-intra CTU 32, all-intra CU16 AQ with
     deblocking; tests/test_torch_digests.py), and of its host P streams
     at 128x64 with the spec's AMVP lists (IPPP CU16 intra_rdo, IPPP CU16
     AQ + deblocking, IPPP CTU 32 AQ + intra-in-P, IBP CTU 32 AQ +
     deblocking, three references; tests/test_torch_digests.py);
  4. the main paths through homerhevc_tpu_torch.api.Encoder, each with the
     kernel launch counts set to 0 just before and read just after it:
     720p IPPP CU16 (1 I + 15 P; its first two frames re-encoded on the
     CPU, plain path, give identical Annex-B bytes) and a 720p all-intra
     CU16 batch (slice 1); 1080p all-intra CU32 and CU64 with intra_rdo,
     deblocking and SAO, 4 frames in flight (frame 0 of CU32 equal to
     path D's I0 coded alone on the CPU); 720p IPPP CU16 with SAO
     (1 I + 7 P, the sweep launched once per P frame, the first two
     frames equal on the CPU) (slice 2); path C, 1080p IPPP (1 I + 7 P)
     with intra_rdo, deblocking and SAO at CTU 64 and at CTU 32 FAST (the
     sweep launched once per P frame, some CTBs coded as CU32 / CU64, the
     I and first P frame of CTU 64 equal on the CPU; CTU 32's I frame
     split by stage) (slice 3); path D,
     1080p IBP at CTU 32 (I0 P2 B1 A4 B3 A6 B5 A8 B7, every frame after P2
     bi-capable, the sweep's 8-bit entry point once per P and twice per
     bi frame, its wide one once per bi frame, some 8x8 units coded bi,
     I0 P2 B1 equal on the CPU) (slice 4); path E, per-CTB QP maps
     and rate control (slice 5): E0 BASELINE config 3 (720p IPPP CU16,
     quarter-pel, CBR 1250 kbps + VBV, deblocking, SAO; 1 I + 15 P), E1
     the same with AQ and row-RC and deblocking off (every P frame inline
     with its map), each with the sweep launched once per P frame, its
     I + 2 P equal on the CPU and one P frame profiled; E2 720p all-intra
     CU16 with AQ (bench.py's config, 4 in flight); E3 one 1088-line
     CTU-64 P frame with a map, card equal to CPU; path F, the CLI
     (homerhevc_tpu_torch.cli.main in this process, slice 6): F0 BASELINE
     config 2 (720p IPPP CU16, full-pel ME, fixed QP 32, 1 I + 7 P; the
     sweep once per P frame, I + 2 P equal on the CPU, -o-raw equal to
     the recon, every slice parsed back by the port's SliceDataParser),
     F1 with half-pel ME, scaling lists and WPP (1 I + 7 P, I + 2 P equal
     on the CPU), `python -m homerhevc_tpu_torch.cli` in a subprocess
     (the same bytes, no jax imported), and the measure_rd and
     prof_device twins; path G, the host intra programs (slice 7), each I
     frame on the host and its P frames on the device: G0 1080p (1088
     coded lines) IPPP CTU 64 without intra_rdo, deblocking + SAO (1 I +
     7 P, I + first P equal on the CPU, CU64s in the P frames), G1 RD_FULL
     416x240 IPPP CTU 32 (1 I + 3 P, NxN PUs and TU splits, I + P equal on
     the CPU), G2 720p all-intra CU16 AQ with deblocking (1 frame, its
     slice parsed back, the decoder's QPs those deblocking read), G3 720p
     IPPP CU32 AQ + row-RC CBR 1250 kbps, deblocking off (1 I + 7 P, I +
     2 P equal on the CPU), the sweep once per P frame (each CPU re-encode
     takes the host I frame of the card's run: the same numpy); path H,
     the host P and B programs (slice 8), every slice parsed back: H0 720p
     IPPP CU16 AQ + row-RC CBR 1250 kbps with deblocking and SAO (1 I + 2
     P, all host; the parsed QPs equal those deblocking read), H1 720p
     IPPP CU16 with three references (1 I + 3 P: the first P frames on
     the device chain, the sweep once per device P frame, then a host
     three-reference frame with CUs at ref_idx >= 1; I + 2 P equal on the
     CPU), H2 720p IBP CU16 with AQ, deblocking off (I0 P2 B1 A4 B3 on the
     device, the anchors with maps; the sweep once per anchor and B
     frame; I0 P2 B1 equal on the CPU), H3 416x240 IBP CTU 32 AQ with
     deblocking and SAO (I0 P2 B1, all host, the host bi B tree, some
     units bi), H4 416x240 IPPP CU16 intra_rdo (1 I + 2 P, all host,
     rectangular PUs); path I, the multi-device scale-out (slice 9, the
     mesh's slots on the one card where the machine has fewer cards than
     slots): I0 encode_frames_sharded, 720p all-intra CU16 (bench.py's
     config), 8 frames over 4 slots, each stream equal to the
     single-device Encoder's on the card and to 1 slot's, fps against 1
     slot; I1 gop_parallel_encode, 720p IPPP CU16 with deblocking, 4
     segments of I + 3 P over 4 slots, each equal to the sequential
     Encoder on the card and segment 0 to 1 slot's, the sweep exactly 12
     times, fps against 1 slot and ms per step; I2 the dry run over 8
     slots; neither jax nor homerhevc_tpu may be imported;
  5. where the time goes: one P frame of slice 1, a P frame with SAO and
     a CTU-64 P frame of path C under torch.profiler, and the aten ops of
     a path-C P frame; one bi frame of path D counted by aten op and under
     torch.profiler; the aten ops of a 1080p tree frame's decision pass
     and first 4 wavefront steps counted, then torch.profiler over the
     decision pass and the first 2 wavefront steps (the tree frame's split
     by stage, decide, wavefront, deblock, SAO, pack, comes from path C's
     CTU-32 I frame). A "[time]" line gives each phase's seconds.
Then the kernel table (JSON, one entry per entry point; launches are
those of the main paths of phase 4), the card's name and power limit,
and the result line.

Exits non-zero without a result when no CUDA device is available.
"""

import dataclasses
import hashlib
import json
import subprocess
import sys
import time
import types

import numpy as np
import torch

DEV = "cuda"
W, H = 1280, 720
N_IPPP = 16          # 1 I + 15 P
N_INTRA, F_INTRA = 8, 4
W_TREE, H_TREE = 1920, 1080   # path A: all-intra CU tree at 1080p
F_TREE = 4                    # frames in flight, one batch
N_SAO = 8                     # path B: 720p IPPP CU16 + SAO, 1 I + 7 P
N_PATH_C = 8                  # path C: 1080p IPPP tree + SAO, 1 I + 7 P
N_PATH_D = 9                  # path D: 1080p IBP CTU 32, I0 P2 B1 A4 ... B7
N_PATH_D_CPU = 3              # I0 P2 B1 re-encoded on the CPU
N_PATH_E = 16                 # path E0 / E1: 720p IPPP CBR, 1 I + 15 P
N_PATH_E_CPU = 3              # E0's and E1's I + 2 P re-encoded on the CPU
PROFILE_STEPS = 2             # wavefront steps under torch.profiler
COUNT_STEPS = 4               # wavefront steps whose aten ops are counted
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
INT32_LANES_PER_SM = 64       # Hopper SM: 64 INT32 lanes per clock
OPS_PER_PACKED_LANE = 8       # vabsdiff4 .add: 4 pairs of |a - b| + add
L2_FLUSH_BYTES = 256 << 20    # written between cold launches (L2: 50 MB)
HOST_LEAD_CYCLES = 200_000_000  # ~0.1 s spin that lets the host queue ahead

# 128x64 parity cells: the port on the card must reproduce these SHA-256
# digests of the JAX package's golden encoder (Annex-B bytes, recon planes)
PARITY_CFG = dict(width=128, height=64, qp=32, sao=False, sign_hiding=True,
                  cu_size=16)
# the intra CU-tree cells (gop 0, intra_rdo, deblocking; SAO off or on)
TREE_CFG = dict(width=128, height=64, qp=32, gop_size=0, intra_rdo=True,
                deblocking=True, sign_hiding=True)
TREE_CELLS = {"I tree CU32 deblock": dict(cu_size=32, sao=False),
              "I tree CU64 deblock": dict(cu_size=64, sao=False),
              "I tree CU32 deblock+SAO": dict(cu_size=32, sao=True)}
# the IPPP tree cells: I + 2 P of the tree frame panning right, intra_rdo,
# deblocking and SAO, every P frame predicted from the filtered recon of
# the one before with the zero-forcing threshold of the I frame (as the
# pipeline's depth-2 P chain gives both)
IPPP_CFG = dict(width=128, height=64, qp=32, gop_size=1, intra_period=0,
                intra_rdo=True, deblocking=True, sao=True, sign_hiding=True)
IPPP_CELLS = {"IPPP tree CU32 deblock+SAO": dict(cu_size=32),
              "IPPP tree CU64 deblock+SAO": dict(cu_size=64)}
# the B cells: streams of the bench clip at 128x96 through the Encoder
# (I frames of the intra tree, deblocking, sign hiding, QP 32): IBP at CTU
# 32 with SAO (6 frames, I0 P2 B1 A4 B3 P5: a bi-predicted anchor, bi B
# frames, a trailing P), IBP at CTU 64 (5 frames, I0 P2 B1 P4 B3: uni-L0
# B frames) and generalized-B at CTU 32 with two references and SAO (4
# frames, I0 P1 B2 B3); digests of the JAX package's Encoder on the CPU
# (tests/torch_golden.py jax_b_stream_digests): B_DIGESTS
B_CFG = dict(width=128, height=96, qp=32, intra_rdo=True, deblocking=True,
             sign_hiding=True, intra_period=0,
             reinit_gop_on_scene_change=False)
B_CELLS = {
    "IBP CTU 32 bi anchors": (dict(cu_size=32, gop_size=2, sao=True), 6),
    "IBP CTU 64 uni-L0 B": (dict(cu_size=64, gop_size=2, sao=False), 5),
    "GPB CTU 32 two refs": (dict(cu_size=32, gop_size=1, num_ref_frames=2,
                                 sao=True), 4),
}
# the AQ cells: streams of the bench clip with a flat band over the top
# quarter of every frame (AQ deltas), through the Encoder at CU16 with
# deblocking off, sign hiding, AQ strength 2 and QP 30: all-intra at 96x64,
# 3 frames in flight (6 frames), and IPPP with row-RC under CBR at 300 kbps
# (5 frames); digests of the JAX package's Encoder on the CPU, which
# tests/test_torch_aq.py computes and holds to AQ_DIGESTS
AQ_CFG = dict(qp=30, cu_size=16, sao=False, deblocking=False,
              sign_hiding=True, aq_strength=2.0,
              reinit_gop_on_scene_change=False)
AQ_CELLS = {
    "all-intra AQ 96x64": (dict(width=96, height=64, gop_size=0,
                                num_frames_in_flight=3), 6),
    "IPPP AQ + row-RC CBR 128x64": (dict(width=128, height=64, gop_size=1,
                                         intra_period=0, rc_ctu=True,
                                         bitrate_mode=1,      # CBR
                                         bitrate_kbps=300), 5),
}
# the host intra cells: streams of the AQ cells' frames (the bench clip
# with a flat band over the top quarter) at 128x64 through the Encoder, QP
# 32, sign hiding, deblocking: IPPP at CTU 32 without intra_rdo (the host
# fixed-CU32 I frame, then 2 P frames of the device P program, with SAO),
# RD_FULL all-intra at CTU 32 (the host tree with NxN PUs, TU splits and
# the chroma RDO, with SAO; 2 frames) and CU16 all-intra with AQ (strength
# 2) and deblocking (the decoder-view QP map; 2 frames); digests of the
# JAX package's Encoder on the CPU, which tests/test_torch_digests.py
# computes and holds to HOST_DIGESTS
HOST_CFG = dict(width=128, height=64, qp=32, sign_hiding=True,
                deblocking=True, intra_period=0,
                reinit_gop_on_scene_change=False)
HOST_CELLS = {
    "IPPP CTU 32 host I": (dict(cu_size=32, gop_size=1, sao=True), 3),
    "RD_FULL all-intra CTU 32": (dict(cu_size=32, gop_size=0,
                                      intra_rdo=True, rd_mode=1,
                                      sao=True), 2),
    "all-intra CU16 AQ deblock": (dict(cu_size=16, gop_size=0,
                                       aq_strength=2.0, sao=False), 2),
}
# the host P cells: streams of the AQ cells' frames at 128x64 through the
# Encoder (HOST_CFG), one per configuration whose P and B frames the JAX
# package codes on its host programs: IPPP CU16 with intra_rdo (rect PUs,
# merge-RD; SAO), IPPP CU16 with AQ (strength 2) and deblocking (SAO), IPPP
# CTU 32 with intra_rdo, AQ and intra-in-P (deblocking off), IBP CTU 32
# with AQ and deblocking (host anchors, the host bi B tree; decode order
# I0 P2 B1 A4 B3), and three references at CU16 with AQ and deblocking, an
# IDR at frame 4 (I0 P1 P2 P3 I4, P2 and P3 with per-CU ref_idx); digests
# of the JAX package's Encoder on the CPU with the spec's AMVP lists
# (tests/torch_golden.jax_host_p_stream_digests), which
# tests/test_torch_digests.py holds to HOST_P_DIGESTS
HOST_P_CELLS = {
    "IPPP CU16 intra_rdo": (dict(cu_size=16, gop_size=1, intra_rdo=True,
                                 sao=True), 3),
    "IPPP CU16 AQ deblock": (dict(cu_size=16, gop_size=1, aq_strength=2.0,
                                  sao=True), 3),
    "IPPP CTU 32 AQ intra-in-P": (dict(cu_size=32, gop_size=1,
                                       intra_rdo=True, aq_strength=2.0,
                                       deblocking=False, intra_in_p=True),
                                  3),
    "IBP CTU 32 AQ deblock": (dict(cu_size=32, gop_size=2, intra_rdo=True,
                                   aq_strength=2.0), 5),
    "IPPP CU16 AQ deblock 3 refs": (dict(cu_size=16, gop_size=1,
                                         aq_strength=2.0, num_ref_frames=3,
                                         intra_period=4), 5),
}
GOLDEN_DIGESTS = {
    "I deblock=0": (
        "75cc9191de8a647a6a5b50d8b8a68a91c032bcd80b960d6c7e38399cab84f7fe",
        "bde158720b373d8e87df0f3903393a4db6333c79a57affb224816c7dd558b736"),
    "I deblock=1": (
        "747a5f69464d9589cfd7df61a59b5934d0ff835f31def7a5b1a22c6d05e9a49c",
        "ac46149178fb180e383bc8e47c0012f9a47ecc1b4a957bfb4e80b3fb1f7faa7e"),
    "P": (
        "02af27e2692a831f5165a0996b62b288697383ab32c88b3aedf52027ef31dd7c",
        "8ad495b0e2b51e38493bc78e43e4ee7971f1a718067e8b9c00f5a8bae532fdd0"),
    "I tree CU32 deblock": (
        "538a0cbc3db768111b5c10fe30d198d8f20e3bdd749fcbd80ebb6aad1d888fa3",
        "6632cb4ad47e565e6e0bb4b2d02c5e46cd55b9ffbe0a951feea51c444af3ce68"),
    "I tree CU64 deblock": (
        "e39f888f3b28d874d0c111cd14709902129d2f8087cf436633a7733e70fbfaa0",
        "6632cb4ad47e565e6e0bb4b2d02c5e46cd55b9ffbe0a951feea51c444af3ce68"),
    "I tree CU32 deblock+SAO": (
        "71b7dff370e5cdc4fa047202e332a05d8f7002a0b8982b6a56373e202908167c",
        "fceb07e9e880bed6bcba5c029401dbdabfc17d3ff3e1fc92d054de38a9c349cc"),
    "IPPP tree CU32 deblock+SAO": (
        "631507cc09722cbd51467cf0fcfee792ea25a0e0daa77c4a6234ddabfa6400c2",
        "4909f79c0c44dfe1e5468a4e79f32444d3c25d152c48c497fe440e7b45d1fa04"),
    "IPPP tree CU64 deblock+SAO": (
        "86bd89a6bc13c9788a3f2a263ce8fac4ea69f7a511ce21eca926ac5d55e5fcbc",
        "314c412ed45a2ac007d282a8ce4b4c2a15f1c66d633464ff0255fd7912480592"),
}
B_DIGESTS = {
    "IBP CTU 32 bi anchors": (
        "b13bbcd2426487cd92d878dc58e34af35ece3690ae942cb8e0128c17f7f6f049",
        "0d4beb095e0e02f96371a6ce90d9820c10320ac6bd04bebf69f3c9fbb1b7517c"),
    "IBP CTU 64 uni-L0 B": (
        "2a678c2bc0333fac4d33bf75209cb4c542bcc8ac34f3878857d55d6f7de8cbe8",
        "70a9aac5799ed44fa0c6cf923880425e702c60f17816e3d533c341e3d132a276"),
    "GPB CTU 32 two refs": (
        "3bcc781869b48f3c3e092b2da0b41669c92916c8035f818766bd7f1345788510",
        "cd9247364373e9cd63865cb5a429a5c874e1865b250bd501592ad4e754ed84b1"),
}
AQ_DIGESTS = {
    "all-intra AQ 96x64": (
        "cec6490d20923aab22dfa99a819b46980bd51151e57941c1aa4e62a046adf388",
        "e3cdb9fe45b5bf66313d34bb1e9f821ad860642ca4615b2657e34361bdccebfd"),
    "IPPP AQ + row-RC CBR 128x64": (
        "5bd7fc66d0c1e4140f9663d8d845e73d12484758f775c85dfe4671cf3a8e25ba",
        "0bd0bb04b5d52cb470ac2b24efb2f3424b7f81f4cf2396ef390aa650d50f1530"),
}
HOST_DIGESTS = {
    "IPPP CTU 32 host I": (
        "e5859a0a0d1053cb1207fa6f66605c9529277c6b782a85cc3e61295c216855c1",
        "61d0c446abe04a24cbe9c639aa8a3dda605a172f2459e6a894e5315283724e99"),
    "RD_FULL all-intra CTU 32": (
        "04d6e32638e87f64a62b144ae58b20d4ff70284872f2b040138b829d9ca7e9de",
        "28e536ec680a73814f63f266b5a42583be30057c7f8249c0298f6a4a380eedb9"),
    "all-intra CU16 AQ deblock": (
        "3837883d411ca007f473eca3af172a86210090d80e44866bd1a9b7c771ae9f82",
        "21636556e29bab6df6df69fecc87132f6c7d7f0cebf09cfcf2abae816d468777"),
}
HOST_P_DIGESTS = {
    "IPPP CU16 intra_rdo": (
        "6c29a3d234f2b4419f1f206a7a73b28e65877dd7090425ca7be498eb763ac74d",
        "24e87535e181fa5c1df68598787dcf9058fb0614d13496a2a9e5c8fe68c6bcb0"),
    "IPPP CU16 AQ deblock": (
        "f5ffb5212184528a0203355f7507f5ffa25dff5e3267a0ac773f533833facd21",
        "385b7c5de61c622dc1f5990a9278b2f6a4974264fd9f8b15b4449ff16b1f48c5"),
    "IPPP CTU 32 AQ intra-in-P": (
        "fb18f2c51fcd9b9fdc07a7a7ced1d19cd0c23b184d393a01b05ee59ffd55f64f",
        "cc2416e276a0b60be6890acda7b0c97efc2674f647445894e5cafe1622a4feed"),
    "IBP CTU 32 AQ deblock": (
        "8738763d9fdb6ea32fd0d8f30bfd16c6b3ad42dd7cb856c029457b680adc7b6d",
        "95b34e4b199d2e8aa29ecc19217532878359691ee8cd1dca47c54985c4fb1770"),
    "IPPP CU16 AQ deblock 3 refs": (
        "559ecb690ad669366ee8d2dc62a251328eb6978be122b6ac9f1c90ba65809184",
        "afa41e560ca728ff03153398bff8fab24ea37beb66ed68f99daa1e1ab22f1c42"),
}


def log(msg):
    print(msg, flush=True)


def check(cond, msg=""):
    """Fail the phase (kept under python -O, unlike assert)."""
    if not cond:
        raise AssertionError(msg)


def smi(query):
    """One nvidia-smi --query-gpu field line of card 0."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def bench_frames(n, seed=42, w=W, h=H):
    """The bench.py clip: moving texture over gradients (720p unless
    another size is asked for)."""
    from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip
    return bench_clip(w, h, n, seed)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches back to back (CUDA
    events), after reps // 4 + 1 launches that bring the card to its
    working clock. The card first spins while the host queues the launches,
    so that a host slower than the kernel does not set the time."""
    for _ in range(reps // 4 + 1):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_LEAD_CYCLES)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cuda_ms_cold(fn, reps):
    """Mean device time of fn() over reps launches, each timed alone (CUDA
    events) after writing a buffer five times the L2 cache, so that none
    of fn's data is cached: the sweep's caller runs thousands of other
    kernels between two sweeps."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    fn()
    for t0, t1 in events:
        flush.zero_()
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in events) / reps


def phase_build():
    from homerhevc_tpu_torch import native
    from homerhevc_tpu_torch.ops import me_sad
    t = time.perf_counter()
    me_sad.build()
    t_k = time.perf_counter() - t
    t = time.perf_counter()
    lib = native.get_lib()
    t_n = time.perf_counter() - t
    if lib is None:
        raise RuntimeError("native CABAC library failed to build (g++)")
    log(f"[build] me_sad.cu (nvcc sm_90a): {t_k:.2f} s; "
        f"native CABAC (g++): {t_n:.2f} s")


def sweep_inputs(frames, R, m=8, gh=None, gw=None, wide=False):
    """Decimated source / edge-padded decimated reference as the P path
    builds them (uint8 on the card), cut to gh x gw blocks of m x m. wide:
    the source is a B program's bi target instead, 2 * src - pred (int16),
    spanning [-255, 510]: the prediction is the earlier frame's negative,
    and two 32x32 areas are black against a white prediction and white
    against a black one."""
    from homerhevc_tpu_torch.engine.inter_encoder import pad_edge
    dev = torch.device(DEV)

    def plane(p):
        return torch.as_tensor(p, device=dev).to(torch.int32)

    def decim(q):
        return (q[0::2, 0::2] + q[1::2, 0::2] + q[0::2, 1::2]
                + q[1::2, 1::2] + 2) >> 2
    src = plane(frames[1][0])
    if wide:
        pred = 255 - plane(frames[0][0])
        src, pred = src.clone(), pred.clone()
        src[:32, :32], pred[:32, :32] = 0, 255
        src[:32, 32:64], pred[:32, 32:64] = 255, 0
        src = 2 * src - pred
    sd = decim(src)
    rd = decim(plane(frames[0][0]))
    gh = sd.shape[0] // m if gh is None else gh
    gw = sd.shape[1] // m if gw is None else gw
    sd, rd = sd[:gh * m, :gw * m], rd[:gh * m, :gw * m]
    rp = pad_edge(rd.to(torch.uint8), R, R).contiguous()
    return sd.to(torch.int16 if wide else torch.uint8).contiguous(), rp


def sweep_bound(sd, rp, R, m, extra_bytes=0):
    """Least time (ms) of one sweep on this card and what bounds it: the
    larger of the bytes time (each input byte read and each int32 output
    written once at the HBM rate; extra_bytes: the wide entry point's
    per-block excess) and the operations time (2 operations,
    |a - b| and the add, per 8-bit sample pair at the integer lanes' rate
    for packed bytes: SMs x 64 lanes x the maximum SM clock x 8 operations
    per vabsdiff4 .add). A SAD cannot use the tensor cores, so their int8
    peak is no rate for it. Returns (bound, "bytes" or "operations",
    operations time)."""
    side = 2 * R + 1
    nbytes = (sd.numel() * sd.element_size() + rp.numel() + extra_bytes
              + 4 * side * side * sd.numel() // (m * m))
    ops = 2 * side * side * sd.numel()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / (sms * INT32_LANES_PER_SM * clock_hz
                    * OPS_PER_PACKED_LANE) * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", ops_ms)


def phase_kernel(frames, frames_1152, frames_g1):
    """The sweep kernel's entry points against their plain version (frames:
    the 720p clip; frames_1152: the clip at 1920x1152, cut to the 1088
    coded lines of paths C and D (gh 68) and to gh 72; frames_g1: path
    G1's class-D clip, edge-padded to its 256 coded lines as the pipeline
    pads it, gh 16 and gw 26): the 8-bit source
    of the P program and of the B program's searches against the source,
    and the wide source (the bi target, in [-255, 510]) of the B program's
    list-1 search. The wide rows time the kernel alone from its inputs
    (the clamped source and the blocks' excess), and beside it the
    wrapper, which computes those with PyTorch launches first."""
    from homerhevc_tpu_torch.device import LAUNCHES
    from homerhevc_tpu_torch.ops import me_sad
    from homerhevc_tpu_torch.ops.me_sad import (coarse_sweep_sads,
                                                coarse_sweep_sads_plain)
    rows = {}
    before = dict(LAUNCHES)
    cases = [("720p R=16", frames, 16, 8, None, None, True, False),
             ("720p R=24", frames, 24, 8, None, None, True, False),
             ("1088 lines R=16", frames_1152, 16, 8, 68, 120, True, False),
             ("1088 lines R=24", frames_1152, 24, 8, 68, 120, True, False),
             ("1152 lines R=16", frames_1152, 16, 8, 72, 120, True, False),
             ("G1 256x416 R=16", frames_g1, 16, 8, 16, 26, True, False),
             ("wide 720p R=24", frames, 24, 8, None, None, True, True),
             ("wide 1088 lines R=24", frames_1152, 24, 8, 68, 120, True,
              True),
             ("ragged 3x5 R=16", frames, 16, 8, 3, 5, False, False),
             ("ragged 1x37 R=13", frames, 13, 8, 1, 37, False, False),
             ("wide ragged 3x5 R=16", frames, 16, 8, 3, 5, False, True),
             ("m=16 22x40 R=24", frames, 24, 16, None, None, False, False),
             ("wide m=16 22x40 R=24", frames, 24, 16, None, None, False,
              True)]
    for label, clip, R, m, gh, gw, timed, wide in cases:
        sd, rp = sweep_inputs(clip, R, m, gh, gw, wide)
        if wide:
            check((int(sd.min()), int(sd.max())) == (-255, 510),
                  f"{label}: the bi target spans [{int(sd.min())}, "
                  f"{int(sd.max())}], not [-255, 510]")
        side = 2 * R + 1
        got = coarse_sweep_sads(sd, rp, R, m)
        torch.cuda.synchronize()
        want = coarse_sweep_sads_plain(sd, rp, R, m)
        check(got.shape == (side * side, sd.shape[0] // m,
                            sd.shape[1] // m), got.shape)
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at {label}")
        err = int((got - want).abs().max())
        msg = (f"[kernel] {label}: sd {tuple(sd.shape)} {sd.dtype} in "
               f"[{int(sd.min())}, {int(sd.max())}], ref_pad "
               f"{tuple(rp.shape)} -> {tuple(got.shape)}; kernel == plain "
               f"(bit-exact, max_abs_err {err})")
        if timed:
            if wide:
                # the kernel alone, from the wide entry point's inputs (the
                # clamped source and the blocks' excess); the wrapper
                # computes those with PyTorch launches first
                clamped, excess = me_sad.wide_parts(sd, m)
                out = torch.empty_like(got)
                lib = me_sad.build()

                def sweep():
                    me_sad.launch(lib, clamped, rp, out, R, m, excess)
                wrapper_ms = cuda_ms_cold(
                    lambda: coarse_sweep_sads(sd, rp, R, m), 200)
                bound_ms, bound_by, ops_ms = sweep_bound(
                    clamped, rp, R, m, extra_bytes=4 * excess.numel())
            else:
                def sweep():
                    return coarse_sweep_sads(sd, rp, R, m)
                bound_ms, bound_by, ops_ms = sweep_bound(sd, rp, R, m)
            warm_ms = cuda_ms(sweep, 400)
            ms = cuda_ms_cold(sweep, 200)
            plain_ms = cuda_ms(
                lambda: coarse_sweep_sads_plain(sd, rp, R, m), 3)
            rows[label] = (err, ms, plain_ms, bound_ms, bound_by)
            msg += (f"; kernel {ms:.4f} ms with the L2 cold, "
                    f"{warm_ms:.4f} ms warm; bound {bound_ms:.4f} ms "
                    f"({bound_by}; operations {ops_ms:.4f} ms), "
                    f"{100 * bound_ms / ms:.1f}% of the bound cold, "
                    f"{100 * bound_ms / warm_ms:.1f}% warm; plain "
                    f"{plain_ms:.4f} ms")
            if wide:
                msg += (f"; the wrapper (clamp and excess, then the "
                        f"kernel) {wrapper_ms:.4f} ms cold")
        log(msg)
    # the extremes: every |difference| is 0 or 255 (8-bit), up to 510
    # (wide)
    sd, rp = sweep_inputs(frames, 16)
    for s_val, r_val in ((0, 255), (255, 0), (255, 255), (-255, 255),
                         (510, 0)):
        dt = torch.uint8 if 0 <= s_val <= 255 else torch.int16
        a = torch.full(sd.shape, s_val, dtype=dt, device=sd.device)
        b = torch.full_like(rp, r_val)
        got = coarse_sweep_sads(a, b, 16, 8)
        torch.cuda.synchronize()
        check(torch.equal(got, coarse_sweep_sads_plain(a, b, 16, 8)),
              f"kernel != plain at sd={s_val} ref={r_val}")
        check(int(got.max()) == abs(s_val - r_val) * 64, int(got.max()))
    log(f"[kernel] 720p R=16 extremes (sd, ref) = (0, 255), (255, 0), "
        f"(255, 255) 8-bit, (-255, 255), (510, 0) wide: kernel == plain; "
        f"launches in this phase " + ", ".join(
            f"{k} {LAUNCHES[k] - before[k]}" for k in LAUNCHES))
    return rows


def slice_annexb(hevc, ps, desc, slice_type, qp, sao_params=None, poc=None):
    """Annex-B bytes of one slice (VPS/SPS/PPS ahead of an I slice; a P
    slice of POC poc, 1 by default, refers to the POC before it) coded by
    the Python CABAC serializer of `hevc`, a namespace of the modules
    headers, bitstream, cabac, ctx_tables and syntax: the port's on the
    card, the JAX package's in the digest test. With sao_params the slice
    header turns SAO on and every CTU codes its parameters."""
    h, bs = hevc.headers, hevc.bitstream
    intra = slice_type == h.SLICE_I
    nal_type = bs.NAL_IDR_W_RADL if intra else bs.NAL_TRAIL_R
    sao = sao_params is not None
    poc = (0 if intra else 1) if poc is None else poc
    sp = h.SliceParams(slice_type=slice_type, nal_type=nal_type,
                       poc=poc, qp=qp, sao_luma=sao, sao_chroma=sao,
                       ref_pocs_before=() if intra else (poc - 1,))
    bw = h.write_slice_header(ps, sp)
    enc = hevc.cabac.CabacEncoder(
        bw, hevc.ctx_tables.init_contexts("I" if intra else "P", qp))
    sd = hevc.syntax.SliceDataEncoder(ps, desc, enc, slice_type, qp,
                                      sao_params=sao_params)
    n_ctus = ps.ctus_x * ps.ctus_y
    for i in range(n_ctus):
        sd.encode_ctu(i % ps.ctus_x, i // ps.ctus_x)
        sd.encode_ctu_end(end_of_slice=(i == n_ctus - 1))
    enc.finish()
    bw.write_byte_alignment()
    nals = [h.write_vps(ps), h.write_sps(ps), h.write_pps(ps)] if intra \
        else []
    return bs.annex_b(nals + [bs.make_nal(nal_type, bw.get_bytes())])


def digests(stream, planes):
    """(SHA-256 of the Annex-B bytes, SHA-256 of the uint8 recon planes)."""
    rec = b"".join(np.ascontiguousarray(np.asarray(p), np.uint8).tobytes()
                   for p in planes)
    return (hashlib.sha256(stream).hexdigest(),
            hashlib.sha256(rec).hexdigest())


def parity_inputs():
    """The seeded 128x64 source frame and the P frame's fixed reference."""
    w, h = PARITY_CFG["width"], PARITY_CFG["height"]
    rng = np.random.RandomState(1234)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    y = np.clip(60 + 0.1 * xx + 0.07 * yy + 25 * np.sin(xx / 11.0)
                + 15 * np.cos(yy / 7.0) + rng.rand(h, w) * 12,
                0, 255).astype(np.uint8)
    u = np.clip(128 + 20 * np.sin(xx[::2, ::2] / 23.0)
                + rng.rand(h // 2, w // 2) * 6, 0, 255).astype(np.uint8)
    v = np.clip(128 - 15 * np.cos(yy[::2, ::2] / 17.0)
                + rng.rand(h // 2, w // 2) * 6, 0, 255).astype(np.uint8)
    ref = (np.roll(y, 3, 1), np.roll(u, 1, 1), np.roll(v, 1, 1))
    return (y, u, v), ref


def tree_parity_inputs():
    """The seeded 128x64 frame of the tree cells: a flat gradient half and
    a rings half (large and split CUs both occur), light luma noise and
    textured chroma (SAO turns on in some CTBs)."""
    w, h = TREE_CFG["width"], TREE_CFG["height"]
    rng = np.random.RandomState(7)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.sqrt((xx - w * 0.75) ** 2 + (yy - h * 0.5) ** 2)
    y = np.where(xx < w // 2, 90 + 0.3 * yy, 60 + 60 * np.sin(r * 0.8))
    y = np.clip(y + rng.randint(-1, 2, (h, w)), 0, 255).astype(np.uint8)
    u = np.clip(120 + 10 * np.sin(xx[::2, ::2] / 9.0)
                + rng.randint(-4, 5, (h // 2, w // 2)), 0, 255) \
        .astype(np.uint8)
    v = np.clip(130 + 10 * np.cos(yy[::2, ::2] / 7.0)
                + rng.randint(-4, 5, (h // 2, w // 2)), 0, 255) \
        .astype(np.uint8)
    return y, u, v


def ippp_parity_inputs():
    """The three frames of the IPPP tree cells: the tree frame moved right
    by 2 luma / 1 chroma sample per frame."""
    y, u, v = tree_parity_inputs()
    return [(np.roll(y, 2 * t, 1), np.roll(u, t, 1), np.roll(v, t, 1))
            for t in range(3)]


def i_frame_avg_dist(src_y, recon_y):
    """The pipeline's zero-forcing feedback after an I frame: the luma SSD
    of the filtered recon per 4x4 partition, x1.5."""
    d = np.asarray(recon_y, np.int64) - np.asarray(src_y, np.int64)
    return float((d * d).sum()) / (d.size / 16.0) * 1.5


def port_digests(device):
    """The port's digests of the parity cells, encoded on `device`."""
    from homerhevc_tpu_torch.config import EncoderConfig
    from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
    from homerhevc_tpu_torch.engine.intra_encoder import TorchIntraEncoder
    from homerhevc_tpu_torch.hevc import (bitstream, cabac, ctx_tables,
                                          headers, syntax)
    from homerhevc_tpu_torch.state import reference_from_numpy
    hevc = types.SimpleNamespace(headers=headers, bitstream=bitstream,
                                 cabac=cabac, ctx_tables=ctx_tables,
                                 syntax=syntax)
    (y, u, v), ref = parity_inputs()
    out = {}
    for deblock in (False, True):
        cfg = EncoderConfig(**PARITY_CFG, gop_size=0, deblocking=deblock)
        ps = headers.ParamSets.from_config(cfg)
        desc, *rec = TorchIntraEncoder(ps, cfg, device=device).encode_frame(
            y, u, v, cfg.qp)
        out[f"I deblock={int(deblock)}"] = digests(
            slice_annexb(hevc, ps, desc, headers.SLICE_I, cfg.qp), rec)
    cfg = EncoderConfig(**PARITY_CFG, gop_size=1, intra_period=0,
                        deblocking=False)
    ps = headers.ParamSets.from_config(cfg)
    desc, *rec = TorchInterEncoder(ps, cfg, device=device).encode_frame(
        (y, u, v), reference_from_numpy(ref, device))
    out["P"] = digests(slice_annexb(hevc, ps, desc, headers.SLICE_P, cfg.qp),
                       rec)
    from homerhevc_tpu_torch.engine.intra_tree_encoder import \
        TorchIntraTreeEncoder
    y, u, v = tree_parity_inputs()
    for name, cell in TREE_CELLS.items():
        cfg = EncoderConfig(**TREE_CFG, **cell)
        ps = headers.ParamSets.from_config(cfg)
        desc, *rec = TorchIntraTreeEncoder(ps, cfg, device=device) \
            .encode_frame(y, u, v, cfg.qp)
        out[name] = digests(slice_annexb(hevc, ps, desc, headers.SLICE_I,
                                         cfg.qp, desc.sao_params), rec)
    frames = ippp_parity_inputs()
    for name, cell in IPPP_CELLS.items():
        cfg = EncoderConfig(**IPPP_CFG, **cell)
        ps = headers.ParamSets.from_config(cfg)
        desc, *rec = TorchIntraTreeEncoder(ps, cfg, device=device) \
            .encode_frame(*frames[0], cfg.qp)
        rec = [np.asarray(p) for p in rec]
        stream = [slice_annexb(hevc, ps, desc, headers.SLICE_I, cfg.qp,
                               desc.sao_params)]
        planes = list(rec)
        avg = i_frame_avg_dist(frames[0][0], rec[0])
        inter = TorchInterEncoder(ps, cfg, device=device)
        for poc in (1, 2):
            desc, *rec = inter.encode_frame(
                frames[poc], reference_from_numpy(rec, device), avg, cfg.qp)
            rec = [np.asarray(p) for p in rec]
            stream.append(slice_annexb(hevc, ps, desc, headers.SLICE_P,
                                       cfg.qp, desc.sao_params, poc))
            planes += rec
        out[name] = digests(b"".join(stream), planes)
    return out


def aq_frames(n, w, h):
    """The AQ cells' frames: the bench clip at w x h with a flat band over
    the top quarter of every frame."""
    frames = bench_frames(n, w=w, h=h)
    for y, _, _ in frames:
        y[:h // 4] = 90
    return frames


def aq_stream_digests(encode):
    """Digests of the AQ cells' streams, encode as in b_stream_digests."""
    out = {}
    for name, (cell, n) in AQ_CELLS.items():
        kw = {**AQ_CFG, **cell}
        efs = encode(kw, aq_frames(n, kw["width"], kw["height"]))
        out[name] = digests(b"".join(e.annex_b() for e in efs),
                            [e.recon[c] for e in efs for c in "yuv"])
    return out


def host_stream_digests(encode):
    """Digests of the host intra cells' streams, encode as in
    b_stream_digests."""
    out = {}
    for name, (cell, n) in HOST_CELLS.items():
        kw = {**HOST_CFG, **cell}
        efs = encode(kw, aq_frames(n, kw["width"], kw["height"]))
        out[name] = digests(b"".join(e.annex_b() for e in efs),
                            [e.recon[c] for e in efs for c in "yuv"])
    return out


def host_p_stream_digests(encode):
    """Digests of the host P cells' streams, encode as in
    b_stream_digests."""
    out = {}
    for name, (cell, n) in HOST_P_CELLS.items():
        kw = {**HOST_CFG, **cell}
        efs = encode(kw, aq_frames(n, kw["width"], kw["height"]))
        out[name] = digests(b"".join(e.annex_b() for e in efs),
                            [e.recon[c] for e in efs for c in "yuv"])
    return out


def b_stream_digests(encode):
    """Digests of the B cells' streams: encode(kw, frames) returns the
    EncodedFrames of the configuration kw (keyword arguments of an
    EncoderConfig) in decode order."""
    out = {}
    for name, (cell, n) in B_CELLS.items():
        efs = encode({**B_CFG, **cell}, bench_frames(n, w=128, h=96))
        out[name] = digests(b"".join(e.annex_b() for e in efs),
                            [e.recon[c] for e in efs for c in "yuv"])
    return out


def phase_digests():
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.config import EncoderConfig
    def encode(kw, frames):
        return encode_all(Encoder(EncoderConfig(**kw), device=DEV), frames)
    got = port_digests(DEV)
    got.update(b_stream_digests(encode))
    got.update(aq_stream_digests(encode))
    got.update(host_stream_digests(encode))
    got.update(host_p_stream_digests(encode))
    for k, want in {**GOLDEN_DIGESTS, **B_DIGESTS, **AQ_DIGESTS,
                    **HOST_DIGESTS, **HOST_P_DIGESTS}.items():
        check(got[k] == want, f"{k}: port {got[k]} != golden {want}")
    log("[parity] 128x64 on the card: I frame (deblock off/on), P frame, "
        "intra tree (CU32 / CU64 deblock, CU32 deblock+SAO) and IPPP tree "
        "streams (I + 2 P, CU32 / CU64 deblock+SAO) == the JAX golden "
        "encoder's SHA-256 digests (Annex-B bytes and recon planes); "
        "128x96 through api.Encoder: IBP CTU 32 with bi anchors, IBP CTU "
        "64 with uni-L0 B, generalized-B CTU 32 with two references; "
        "96x64 all-intra AQ and 128x64 IPPP AQ + row-RC under CBR == "
        "the JAX Encoder's digests; 128x64 host intra streams (IPPP CTU "
        "32 with a fixed-CU32 I frame, RD_FULL all-intra CTU 32, all-intra "
        "CU16 AQ with deblocking) == the JAX Encoder's digests; 128x64 "
        "host P streams (IPPP CU16 intra_rdo, IPPP CU16 AQ + deblocking, "
        "IPPP CTU 32 AQ + intra-in-P, IBP CTU 32 AQ + deblocking, three "
        "references with AQ + deblocking) == the JAX Encoder's digests "
        "with the spec's AMVP lists")


def encode_all(enc, frames):
    efs = []
    for f in frames:
        efs.extend(enc.encode(*f))
    efs.extend(enc.flush())
    return efs


def check_frames(efs, frames, types_, floor=25.0):
    """The frame types, each recon's shape and finite values, and a luma
    PSNR floor (25 dB at QP 32 on the bench clip); the mean PSNR."""
    from homerhevc_tpu_torch.utils.metrics import psnr
    check([e.frame_type for e in efs] == types_, [e.frame_type for e in efs])
    ps = []
    for e, (y, u, v) in zip(efs, frames):
        r = e.recon
        check(r["y"].shape == y.shape and r["y"].dtype == np.uint8)
        check(r["u"].shape == u.shape)
        check(np.isfinite(r["y"].astype(np.float64)).all())
        ps.append(psnr(r["y"], y))
    check(min(ps) > floor, ps)
    return float(np.mean(ps))


def spy_emit(pipe):
    """Record each frame's FrameDesc and its emission time on pipe."""
    descs, emitted = [], []
    emit = pipe._emit

    def spy(desc, *a, **k):
        descs.append(desc)
        ef = emit(desc, *a, **k)
        emitted.append(time.perf_counter())
        return ef
    pipe._emit = spy
    return descs, emitted


def phase_main_path(frames):
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.config import EncoderConfig
    from homerhevc_tpu_torch.device import LAUNCHES, reset_launches
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    cfg = EncoderConfig(width=W, height=H, cu_size=16, gop_size=1, qp=32,
                        sign_hiding=True, deblocking=True, sao=False)
    # warm-up (CUDA context, cuBLAS handles, caches): 1 I + 2 P
    encode_all(Encoder(cfg), frames[:3])
    torch.cuda.synchronize()
    enc = Encoder(cfg)
    PROFILER.reset()
    PROFILER.enable()
    reset_launches()
    t = time.perf_counter()
    efs = encode_all(enc, frames[:N_IPPP])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = dict(LAUNCHES)
    n_p = N_IPPP - 1
    check(len(efs) == N_IPPP, len(efs))
    if launches["coarse_sweep_sads"] != n_p:
        raise AssertionError(f"coarse sweep launched "
                             f"{launches['coarse_sweep_sads']} times for "
                             f"{n_p} P frames")
    mean_psnr = check_frames(efs, frames, ["I"] + ["P"] * n_p)
    bits = [e.bits for e in efs]
    log(f"[main] 720p IPPP CU16 qp32 deblock: {N_IPPP} frames (1 I + {n_p} "
        f"P) in {dt:.3f} s = {N_IPPP / dt:.3f} fps; bits/frame "
        f"{np.mean(bits):.0f} (I {bits[0]}, P mean "
        f"{np.mean(bits[1:]):.0f}); luma PSNR {mean_psnr:.2f} dB; "
        f"coarse sweep launches {launches['coarse_sweep_sads']}")
    log("[main] host scopes:\n" + PROFILER.report())
    # the same two frames through the plain CPU path: identical stream
    t = time.perf_counter()
    cpu = encode_all(Encoder(cfg, device="cpu"), frames[:2])
    check(b"".join(e.annex_b() for e in cpu)
          == b"".join(e.annex_b() for e in efs[:2]),
          "CUDA stream != CPU stream")
    log(f"[main] I+P at 720p re-encoded on the CPU (plain path, "
        f"{time.perf_counter() - t:.1f} s): Annex-B bytes identical")

    cfg0 = EncoderConfig(width=W, height=H, cu_size=16, gop_size=0, qp=32,
                         sign_hiding=True, deblocking=False, sao=False,
                         num_frames_in_flight=F_INTRA)
    encode_all(Encoder(cfg0), frames[:F_INTRA])  # warm-up
    enc0 = Encoder(cfg0)
    t = time.perf_counter()
    efs0 = encode_all(enc0, frames[:N_INTRA])
    torch.cuda.synchronize()
    dt0 = time.perf_counter() - t
    mean0 = check_frames(efs0, frames, ["I"] * N_INTRA)
    log(f"[main] 720p all-intra CU16 qp32 (bench.py config, "
        f"{F_INTRA} frames in flight): {N_INTRA} frames in {dt0:.3f} s = "
        f"{N_INTRA / dt0:.3f} fps; bits/frame "
        f"{np.mean([e.bits for e in efs0]):.0f}; luma PSNR {mean0:.2f} dB")
    return launches


def tree_config(w, h, cu, frames_in_flight=F_TREE):
    """Path A: all-intra CU tree, fast decision, fixed QP 32, sign hiding,
    deblocking and SAO."""
    from homerhevc_tpu_torch.config import EncoderConfig
    return EncoderConfig(width=w, height=h, cu_size=cu, gop_size=0, qp=32,
                         intra_rdo=True, sign_hiding=True, deblocking=True,
                         sao=True, num_frames_in_flight=frames_in_flight)


def sao_share(params):
    """(share of CTBs with SAO on in luma or chroma, frames with any)."""
    on = [(p.type_luma != 0) | (p.type_chroma != 0) for p in params]
    return (float(np.mean([o.mean() for o in on])),
            sum(bool(o.any()) for o in on))


def phase_tree_path(frames):
    """Path A on the card: 1080p all-intra CU32 and CU64 with intra_rdo,
    deblocking and SAO, one batch of F_TREE frames each (after a 256x128
    warm-up of the same configuration). Returns the slice NAL of CU32's
    frame 0, which path D's CPU re-encode of the same frame alone (its
    I0: the same tree program, frame and QP) must give."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.device import LAUNCHES, reset_launches
    small = bench_frames(F_TREE, w=256, h=128)
    for cu in (32, 64):
        encode_all(Encoder(tree_config(256, 128, cu)), small)   # warm-up
        torch.cuda.synchronize()
        enc = Encoder(tree_config(W_TREE, H_TREE, cu))
        params = []
        emit = enc._pipeline._emit

        def spy(desc, *a, **k):
            params.append(desc.sao_params)
            return emit(desc, *a, **k)
        enc._pipeline._emit = spy
        reset_launches()
        t = time.perf_counter()
        efs = encode_all(enc, frames)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        check(all(v == 0 for v in LAUNCHES.values()), dict(LAUNCHES))
        mean_psnr = check_frames(efs, frames, ["I"] * F_TREE)
        share, n_on = sao_share(params)
        tree = enc._pipeline._intra()
        log(f"[tree] 1080p all-intra CU{cu} intra_rdo qp32 deblock+SAO, "
            f"{F_TREE} frames in flight: {F_TREE} frames in {dt:.3f} s = "
            f"{F_TREE / dt:.4f} fps; bits/frame "
            f"{np.mean([e.bits for e in efs]):.0f}; luma PSNR "
            f"{mean_psnr:.2f} dB; SAO on in {100 * share:.1f}% of CTBs, "
            f"{n_on}/{F_TREE} frames; {tree.nsteps} wavefront steps of "
            f"{tree.nslot} CTB32 slots; kernel launches "
            f"{dict(LAUNCHES)} (no hand kernel on this path)")
        if cu == 32:
            first = efs[0].nals[-1]
    return first


def phase_sao_ippp(frames):
    """Path B on the card: 720p IPPP CU16 with SAO (1 I + 7 P); the coarse
    sweep kernel runs once per P frame; the first two frames re-encoded on
    the CPU give identical bytes."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.config import EncoderConfig
    from homerhevc_tpu_torch.device import LAUNCHES, reset_launches
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    cfg = EncoderConfig(width=W, height=H, cu_size=16, gop_size=1, qp=32,
                        sign_hiding=True, deblocking=True, sao=True)
    encode_all(Encoder(cfg), frames[:3])                     # warm-up
    torch.cuda.synchronize()
    enc = Encoder(cfg)
    PROFILER.reset()
    PROFILER.enable()
    reset_launches()
    t = time.perf_counter()
    efs = encode_all(enc, frames[:N_SAO])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = dict(LAUNCHES)
    check(launches["coarse_sweep_sads"] == N_SAO - 1, launches)
    mean_psnr = check_frames(efs, frames, ["I"] + ["P"] * (N_SAO - 1))
    log(f"[sao] 720p IPPP CU16 qp32 deblock+SAO: {N_SAO} frames (1 I + "
        f"{N_SAO - 1} P) in {dt:.3f} s = {N_SAO / dt:.3f} fps; bits/frame "
        f"{np.mean([e.bits for e in efs]):.0f}; luma PSNR {mean_psnr:.2f} "
        f"dB; coarse sweep launches {launches['coarse_sweep_sads']}")
    log("[sao] host scopes:\n" + PROFILER.report())
    cpu = encode_all(Encoder(cfg, device="cpu"), frames[:2])
    check(b"".join(e.annex_b() for e in cpu)
          == b"".join(e.annex_b() for e in efs[:2]),
          "CUDA IPPP+SAO stream != CPU stream")
    log("[sao] I+P at 720p with SAO re-encoded on the CPU: Annex-B bytes "
        "identical")
    return launches["coarse_sweep_sads"]


def tree_share(descs, ps):
    """(share of CTB32 areas coded as one CU32, share coded inside a CU64)
    over the P frames descs."""
    d = np.stack([desc.cu_depth[::4, ::4] for desc in descs])
    cu32 = float(np.mean(d == ps.log2_ctu - 5))
    return cu32, (float(np.mean(d == 0)) if ps.ctu_size == 64 else 0.0)


def phase_path_c(frames):
    """Path C on the card: 1080p IPPP (1 I + 7 P) with the CU tree,
    intra_rdo, deblocking and SAO at CTU 64, then at CTU 32 in the FAST
    mode, each after a 256x128 warm-up of the same configuration; the sweep
    runs once per P frame, some CTBs code as CU32 / CU64; the I and first P
    frame of CTU 64 re-encoded on the CPU give the same Annex-B bytes;
    CTU 32's I frame split by stage (stage_timer); one CTU-64 P frame
    under torch.profiler and counted by aten op. Returns the sweep's
    launches."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.device import LAUNCHES, reset_launches
    from homerhevc_tpu_torch.tools.p_frame_ops import (count_p_frame,
                                                       p_frame_config)
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    small = bench_frames(3, w=256, h=128)
    n_p = N_PATH_C - 1
    sweeps = 0
    card64 = None
    for label, cu, perf in (("CTU 64", 64, 0), ("CTU 32 FAST", 32, 1)):
        encode_all(Encoder(p_frame_config(256, 128, cu, perf)), small)
        torch.cuda.synchronize()
        enc = Encoder(p_frame_config(W_TREE, H_TREE, cu, perf))
        pipe = enc._pipeline
        descs, emitted = spy_emit(pipe)
        if cu == 32:
            # the I frame's stage split (the tree encoder's five stages,
            # the card synchronised around each)
            stages, unstage = stage_timer(pipe._intra())
        PROFILER.reset()
        PROFILER.enable()
        reset_launches()
        t = time.perf_counter()
        efs = encode_all(enc, frames)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        dt = t_end - t
        launches = dict(LAUNCHES)
        check(launches["coarse_sweep_sads"] == n_p, launches)
        sweeps += launches["coarse_sweep_sads"]
        mean_psnr = check_frames(efs, frames, ["I"] + ["P"] * n_p)
        cu32, cu64 = tree_share(descs[1:], pipe.ps)
        check(cu32 + cu64 > 0, "no CTB coded as one CU32 / CU64")
        bits = [e.bits for e in efs]
        log(f"[path C] 1080p IPPP {label} intra_rdo qp32 deblock+SAO: "
            f"{N_PATH_C} frames (1 I + {n_p} P) in {dt:.3f} s = "
            f"{N_PATH_C / dt:.4f} fps; I frame {emitted[0] - t:.3f} s, P "
            f"frames {(t_end - emitted[0]) / n_p * 1e3:.1f} ms each "
            f"({n_p / (t_end - emitted[0]):.3f} fps); bits/frame "
            f"{np.mean(bits):.0f} (I {bits[0]}, P mean "
            f"{np.mean(bits[1:]):.0f}); luma PSNR {mean_psnr:.2f} dB; CTB32 "
            f"areas of the P frames coded as one CU32 {100 * cu32:.1f}%, "
            f"inside a CU64 {100 * cu64:.1f}%; coarse sweep launches "
            f"{launches['coarse_sweep_sads']}")
        log(f"[path C] {label} host scopes:\n" + PROFILER.report())
        if cu == 32:
            unstage()
            i_s = emitted[0] - t
            log(f"[stages] 1080p CU32 tree I frame (path C, CTU 32 FAST): "
                f"{i_s:.3f} s to its emission; " + ", ".join(
                    f"{k} {stages[k]:.3f} s ({100 * stages[k] / i_s:.1f}%)"
                    for k in TREE_STAGES.values()))
        if cu == 64:
            card64 = b"".join(e.annex_b() for e in efs[:2])
            pe = pipe._inter()
            ref = pe.last_dev
            src = [pipe._pad_frame(*f) for f in frames[1:3]]
            ops, compute = count_p_frame(pe, src[0], ref)
            log(f"[path C] one CTU-64 P frame: {ops} aten ops, {compute} "
                f"not views")
            n_k, busy, wall = profile_window(
                "path C CTU 64, one P frame (dispatch)",
                lambda: pe.dispatch(src[0], ref))
            log(f"[path C] CTU 64: {n_k} kernels, device busy "
                f"{busy:.2f} ms per P frame")
    t = time.perf_counter()
    cpu = encode_all(Encoder(p_frame_config(W_TREE, H_TREE, 64),
                             device="cpu"), frames[:2])
    check(b"".join(e.annex_b() for e in cpu) == card64,
          "CUDA path C stream != CPU stream")
    log(f"[path C] 1080p CTU 64 I + P re-encoded on the CPU (plain path, "
        f"{time.perf_counter() - t:.1f} s): Annex-B bytes identical")
    return sweeps


def ibp_config(w, h):
    """Path D: IBP (gop_size 2, one B between anchors) at CTU 32 with
    intra_rdo, deblocking, SAO, sign hiding, QP 32 and me_range 32 (the IBP
    search range is 24), one IDR and no scene-cut check."""
    from homerhevc_tpu_torch.config import EncoderConfig
    return EncoderConfig(width=w, height=h, cu_size=32, gop_size=2, qp=32,
                         intra_rdo=True, sign_hiding=True, deblocking=True,
                         sao=True, me_range=32, intra_period=0,
                         reinit_gop_on_scene_change=False)


def first_frames(enc, frames, n):
    """The first n EncodedFrames enc gives for frames (decode order),
    without coding the rest."""
    out = []
    for f in frames:
        for e in enc.encode(*f):
            out.append(e)
            if len(out) == n:
                return out
    raise AssertionError(f"{len(out)} frames out of {len(frames)} pushed")


def phase_path_d(frames, tree_slice):
    """Path D on the card: 1080p IBP at CTU 32, I0 P2 B1 A4 B3 A6 B5 A8 B7
    (every frame after P2 runs the bi-capable program), after a 256x128
    warm-up of the same configuration; the sweep runs once per P frame
    and three times per bi frame (twice on the source, once wide on the
    bi target); I0 P2 B1 re-encoded on the CPU give the same Annex-B
    bytes, and I0's slice on the CPU is tree_slice, path A's frame 0 from
    the card's batch of F_TREE (the same tree program on the same frame);
    one bi frame under torch.profiler and counted by aten op. Returns the
    launches of the sweep's two entry points."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.device import LAUNCHES, reset_launches
    from homerhevc_tpu_torch.tools.p_frame_ops import count_b_frame
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    encode_all(Encoder(ibp_config(256, 128)), bench_frames(5, w=256, h=128))
    torch.cuda.synchronize()
    enc = Encoder(ibp_config(W_TREE, H_TREE))
    pipe = enc._pipeline
    descs, emitted = spy_emit(pipe)
    PROFILER.reset()
    PROFILER.enable()
    reset_launches()
    t = time.perf_counter()
    efs = encode_all(enc, frames)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    dt = t_end - t
    launches = dict(LAUNCHES)
    check([e.poc for e in efs] == [0, 2, 1, 4, 3, 6, 5, 8, 7],
          [e.poc for e in efs])
    check([e.frame_type for e in efs] == ["I", "P"] + ["B"] * 7,
          [e.frame_type for e in efs])
    n_bi = N_PATH_D - 2
    check(launches["coarse_sweep_sads"] == 1 + 2 * n_bi, launches)
    check(launches["coarse_sweep_sads_wide"] == n_bi, launches)
    by_poc = sorted(efs, key=lambda e: e.poc)
    mean_psnr = check_frames(by_poc, frames,
                             [e.frame_type for e in by_poc])
    share = float(np.mean([(d.inter_dir == 3).mean() for d in descs[2:]]))
    check(0.0 < share, "no 8x8 unit coded bi")
    bits = [e.bits for e in efs]
    steps = zip(emitted[1:], emitted[2:])        # each bi frame's wall
    log(f"[path D] 1080p IBP CTU 32 intra_rdo qp32 deblock+SAO, search "
        f"{pipe._inter().search}: {N_PATH_D} frames (I0 P2 B1 A4 B3 A6 B5 "
        f"A8 B7) in {dt:.3f} s = {N_PATH_D / dt:.4f} fps; I frame "
        f"{emitted[0] - t:.3f} s, P2 {(emitted[1] - emitted[0]) * 1e3:.1f} "
        f"ms, bi frames {(t_end - emitted[1]) / n_bi * 1e3:.1f} ms each "
        f"({', '.join(f'{(b - a) * 1e3:.0f}' for a, b in steps)} ms); "
        f"bits/frame {np.mean(bits):.0f} (I {bits[0]}, P2 {bits[1]}, "
        f"anchors {np.mean(bits[3::2]):.0f}, B {np.mean(bits[2::2]):.0f}); "
        f"luma PSNR {mean_psnr:.2f} dB; 8x8 units coded bi in the bi "
        f"frames {100 * share:.1f}%; sweep launches {launches}")
    log("[path D] host scopes:\n" + PROFILER.report())
    pe = pipe._inter()
    src = pipe._pad_frame(*frames[7])
    ref0, ref1 = pipe._anchor_m2, pipe._last_recon
    ops, compute = count_b_frame(pe, src, ref0, ref1)
    log(f"[path D] one bi frame: {ops} aten ops, {compute} not views")
    n_k, busy, wall = profile_window(
        "path D, one bi frame (dispatch_b)",
        lambda: pe.dispatch_b(src, ref0, ref1))
    log(f"[path D] one bi frame: {n_k} kernels, device busy {busy:.2f} ms "
        f"of {wall:.2f} ms")
    t = time.perf_counter()
    cpu = first_frames(Encoder(ibp_config(W_TREE, H_TREE), device="cpu"),
                       frames, N_PATH_D_CPU)
    check(b"".join(e.annex_b() for e in cpu)
          == b"".join(e.annex_b() for e in efs[:N_PATH_D_CPU]),
          "CUDA path D stream != CPU stream")
    check(cpu[0].nals[-1] == tree_slice,
          "path A's batched CU32 frame 0 on the card != I0 on the CPU")
    log(f"[path D] I0 P2 B1 re-encoded on the CPU (plain path, "
        f"{time.perf_counter() - t:.1f} s): Annex-B bytes identical; I0's "
        f"slice equal to path A's frame 0 from the card's batch of "
        f"{F_TREE}")
    return (launches["coarse_sweep_sads"],
            launches["coarse_sweep_sads_wide"])


def config3(**kw):
    """Path E: BASELINE config 3, 720p IPPP CU16 with quarter-pel motion
    estimation, CBR at 1250 kbps with a VBV of 1 s, deblocking, SAO and
    sign hiding at 25 fps (kw: the changes of E1)."""
    from homerhevc_tpu_torch.config import BitrateMode, EncoderConfig
    return EncoderConfig(**{**dict(
        width=W, height=H, cu_size=16, gop_size=1, qp=32,
        bitrate_mode=BitrateMode.CBR, bitrate_kbps=1250, vbv_size=1.0,
        deblocking=True, sao=True, sign_hiding=True), **kw})


def qp_off_share(descs, efs):
    """The share of CTBs (equally, of 8x8 units) whose QP differs from
    their slice's QP, over frames that carry a per-CTB QP map."""
    shares = [float(np.mean(d.qp_map != e.avg_qp)) for d, e in zip(descs, efs)
              if d.qp_map is not None]
    return float(np.mean(shares)) if shares else 0.0


def phase_path_e(frames, frames_1080):
    """Path E on the card: per-CTB QP maps and rate control. E0 is
    BASELINE config 3 (720p IPPP CU16, quarter-pel, CBR 1250 kbps, VBV
    1 s, deblocking, SAO), 1 I + 15 P on the depth-2 P chain; E1 the same
    with AQ (strength 2) and row-RC, deblocking off, every P frame inline
    with its map; each after a 3-frame warm-up of its configuration, its
    I and first two P frames re-encoded on the CPU (identical bytes), and
    one P frame of each under torch.profiler. E2 is bench.py's all-intra
    CU16 with AQ,
    4 frames in flight. E3 one 1088-line CTU-64 P frame with a map
    through the P program on the card and on the CPU (every field equal).
    Returns the sweep's launches."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.config import EncoderConfig
    from homerhevc_tpu_torch.device import LAUNCHES, reset_launches
    from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
    from homerhevc_tpu_torch.engine.rate_control import aq_qp_map
    from homerhevc_tpu_torch.hevc.headers import ParamSets
    from homerhevc_tpu_torch.state import reference_from_numpy
    from homerhevc_tpu_torch.tools.p_frame_ops import count_p_frame
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    t_e = time.perf_counter()
    sweeps = 0
    n_p = N_PATH_E - 1
    for label, cfg in (("E0 config 3", config3()),
                       ("E1 config 3 + AQ + row-RC", config3(
                           aq_strength=2.0, rc_ctu=True, deblocking=False))):
        encode_all(Encoder(cfg), frames[:3])                 # warm-up
        torch.cuda.synchronize()
        enc = Encoder(cfg)
        pipe = enc._pipeline
        descs, emitted = spy_emit(pipe)
        PROFILER.reset()
        PROFILER.enable()
        reset_launches()
        t = time.perf_counter()
        efs = encode_all(enc, frames[:N_PATH_E])
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = dict(LAUNCHES)
        check(launches["coarse_sweep_sads"] == n_p, launches)
        sweeps += launches["coarse_sweep_sads"]
        # CBR drives the QP up to the budget: a lower sanity floor
        mean_psnr = check_frames(efs, frames, ["I"] + ["P"] * n_p, 18.0)
        bits = [e.bits for e in efs]
        kbps = float(np.sum(bits)) / N_PATH_E * cfg.frame_rate / 1e3
        kbps_p = float(np.mean(bits[1:])) * cfg.frame_rate / 1e3
        share = qp_off_share(descs, efs)
        if cfg.aq_strength > 0:
            check(share > 0, "no CTB coded away from its slice QP")
        qps = [e.avg_qp for e in efs]
        log(f"[path E] {label}: {N_PATH_E} frames (1 I + {n_p} P) in "
            f"{t_end - t:.3f} s = {N_PATH_E / (t_end - t):.3f} fps; I frame "
            f"{emitted[0] - t:.3f} s, P frames "
            f"{(t_end - emitted[0]) / n_p * 1e3:.1f} ms each; "
            f"{kbps:.1f} kbps over the clip against {cfg.bitrate_kbps} "
            f"({100 * kbps / cfg.bitrate_kbps:.1f}%), the P frames "
            f"{kbps_p:.1f} kbps; slice QPs {qps}; bits/frame "
            f"{np.mean(bits):.0f} (I {bits[0]}); luma PSNR {mean_psnr:.2f} "
            f"dB; CTBs away from their slice QP {100 * share:.1f}%; coarse "
            f"sweep launches {launches['coarse_sweep_sads']}")
        log(f"[path E] {label} host scopes:\n" + PROFILER.report())
        t = time.perf_counter()
        cpu = first_frames(Encoder(cfg, device="cpu"), frames, N_PATH_E_CPU)
        check(b"".join(e.annex_b() for e in cpu)
              == b"".join(e.annex_b() for e in efs[:N_PATH_E_CPU]),
              f"CUDA {label} stream != CPU stream")
        log(f"[path E] {label}: I + 2 P re-encoded on the CPU (plain path, "
            f"{time.perf_counter() - t:.1f} s): Annex-B bytes identical")
    # one P frame with and without a map under torch.profiler: E0's
    # (deblocking on, no map) and E1's (a map, deblocking off)
    src, ref = frames[2], reference_from_numpy(frames[1], DEV)
    qp_map = aq_qp_map(src[0], 16, 32, 2.0)
    for label, cfg, m in (("E0 P frame", config3(), None),
                          ("E1 P frame with a map",
                           config3(deblocking=False), qp_map)):
        pe = TorchInterEncoder(ParamSets.from_config(cfg), cfg, device=DEV)
        pe.encode_frame(src, ref, qp_map=m)                 # warm-up
        ops, compute = count_p_frame(pe, src, ref, m)
        n_k, busy, wall = profile_window(
            f"path E {label} (dispatch)",
            lambda: pe.dispatch(src, ref, qp_map=m))
        log(f"[path E] {label}: {ops} aten ops, {compute} not views; "
            f"{n_k} kernels, device busy {busy:.2f} ms")
    # E2: bench.py's configuration with AQ
    cfg2 = EncoderConfig(width=W, height=H, cu_size=16, gop_size=0, qp=32,
                         sign_hiding=True, deblocking=False, sao=False,
                         aq_strength=2.0, num_frames_in_flight=F_INTRA)
    encode_all(Encoder(cfg2), frames[:F_INTRA])               # warm-up
    enc2 = Encoder(cfg2)
    descs, _ = spy_emit(enc2._pipeline)
    reset_launches()
    t = time.perf_counter()
    efs2 = encode_all(enc2, frames[:N_INTRA])
    torch.cuda.synchronize()
    dt2 = time.perf_counter() - t
    check(all(v == 0 for v in LAUNCHES.values()), dict(LAUNCHES))
    mean2 = check_frames(efs2, frames, ["I"] * N_INTRA)
    share2 = qp_off_share(descs, efs2)
    check(share2 > 0, "no CTB coded away from its slice QP")
    log(f"[path E] E2 720p all-intra CU16 AQ qp32 ({F_INTRA} frames in "
        f"flight): {N_INTRA} frames in {dt2:.3f} s = {N_INTRA / dt2:.3f} "
        f"fps; bits/frame {np.mean([e.bits for e in efs2]):.0f}; luma PSNR "
        f"{mean2:.2f} dB; CTBs away from their slice QP "
        f"{100 * share2:.1f}%")
    # E3: one CTU-64 P frame with a map, card against CPU (1080 lines
    # code as 1088, padded as the pipeline pads)
    from homerhevc_tpu_torch.tools.p_frame_ops import p_frame_config
    cfg3 = p_frame_config(W_TREE, H_TREE, 64, deblocking=False)
    pipe3 = Encoder(cfg3, device="cpu")._pipeline
    pad = [pipe3._pad_frame(*f) for f in frames_1080]
    cfg3 = pipe3.cfg
    qp_map = aq_qp_map(pad[1][0], 64, 32, 2.0)
    out = {}
    for dev in (DEV, "cpu"):
        pe = TorchInterEncoder(ParamSets.from_config(cfg3), cfg3, device=dev)
        ref = reference_from_numpy(pad[0], dev)
        if dev == DEV:
            pe.encode_frame(pad[1], ref, qp_map=qp_map)      # warm-up
            torch.cuda.synchronize()
            reset_launches()
        t = time.perf_counter()
        desc, *rec = pe.encode_frame(pad[1], ref, qp_map=qp_map)
        out[dev] = (desc, [np.asarray(p) for p in rec],
                    time.perf_counter() - t)
        if dev == DEV:
            check(LAUNCHES["coarse_sweep_sads"] == 1, dict(LAUNCHES))
            sweeps += 1
    (cd, crec, ct), (hd, hrec, ht) = out[DEV], out["cpu"]
    for f in ("cu_depth", "tr_depth", "pred_mode", "mv", "coef_y", "coef_u",
              "coef_v", "skip", "inter_mode", "merge_idx", "root_cbf",
              "mvp_flag", "qp_map", "row_ssd_y"):
        check(np.array_equal(getattr(cd, f), getattr(hd, f)),
              f"E3: {f} differs between the card and the CPU")
    check(all(np.array_equal(a, b) for a, b in zip(crec, hrec)),
          "E3: recon differs between the card and the CPU")
    depths = sorted(int(d) for d in np.unique(cd.cu_depth))
    log(f"[path E] E3 {cfg3.height}-line CTU-64 P frame with a per-CTB "
        f"map (QPs {int(qp_map.min())}..{int(qp_map.max())}, "
        f"{100 * float(np.mean(qp_map != 32)):.1f}% of CTBs away from 32): "
        f"card {ct * 1e3:.1f} ms, CPU {ht:.1f} s; CU depths {depths}; every "
        f"field, the recon and the row SSDs equal")
    log(f"[path E] E0-E3 took {time.perf_counter() - t_e:.1f} s")
    return sweeps


F0_ARGS = ["-gop_size", "1", "-motion_estimation_precision", "0", "-qp",
           "32"]                 # BASELINE config 2 with the CLI's defaults
F1_ARGS = ["-gop_size", "1", "-motion_estimation_precision", "1",
           "-scaling_lists", "1", "-wpp", "1"]
N_PATH_F0 = 8                 # F0: 1 I + 7 P
N_PATH_F1 = 8                 # F1: 1 I + 7 P
N_PATH_F_CPU = 3              # F0's and F1's I + 2 P re-encoded on the CPU
N_PATH_F_RD = 8               # measure_rd's frames of F0's clip


def run_cli(argv):
    """homerhevc_tpu_torch.cli.main(argv) in this process: its return code
    and its standard output lines."""
    import contextlib
    import io
    from homerhevc_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def phase_path_f(frames):
    """Path F: the CLI, homerhevc_tpu_torch.cli.main, in this process so
    that the launch counters count it. F0 is BASELINE config 2 (720p
    IPPP CU16, full-pel ME, fixed QP 32; deblocking, SAO and sign hiding
    at the CLI's defaults), 1 I + 7 P with -psnr and -profile: the sweep
    once per P frame, its I + 2 P re-encoded by the CLI on the CPU
    (identical bytes and recon), the -o-raw file equal to the frames'
    recon, every slice of the stream parsed back by the port's
    SliceDataParser into the modes, MVs, levels and SAO parameters that
    were serialized; one F0 P frame under torch.profiler. F1 is F0 with
    half-pel ME, scaling lists and WPP, 1 I + 7 P, its I + 2 P equal on
    the CPU; `python -m
    homerhevc_tpu_torch.cli` with F1's arguments in a subprocess gives the
    same bytes and imports neither jax nor homerhevc_tpu. Then the twins:
    tools/measure_rd on F0's file (8 frames, QPs 32 and 37; at QP 32 the
    kbps of the CLI's first 8 frames), tools/prof_device (me, impl and
    fetch at 1088 lines, the CU32 tree P program). Returns the sweep's
    launches of F0 and F1."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f_") as tmp:
        return _path_f(frames, tmp)


def _path_f(frames, tmp):
    """Path F with its files in the directory tmp."""
    import contextlib
    import io
    import os
    from homerhevc_tpu_torch.device import LAUNCHES, reset_launches
    from homerhevc_tpu_torch.hevc.parse import (SerializedSlices,
                                                desc_mismatches,
                                                parse_slice_nal,
                                                split_annexb)
    from homerhevc_tpu_torch.tools import measure_rd, prof_device
    from homerhevc_tpu_torch.tools.p_frame_ops import read_yuv, write_yuv
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    t_f = time.perf_counter()
    src = os.path.join(tmp, "clip.yuv")
    write_yuv(src, frames[:N_IPPP])
    size = ["-widthxheight", f"{W}x{H}"]

    def io_args(tag, n):
        return ["-i", src, "-o", os.path.join(tmp, f"{tag}.265"),
                "-o-raw", os.path.join(tmp, f"{tag}.yuv"), *size,
                "-n_frames", str(n)]

    def stream(tag):
        with open(os.path.join(tmp, f"{tag}.265"), "rb") as f:
            return f.read()

    sweeps = 0
    for label, tag, args, n in (("F0 config 2", "f0", F0_ARGS, N_PATH_F0),
                                ("F1 config 2 + half-pel + scaling lists + "
                                 "WPP", "f1", F1_ARGS, N_PATH_F1)):
        PROFILER.reset()
        PROFILER.enable()
        reset_launches()
        with SerializedSlices() as spy:
            t = time.perf_counter()
            rc, out = run_cli(io_args(tag, n) + args
                              + (["-psnr", "-profile"] if tag == "f0"
                                 else []))
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        check(rc == 0, f"{label}: the CLI returned {rc}")
        launches = dict(LAUNCHES)
        check(launches["coarse_sweep_sads"] == n - 1,
              f"{label}: {launches} for {n - 1} P frames")
        sweeps += launches["coarse_sweep_sads"]
        efs = spy.frames
        rec = list(read_yuv(os.path.join(tmp, f"{tag}.yuv"), W, H))
        check(len(rec) == len(efs) == n, (len(rec), len(efs)))
        for e, r in zip(efs, rec):
            check(all(np.array_equal(e.recon[c], r[i])
                      for i, c in enumerate("yuv")),
                  f"{label}: -o-raw differs from frame {e.poc}'s recon")
        mean_psnr = check_frames(efs, frames, ["I"] + ["P"] * (n - 1))
        data = stream(tag)
        nals = [x for x in split_annexb(data) if (x[0] >> 1) & 0x3F < 32]
        check(nals == [nal for _, _, _, nal in spy.slices],
              f"{label}: the stream's slices are not the serialized ones")
        summary = [ln for ln in out if " frames in " in ln
                   or ln.startswith("average PSNR")]
        log(f"[path F] {label}: the CLI's lines: {' | '.join(summary)}; "
            f"{n} frames in {t_end - t:.3f} s = {n / (t_end - t):.3f} fps, "
            f"I frame {spy.emitted[0] - t:.3f} s, P frames "
            f"{(t_end - spy.emitted[0]) / (n - 1) * 1e3:.1f} ms each; "
            f"{len(data) * 8 * 25.0 / n / 1e3:.1f} kbps; bits/frame "
            f"{np.mean([e.bits for e in efs]):.0f}; luma PSNR "
            f"{mean_psnr:.2f} dB; coarse sweep launches "
            f"{launches['coarse_sweep_sads']}")
        if tag == "f0":
            log("[path F] F0 host scopes (the CLI's -profile):\n"
                + "\n".join(ln for ln in out if " ms total, " in ln))
            t = time.perf_counter()
            for ps, desc, sao, nal in spy.slices:
                _, p = parse_slice_nal(ps, nal)
                bad = desc_mismatches(p.d, desc, p.sao, sao)
                check(bad == [], f"F0: parsed slice differs in {bad}")
            log(f"[path F] F0: all {len(spy.slices)} slices parsed back "
                f"by the port's SliceDataParser into the serialized modes, "
                f"MVs, levels, skip flags and SAO parameters "
                f"({time.perf_counter() - t:.1f} s)")
            f0_efs = efs
        # the first frames through the CLI on the CPU: identical bytes
        t = time.perf_counter()
        rc, _ = run_cli(io_args(f"{tag}_cpu", N_PATH_F_CPU) + args
                        + ["-device", "cpu"])
        check(rc == 0, f"{label}: the CLI on the CPU returned {rc}")
        cpu = stream(f"{tag}_cpu")
        check(data[:len(cpu)] == cpu
              and data[len(cpu):len(cpu) + 4] == b"\x00\x00\x00\x01",
              f"CUDA {label} stream != CPU stream")
        cpu_rec = list(read_yuv(os.path.join(tmp, f"{tag}_cpu.yuv"),
                                W, H))
        check(all(np.array_equal(a[i], b[i]) for a, b in zip(cpu_rec, rec)
                  for i in range(3)), f"CUDA {label} recon != CPU recon")
        log(f"[path F] {label}: I + 2 P re-encoded by the CLI on the CPU "
            f"({time.perf_counter() - t:.1f} s): Annex-B bytes and recon "
            f"identical")
    # one P frame of F0's configuration under torch.profiler: launches
    # and device time of the full-pel P program (no sub-pel stage)
    from homerhevc_tpu_torch import cli
    from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
    from homerhevc_tpu_torch.hevc.headers import ParamSets
    from homerhevc_tpu_torch.state import reference_from_numpy
    from homerhevc_tpu_torch.tools.p_frame_ops import count_p_frame
    cfg0 = cli.config_from_args(cli.build_parser().parse_args(
        io_args("f0", N_PATH_F0) + F0_ARGS))
    pe = TorchInterEncoder(ParamSets.from_config(cfg0), cfg0, device=DEV)
    p_src, p_ref = frames[2], reference_from_numpy(frames[1], DEV)
    pe.encode_frame(p_src, p_ref)                           # warm-up
    ops, compute = count_p_frame(pe, p_src, p_ref)
    n_k, busy, _ = profile_window("path F F0 P frame (dispatch)",
                                  lambda: pe.dispatch(p_src, p_ref))
    log(f"[path F] F0 P frame: {ops} aten ops, {compute} not views; "
        f"{n_k} kernels, device busy {busy:.2f} ms")
    # the module entry point in a process of its own, with F1's arguments
    t = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "homerhevc_tpu_torch.cli",
         *io_args("f1_module", N_PATH_F1), *F1_ARGS],
        cwd=root, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, r.stderr[-3000:])
    mods = [ln.split("|")[-1].strip() for ln in r.stderr.splitlines()
            if ln.startswith("import time:") and "|" in ln]
    check("homerhevc_tpu_torch.api" in mods, "no import trace")
    bad = [m for m in mods if m.split(".")[0] in ("jax", "homerhevc_tpu")]
    check(not bad, f"python -m homerhevc_tpu_torch.cli imported {bad}")
    check(stream("f1_module") == stream("f1"),
          "python -m homerhevc_tpu_torch.cli: bytes differ from the "
          "in-process run's")
    log(f"[path F] python -m homerhevc_tpu_torch.cli with F1's arguments "
        f"({time.perf_counter() - t:.1f} s, the nvcc build of the sweep "
        f"included): {r.stdout.splitlines()[-1]}; bytes equal to the "
        f"in-process run's; {len(mods)} modules imported, none of jax or "
        f"homerhevc_tpu")

    # the twins, each printing its JSON lines
    def twin(fn, argv):
        buf = io.StringIO()
        reset_launches()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fn(argv)
        rows = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]
        check(rows, f"{fn.__module__} printed no JSON line")
        return rows, time.perf_counter() - t, LAUNCHES["coarse_sweep_sads"]

    rows, dt, n_k = twin(measure_rd.main, [
        "-i", src, "-w", str(W), "-ht", str(H), "-n", str(N_PATH_F_RD),
        "-cu", "16", "-sao", "-me_prec", "0", "-qps", "32,37"])
    for row in rows:
        log(f"[path F] measure_rd: {json.dumps(row)}")
    kbps8 = sum(e.bits for e in f0_efs[:N_PATH_F_RD]) * 25.0 \
        / N_PATH_F_RD / 1e3
    check(rows[0]["label"] == "rd_qp32" and rows[0]["kbps"] == round(
        kbps8, 1), f"measure_rd at QP 32: {rows[0]['kbps']} kbps, the "
        f"CLI's first {N_PATH_F_RD} frames {kbps8:.1f}")
    check(rows[1]["kbps"] < rows[0]["kbps"]
          and rows[1]["psnr_y"] < rows[0]["psnr_y"], rows)
    log(f"[path F] measure_rd ({dt:.1f} s, {n_k} sweeps): its QP-32 kbps "
        f"equals the CLI's over the same {N_PATH_F_RD} frames "
        f"({kbps8:.1f})")
    rows, dt, n_k = twin(prof_device.main, ["-probe", "me,impl,fetch",
                                            "-n", "3"])
    check([r["probe"] for r in rows] == ["hier_me", "impl_p",
                                         "dispatch_fetch"], rows)
    for row in rows:
        log(f"[path F] prof_device: {json.dumps(row)}")
    log(f"[path F] prof_device ({dt:.1f} s, {n_k} sweeps)")
    log(f"[path F] took {time.perf_counter() - t_f:.1f} s")
    return sweeps


N_PATH_G = 8                  # G0, G3: 1 I + 7 P
N_PATH_G1 = 4                 # G1: 1 I + 3 P
N_PATH_G2 = 1                 # G2: one all-intra frame
N_PATH_G_CPU = (2, 2, 3)      # G0's, G1's I + P, G3's I + 2 P on the CPU
W_G1, H_G1 = 416, 240         # G1: the HEVC class-D size
H_G1_CODED = 256              # G1's coded lines at CTU 32


def host_ippp_config(w, h, cu, **kw):
    """Path G's IPPP configurations: QP 32, sign hiding, deblocking and SAO,
    one IDR (kw: each cell's changes)."""
    from homerhevc_tpu_torch.config import EncoderConfig
    return EncoderConfig(**{**dict(
        width=w, height=h, cu_size=cu, gop_size=1, qp=32, intra_period=0,
        sign_hiding=True, deblocking=True, sao=True,
        reinit_gop_on_scene_change=False), **kw})


def record_host_i_frames(pipe):
    """Record what pipe's host intra programs return (the list grows as
    its I frames are coded)."""
    out = []
    analyze = pipe._analyze_intra_host

    def record(*a, **k):
        out.append(analyze(*a, **k))
        return out[-1]
    pipe._analyze_intra_host = record
    return out


def run_path_g(label, cfg, frames, n_cpu, profile=True):
    """Encode frames with cfg on the card (1 I + P frames; the I frame on
    the host programs, no device intra encoder built), the sweep launched
    once per P frame; the first n_cpu frames re-encoded on the CPU give
    the same bytes, the CPU pipeline taking the I frame the host programs
    coded in the card's run (numpy on this host either way: the CPU run
    checks the device P frames coded from it); with profile, one P frame
    under torch.profiler. Logs fps, the I frame's host seconds
    (the intra.host scope), ms per P frame, launches and device busy per P
    frame. Returns (EncodedFrames, FrameDescs, pipeline, sweep
    launches)."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.device import LAUNCHES, reset_launches
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    enc = Encoder(cfg)
    pipe = enc._pipeline
    descs, emitted = spy_emit(pipe)
    host_i = record_host_i_frames(pipe)
    PROFILER.reset()
    PROFILER.enable()
    reset_launches()
    t = time.perf_counter()
    efs = encode_all(enc, frames)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dict(LAUNCHES)
    n_p = len(frames) - 1
    check(launches["coarse_sweep_sads"] == n_p, launches)
    check(pipe._intra_enc is None, "a device intra encoder was built")
    host_s = PROFILER.totals["intra.host"]
    check(PROFILER.counts["intra.host"] == 1, PROFILER.counts)
    floor = 18.0 if cfg.bitrate_mode else 25.0
    mean_psnr = check_frames(efs, frames, ["I"] + ["P"] * n_p, floor)
    prof = "not profiled"
    if profile:
        pe = pipe._inter()
        src = pipe._pad_frame(*frames[-1])
        ref = pe.last_dev
        qp_map = pipe._inter_qp_map(src[0], cfg.qp)
        n_k, busy, _ = profile_window(
            f"path G {label}, one P frame (dispatch)",
            lambda: pe.dispatch(src, ref, qp_map=qp_map))
        prof = f"{n_k} kernels, device busy {busy:.2f} ms"
    bits = [e.bits for e in efs]
    log(f"[path G] {label}: {len(frames)} frames (1 I + {n_p} P) in "
        f"{t_end - t:.3f} s = {len(frames) / (t_end - t):.4f} fps; I frame "
        f"{emitted[0] - t:.3f} s ({host_s:.3f} s intra.host, "
        f"{PROFILER.totals['sao.decide']:.3f} s host SAO); P frames "
        f"{(t_end - emitted[0]) / n_p * 1e3:.1f} ms each; one P frame "
        f"{prof}; bits/frame "
        f"{np.mean(bits):.0f} (I {bits[0]}); luma PSNR {mean_psnr:.2f} dB; "
        f"coarse sweep launches {launches['coarse_sweep_sads']}")
    log(f"[path G] {label} host scopes:\n" + PROFILER.report())
    t = time.perf_counter()
    check(len(host_i) == 1, f"{len(host_i)} host I frames")
    cpu_enc = Encoder(cfg, device="cpu")
    cpu_enc._pipeline._analyze_intra_host = lambda *a, **k: host_i.pop()
    cpu = first_frames(cpu_enc, frames, n_cpu)
    check(not host_i, "the CPU run coded no I frame")
    check(b"".join(e.annex_b() for e in cpu)
          == b"".join(e.annex_b() for e in efs[:n_cpu]),
          f"CUDA path G {label} stream != CPU stream")
    log(f"[path G] {label}: the first {n_cpu} frames re-encoded on the "
        f"CPU (plain path from the card run's host I frame, "
        f"{time.perf_counter() - t:.1f} s): Annex-B bytes identical")
    return efs, descs, pipe, launches["coarse_sweep_sads"]


def g1_frames(n):
    """G1's clip: the bench clip at 416x240 with a 64x64 patch of
    concentric rings in its top-left corner, whose locally straight edges
    want 4x4 PUs."""
    g1 = bench_frames(n, w=W_G1, h=H_G1)
    yy, xx = np.mgrid[0:64, 0:64]
    rings = np.clip(60 + 60 * np.sin(0.8 * np.hypot(xx - 32.0, yy - 32.0)),
                    0, 255).astype(np.uint8)
    for y, _, _ in g1:
        y[:64, :64] = rings
    return g1


def phase_path_g(frames, frames_1080, frames_g1):
    """Path G on the card: the host intra programs (slice 7), each I frame
    on the host and the P frames on the device P programs (the card is
    warm from the earlier paths). G0: 1080p (1088 coded lines) IPPP at
    CTU 64 without intra_rdo, deblocking and SAO (fixed-CU32 host I frame,
    the CU64 tree P program), 1 I + 7 P, I + first P equal on the CPU,
    some CTBs of the P frames coded as CU64. G1: RD_FULL, 416x240 (256
    coded lines) IPPP at CTU 32 with intra_rdo (the host RD_FULL tree:
    NxN 4x4 PUs and TU splits present; frames_g1, g1_frames' clip),
    1 I + 3 P. G2: 720p all-intra CU16 with AQ (strength 2) and
    deblocking, one frame (the host program, deblocking at the
    decoder-view QP map), on the AQ cells' frames (a flat band over the
    top quarter) with a flat left column too, whose quantization groups
    below the band code nothing and so keep the QP predicted from the row
    above: some CTBs away from their slice QP, some units deblocked at
    the predictor's QP, no kernel launched, every slice parsed back into
    what was serialized and the parsed decoder-view QPs equal to those
    deblocking read. G3: 720p IPPP CU32 without intra_rdo, AQ + row-RC,
    deblocking off, CBR 1250 kbps (the host I frame with its map, the
    CU32 P program with a map per P frame, inline), 1 I + 7 P, I + 2 P
    equal on the CPU. G1's I + first P are equal on the CPU too. Returns
    the sweep's launches."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.config import BitrateMode, EncoderConfig
    from homerhevc_tpu_torch.device import LAUNCHES, reset_launches
    from homerhevc_tpu_torch.hevc.deblock import decoder_qp_map8
    from homerhevc_tpu_torch.hevc.parse import (SerializedSlices,
                                                desc_mismatches,
                                                parse_slice_nal)
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    t_g = time.perf_counter()
    sweeps = 0
    # G0
    efs, descs, pipe, n = run_path_g(
        "G0 1080p IPPP CTU 64 fixed-CU32 host I",
        host_ippp_config(W_TREE, H_TREE, 64), frames_1080[:N_PATH_G],
        N_PATH_G_CPU[0], profile=False)   # path C profiles its P program
    sweeps += n
    check(pipe.cfg.height == -(-H_TREE // 64) * 64, pipe.cfg.height)
    cu32, cu64 = tree_share(descs[1:], pipe.ps)
    check(cu64 > 0, "no CTB of the P frames coded as one CU64")
    log(f"[path G] G0: {pipe.cfg.height} coded lines; CTB32 areas of the "
        f"P frames coded as one CU32 "
        f"{100 * cu32:.1f}%, inside a CU64 {100 * cu64:.1f}%")
    # G1
    efs, descs, pipe, n = run_path_g(
        "G1 416x240 IPPP CTU 32 RD_FULL host tree",
        host_ippp_config(W_G1, H_G1, 32, intra_rdo=True, rd_mode=1),
        frames_g1,
        N_PATH_G_CPU[1])
    sweeps += n
    check(pipe.cfg.height == H_G1_CODED, pipe.cfg.height)
    nxn = float(np.mean(descs[0].part_nxn))
    split = float(np.mean(descs[0].tr_depth > 0))
    check(nxn > 0 and split > 0, "no NxN PU or TU split in the I frame")
    log(f"[path G] G1: {pipe.cfg.height} coded lines; the I frame's 8x8 "
        f"units in NxN CUs {100 * nxn:.1f}%, "
        f"under a TU split {100 * split:.1f}%")
    # G2
    cfg2 = EncoderConfig(width=W, height=H, cu_size=16, gop_size=0, qp=32,
                         sign_hiding=True, deblocking=True, sao=False,
                         aq_strength=2.0, num_frames_in_flight=N_PATH_G2)
    g2 = aq_frames(N_PATH_G2, W, H)
    for y, u, v in g2:
        y[:, :64] = 90
        for c in (u, v):
            c[:H // 8] = 128
            c[:, :32] = 128
    enc2 = Encoder(cfg2)
    PROFILER.reset()
    PROFILER.enable()
    reset_launches()
    with SerializedSlices() as spy:
        t = time.perf_counter()
        efs2 = encode_all(enc2, g2)
        torch.cuda.synchronize()
        dt2 = time.perf_counter() - t
    check(all(v == 0 for v in LAUNCHES.values()), dict(LAUNCHES))
    check(enc2._pipeline._intra_enc is None,
          "a device intra encoder was built")
    mean2 = check_frames(efs2, g2, ["I"] * N_PATH_G2)
    share2 = qp_off_share([d for _, d, _, _ in spy.slices], efs2)
    check(share2 > 0, "no CTB coded away from its slice QP")
    t = time.perf_counter()
    uncoded = 0
    for ps, desc, sao, nal in spy.slices:
        _, p = parse_slice_nal(ps, nal)
        bad = desc_mismatches(p.d, desc, p.sao, sao)
        check(not bad, f"G2: the parsed slice differs in {bad}")
        qp8 = decoder_qp_map8(desc, ps, cfg2.qp, wpp=ps.wpp)
        check(np.array_equal(p.d.qp_map.astype(np.int32), qp8),
              "G2: the decoder's QPs differ from those deblocking read")
        uncoded += int((qp8 != desc.qp_map).sum())
    check(uncoded > 0, "G2: no unit deblocked at its predictor's QP")
    log(f"[path G] G2 720p all-intra CU16 AQ + deblocking qp32 "
        f"({N_PATH_G2} frames in flight): {N_PATH_G2} frames in "
        f"{dt2:.3f} s = {N_PATH_G2 / dt2:.4f} fps; I frames "
        f"{PROFILER.totals['intra.host'] / N_PATH_G2:.3f} s each "
        f"intra.host; bits/frame "
        f"{np.mean([e.bits for e in efs2]):.0f}; luma PSNR {mean2:.2f} dB; "
        f"CTBs away from their slice QP {100 * share2:.1f}%; 8x8 units "
        f"deblocked at the predictor's QP, not their map's: {uncoded}; "
        f"{len(spy.slices)} slice(s) parsed back "
        f"({time.perf_counter() - t:.1f} s): "
        f"modes, levels and the decoder's QPs equal")
    # G3
    cfg3 = host_ippp_config(W, H, 32, aq_strength=2.0, rc_ctu=True,
                            deblocking=False, bitrate_mode=BitrateMode.CBR,
                            bitrate_kbps=1250, vbv_size=1.0)
    efs, descs, pipe, n = run_path_g(
        "G3 720p IPPP CU32 host I + AQ + row-RC CBR", cfg3,
        frames[:N_PATH_G], N_PATH_G_CPU[2])
    sweeps += n
    share = qp_off_share(descs, efs)
    check(share > 0 and all(d.qp_map is not None for d in descs),
          "G3: a frame without its map")
    kbps = float(np.sum([e.bits for e in efs])) / N_PATH_G \
        * cfg3.frame_rate / 1e3
    log(f"[path G] G3: {kbps:.1f} kbps over the clip against "
        f"{cfg3.bitrate_kbps} ({100 * kbps / cfg3.bitrate_kbps:.1f}%); "
        f"slice QPs {[e.avg_qp for e in efs]}; CTBs away from their slice "
        f"QP {100 * share:.1f}%")
    log(f"[path G] G0-G3 took {time.perf_counter() - t_g:.1f} s")
    return sweeps


N_PATH_H = (3, 4, 5, 3, 3)     # H0 1 I + 2 P, H1 1 I + 3 P, H2 I0 P2 B1 A4
                               # B3, H3 I0 P2 B1, H4 1 I + 2 P
N_PATH_H_CPU = (3, 3)          # H1's I + 2 P, H2's I0 P2 B1 on the CPU


def h_config(w, h, **kw):
    """Path H's configurations: QP 32, sign hiding, deblocking, one IDR
    (kw: each cell's changes)."""
    from homerhevc_tpu_torch.config import EncoderConfig
    return EncoderConfig(**{**dict(
        width=w, height=h, qp=32, gop_size=1, intra_period=0,
        sign_hiding=True, deblocking=True, sao=False,
        reinit_gop_on_scene_change=False), **kw})


def run_path_h(label, cfg, frames, types, sweeps, n_cpu=0):
    """Encode frames with cfg on the card (decode order types), the sweep
    launched `sweeps` times; every slice parsed back by the port's
    SliceDataParser into what was serialized, and where deblocking reads
    a per-CTB QP map, the parsed decoder-view QPs equal to those it read;
    the first n_cpu frames re-encoded on the CPU give the same bytes.
    Logs fps, ms per frame and the host scopes. Returns (EncodedFrames,
    FrameDescs) in decode order."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.device import LAUNCHES, reset_launches
    from homerhevc_tpu_torch.hevc.deblock import decoder_qp_map8
    from homerhevc_tpu_torch.hevc.parse import (SerializedSlices,
                                                desc_mismatches,
                                                parse_slice_nal)
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    enc = Encoder(cfg)
    PROFILER.reset()
    PROFILER.enable()
    reset_launches()
    with SerializedSlices() as spy:
        t = time.perf_counter()
        efs = encode_all(enc, frames)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    launches = dict(LAUNCHES)
    check(launches["coarse_sweep_sads"] == sweeps, launches)
    check("".join(e.frame_type for e in efs) == types,
          [e.frame_type for e in efs])
    by_poc = sorted(efs, key=lambda e: e.poc)
    mean_psnr = check_frames(by_poc, frames, [e.frame_type for e in by_poc],
                             18.0 if cfg.bitrate_mode else 25.0)
    descs = [d for _, d, _, _ in spy.slices]
    steps = [b - a for a, b in zip([t] + spy.emitted, spy.emitted)]
    log(f"[path H] {label}: {len(frames)} frames ({types}) in {dt:.3f} s "
        f"= {len(frames) / dt:.4f} fps; per frame (decode order) "
        f"{', '.join(f'{s:.2f}' for s in steps)} s; bits/frame "
        f"{np.mean([e.bits for e in efs]):.0f}; luma PSNR {mean_psnr:.2f} "
        f"dB; coarse sweep launches {launches['coarse_sweep_sads']}")
    log(f"[path H] {label} host scopes:\n" + PROFILER.report())
    t = time.perf_counter()
    qp_checked = 0
    for (ps, desc, sao, nal), e in zip(spy.slices, efs):
        _, p = parse_slice_nal(ps, nal)
        bad = desc_mismatches(p.d, desc, p.sao, sao)
        check(not bad, f"{label}: the parsed slice of POC {e.poc} differs "
              f"in {bad}")
        if desc.qp_map is not None and ps.deblocking_enabled:
            qp8 = decoder_qp_map8(desc, ps, e.avg_qp, wpp=ps.wpp)
            check(np.array_equal(p.d.qp_map.astype(np.int32), qp8),
                  f"{label}: the decoder's QPs differ from those "
                  f"deblocking read (POC {e.poc})")
            qp_checked += 1
    log(f"[path H] {label}: all {len(efs)} slices parsed back "
        f"({time.perf_counter() - t:.1f} s): modes, MVs, reference "
        f"indices, levels and SAO equal; the decoder's QPs equal those "
        f"deblocking read in {qp_checked} slices")
    if n_cpu:
        t = time.perf_counter()
        cpu = first_frames(Encoder(cfg, device="cpu"), frames, n_cpu)
        check(b"".join(e.annex_b() for e in cpu)
              == b"".join(e.annex_b() for e in efs[:n_cpu]),
              f"CUDA path H {label} stream != CPU stream")
        log(f"[path H] {label}: the first {n_cpu} frames re-encoded on the "
            f"CPU (plain path, {time.perf_counter() - t:.1f} s): Annex-B "
            f"bytes identical")
    return efs, descs


def h0_frames(n):
    """H0's clip: the AQ cells' frames at 720p (a flat band over the top
    quarter) with a flat left column too, so that quantization groups
    below the band code nothing and keep the QP predicted (G2's)."""
    frames = aq_frames(n, W, H)
    for y, u, v in frames:
        y[:, :64] = 90
        for c in (u, v):
            c[:H // 8] = 128
            c[:, :32] = 128
    return frames


def h1_frames(frames):
    """H1's clip: the bench clip with the luma of every odd frame lifted
    by 12 (a flicker: the picture two back often predicts better than
    the one before)."""
    out = []
    for t, (y, u, v) in enumerate(frames):
        if t % 2:
            y = np.clip(y.astype(np.int32) + 12, 0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


def phase_path_h(frames):
    """Path H on the card: the host P and B programs (slice 8), each
    through api.Encoder, every slice parsed back. H0: 720p IPPP CU16 with
    AQ (strength 2) and row-RC under CBR 1250 kbps, deblocking and SAO (1
    I + 2 P, all on the host; h0_frames' flat areas: some units deblocked
    at the predicted QP, the parsed QPs equal those deblocking read). H1:
    720p IPPP CU16 with three references, QP 32 (1 I + 3 P on the
    flickering h1_frames: I0, P1, P2 on the device chain, the sweep once
    per device P frame; P3 a three-reference frame on the host with some
    CUs at ref_idx 1 or 2; I + 2 P, the device frames, equal on the
    CPU). H2: 720p IBP
    CU16 with AQ, deblocking off (I0 P2 B1 A4 B3 on the device: the
    anchors with their maps, the B frames without; the sweep once per
    anchor and B frame; I0 P2 B1 equal on the CPU). H3: 416x240 IBP CTU
    32 with intra_rdo, AQ, deblocking and SAO (I0 P2 B1, all host: the
    host tree I frame, a host anchor, the host bi B tree; some 8x8 units
    bi). H4: 416x240 IPPP CU16 with intra_rdo, deblocking and SAO (1 I +
    2 P, all
    host; rectangular PUs in the P frames). Returns the sweep's
    launches."""
    from homerhevc_tpu_torch.config import BitrateMode
    t_h = time.perf_counter()
    sweeps = 0
    # H0
    n = N_PATH_H[0]
    cfg = h_config(W, H, cu_size=16, aq_strength=2.0, rc_ctu=True, sao=True,
                   bitrate_mode=BitrateMode.CBR, bitrate_kbps=1250,
                   vbv_size=1.0)
    efs, descs = run_path_h("H0 720p IPPP CU16 AQ + row-RC CBR + deblocking "
                            "+ SAO, host", cfg, h0_frames(n), "I" + "P" * (n - 1),
                            0)
    share = qp_off_share(descs, efs)
    check(share > 0 and all(d.qp_map is not None for d in descs),
          "H0: a frame without its map")
    kbps = float(np.sum([e.bits for e in efs])) / n * cfg.frame_rate / 1e3
    log(f"[path H] H0: {kbps:.1f} kbps against {cfg.bitrate_kbps}; slice "
        f"QPs {[e.avg_qp for e in efs]}; CTBs away from their slice QP "
        f"{100 * share:.1f}%")
    # H1
    n = N_PATH_H[1]
    efs, descs = run_path_h("H1 720p IPPP CU16 three references",
                            h_config(W, H, cu_size=16, num_ref_frames=3),
                            h1_frames(frames[:n]), "I" + "P" * (n - 1), 2,
                            N_PATH_H_CPU[0])
    sweeps += 2
    check([d.ref_idx is not None for d in descs]
          == [False, False, False, True],
          "H1: not P3 alone a three-reference frame")
    far = [float(np.mean(d.ref_idx[d.pred_mode == 0] >= 1))
           for d in descs[3:]]
    check(max(far) > 0, "H1: no CU at ref_idx 1 or 2")
    log(f"[path H] H1: the inter 8x8 units of P3 at ref_idx >= 1: "
        f"{', '.join(f'{100 * x:.1f}%' for x in far)}")
    # H2
    efs, descs = run_path_h("H2 720p IBP CU16 AQ, deblocking off, device",
                            h_config(W, H, cu_size=16, gop_size=2, num_b=1,
                                     aq_strength=2.0, deblocking=False),
                            aq_frames(N_PATH_H[2], W, H), "IPBPB", 4,
                            N_PATH_H_CPU[1])
    sweeps += 4
    check([d.qp_map is None for d in descs]
          == [False, False, True, False, True],
          "H2: not the anchors alone with their maps")
    # H3
    efs, descs = run_path_h(
        "H3 416x240 IBP CTU 32 intra_rdo AQ + deblocking + SAO, host",
        h_config(W_G1, H_G1, cu_size=32, gop_size=2, num_b=1,
                 intra_rdo=True, aq_strength=2.0, sao=True),
        aq_frames(N_PATH_H[3], W_G1, H_G1), "IPB", 0)
    bi = [float(np.mean(d.inter_dir == 3)) for d in descs[2::2]]
    check(max(bi) > 0, "H3: no 8x8 unit coded bi")
    log(f"[path H] H3: 8x8 units coded bi in B1: "
        f"{', '.join(f'{100 * x:.1f}%' for x in bi)}")
    # H4
    n = N_PATH_H[4]
    efs, descs = run_path_h("H4 416x240 IPPP CU16 intra_rdo, host",
                            h_config(W_G1, H_G1, cu_size=16, intra_rdo=True,
                                     sao=True),
                            bench_frames(n, w=W_G1, h=H_G1),
                            "I" + "P" * (n - 1), 0)
    rect = [float(np.mean(d.inter_part != 0)) for d in descs[1:]]
    check(max(rect) > 0, "H4: no rectangular PU in the P frames")
    log(f"[path H] H4: 8x8 units in rectangular PUs in the P frames: "
        f"{', '.join(f'{100 * x:.1f}%' for x in rect)}")
    log(f"[path H] H0-H4 took {time.perf_counter() - t_h:.1f} s")
    return sweeps


N_PATH_I = 4                   # path I: slots of I0 and I1
N_PATH_I0 = 8                  # I0: all-intra frames, 2 per slot
N_PATH_I1 = 4                  # I1: frames per GOP segment, 1 I + 3 P
N_PATH_I2 = 8                  # I2: the dry run's slots


def path_i_mesh(n):
    """n slots: the first n cards where the machine has them, else all n
    on cuda:0 (each slot still its own host thread and CUDA stream)."""
    from homerhevc_tpu_torch.parallel.mesh import make_mesh
    if torch.cuda.device_count() >= n:
        return make_mesh(n)
    return make_mesh(n, ["cuda:0"] * n)


def record_emissions():
    """Patch TorchPipeline._emit to record the clock at each emission;
    returns (the list of times, a function that restores _emit)."""
    from homerhevc_tpu_torch.engine.pipeline import TorchPipeline
    times = []
    emit = TorchPipeline._emit

    def timed(self, *a, **k):
        out = emit(self, *a, **k)
        times.append(time.perf_counter())
        return out
    TorchPipeline._emit = timed

    def restore():
        TorchPipeline._emit = emit
    return times, restore


def phase_path_i(frames):
    """Path I on the card: the multi-device scale-out (slice 9,
    homerhevc_tpu_torch.parallel.mesh), its slots all on cuda:0 where the
    machine has fewer cards than slots. I0: encode_frames_sharded, 720p
    all-intra CU16 (bench.py's config: sign hiding, SAO and deblocking
    off), N_PATH_I0 frames over N_PATH_I slots (2 per slot), then over 1
    slot (each run building its slots' encoders): no launch of the
    sweep, every stream equal to the single-device Encoder's on the card
    (one Encoder, all N_PATH_I0 frames in flight) and to 1 slot's; fps of
    each run.
    I1: gop_parallel_encode, 720p IPPP CU16 with deblocking, N_PATH_I
    segments of 1 I + 3 P over N_PATH_I slots, then segment 0 over 1
    slot: the sweep launched exactly once per P frame (12) under the slot
    threads, every segment equal to the sequential Encoder on the card,
    segment 0 to 1 slot's; fps of each and ms per step (from the
    emission of frame t-1 of every segment to that of frame t). I2:
    encode_frames_sharded_dryrun over N_PATH_I2 slots. Returns I1's
    sweep launches."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.config import EncoderConfig
    from homerhevc_tpu_torch.device import LAUNCHES, reset_launches
    from homerhevc_tpu_torch.parallel.mesh import (
        encode_frames_sharded, encode_frames_sharded_dryrun,
        gop_parallel_encode)
    t_i = time.perf_counter()
    n = N_PATH_I
    mesh, mesh1 = path_i_mesh(n), path_i_mesh(1)
    log(f"[path I] mesh: {n} slots on "
        f"{', '.join(str(d) for d in mesh)} ({torch.cuda.device_count()} "
        f"card(s) on this machine; each slot its own host thread and CUDA "
        f"stream, the threads taking turns)")
    # I0
    cfg0 = EncoderConfig(width=W, height=H, cu_size=16, gop_size=0, qp=32,
                         sign_hiding=True, deblocking=False, sao=False,
                         num_devices=n)
    fr0 = frames[:N_PATH_I0]
    runs = []
    for m in (mesh, mesh1):
        reset_launches()
        t = time.perf_counter()
        streams = encode_frames_sharded(cfg0, fr0, m)
        torch.cuda.synchronize()
        runs.append((len(m), time.perf_counter() - t, streams))
        check(all(v == 0 for v in LAUNCHES.values()), dict(LAUNCHES))
    check(runs[1][2] == runs[0][2], "I0: the slots changed the streams")
    ref = encode_all(Encoder(dataclasses.replace(
        cfg0, num_devices=1, num_frames_in_flight=N_PATH_I0)), fr0)
    check([e.nals for e in ref] == runs[0][2],
          "I0: a sharded stream != the single-device Encoder's")
    log(f"[path I] I0 720p all-intra CU16 (bench.py's config), "
        f"{N_PATH_I0} frames: "
        + "; ".join(f"{k} slot(s) {dt:.3f} s = {N_PATH_I0 / dt:.3f} fps"
                    for k, dt, _ in runs)
        + f" (each run builds its slots' encoders); every stream equal to "
        f"the single-device Encoder's on the card and across slot counts")
    # I1
    cfg1 = EncoderConfig(width=W, height=H, cu_size=16, gop_size=1, qp=32,
                         sign_hiding=True, deblocking=True, sao=False,
                         intra_period=0, reinit_gop_on_scene_change=False,
                         num_devices=n)
    seg = N_PATH_I1
    fr1 = frames[:n * seg]
    out = {}
    for m, fr in ((mesh, fr1), (mesh1, fr1[:seg])):
        times, restore = record_emissions()
        reset_launches()
        t = time.perf_counter()
        try:
            segs = gop_parallel_encode(cfg1, fr, m)
            torch.cuda.synchronize()
        finally:
            restore()
        dt = time.perf_counter() - t
        launches = dict(LAUNCHES)
        k = len(m)
        check(launches["coarse_sweep_sads"] == k * (seg - 1), launches)
        check(len(times) == k * seg, len(times))
        ends = [t] + times[k - 1::k]    # frame t emitted in every segment
        steps = [b - a for a, b in zip(ends, ends[1:])]
        out[k] = (segs, dt, steps, launches["coarse_sweep_sads"])
    segs, dt, steps, sweeps = out[n]
    check(out[1][0][0] == segs[0], "I1: segment 0 over 1 slot != over "
          f"{n} slots")
    seq = None
    for d in range(n):
        enc = Encoder(cfg1)
        if seq is not None:
            # the device encoders of the segment before (the same config;
            # Encoder.reconfigure keeps them so too)
            enc._pipeline._intra_enc = seq._pipeline._intra_enc
            enc._pipeline._inter_enc = seq._pipeline._inter_enc
        seq = enc
        efs = encode_all(enc, fr1[d * seg:(d + 1) * seg])
        check([e.frame_type for e in efs] == ["I"] + ["P"] * (seg - 1))
        check([x for e in efs for x in e.nals] == segs[d],
              f"I1: segment {d} != the sequential Encoder's stream")
    for k in (n, 1):
        segs_k, dt_k, steps_k, sweeps_k = out[k]
        log(f"[path I] I1 720p IPPP CU16 deblocking, {k} segment(s) of 1 I "
            f"+ {seg - 1} P over {k} slot(s): {k * seg} frames in "
            f"{dt_k:.3f} s = {k * seg / dt_k:.3f} fps; ms until frame t "
            f"of every segment is emitted, t = 0..{seg - 1} (t = 1 spans "
            f"two dispatch steps: depth 2) "
            f"{', '.join(f'{x * 1e3:.1f}' for x in steps_k)}; coarse "
            f"sweep launches {sweeps_k}")
    log(f"[path I] I1: every segment equal to the sequential Encoder on "
        f"the card; {sweeps} sweep launches counted under {n} slot threads")
    # I2
    t = time.perf_counter()
    encode_frames_sharded_dryrun(N_PATH_I2, mesh=path_i_mesh(N_PATH_I2))
    log(f"[path I] I2 the dry run over {N_PATH_I2} slots: passed "
        f"({time.perf_counter() - t:.1f} s)")
    log(f"[path I] I0-I2 took {time.perf_counter() - t_i:.1f} s")
    return sweeps


TREE_STAGES = {"_decide_impl": "decide", "_wavefront": "wavefront",
               "_deblock": "deblock", "_sao": "sao", "_pack": "pack"}


def stage_timer(enc, counter=None):
    """Wrap the stages (TREE_STAGES) of the tree encoder enc: each runs
    with the card synchronised around it, its seconds added up by name
    and, with an OpCounter, its aten ops counted under its name. Returns
    (the seconds by stage, a function that removes the wrappers)."""
    from collections import Counter
    seconds = Counter()
    for attr, name in TREE_STAGES.items():
        def staged(*a, _f=getattr(enc, attr), _name=name, **k):
            if counter is not None:
                counter.stage = _name
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return _f(*a, **k)
            finally:
                torch.cuda.synchronize()
                seconds[_name] += time.perf_counter() - t
                if counter is not None:
                    counter.stage = "other"
        setattr(enc, attr, staged)

    def remove():
        for attr in TREE_STAGES:
            delattr(enc, attr)
    return seconds, remove


def phase_tree_stages(frame):
    """Where path A's time goes, beside the stage split of path C's CTU-32
    I frame: the aten ops of a 1080p CU32 tree frame's decision pass and
    of its first COUNT_STEPS wavefront steps counted by a
    TorchDispatchMode (all ops, and those that are not views, which bounds
    the kernel launches; every step runs the same ops); then
    torch.profiler over the decision pass and over the first
    PROFILE_STEPS wavefront steps."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.tools.p_frame_ops import OpCounter

    # the pipeline's encoder and padding (1080 lines code as 1088)
    pipe = Encoder(tree_config(W_TREE, H_TREE, 32, 1))._pipeline
    enc = pipe._intra()
    frame = pipe._pad_frame(*frame)
    counter = OpCounter()
    _, unstage = stage_timer(enc, counter)
    y, u, v = (torch.as_tensor(p, device=DEV)[None] for p in frame)
    qp = torch.tensor([32], dtype=torch.int32, device=DEV)
    n_count = min(COUNT_STEPS, enc.nsteps)
    with counter:
        d8, m8 = enc._decide_impl(y, u, v, qp)
        enc._wavefront(y, u, v, qp, d8, m8, n_steps=n_count)
    torch.cuda.synchronize()
    unstage()
    ops, compute = counter.ops, counter.compute
    per_step = ops["wavefront"] / n_count
    log(f"[stages] a 1080p CU32 tree frame's aten ops (all / not views): "
        f"decide {ops['decide']} / {compute['decide']}; the first "
        f"{n_count} wavefront steps {ops['wavefront']} / "
        f"{compute['wavefront']}, {per_step:.0f} ops "
        f"({compute['wavefront'] / n_count:.0f} not views) per step of "
        f"{enc.nslot} CTB32 slots, {per_step * enc.nsteps:.0f} over its "
        f"{enc.nsteps} steps")
    for label, fn in (
            ("decision pass", lambda: enc._decide_impl(y, u, v, qp)),
            (f"first {PROFILE_STEPS} wavefront steps",
             lambda: enc._wavefront(y, u, v, qp, d8, m8,
                                    n_steps=PROFILE_STEPS))):
        profile_window(f"1080p CU32 tree {label}", fn)


def profile_window(label, fn):
    """fn() under torch.profiler: kernels, device busy time against the
    (profiled) wall time, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kern = [e for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = sum(getattr(e, "device_time", 0) or 0 for e in kern)
    top = sorted(prof.key_averages(),
                 key=lambda e: -getattr(e, "self_device_time_total", 0))
    names = ", ".join(
        f"{e.key[:40]} {getattr(e, 'self_device_time_total', 0) / 1e3:.2f}"
        " ms" for e in top[:5])
    log(f"[profile] {label}: wall {wall * 1e3:.2f} ms, {len(kern)} device "
        f"kernels, device busy {dev_us / 1e3:.2f} ms "
        f"({100 * dev_us / 1e3 / (wall * 1e3):.1f}% of wall); top: {names}")
    return len(kern), dev_us / 1e3, wall * 1e3


def phase_profile(frames):
    """One P frame of slice 1 and a P frame with SAO (slice 2) under
    torch.profiler: kernel launches and device time against wall time
    (the profiler's own cost inflates the wall time; phase 4 has the
    unprofiled times). The CU16 I frame is not profiled: the profiler's
    processing of its ~118 k kernel events takes about a minute of the
    script's limit."""
    from homerhevc_tpu_torch.config import EncoderConfig
    from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
    from homerhevc_tpu_torch.engine.intra_encoder import TorchIntraEncoder
    from homerhevc_tpu_torch.hevc.headers import ParamSets
    from homerhevc_tpu_torch.state import reference_from_numpy
    cfg = EncoderConfig(width=W, height=H, cu_size=16, gop_size=1, qp=32,
                        sign_hiding=True, deblocking=True, sao=False)
    ps = ParamSets.from_config(cfg)
    ie = TorchIntraEncoder(ps, cfg, device=DEV)
    pe = TorchInterEncoder(ps, cfg, device=DEV)
    y, u, v = frames[0]
    _, ry, ru, rv = ie.encode_frame(y, u, v, 32)
    ref = reference_from_numpy((ry, ru, rv), DEV)
    pe.encode_frame(frames[1], ref)
    profile_window("P frame (dispatch)", lambda: pe.dispatch(frames[1], ref))
    cfg_sao = EncoderConfig(width=W, height=H, cu_size=16, gop_size=1, qp=32,
                            sign_hiding=True, deblocking=True, sao=True)
    pe_sao = TorchInterEncoder(ParamSets.from_config(cfg_sao), cfg_sao,
                               device=DEV)
    pe_sao.encode_frame(frames[1], ref)
    profile_window("P frame with SAO (dispatch)",
                   lambda: pe_sao.dispatch(frames[1], ref))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}; "
        f"{smi('name,power.limit,clocks.max.sm')}")
    t0 = time.perf_counter()

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        now = time.perf_counter()
        log(f"[time] {label}: {now - t:.1f} s (at {now - t0:.1f} s)")
        return out
    frames = bench_frames(N_IPPP)
    timed("phase 1 build", phase_build)
    g1 = g1_frames(N_PATH_G1)
    g1_coded = [(np.pad(y, ((0, H_G1_CODED - H_G1), (0, 0)), mode="edge"),
                 u, v) for y, u, v in g1[:2]]
    rows = timed("phase 2 kernel", phase_kernel, frames,
                 bench_frames(2, w=W_TREE, h=1152), g1_coded)
    timed("phase 3 digests", phase_digests)
    launches = timed("main paths", phase_main_path, frames)
    tree_frames = bench_frames(N_PATH_D, w=W_TREE, h=H_TREE)
    tree_slice = timed("path A", phase_tree_path, tree_frames[:F_TREE])
    sao_launches = timed("path B", phase_sao_ippp, frames)
    path_c_launches = timed("path C", phase_path_c, tree_frames[:N_PATH_C])
    path_d_launches, wide_launches = timed("path D", phase_path_d,
                                           tree_frames, tree_slice)
    path_e_launches = timed("path E", phase_path_e, frames, tree_frames[:2])
    path_f_launches = timed("path F", phase_path_f, frames)
    path_g_launches = timed("path G", phase_path_g, frames,
                            tree_frames[:N_PATH_G], g1)
    path_h_launches = timed("path H", phase_path_h, frames)
    path_i_launches = timed("path I", phase_path_i, frames)
    timed("phase 5 profile", phase_profile, frames)
    timed("phase 5 tree stages", phase_tree_stages, tree_frames[0])
    for name in ("jax", "homerhevc_tpu"):
        check(name not in sys.modules, f"{name} was imported")
    log("[isolation] neither jax nor homerhevc_tpu was imported")
    kernels = []
    for name, row, n in (
            ("coarse_sweep_sads", "720p R=16",
             launches["coarse_sweep_sads"] + sao_launches + path_c_launches
             + path_d_launches + path_e_launches + path_f_launches
             + path_g_launches + path_h_launches + path_i_launches),
            ("coarse_sweep_sads_wide", "wide 1088 lines R=24",
             wide_launches)):
        err, ms, plain_ms, bound_ms, bound_by = rows[row]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "homerhevc_tpu_torch/csrc/me_sad.cu",
            "replaces": "homerhevc_tpu/ops/pallas/me_sad.py:35",
            "launches": n, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
