# Frozen copy of homerhevc_tpu_torch/config.py, lines 1-152, for the
# benchmark's plain reference decoder: later changes to the program
# do not move it. Imports point at the other copies beside it.
"""Encoder configuration — the TPU-native analog of HVENC_Cfg
(reference: homer_hevc_enc_api.h:138-167, 28 fields).
"""

from __future__ import annotations

import dataclasses
import enum


class RDMode(enum.IntEnum):
    """reference: homer_hevc_enc_api.h RD modes."""
    RD_DIST_ONLY = 0
    RD_FULL = 1
    RD_FAST = 2


class BitrateMode(enum.IntEnum):
    FIXED_QP = 0
    CBR = 1
    VBR = 2


class PerformanceMode(enum.IntEnum):
    """Decision-effort pruning on the golden CU-tree path (reference
    hmr_encoder_lib.c:921-947 fast_skip_loop / min_depth). FAST adds a
    fast-skip loop to the consolidation passes; UFAST also raises the
    minimum CU depth by one (no CU64 evaluation). The device path
    evaluates every level in one batched program, so pruning there
    saves nothing — these modes shape golden/off-device encodes."""
    FULL_COMPUTATION = 0
    FAST = 1
    UFAST = 2


class MEPrecision(enum.IntEnum):
    PEL = 0
    HALF_PEL = 1
    QUARTER_PEL = 2


@dataclasses.dataclass
class EncoderConfig:
    # geometry / timing
    width: int = 1280
    height: int = 720
    frame_rate: float = 25.0
    # coding structure
    cu_size: int = 64                 # CTU size: 16/32/64
    intra_period: int = 100           # 0 = infinite (first frame IDR only)
    gop_size: int = 2                 # 0=all intra, 1=IPPP, 2=IBP
    num_b: int = 0                    # B frames between references (0 or 1)
    num_ref_frames: int = 1
    # prediction depth
    max_pred_depth: int = 4           # CU quadtree depth below CTU
    max_intra_tr_depth: int = 2
    max_inter_tr_depth: int = 1
    motion_estimation_precision: MEPrecision = MEPrecision.QUARTER_PEL
    # full-pel ME reach. The 2x pyramid level covers +-2*coarse_range
    # (32 IPPP / 48 IBP); me_range beyond that activates a 4x-decimated
    # FAR level up to +-me_range horizontal x +-64 vertical — the
    # reference's window is +-128x64 (hmr_private.h:76-77).
    me_range: int = 32
    # quality / rate
    qp: int = 32
    chroma_qp_offset: int = 2
    bitrate_mode: BitrateMode = BitrateMode.FIXED_QP
    bitrate_kbps: int = 1250
    vbv_size: float = 1.0             # in seconds-of-bitrate
    vbv_init: float = 0.35            # initial fullness fraction
    # tools
    sign_hiding: bool = True
    sao: bool = True
    deblocking: bool = True
    # per-CTB adaptive quantization: strength of the variance-driven QP
    # modulation (0 = off). >0 enables the PPS cu_qp_delta machinery.
    # TPU-native stand-in for the reference's sequential per-CTU RC QP
    # (hmr_rate_control.c:266-347 consumes bits-so-far, which fights
    # batching; a source-activity map is computable before the batch).
    aq_strength: float = 0.0
    # row-granular rate control: per-CTB-row QP offsets from intra-frame
    # VBV feedback (the SURVEY §7(4) relaxation of the reference's
    # per-CTU bits-so-far QP, hmr_rate_control.c:266-347). Enables the
    # PPS cu_qp_delta machinery; effective with CBR/VBR.
    rc_ctu: bool = False
    # batched merge-RD stage inside the DEVICE CU16 inter program (the
    # fast-path analog of the golden decode-order merge-RD post-pass);
    # golden twin merge_rd_fast. Off: pre-round-4 device streams.
    merge_rd_device: bool = True
    scaling_lists: bool = False       # default lists on/off (flat when off)
    rd_mode: RDMode = RDMode.RD_FAST
    # intra CU-tree RDO (two-pass: open-loop batched decision + closed-loop
    # wavefront encode; golden/intra_tree.py). Needs cu_size >= 32.
    intra_rdo: bool = False
    # per-CU16 intra fallback inside P frames: post-pass over the all-inter
    # coding flips a king-graph-independent subset of CUs to intra where
    # intra wins RD (golden/inter_frame.py intra_fallback_p; reference
    # analog hmr_motion_inter.c:4008-4038).
    intra_in_p: bool = False
    performance_mode: PerformanceMode = PerformanceMode.FULL_COMPUTATION
    reinit_gop_on_scene_change: bool = True
    # generalized-B "P" frames (gop_size 1): once two references exist, P
    # frames are coded as B slices predicting from t-1 (L0) and t-2 (L1,
    # via ref list modification) with PER-CU uni/bi selection (AMVP uses
    # the spec 8.5.3.2.6 POC-distance scaling for mixed-direction
    # neighbours). Also activated by num_ref_frames >= 2 (two-list
    # multi-reference).
    gpb: bool = False
    # QP offset for NON-REFERENCE B frames (the IBP in-between pictures):
    # nothing references them, so their distortion never propagates — the
    # hierarchy spends fewer bits there. The reference reaches the same
    # point through depth-scaled lambda tables (hmr_tables.c:315-374);
    # with lambda derived from QP here, one QP step IS the lambda scale.
    b_qp_offset: int = 2
    # parallelism (TPU-native knobs; replaces n_enc_engines/n_wpp_threads)
    wpp: bool = False                 # per-CTU-row substreams (host-parallel CABAC)
    num_frames_in_flight: int = 1     # device pipeline depth (frame engines analog)
    num_devices: int = 1              # mesh size for frame/stream sharding
    # internals
    bit_depth: int = 8

    def __post_init__(self) -> None:
        assert self.cu_size in (16, 32, 64)
        assert 0 <= self.qp <= 51
        # num_b <-> gop structure (reference couples them the same way:
        # homer_app.c gop_size/num_b defaults): gop_size 2 is the IBP
        # pattern with one B between anchors; num_b=1 requests it.
        if self.num_b not in (0, 1):
            raise ValueError("num_b: only 0 (IPPP) or 1 (IBP) supported")
        if self.gop_size >= 2 and self.num_b == 0:
            self.num_b = 1
        elif self.num_b == 1 and 0 < self.gop_size < 2:
            self.gop_size = 2
        if self.me_range % 4 or not 16 <= self.me_range <= 256:
            raise ValueError("me_range: multiple of 4 in [16, 256]")
        if self.width % 2 or self.height % 2:
            raise ValueError(
                f"frame dimensions must be even (4:2:0 chroma), got "
                f"{self.width}x{self.height}")
        assert self.bit_depth == 8, "only 8-bit supported (as the reference)"

    @property
    def ctu_size(self) -> int:
        return self.cu_size

    @property
    def ctus_x(self) -> int:
        return -(-self.width // self.ctu_size)

    @property
    def ctus_y(self) -> int:
        return -(-self.height // self.ctu_size)
