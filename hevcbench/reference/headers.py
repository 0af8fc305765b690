# Written for the benchmark's plain reference decoder. ParamSets and its
# from_config are a frozen copy of homerhevc_tpu_torch/hevc/headers.py,
# lines 20-93 (what a configuration states), without the fields that
# decoding does not read; the parameter-set parser below is the
# reference's own, from the spec's syntax.
"""Parameter sets: what a configuration states, and what a stream's VPS,
SPS and PPS say (H.265 clause 7.3.2), read into the same ParamSets.

The parser reads every syntax element of the three sets and raises
`Unsupported` where a stream uses a tool that the reference decoder does
not decode (tiles, PCM, AMP, long-term or SPS-coded reference picture
sets, temporal MVP, transform skip, lossless, weighted prediction, coded
scaling lists, range extensions) or that the slice-header reader assumes
absent, so that a stream is decoded only with what it says.
"""

from __future__ import annotations

import dataclasses

from hevcbench.reference.cabac_dec import BitReader, unescape_ebsp
from hevcbench.reference.config import EncoderConfig

SLICE_B, SLICE_P, SLICE_I = 0, 1, 2
NAL_VPS, NAL_SPS, NAL_PPS = 32, 33, 34

# the ParamSets fields a configuration states, which a stream's parameter
# sets are held to
STATED = ("pic_width", "pic_height", "conf_win_right", "conf_win_bottom",
          "log2_ctu", "log2_min_cb", "log2_min_tb", "log2_max_tb",
          "max_tr_depth_intra", "max_tr_depth_inter",
          "scaling_list_enabled", "sao_enabled", "deblocking_enabled",
          "sign_hiding", "cu_qp_delta_enabled", "wpp",
          "strong_intra_smoothing", "cb_qp_offset", "cr_qp_offset")


class Unsupported(ValueError):
    """Syntax outside what the reference decodes."""


@dataclasses.dataclass
class ParamSets:
    """The parameters of a stream that its decoding reads: those its SPS
    and PPS state (`parse_parameter_sets`), or those a configuration
    states (`from_config`)."""
    pic_width: int = 0          # coded luma size, whole minimum CBs
    pic_height: int = 0
    log2_ctu: int = 6
    log2_min_cb: int = 3
    log2_min_tb: int = 2
    log2_max_tb: int = 5
    log2_max_poc_lsb: int = 8
    max_tr_depth_intra: int = 2
    max_tr_depth_inter: int = 1
    scaling_list_enabled: bool = False
    sao_enabled: bool = True
    deblocking_enabled: bool = True
    sign_hiding: bool = True
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    wpp: bool = False
    strong_intra_smoothing: bool = False
    init_qp: int = 32
    cb_qp_offset: int = 2
    cr_qp_offset: int = 2
    # conformance window (luma samples cropped from the coded picture on
    # output; the pipeline pads input to CTU multiples and crops here)
    conf_win_right: int = 0
    conf_win_bottom: int = 0

    @classmethod
    def from_config(cls, cfg: EncoderConfig) -> "ParamSets":
        log2_ctu = cfg.ctu_size.bit_length() - 1
        return cls(
            pic_width=cfg.width,
            pic_height=cfg.height,
            log2_ctu=log2_ctu,
            log2_max_tb=min(5, log2_ctu),
            max_tr_depth_intra=cfg.max_intra_tr_depth,
            max_tr_depth_inter=cfg.max_inter_tr_depth,
            scaling_list_enabled=cfg.scaling_lists,
            sao_enabled=cfg.sao,
            deblocking_enabled=cfg.deblocking,
            sign_hiding=cfg.sign_hiding,
            # per-CTB adaptive quantization signals cu_qp_delta (QG = CTB;
            # diff_cu_qp_delta_depth stays 0)
            cu_qp_delta_enabled=(cfg.aq_strength > 0
                                 or getattr(cfg, "rc_ctu", False)),
            wpp=cfg.wpp,
            init_qp=cfg.qp,
            cb_qp_offset=cfg.chroma_qp_offset,
            cr_qp_offset=cfg.chroma_qp_offset,
        )

    @property
    def ctu_size(self) -> int:
        return 1 << self.log2_ctu

    @property
    def ctus_x(self) -> int:
        return -(-self.pic_width // self.ctu_size)

    @property
    def ctus_y(self) -> int:
        return -(-self.pic_height // self.ctu_size)


class _Rbsp(BitReader):
    """A parameter set's RBSP; reading past its end raises."""

    def __init__(self, nal: bytes):
        super().__init__(unescape_ebsp(nal[2:]))

    def read(self, n: int) -> int:
        if self.pos + n > 8 * len(self.data):
            raise ValueError("a parameter set ends early")
        return super().read(n)

    def expect(self, n: int, want: int, what: str) -> None:
        got = self.read(n)
        if got != want:
            raise Unsupported(f"{what} = {got}, the reference reads {want}")

    def expect_ue(self, want: int, what: str) -> int:
        got = self.read_ue()
        if got != want:
            raise Unsupported(f"{what} = {got}, the reference reads {want}")
        return got

    def trailing(self, what: str) -> None:
        """rbsp_trailing_bits: a one, then zeros to the end."""
        self.expect(1, 1, f"{what} rbsp_stop_one_bit")
        while self.pos < 8 * len(self.data):
            if self.read(1):
                raise ValueError(f"{what}: data after rbsp_trailing_bits")


def _profile_tier_level(r: _Rbsp, max_sub_layers_minus1: int) -> None:
    """7.3.3 with no sub-layers: the general profile, tier and level."""
    r.read(2 + 1 + 5)            # profile space, tier, profile idc
    r.read(32)                   # profile compatibility flags
    r.read(4)                    # progressive, interlaced, non-packed,
    r.read(43)                   # frame-only; reserved / constraint bits
    r.read(1)                    # general_inbld / reserved
    r.read(8)                    # general_level_idc
    if max_sub_layers_minus1:
        raise Unsupported("sub-layers")


def _vps(r: _Rbsp) -> None:
    r.read(4)                                  # vps_video_parameter_set_id
    r.read(2)                                  # base layer internal, available
    r.expect(6, 0, "vps_max_layers_minus1")
    r.expect(3, 0, "vps_max_sub_layers_minus1")
    r.read(1)                                  # vps_temporal_id_nesting_flag
    r.expect(16, 0xFFFF, "vps_reserved_0xffff_16bits")
    _profile_tier_level(r, 0)
    r.read(1)                   # vps_sub_layer_ordering_info_present_flag
    r.read_ue(), r.read_ue(), r.read_ue()      # dec buffering, reorder, latency
    r.read(6)                                  # vps_max_layer_id
    r.expect_ue(0, "vps_num_layer_sets_minus1")
    r.expect(1, 0, "vps_timing_info_present_flag")
    r.expect(1, 0, "vps_extension_flag")
    r.trailing("VPS")


def _sps(r: _Rbsp, ps: ParamSets) -> None:
    r.read(4)                                  # sps_video_parameter_set_id
    r.expect(3, 0, "sps_max_sub_layers_minus1")
    r.read(1)                                  # sps_temporal_id_nesting_flag
    _profile_tier_level(r, 0)
    r.expect_ue(0, "sps_seq_parameter_set_id")
    r.expect_ue(1, "chroma_format_idc")
    ps.pic_width, ps.pic_height = r.read_ue(), r.read_ue()
    if r.read(1):                              # conformance_window_flag
        left, right, top, bottom = (r.read_ue() for _ in range(4))
        if left or top:
            raise Unsupported("a conformance window on the left or top")
        ps.conf_win_right, ps.conf_win_bottom = 2 * right, 2 * bottom
    else:
        ps.conf_win_right = ps.conf_win_bottom = 0
    r.expect_ue(0, "bit_depth_luma_minus8")
    r.expect_ue(0, "bit_depth_chroma_minus8")
    ps.log2_max_poc_lsb = r.read_ue() + 4
    r.read(1)     # sps_sub_layer_ordering_info_present_flag: one sub-layer
    r.read_ue(), r.read_ue(), r.read_ue()      # dec buffering, reorder, latency
    ps.log2_min_cb = r.read_ue() + 3
    ps.log2_ctu = ps.log2_min_cb + r.read_ue()
    ps.log2_min_tb = r.read_ue() + 2
    ps.log2_max_tb = ps.log2_min_tb + r.read_ue()
    ps.max_tr_depth_inter = r.read_ue()
    ps.max_tr_depth_intra = r.read_ue()
    ps.scaling_list_enabled = bool(r.read(1))
    if ps.scaling_list_enabled:
        r.expect(1, 0, "sps_scaling_list_data_present_flag")
    r.expect(1, 0, "amp_enabled_flag")
    ps.sao_enabled = bool(r.read(1))
    r.expect(1, 0, "pcm_enabled_flag")
    r.expect_ue(0, "num_short_term_ref_pic_sets")
    r.expect(1, 0, "long_term_ref_pics_present_flag")
    r.expect(1, 0, "sps_temporal_mvp_enabled_flag")
    ps.strong_intra_smoothing = bool(r.read(1))
    r.expect(1, 0, "vui_parameters_present_flag")
    r.expect(1, 0, "sps_extension_present_flag")
    r.trailing("SPS")
    if ps.pic_width % (1 << ps.log2_min_cb) or \
            ps.pic_height % (1 << ps.log2_min_cb):
        raise ValueError("the picture is not whole minimum coding blocks")


def _pps(r: _Rbsp, ps: ParamSets) -> None:
    r.expect_ue(0, "pps_pic_parameter_set_id")
    r.expect_ue(0, "pps_seq_parameter_set_id")
    r.expect(1, 0, "dependent_slice_segments_enabled_flag")
    r.expect(1, 0, "output_flag_present_flag")
    r.expect(3, 0, "num_extra_slice_header_bits")
    ps.sign_hiding = bool(r.read(1))
    r.expect(1, 0, "cabac_init_present_flag")
    r.expect_ue(0, "num_ref_idx_l0_default_active_minus1")
    r.expect_ue(0, "num_ref_idx_l1_default_active_minus1")
    ps.init_qp = 26 + r.read_se()
    r.expect(1, 0, "constrained_intra_pred_flag")
    r.expect(1, 0, "transform_skip_enabled_flag")
    ps.cu_qp_delta_enabled = bool(r.read(1))
    ps.diff_cu_qp_delta_depth = (r.read_ue() if ps.cu_qp_delta_enabled
                                 else 0)
    ps.cb_qp_offset, ps.cr_qp_offset = r.read_se(), r.read_se()
    r.expect(1, 0, "pps_slice_chroma_qp_offsets_present_flag")
    r.expect(1, 0, "weighted_pred_flag")
    r.expect(1, 0, "weighted_bipred_flag")
    r.expect(1, 0, "transquant_bypass_enabled_flag")
    r.expect(1, 0, "tiles_enabled_flag")
    ps.wpp = bool(r.read(1))
    r.expect(1, 1, "pps_loop_filter_across_slices_enabled_flag")
    if r.read(1):                   # deblocking_filter_control_present_flag
        r.expect(1, 0, "deblocking_filter_override_enabled_flag")
        ps.deblocking_enabled = not r.read(1)
        if ps.deblocking_enabled:
            if r.read_se() or r.read_se():
                raise Unsupported("deblocking beta or tc offsets")
    else:
        ps.deblocking_enabled = True
    r.expect(1, 0, "pps_scaling_list_data_present_flag")
    r.expect(1, 1, "lists_modification_present_flag")
    r.expect_ue(0, "log2_parallel_merge_level_minus2")
    r.expect(1, 0, "slice_segment_header_extension_present_flag")
    r.expect(1, 0, "pps_extension_present_flag")
    r.trailing("PPS")


def parse_parameter_sets(nals: list[bytes]) -> ParamSets:
    """The ParamSets that an access unit's VPS, SPS and PPS (NAL payloads
    without start codes; one of each) state."""
    by_type: dict[int, list[bytes]] = {}
    for n in nals:
        by_type.setdefault((n[0] >> 1) & 0x3F, []).append(n)
    for t, name in ((NAL_VPS, "VPS"), (NAL_SPS, "SPS"), (NAL_PPS, "PPS")):
        if len(by_type.get(t, [])) != 1:
            raise ValueError(f"{len(by_type.get(t, []))} {name} NALs")
    ps = ParamSets()
    _vps(_Rbsp(by_type[NAL_VPS][0]))
    _sps(_Rbsp(by_type[NAL_SPS][0]), ps)
    _pps(_Rbsp(by_type[NAL_PPS][0]), ps)
    return ps


def differences(got: ParamSets, stated: ParamSets) -> list[str]:
    """The STATED fields in which a stream's parameter sets differ from a
    configuration's, each as `name got/stated`."""
    return [f"{k} {getattr(got, k)}/{getattr(stated, k)}" for k in STATED
            if getattr(got, k) != getattr(stated, k)]
