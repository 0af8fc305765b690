"""VPS / SPS / PPS / slice-header writers (H.265 clause 7.3).

Parity with reference: hmr_headers.c (VPS :99, SPS :204, PPS :312, slice
header :375, WPP entry points :617) — written from spec syntax, not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from homerhevc_tpu_torch.config import BitrateMode, EncoderConfig
from homerhevc_tpu_torch.hevc.bitstream import (
    NAL_IDR_W_RADL, NAL_PPS, NAL_SPS, NAL_VPS, BitWriter, make_nal,
)

SLICE_B, SLICE_P, SLICE_I = 0, 1, 2


@dataclasses.dataclass
class ParamSets:
    """Derived normative parameters shared by headers and slice coding."""
    cfg: EncoderConfig
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
    num_ref: int = 1
    reorder_pics: int = 0
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
            cfg=cfg,
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
            num_ref=max(1, cfg.num_ref_frames),
            reorder_pics=1 if cfg.gop_size >= 2 else 0,
            init_qp=cfg.qp,
            cb_qp_offset=cfg.chroma_qp_offset,
            cr_qp_offset=cfg.chroma_qp_offset,
        )

    @property
    def ctu_size(self) -> int:
        return 1 << self.log2_ctu

    @property
    def pic_width(self) -> int:
        return self.cfg.width

    @property
    def pic_height(self) -> int:
        return self.cfg.height

    @property
    def ctus_x(self) -> int:
        return -(-self.pic_width // self.ctu_size)

    @property
    def ctus_y(self) -> int:
        return -(-self.pic_height // self.ctu_size)

    @property
    def level_idc(self) -> int:
        # pick a generous level by luma picture size (Table A.8)
        px = self.pic_width * self.pic_height
        if px <= 422_912:
            return 93   # 3.1
        if px <= 2_228_224:
            return 123  # 4.1
        return 153      # 5.1


def _profile_tier_level(bw: BitWriter, level_idc: int) -> None:
    bw.write(0, 2)            # general_profile_space
    bw.write(0, 1)            # general_tier_flag
    bw.write(1, 5)            # general_profile_idc = Main
    bw.write(0b0110 << 28, 32)  # compatibility flags: Main + Main10
    bw.write(1, 1)            # general_progressive_source_flag
    bw.write(0, 1)            # general_interlaced_source_flag
    bw.write(0, 1)            # general_non_packed_constraint_flag
    bw.write(1, 1)            # general_frame_only_constraint_flag
    bw.write(0, 32)           # general_reserved_zero_44bits...
    bw.write(0, 12)
    bw.write(level_idc, 8)    # general_level_idc


def write_vps(ps: ParamSets) -> bytes:
    bw = BitWriter()
    bw.write(0, 4)      # vps_video_parameter_set_id
    bw.write(3, 2)      # vps_base_layer_internal/available (reserved 3 in v1)
    bw.write(0, 6)      # vps_max_layers_minus1
    bw.write(0, 3)      # vps_max_sub_layers_minus1
    bw.write(1, 1)      # vps_temporal_id_nesting_flag
    bw.write(0xFFFF, 16)  # vps_reserved_0xffff_16bits
    _profile_tier_level(bw, ps.level_idc)
    bw.write(1, 1)      # vps_sub_layer_ordering_info_present_flag
    bw.write_ue(ps.num_ref + 2)  # vps_max_dec_pic_buffering_minus1
    bw.write_ue(ps.reorder_pics)  # vps_max_num_reorder_pics
    bw.write_ue(0)      # vps_max_latency_increase_plus1
    bw.write(0, 6)      # vps_max_layer_id
    bw.write_ue(0)      # vps_num_layer_sets_minus1
    bw.write(0, 1)      # vps_timing_info_present_flag
    bw.write(0, 1)      # vps_extension_flag
    bw.write_byte_alignment()
    return make_nal(NAL_VPS, bw.get_bytes())


def write_sps(ps: ParamSets) -> bytes:
    bw = BitWriter()
    bw.write(0, 4)      # sps_video_parameter_set_id
    bw.write(0, 3)      # sps_max_sub_layers_minus1
    bw.write(1, 1)      # sps_temporal_id_nesting_flag
    _profile_tier_level(bw, ps.level_idc)
    bw.write_ue(0)      # sps_seq_parameter_set_id
    bw.write_ue(1)      # chroma_format_idc = 4:2:0
    bw.write_ue(ps.pic_width)
    bw.write_ue(ps.pic_height)
    min_cb = 1 << ps.log2_min_cb
    assert ps.pic_width % min_cb == 0 and ps.pic_height % min_cb == 0, \
        "coded dims must be CTU-padded (EncoderPipeline does this)"
    if ps.conf_win_right or ps.conf_win_bottom:
        # offsets in chroma units (SubWidthC/SubHeightC = 2 for 4:2:0)
        bw.write(1, 1)  # conformance_window_flag
        bw.write_ue(0)                       # conf_win_left_offset
        bw.write_ue(ps.conf_win_right // 2)  # conf_win_right_offset
        bw.write_ue(0)                       # conf_win_top_offset
        bw.write_ue(ps.conf_win_bottom // 2)
    else:
        bw.write(0, 1)  # conformance_window_flag
    bw.write_ue(0)      # bit_depth_luma_minus8
    bw.write_ue(0)      # bit_depth_chroma_minus8
    bw.write_ue(ps.log2_max_poc_lsb - 4)
    bw.write(1, 1)      # sps_sub_layer_ordering_info_present_flag
    bw.write_ue(ps.num_ref + 2)  # sps_max_dec_pic_buffering_minus1
    bw.write_ue(ps.reorder_pics)  # sps_max_num_reorder_pics
    bw.write_ue(0)      # sps_max_latency_increase_plus1
    bw.write_ue(ps.log2_min_cb - 3)
    bw.write_ue(ps.log2_ctu - ps.log2_min_cb)
    bw.write_ue(ps.log2_min_tb - 2)
    bw.write_ue(ps.log2_max_tb - ps.log2_min_tb)
    bw.write_ue(ps.max_tr_depth_inter)
    bw.write_ue(ps.max_tr_depth_intra)
    bw.write(int(ps.scaling_list_enabled), 1)
    if ps.scaling_list_enabled:
        bw.write(0, 1)  # sps_scaling_list_data_present_flag -> default lists
    bw.write(0, 1)      # amp_enabled_flag
    bw.write(int(ps.sao_enabled), 1)
    bw.write(0, 1)      # pcm_enabled_flag
    bw.write_ue(0)      # num_short_term_ref_pic_sets (RPS inline in slices)
    bw.write(0, 1)      # long_term_ref_pics_present_flag
    bw.write(0, 1)      # sps_temporal_mvp_enabled_flag
    bw.write(int(ps.strong_intra_smoothing), 1)
    bw.write(0, 1)      # vui_parameters_present_flag
    bw.write(0, 1)      # sps_extension_present_flag
    bw.write_byte_alignment()
    return make_nal(NAL_SPS, bw.get_bytes())


def write_pps(ps: ParamSets) -> bytes:
    bw = BitWriter()
    bw.write_ue(0)      # pps_pic_parameter_set_id
    bw.write_ue(0)      # pps_seq_parameter_set_id
    bw.write(0, 1)      # dependent_slice_segments_enabled_flag
    bw.write(0, 1)      # output_flag_present_flag
    bw.write(0, 3)      # num_extra_slice_header_bits
    bw.write(int(ps.sign_hiding), 1)
    bw.write(0, 1)      # cabac_init_present_flag
    # One active ref per list ALWAYS: the encoder codes refidx 0 in every
    # list (multi-reference rides L1 via ref_pic_list_modification l1_swap,
    # see SliceParams), and the syntax layer never writes ref_idx_lX — an
    # active count > 1 would desync the decoder's prediction_unit parse.
    # ps.num_ref only sizes the DPB (sps_max_dec_pic_buffering above).
    bw.write_ue(0)      # num_ref_idx_l0_default_active_minus1
    bw.write_ue(0)      # num_ref_idx_l1_default_active_minus1
    bw.write_se(ps.init_qp - 26)
    bw.write(0, 1)      # constrained_intra_pred_flag
    bw.write(0, 1)      # transform_skip_enabled_flag
    bw.write(int(ps.cu_qp_delta_enabled), 1)
    if ps.cu_qp_delta_enabled:
        bw.write_ue(ps.diff_cu_qp_delta_depth)
    bw.write_se(ps.cb_qp_offset)
    bw.write_se(ps.cr_qp_offset)
    bw.write(0, 1)      # pps_slice_chroma_qp_offsets_present_flag
    bw.write(0, 1)      # weighted_pred_flag
    bw.write(0, 1)      # weighted_bipred_flag
    bw.write(0, 1)      # transquant_bypass_enabled_flag
    bw.write(0, 1)      # tiles_enabled_flag
    bw.write(int(ps.wpp), 1)  # entropy_coding_sync_enabled_flag
    bw.write(1, 1)      # pps_loop_filter_across_slices_enabled_flag
    bw.write(1, 1)      # deblocking_filter_control_present_flag
    bw.write(0, 1)      # deblocking_filter_override_enabled_flag
    bw.write(int(not ps.deblocking_enabled), 1)  # pps_deblocking_filter_disabled_flag
    if ps.deblocking_enabled:
        bw.write_se(0)  # pps_beta_offset_div2
        bw.write_se(0)  # pps_tc_offset_div2
    bw.write(0, 1)      # pps_scaling_list_data_present_flag
    bw.write(1, 1)      # lists_modification_present_flag (generalized-B)
    bw.write_ue(0)      # log2_parallel_merge_level_minus2
    bw.write(0, 1)      # slice_segment_header_extension_present_flag
    bw.write(0, 1)      # pps_extension_present_flag
    bw.write_byte_alignment()
    return make_nal(NAL_PPS, bw.get_bytes())


@dataclasses.dataclass
class SliceParams:
    slice_type: int              # SLICE_B/P/I
    nal_type: int                # e.g. NAL_IDR_W_RADL, NAL_TRAIL_R
    poc: int
    qp: int
    sao_luma: bool = False
    sao_chroma: bool = False
    ref_pocs_before: tuple = ()  # negative-delta refs (L0), nearest first
    ref_pocs_after: tuple = ()   # positive-delta refs (L1)
    num_entry_points: int = 0
    max_merge_cand: int = 5
    # generalized-B: swap L1[0] to the second list-temp entry via
    # ref_pic_list_modification (list_entry_l1[0] = 1), so a "P" frame
    # bi-predicts from t-1 (L0) and t-2 (L1) with refidx 0 in both lists
    l1_swap: bool = False
    # multi-reference L0: active refs in list 0 (>1 writes the
    # num_ref_idx_active override; per-PU ref_idx_l0 follows in the CUs)
    num_ref_l0: int = 1

    @property
    def is_irap(self) -> bool:
        return 16 <= self.nal_type <= 23

    @property
    def is_idr(self) -> bool:
        return self.nal_type in (19, 20)


def write_slice_header(ps: ParamSets, sp: SliceParams,
                       entry_point_offsets: Optional[list] = None) -> BitWriter:
    """Write the slice segment header into a fresh BitWriter and return it
    (slice data continues in the same writer after byte alignment)."""
    bw = BitWriter()
    bw.write(1, 1)      # first_slice_segment_in_pic_flag
    if sp.is_irap:
        bw.write(0, 1)  # no_output_of_prior_pics_flag
    bw.write_ue(0)      # slice_pic_parameter_set_id
    bw.write_ue(sp.slice_type)
    if not sp.is_idr:
        poc_lsb = sp.poc & ((1 << ps.log2_max_poc_lsb) - 1)
        bw.write(poc_lsb, ps.log2_max_poc_lsb)
        bw.write(0, 1)  # short_term_ref_pic_set_sps_flag
        # st_ref_pic_set() inline (spec 7.3.7)
        neg = sorted(sp.ref_pocs_before, key=lambda p: sp.poc - p)
        pos = sorted(sp.ref_pocs_after, key=lambda p: p - sp.poc)
        bw.write_ue(len(neg))
        bw.write_ue(len(pos))
        prev = sp.poc
        for rp in neg:
            bw.write_ue(prev - rp - 1)   # delta_poc_s0_minus1
            bw.write(1, 1)               # used_by_curr_pic_s0_flag
            prev = rp
        prev = sp.poc
        for rp in pos:
            bw.write_ue(rp - prev - 1)   # delta_poc_s1_minus1
            bw.write(1, 1)               # used_by_curr_pic_s1_flag
            prev = rp
    if ps.sao_enabled:
        bw.write(int(sp.sao_luma), 1)
        bw.write(int(sp.sao_chroma), 1)
    if sp.slice_type != SLICE_I:
        if sp.num_ref_l0 > 1:
            bw.write(1, 1)  # num_ref_idx_active_override_flag
            bw.write_ue(sp.num_ref_l0 - 1)
            if sp.slice_type == SLICE_B:
                bw.write_ue(0)  # num_ref_idx_l1_active_minus1
        else:
            bw.write(0, 1)  # num_ref_idx_active_override_flag
        # ref_pic_list_modification (PPS lists_modification_present_flag=1;
        # spec 7.3.6.2) — present whenever NumPicsTotalCurr > 1
        npt = len(sp.ref_pocs_before) + len(sp.ref_pocs_after)
        if npt > 1:
            nbits = max(1, (npt - 1).bit_length())
            bw.write(0, 1)  # ref_pic_list_modification_flag_l0
            if sp.slice_type == SLICE_B:
                if sp.l1_swap:
                    bw.write(1, 1)  # ref_pic_list_modification_flag_l1
                    # exactly num_ref_idx_l1_active entries must follow;
                    # write_pps signals num_ref_idx_l1_default_active_minus1
                    # = 0 (see line ~200) and no override is written above,
                    # so the active L1 count is pinned to 1 here
                    bw.write(1, nbits)  # list_entry_l1[0] = 1
                else:
                    bw.write(0, 1)
        if sp.slice_type == SLICE_B:
            bw.write(0, 1)  # mvd_l1_zero_flag
        bw.write_ue(5 - sp.max_merge_cand)  # five_minus_max_num_merge_cand
    bw.write_se(sp.qp - ps.init_qp)  # slice_qp_delta
    # spec 7.3.6.1: gated on (slice_sao_luma || slice_sao_chroma ||
    # !slice_deblocking_filter_disabled_flag), not the SPS/PPS enables
    if sp.sao_luma or sp.sao_chroma or ps.deblocking_enabled:
        bw.write(1, 1)  # slice_loop_filter_across_slices_enabled_flag
    if ps.wpp:
        offsets = entry_point_offsets or []
        bw.write_ue(len(offsets))
        if offsets:
            max_off = max(offsets)
            offset_len = max(1, (max_off - 1).bit_length() if max_off > 1 else 1)
            bw.write_ue(offset_len - 1)
            for off in offsets:
                bw.write(off - 1, offset_len)
    # byte_alignment(): one alignment_bit_equal_to_one, then zeros
    bw.write(1, 1)
    bw.align_zero()
    return bw
