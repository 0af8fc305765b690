"""TorchPipeline: GOP/POC flow, frame dispatch to the port's device
encoders and host programs, SAO, NAL assembly. Written from
homerhevc_tpu/engine/pipeline.py EncoderPipeline, for every configuration
of one device:

  - I frames: on the device programs below where the JAX package runs
    its own (intra_device_ok, the twin of its _tpu_ok), else on the host
    programs it runs there (_analyze_intra_host: hevc/intra_frame.py at a
    fixed CU size with the per-CTB AQ map, hevc/intra_tree.py's tree with
    intra_rdo at CTU 32 / 64 and RD_FULL, hevc/deblock.py with the
    decoder-view QP map), chosen by configuration alone;
  - P and B frames: on the device P programs where the JAX package runs
    its own (inter_device_ok, the twin of _tpu_inter_ok), each predicting
    from the recon as SAO filtered it (a host recon uploaded once), else
    inline on the host programs it runs there (_analyze_inter_host:
    hevc/inter_frame.py's CU32 / CU64 tree at CTU 32 / 64, else CU16, with
    merge-RD and rectangular PUs, the per-CTB map, deblocking inside; its
    bi B tree for IBP's B frames at CTU 32): intra_rdo at CU16, per-CTB
    QP maps with deblocking on or with intra-in-P at CU32 / CU64;
  - all-intra CU16 (gop_size 0): frames are batched num_frames_in_flight
    at a time, with the upload / dispatch / background fetch pipeline;
    all-intra CU32 / CU64 with intra_rdo (the fast decision, no per-CTB QP
    maps): the intra CU-tree encoder, batched the same way, with
    deblocking and SAO inside its device program;
  - IPPP (gop_size 1) on the device: the depth-2 P chain, whose motion
    search reads the device-resident recon of the previous frame, in
    every performance mode, with the FAR motion search level (me_range >
    32) and intra-in-P; periodic and scene-change IDRs. With gpb or
    num_ref_frames 2 at CTU 32, every P frame after the second
    bi-predicts from t-1 and t-2 (generalized-B slices, t-2 in list 1 by
    l1_swap). With num_ref_frames > 2, once the reference queue holds two
    pictures every P frame up to the next IDR predicts from all of them
    (per-CU ref_idx_l0, CU16, on the host: _mref_frame), the device chain
    drained and dropped first;
  - IBP (gop_size 2, num_b 1): anchors at even display positions, each B
    between them coded after its later anchor (decode order I0 P2 B1 A4
    B3 ...). At CTU 32 the B frames bi-predict from both anchors and,
    on the device, the anchors from the third on from the two previous
    anchors; elsewhere B frames predict from the earlier anchor alone.
    Search range 24.

Per-CTB QP maps (AQ, and row-RC under CBR / VBR; cu_qp_delta with the
quantization group a CTB): an AQ map per I frame (the batched CU16 path
carries one per frame; the tree takes none, as in the JAX package), the
AQ map plus the row-RC offsets per P frame and IBP anchor, each emitted
before the next is dispatched. The device programs give B frames no map,
the host programs give them one, as the JAX package's do.

SAO: the tree and P programs decide and apply SAO on the device and ship
its parameters on the wire. The CU16 intra program and the host programs
have none, and for their frames SAO is decided and applied on the host
(hevc/sao.py sao_decide), as the JAX package does for the same frames:
this is that package's own behaviour, not a fallback, and it keeps the
two streams equal (a device decision there would choose other, equally
legal parameters). The next frame then predicts from the filtered
picture.

Rate control, WPP substreams and the native CABAC serializer work as in
the JAX package (multi-reference slices and B slices with rectangular PUs
take the Python serializer, as there). The pipeline codes on its one
device whatever num_devices says, as the JAX EncoderPipeline does (it
never reads it); parallel/mesh.py spreads frames or GOP segments over
several. No route depends on the device found or on a failure.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator

import numpy as np

from homerhevc_tpu_torch.config import EncoderConfig, RDMode
from homerhevc_tpu_torch.device import resolve_device
from homerhevc_tpu_torch.engine.rate_control import RateControl, aq_qp_map
from homerhevc_tpu_torch.hevc import deblock as hdb
from homerhevc_tpu_torch.hevc.bitstream import (
    NAL_IDR_W_RADL, NAL_TRAIL_N, NAL_TRAIL_R, BitWriter, ebsp_row_escapes,
    make_nal,
)
from homerhevc_tpu_torch.hevc.cabac import CabacEncoder
from homerhevc_tpu_torch.hevc.ctx_tables import init_contexts
from homerhevc_tpu_torch.hevc.headers import (
    SLICE_B, SLICE_I, SLICE_P, ParamSets, SliceParams, write_pps,
    write_slice_header, write_sps, write_vps,
)
from homerhevc_tpu_torch.hevc.inter_frame import (encode_b_frame_tree,
                                                  encode_inter_frame,
                                                  encode_inter_frame_tree)
from homerhevc_tpu_torch.hevc.intra_frame import encode_intra_frame
from homerhevc_tpu_torch.hevc.intra_tree import (decide_intra_tree,
                                                 encode_intra_tree_frame)
from homerhevc_tpu_torch.hevc.sao import sao_apply_component, sao_decide
from homerhevc_tpu_torch.hevc.syntax import SliceDataEncoder
from homerhevc_tpu_torch.utils.profiler import PROFILER

# the scene-change detector's least deviation, a share of its MAD level
# (TorchPipeline._scene_change)
SCENE_DEV_FLOOR = 0.05


def _mref(desc, refs_before, poc):
    """(num_ref_l0, ref_dists_l0) for a multi-reference slice, or (1, None)
    when the desc carries no per-CU ref_idx (two references ride the two
    lists)."""
    if getattr(desc, "ref_idx", None) is None:
        return 1, None
    return len(refs_before), tuple(poc - rp for rp in refs_before)


def _ref_dists(poc, refs_before, refs_after, l1_swap):
    """POC(cur) - POC(first entry) of each reference list. L0 leads with
    the closest past ref; L1 leads with the first future ref, or (under
    ref_pic_list_modification l1_swap) the second past ref."""
    refs_before = tuple(refs_before or ())
    refs_after = tuple(refs_after or ())
    if not refs_before and not refs_after:
        return (1, 1)
    l0 = refs_before[0] if refs_before else refs_after[0]
    if refs_after:
        l1 = refs_after[0]
    elif l1_swap and len(refs_before) >= 2:
        l1 = refs_before[1]
    else:
        l1 = refs_before[0]
    return (poc - l0, poc - l1)


def _maps(cfg: EncoderConfig) -> bool:
    """Per-CTB QP maps (AQ, row-RC): the PPS cu_qp_delta machinery."""
    return cfg.aq_strength > 0 or cfg.rc_ctu


def tree_ok(cfg: EncoderConfig) -> bool:
    """The intra CU-tree device path (decision + CTB32 wavefront with
    in-loop deblocking and SAO) serves `cfg`, a config padded to whole
    CTUs: the twin of EncoderPipeline._tpu_tree_ok."""
    return (cfg.intra_rdo and cfg.cu_size in (32, 64) and not _maps(cfg)
            and cfg.rd_mode != RDMode.RD_FULL
            and cfg.width % 32 == 0 and cfg.height % 32 == 0)


def intra_device_ok(cfg: EncoderConfig) -> bool:
    """A device program codes the I frames of `cfg` (padded): the tree, or
    the CU16 wavefront without intra_rdo, whose per-CTB QP maps need
    deblocking off (the deblocking QP of an uncoded quantization group is
    the decoder's predictor, which only the host infers). The twin of
    EncoderPipeline._tpu_ok; every other I frame takes the host programs
    (TorchPipeline._analyze_intra_host)."""
    return tree_ok(cfg) or (
        not cfg.intra_rdo and not (_maps(cfg) and cfg.deblocking)
        and cfg.cu_size == 16
        and cfg.width % 16 == 0 and cfg.height % 16 == 0)


def inter_device_ok(cfg: EncoderConfig) -> bool:
    """The device P programs code the P and B frames of `cfg` (padded):
    CU16 where the I frames are on the device, and the CU32 / CU64 tree
    whatever codes the I frames, with per-CTB QP maps only with deblocking
    and intra-in-P off. The twin of EncoderPipeline._tpu_inter_ok."""
    if intra_device_ok(cfg):
        return True
    maps_ok = not _maps(cfg) or (not cfg.deblocking and not cfg.intra_in_p)
    geom_ok = ((cfg.cu_size == 32 and cfg.width % 32 == 0
                and cfg.height % 16 == 0)
               or (cfg.cu_size == 64 and cfg.width % 64 == 0
                   and cfg.height % 64 == 0))
    return maps_ok and geom_ok


class _Traced(tuple):
    """A pushed source frame (y, u, v) that carries its lifecycle stamps
    (`trace`, a utils.profiler.FrameTrace) while the tracer is on."""


class _AsyncFetch:
    """Background fetch of a dispatched all-intra batch's wire data: the
    device->host copy and the native unpack release the GIL, so they
    overlap the CABAC serialization of the previous batch on the main
    thread."""

    def __init__(self, enc, out, frames, qp, qp_maps=None):
        self.frames = frames
        self.qp = qp
        self._result = None
        self._err = None
        PROFILER.stamp(frames, "fetch")

        def run():
            PROFILER.set_role("fetch")
            try:
                self._result = enc.fetch_frames(out, len(frames),
                                                qp_maps=qp_maps)
            except BaseException as e:   # re-raised on join()
                self._err = e
        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def join(self):
        with PROFILER.scope("intra.fetch_join"):
            self._t.join()
        if self._err is not None:
            raise self._err
        PROFILER.stamp(self.frames, "fetched")
        return self._result, self.frames, self.qp


class TorchPipeline:
    def __init__(self, cfg: EncoderConfig, device):
        # pad the coded picture to CTU multiples and crop on output via the
        # SPS conformance window; the slice check reads the padded config
        # (1080p is 1088 lines at CTU 32 and 64)
        self.out_w, self.out_h = cfg.width, cfg.height
        ctu = cfg.ctu_size
        cw, ch = -(-cfg.width // ctu) * ctu, -(-cfg.height // ctu) * ctu
        if (cw, ch) != (cfg.width, cfg.height):
            cfg = dataclasses.replace(cfg, width=cw, height=ch)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ps = ParamSets.from_config(cfg)
        self.ps.conf_win_right = cw - self.out_w
        self.ps.conf_win_bottom = ch - self.out_h
        self.poc = 0
        self.gop_poc = 0
        # frame batching applies to all-intra only (P frames chain on the
        # previous reconstruction)
        self.batch = (max(1, cfg.num_frames_in_flight) if cfg.gop_size == 0
                      else 1)
        self._queue: list = []
        self._upload_q: list = []   # packed source batches on the device
        self._pending_q: list = []  # dispatched intra batches
        self._fetch_inflight = None  # _AsyncFetch of the oldest batch
        # dispatched P frames: depth 2, or 1 (inline) with cu_qp_delta
        self._p_pendings: list = []
        # the P chain's references: _ref for the next P frame (the I
        # frame's filtered recon, then each dispatched P frame's
        # device-resident recon), _ref_prev the one before it on the
        # chain (t-2, the list-1 reference of a generalized-B frame)
        self._ref = None
        self._ref_prev = None
        # the last emitted reference picture's filtered recon (a
        # non-reference B never becomes it)
        self._last_recon = None
        # IBP: the next display index, the held odd frame, the IDR's
        # display index and the anchor before the last (t-2 of an anchor
        # that bi-predicts)
        self._disp = 0
        self._held = None
        self._idr_base = 0
        self._anchor_m2 = None
        self.avg_dist = 1000.0   # reference init, hmr_encoder_lib.c:913
        self.rc = RateControl(cfg)
        # the exact per-CTU-row byte counts of the last WPP slice (row-RC)
        self._last_row_sizes = None
        # which program codes the I frames: the device's, or the host's
        # (hevc/intra_frame.py, hevc/intra_tree.py), by configuration alone
        self._intra_device = intra_device_ok(cfg)
        # and which codes the P and B frames: the device P programs, or
        # the host's (hevc/inter_frame.py), which code every
        # multi-reference frame
        self._inter_device = inter_device_ok(cfg)
        # the reference pictures of a multi-reference P frame (filtered
        # recon, most recent first, at most num_ref_frames; never across
        # an IDR)
        self._ref_queue: list = []
        self._intra_enc = None
        self._inter_enc = None

    # ---- device encoders ---------------------------------------------------

    def _intra(self):
        assert self._intra_device, "the host programs code these I frames"
        if self._intra_enc is None:
            if tree_ok(self.cfg):
                from homerhevc_tpu_torch.engine.intra_tree_encoder import \
                    TorchIntraTreeEncoder as Enc
            else:
                from homerhevc_tpu_torch.engine.intra_encoder import \
                    TorchIntraEncoder as Enc
            self._intra_enc = Enc(self.ps, self.cfg, device=self.device)
        return self._intra_enc

    def _inter(self):
        if self._inter_enc is None:
            from homerhevc_tpu_torch.engine.inter_encoder import \
                TorchInterEncoder
            self._inter_enc = TorchInterEncoder(
                self.ps, self.cfg, search=self._inter_search_range(),
                device=self.device)
        return self._inter_enc

    def _inter_search_range(self) -> int:
        # IBP anchors are two display frames apart: double the window so
        # that anchor ME covers the same velocity as the IPPP chain
        return 24 if self.cfg.num_b >= 1 else 16

    # ---- per-CTB QP maps (AQ, row-RC) -------------------------------------

    def _aq_map(self, y, qp):
        """The per-CTB AQ map of an I frame, or None with cu_qp_delta off
        (maps never reach the device tree encoder: tree_ok excludes
        them)."""
        if not self.ps.cu_qp_delta_enabled:
            return None
        return aq_qp_map(np.asarray(y), self.ps.ctu_size, qp,
                         self.cfg.aq_strength)

    def _inter_qp_map(self, y, qp):
        """The per-CTB QP map of a P frame: the AQ map and/or the row-RC
        offsets of the last P frame's row shares, clipped to [0, 51]; None
        when neither applies."""
        if not self.ps.cu_qp_delta_enabled:
            return None
        ctu = self.ps.ctu_size
        rows = -(-self.cfg.height // ctu)
        cols = -(-self.cfg.width // ctu)
        base = None
        if self.cfg.aq_strength > 0:
            base = aq_qp_map(np.asarray(y), ctu, qp, self.cfg.aq_strength)
        if self.cfg.rc_ctu and self.rc.enabled:
            off = self.rc.row_offsets(rows)
            if base is None:
                base = np.full((rows, cols), qp, np.int32)
            base = np.clip(base + off[:, None], 0, 51).astype(np.int32)
        return base

    def _note_row_shares(self, desc) -> None:
        """Row-RC: the emitted P frame's per-CTB-row share of the bits, from
        the WPP serializer's exact row sizes, else from the coefficient
        mass (3 * nnz + sum |level|, the device cost model's proxy)."""
        if self._last_row_sizes is not None:
            self.rc.note_row_shares(
                np.asarray(self._last_row_sizes, np.float64) + 1)
            return
        if desc.coef_y is None and desc.cg_wire is None:
            return
        d = desc.densify()
        ctu = self.ps.ctu_size
        rows = -(-self.cfg.height // ctu)

        def row_mass(plane, unit):
            p = np.abs(plane.astype(np.int64))
            pad = rows * unit - p.shape[0]
            if pad > 0:
                p = np.pad(p, ((0, pad), (0, 0)))
            return (p + 2 * (p != 0)).reshape(rows, -1).sum(axis=1)
        self.rc.note_row_shares(row_mass(d.coef_y, ctu)
                                + row_mass(d.coef_u, ctu // 2)
                                + row_mass(d.coef_v, ctu // 2) + 1)

    # ---- I frames -----------------------------------------------------------

    def _analyze_intra(self, fr, qp):
        """One I frame, inline: on the device programs where they serve the
        configuration, else on the host programs."""
        if not self._intra_device:
            return self._host(fr, "intra.host", self._analyze_intra_host,
                              *fr, qp)
        enc = self._intra()
        y, u, v = fr
        qp_map = self._aq_map(y, qp)
        maps = None if qp_map is None else [qp_map]
        return self._inline(
            fr, lambda: enc.dispatch_frames([y], [u], [v], qps=[qp],
                                            qp_maps=maps),
            lambda out: enc.fetch_frames(out, 1, qp_maps=maps)[0])

    @staticmethod
    def _host(fr, name, analyze, *args, **kw):
        """analyze(*args, **kw): a host program coding the frame fr, in the
        scope `name`; its trace's dispatch is the start, fetch and fetched
        the end."""
        PROFILER.stamp((fr,), "dispatch")
        with PROFILER.scope(name):
            res = analyze(*args, **kw)
        PROFILER.stamp((fr,), "fetch", "fetched")
        return res

    @staticmethod
    def _inline(fr, dispatch, fetch):
        """fetch(dispatch()): the frame fr on a device program, launched
        and fetched at once, its trace stamped at each step."""
        PROFILER.stamp((fr,), "dispatch")
        out = dispatch()
        PROFILER.stamp((fr,), "fetch")
        res = fetch(out)
        PROFILER.stamp((fr,), "fetched")
        return res

    def _analyze_intra_host(self, y, u, v, qp):
        """The host I-frame programs, as the JAX package's
        _analyze_intra_golden runs them: the tree (CTB32 nodes; RD_FULL
        adds NxN 4x4 PUs, TU splits and the chroma RDO) with intra_rdo at
        CTU 32 / 64, else fixed CUs of min(cu_size, 32) with the per-CTB AQ
        map; then deblocking, at the QP a decoder derives for each unit
        under cu_qp_delta. SAO follows in _emit. Returns (FrameDesc, y, u,
        v) with int32 recon planes."""
        ps = self.ps
        tree = self.cfg.intra_rdo and ps.ctu_size >= 32
        if tree:
            # the tree takes no map (the JAX package passes none there)
            ctb = min(ps.ctu_size, 32)
            dec = decide_intra_tree(
                ps, y, u, v, qp, ctb=ctb,
                full_rd=self.cfg.rd_mode == RDMode.RD_FULL)
            desc, ry, ru, rv = encode_intra_tree_frame(ps, y, u, v, qp, dec,
                                                       ctb=ctb)
        else:
            desc, ry, ru, rv = encode_intra_frame(
                ps, y, u, v, qp, cu_size=min(self.cfg.cu_size, 32),
                qp_map=self._aq_map(y, qp))
        if ps.deblocking_enabled:
            tu8 = ((ps.ctu_size >> desc.cu_depth) >> desc.tr_depth) \
                .astype(np.int32)
            if ps.cu_qp_delta_enabled:
                # uncoded quantization groups keep the predictor's QP
                qp8 = hdb.decoder_qp_map8(desc, ps, qp, wpp=ps.wpp)
            else:
                qp8 = np.full_like(tu8, qp)
            bs_v, bs_h = hdb.intra_bs_maps(tu8)
            ry = hdb.deblock_plane_luma(ry, tu8, qp8, bs_v, bs_h)
            ru = hdb.deblock_plane_chroma(ru, qp8, bs_v, bs_h,
                                          ps.cb_qp_offset)
            rv = hdb.deblock_plane_chroma(rv, qp8, bs_v, bs_h,
                                          ps.cr_qp_offset)
        return desc, ry, ru, rv

    # ---- serialization ------------------------------------------------------

    def _serialize_slice(self, desc, slice_type: int, nal_type: int,
                         qp: int, sao_params=None, poc=None,
                         refs_before=None, refs_after=(),
                         l1_swap: bool = False) -> bytes:
        """One slice NAL: the native C++ serializer (one CABAC substream
        per CTU row under WPP, contexts forking from the state after the
        second CTB of the row above), else the Python one. poc and the
        reference POCs default to a P slice of the previous picture."""
        from homerhevc_tpu_torch import native
        ps = self.ps
        poc = self.gop_poc if poc is None else poc
        if refs_before is None:
            refs_before = (poc - 1,) if slice_type != SLICE_I else ()
        st = {SLICE_I: "I", SLICE_P: "P"}.get(slice_type, "B")
        dists = _ref_dists(poc, refs_before, refs_after, l1_swap)
        num_ref_l0, rdl0 = _mref(desc, refs_before, poc)
        with PROFILER.scope("serialize.cabac"):
            res = None if rdl0 is not None else native.encode_slice_native(
                ps, desc, init_contexts(st, qp), ps.sign_hiding,
                slice_type=slice_type, sao_params=sao_params, wpp=ps.wpp,
                ref_dists=dists, slice_qp=qp)
        offsets = None
        if res is None:
            # no native library (no g++): the Python serializer
            res = self._serialize_python(desc, slice_type, st, qp,
                                         sao_params, dists, rdl0)
        if ps.wpp:
            payload, row_sizes = res
            self._last_row_sizes = row_sizes
            # entry points count escaped bytes (spec 7.4.7.1)
            with PROFILER.scope("serialize.escapes"):
                esc = ebsp_row_escapes(payload, row_sizes)
            offsets = [s + e for s, e in zip(row_sizes[:-1], esc[:-1])]
        else:
            payload = res
        sao = sao_params is not None
        sp = SliceParams(slice_type=slice_type, nal_type=nal_type, poc=poc,
                         qp=qp, sao_luma=sao, sao_chroma=sao,
                         ref_pocs_before=refs_before,
                         ref_pocs_after=refs_after, l1_swap=l1_swap,
                         num_ref_l0=num_ref_l0)
        bw = write_slice_header(ps, sp, entry_point_offsets=offsets)
        with PROFILER.scope("serialize.nal"):
            return make_nal(nal_type, bw.get_bytes() + payload)

    def _serialize_python(self, desc, slice_type, st, qp, sao_params, dists,
                          rdl0):
        """The Python CABAC serializer: the payload, or under WPP
        (payload, row byte counts)."""
        ps = self.ps

        def data_encoder(enc):
            return SliceDataEncoder(ps, desc, enc, slice_type, qp,
                                    sao_params=sao_params, ref_dists=dists,
                                    ref_dists_l0=rdl0)
        if not ps.wpp:
            bw = BitWriter()
            enc = CabacEncoder(bw, init_contexts(st, qp))
            sd = data_encoder(enc)
            n_ctus = ps.ctus_x * ps.ctus_y
            for i in range(n_ctus):
                sd.encode_ctu(i % ps.ctus_x, i // ps.ctus_x)
                sd.encode_ctu_end(end_of_slice=(i == n_ctus - 1))
            enc.finish()
            bw.write_byte_alignment()
            return bw.get_bytes()
        rows = []
        saved_ctx = None      # ctx snapshot after CTB 1 of the row above
        for cy in range(ps.ctus_y):
            ctx = (init_contexts(st, qp) if saved_ctx is None
                   else saved_ctx.copy())
            bw_row = BitWriter()
            enc = CabacEncoder(bw_row, ctx)
            sd = data_encoder(enc)
            for cx in range(ps.ctus_x):
                sd.encode_ctu(cx, cy)
                last_ctu = (cy == ps.ctus_y - 1) and (cx == ps.ctus_x - 1)
                sd.encode_ctu_end(end_of_slice=last_ctu)
                if cx == 1:
                    saved_ctx = ctx.copy()
            if cy != ps.ctus_y - 1:
                enc.encode_terminate(1)  # end_of_subset_one_bit
            enc.finish()
            bw_row.write_byte_alignment()
            rows.append(bw_row.get_bytes())
        return b"".join(rows), [len(r) for r in rows]

    # ---- public flow -------------------------------------------------------

    def _is_intra_poc(self, poc: int) -> bool:
        if self.cfg.gop_size == 0 or poc == 0:
            return True
        ip = self.cfg.intra_period
        return ip > 0 and poc % ip == 0

    def _emit(self, desc, ry, ru, rv, src, slice_type=SLICE_I, qp=None,
              poc=None, refs_before=None, refs_after=(), is_ref=True,
              display_poc=None, l1_swap=False):
        from homerhevc_tpu_torch.api import EncodedFrame
        qp = self.cfg.qp if qp is None else qp
        # device-decided SAO: the recon arrived filtered and the host only
        # writes the syntax; CU16 I frames decide and apply it here
        sao_params = getattr(desc, "sao_params", None)
        device_sao = sao_params is not None
        if self.ps.sao_enabled and not device_sao:
            ctu = self.ps.ctu_size
            with PROFILER.scope("sao.decide"):
                ry, ru, rv = (np.asarray(ry), np.asarray(ru), np.asarray(rv))
                sao_params = sao_decide(src, (ry, ru, rv), ctu, qp)
                ry = sao_apply_component(ry, sao_params, 0, ctu)
                ru = sao_apply_component(ru, sao_params, 1, ctu // 2)
                rv = sao_apply_component(rv, sao_params, 2, ctu // 2)
        if is_ref:
            self._last_recon = (ry, ru, rv)
            if self.cfg.gop_size != 0:
                q = [] if slice_type == SLICE_I else self._ref_queue
                self._ref_queue = ([(ry, ru, rv)] + q)[
                    :max(1, self.cfg.num_ref_frames)]
        nals = []
        if slice_type == SLICE_I:
            self.gop_poc = 0
            nal_type = NAL_IDR_W_RADL
            nals += [write_vps(self.ps), write_sps(self.ps),
                     write_pps(self.ps)]
        else:
            nal_type = NAL_TRAIL_R if is_ref else NAL_TRAIL_N
        with PROFILER.scope("serialize"):
            nals.append(self._serialize_slice(
                desc, slice_type, nal_type, qp, sao_params, poc=poc,
                refs_before=refs_before, refs_after=refs_after,
                l1_swap=l1_swap))
        if self.cfg.gop_size != 0:
            # average luma distortion per 4x4 partition, feeding the adaptive
            # inter zero-forcing threshold (reference avg_dist,
            # hmr_encoder_lib.c:3215-3233: x1.5 after I frames). Exact int
            # SSD: P frames ship per-row sums (desc.row_ssd_y), so their
            # recon never crosses to the host for this.
            rs = getattr(desc, "row_ssd_y", None)
            if rs is not None and (sao_params is None or device_sao):
                ssd = int(np.asarray(rs, np.int64).sum())
            else:
                d = (np.asarray(ry, np.int64)
                     - np.asarray(src[0], np.int64)).ravel()
                ssd = int(np.dot(d, d))
            avg = float(ssd) / (np.asarray(src[0]).size / 16.0)
            self.avg_dist = avg * (1.5 if slice_type == SLICE_I else 1.0)
        if self.cfg.rc_ctu and self.rc.enabled and slice_type != SLICE_I:
            self._note_row_shares(desc)
        oh, ow = self.out_h, self.out_w

        def recon_thunk(ry=ry, ru=ru, rv=rv):
            return {"y": np.asarray(ry, np.uint8)[:oh, :ow],
                    "u": np.asarray(ru, np.uint8)[:oh // 2, :ow // 2],
                    "v": np.asarray(rv, np.uint8)[:oh // 2, :ow // 2]}
        ftype = {SLICE_I: "I", SLICE_P: "P"}.get(slice_type, "B")
        trace = getattr(src, "trace", None)
        ef = EncodedFrame(self.poc if display_poc is None else display_poc,
                          ftype, nals, recon=recon_thunk, avg_qp=qp,
                          trace=trace)
        self.rc.end_pic(ef.bits, slice_type == SLICE_I)
        self.poc += 1
        self.gop_poc += 1
        if trace is not None:
            trace.d2h_bytes = getattr(desc, "d2h_bytes", 0)
            PROFILER.stamp((src,), "emit")
        return ef

    def _drain_queue(self, final: bool = False) -> Iterator:
        """Dispatch the queued batch to the device, then serialize the
        PREVIOUS batch while the device runs (host/device overlap)."""
        frames = self._queue
        self._queue = []
        if len(frames) > 1 and self._intra_device:
            # all-intra batch pipeline: two batches stay in flight
            enc = self._intra()
            self._upload_q.append((enc.pack_upload(frames), frames))
            yield from self._dispatch_upload(enc)
        else:
            # in-order output: finish uploaded + in-flight device batches
            # before any inline-analyzed frame is emitted
            yield from self._drain_intra_batches()
            for fr in frames:
                if self.cfg.num_b >= 1:
                    yield from self._encode_gop2(fr)
                else:
                    yield from self._encode_one(fr)
        if final:
            yield from self._drain_p_pending()
            if self.cfg.num_b >= 1 and self._held is not None:
                # the held frame has no later anchor: a trailing P
                yield from self._trailing_p()
            yield from self._drain_intra_batches()

    def _encode_one(self, fr) -> Iterator:
        y, u, v = fr
        intra = self._is_intra_poc(self.poc)
        qp = self.rc.pic_qp(intra)
        # record the source for EVERY frame (including scheduled intras) so
        # the MAD stays a one-frame delta
        with PROFILER.scope("scene.detect"):
            scene_cut = self._scene_change(y)
        if scene_cut:
            PROFILER.count("scene.cuts")
        if (not intra and self.cfg.reinit_gop_on_scene_change
                and scene_cut):
            # scene change -> RC pivot + GOP reinit (hmr_motion_inter.c:3791;
            # RC pivot hmr_rate_control.c:49-87): the injected IDR takes the
            # I-frame QP/budget and stale P-cost stats reset
            intra = True
            self.rc.scene_pivot()
            qp = self.rc.pic_qp(True)
        if intra:
            yield from self._drain_p_pending()
            desc, ry, ru, rv = self._analyze_intra(fr, qp)
            ef = self._emit(desc, ry, ru, rv, fr, qp=qp)
            # the next P frame predicts from the recon as filtered by SAO (a
            # host recon is uploaded by the P program's dispatch, only when
            # a P frame follows); references never cross an IDR
            self._ref, self._ref_prev = self._last_recon, None
            yield ef
            return
        if self.cfg.num_ref_frames > 2 and len(self._ref_queue) >= 2:
            # multi-reference L0 (more than two references): per-CU
            # reference choice and ref_idx_l0 on the host, once two
            # references exist; the frames before ride the device chain
            yield from self._drain_p_pending()
            yield from self._mref_frame(fr, qp)
            return
        if not self._inter_device:
            # the host P programs, inline (a configuration whose P frames
            # no device program codes)
            desc, ry, ru, rv = self._inter_frame(fr, qp)
            yield self._emit(desc, ry, ru, rv, fr, slice_type=SLICE_P,
                             qp=qp, refs_before=self._p_refs())
            self._ref, self._ref_prev = self._last_recon, None
            return
        # P chain: dispatch frame i on the device (its ME reads the
        # device-resident recon of frame i-1), then do frame i-1's host half
        # (download, syntax selection, CABAC) while the device runs. Depth
        # 2: the avg_dist zero-forcing feedback lags 2 frames, like the
        # reference's cross-engine RC handoff (hmr_encoder_lib.c:3268).
        # Generalized-B (cfg.gpb, or num_ref_frames 2 realized as the
        # two-list t-1 / t-2 machinery): once two references exist, the
        # frame bi-predicts from t-1 (list 0) and t-2 (list 1), at CTU 32.
        # With cu_qp_delta (per-CTB QP maps, CU16 only) each P frame is
        # fetched and emitted before the next is dispatched, as the JAX
        # package runs them (its _p_pipeline_ok): the zero-forcing
        # feedback and row-RC's row shares then come from the frame
        # just before.
        enc = self._inter()
        ref, ref2 = self._ref, self._ref_prev
        gpb = ((self.cfg.gpb or self.cfg.num_ref_frames >= 2)
               and ref2 is not None and self.ps.ctu_size == 32)
        qp_map = self._inter_qp_map(y, qp)
        PROFILER.stamp((fr,), "dispatch")
        if gpb:
            out = enc.dispatch_b(fr, ref, ref2, self.avg_dist, qp=qp)
        else:
            out = enc.dispatch(fr, ref, self.avg_dist, qp=qp, qp_map=qp_map)
        self._ref_prev, self._ref = ref, enc.last_dev
        self._p_pendings.append((out, fr, qp, gpb, qp_map))
        if len(self._p_pendings) >= (1 if self.ps.cu_qp_delta_enabled
                                     else 2):
            yield from self._drain_p_pending(one=True)

    def _p_refs(self):
        """The reference POCs of an IPPP P slice that predicts from the
        previous picture alone: that picture, and with num_ref_frames > 2
        every picture of the reference queue, which the multi-reference
        frames after it predict from (a picture left out of a slice's
        reference picture set leaves the decoder's buffer). The JAX
        package lists the previous picture alone, so its depth-2 chain's
        second P frame drops the I frame the first multi-reference frame
        then reads, and its stream does not decode (ROADMAP Queue 3);
        this differs from it in that slice header only."""
        n = len(self._ref_queue) if self.cfg.num_ref_frames > 2 else 1
        return tuple(self.gop_poc - 1 - i for i in range(max(1, n)))

    def _mref_frame(self, src, qp) -> Iterator:
        """A P frame predicting from every picture of the reference queue
        (nearest first, POC distances 1, 2, ...): CU16, per-CU ref_idx_l0,
        the Python serializer (the native one codes one reference). The
        device chain ends here: the frames up to the next IDR are all of
        this kind."""
        nref = min(self.cfg.num_ref_frames, len(self._ref_queue))
        refs = [tuple(np.asarray(pl, np.int32) for pl in r)
                for r in self._ref_queue[:nref]]
        dists = tuple(range(1, nref + 1))
        desc, ry, ru, rv = self._host(
            src, "inter.mref", encode_inter_frame, self.ps, src, refs[0], qp,
            cu_size=16, search=self._inter_search_range(),
            avg_dist=self.avg_dist, ref_list=refs, ref_dists=dists)
        poc = self.gop_poc
        yield self._emit(desc, ry, ru, rv, src, slice_type=SLICE_P, qp=qp,
                         refs_before=tuple(poc - d for d in dists))
        self._ref, self._ref_prev = self._last_recon, None

    def _drain_p_pending(self, one: bool = False) -> Iterator:
        while self._p_pendings:
            out, src, qp, gpb, qp_map = self._p_pendings.pop(0)
            PROFILER.stamp((src,), "fetch")
            desc, ry, ru, rv = self._inter().fetch(
                out, bi=gpb, ref_dists=(1, 2), qp_map=qp_map)
            PROFILER.stamp((src,), "fetched")
            if gpb:
                p = self.gop_poc
                yield self._emit(desc, ry, ru, rv, src, slice_type=SLICE_B,
                                 qp=qp, refs_before=(p - 1, p - 2),
                                 l1_swap=True)
            else:
                yield self._emit(desc, ry, ru, rv, src, slice_type=SLICE_P,
                                 qp=qp, refs_before=self._p_refs())
            if one:
                return

    # ---- IBP (gop_size 2, one B between anchors) --------------------------

    def _inter_frame(self, fr, qp, ref=None, is_b=False):
        """One P frame (or, with is_b, a B frame of uni-L0 CUs) coded
        inline against ref, by default the last reference picture: on the
        device P program with the frame's per-CTB QP map (a B frame takes
        none), or on the host programs, which take the map for B frames
        too, as the JAX package's do."""
        ref = self._last_recon if ref is None else ref
        if not self._inter_device:
            return self._host(fr, "inter.host", self._analyze_inter_host,
                              fr, qp, ref, is_b)
        qp_map = None if is_b else self._inter_qp_map(fr[0], qp)
        enc = self._inter()
        return self._inline(
            fr, lambda: enc.dispatch(fr, ref, self.avg_dist, qp=qp,
                                     qp_map=qp_map),
            lambda out: enc.fetch(out, is_b=is_b, qp_map=qp_map))

    def _analyze_inter_host(self, fr, qp, ref, is_b):
        """The host P programs, as the JAX package's _analyze_inter runs
        them where its device does not: the CU32 / CU64 tree at CTU 32 /
        64, else CU16, each with merge-RD and rectangular PUs (off with a
        map, and in FAST / UFAST) and deblocking inside. SAO follows in
        _emit. Returns (FrameDesc, y, u, v) with int32 recon planes."""
        kw = dict(is_b=is_b, search=self._inter_search_range(),
                  avg_dist=self.avg_dist, merge_rd=True, rect_pu=True,
                  qp_map=self._inter_qp_map(fr[0], qp))
        if self.ps.ctu_size in (32, 64):
            return encode_inter_frame_tree(self.ps, fr, ref, qp, **kw)
        return encode_inter_frame(self.ps, fr, ref, qp, cu_size=16, **kw)

    def _trailing_p(self) -> Iterator:
        """The held frame as a P frame of the anchor before it (closed GOP
        before an IDR, and at the end of the stream)."""
        bt, fb = self._held
        self._held = None
        qb = self.rc.pic_qp(False)
        desc, ry, ru, rv = self._inter_frame(fb, qb)
        yield self._emit(desc, ry, ru, rv, fb, slice_type=SLICE_P, qp=qb,
                         poc=bt - self._idr_base, display_poc=bt,
                         refs_before=(bt - 1 - self._idr_base,))

    def _bi_ok(self) -> bool:
        """The bi-predicted program serves this geometry (the CU32/CU16
        tree at CTU 32)."""
        return (self.ps.ctu_size == 32 and self.cfg.width % 32 == 0
                and self.cfg.height % 32 == 0)

    def _encode_gop2(self, fr) -> Iterator:
        """IBP: anchors at even display positions, one B between them,
        emitted in decode order I0 P2 B1 A4 B3 ... Each anchor predicts
        from the anchor before it, two display frames back (from the third
        anchor on, at CTU 32 on the device, bi-predicted from the two
        previous anchors: t-2 in list 0, t-4 in list 1 by l1_swap); each B,
        a non-reference picture, from both anchors around it (at CTU 32,
        on the device's B program or the host bi B tree; elsewhere from
        the earlier one alone) with the B QP offset. No scene-cut check,
        as in the JAX package."""
        t = self._disp
        self._disp += 1
        ip = self.cfg.intra_period
        intra = t == 0 or (ip > 0 and (t - self._idr_base) % ip == 0)
        if t % 2 == 1 and not intra:
            self._held = (t, fr)
            return
        prev_anchor = self._last_recon
        qp = self.rc.pic_qp(intra)
        if intra:
            if self._held is not None:
                yield from self._trailing_p()    # closed GOP before the IDR
            self._idr_base = t
            desc, ry, ru, rv = self._analyze_intra(fr, qp)
            self._anchor_m2 = None
            yield self._emit(desc, ry, ru, rv, fr, qp=qp, display_poc=t)
        else:
            poc = t - self._idr_base
            held = self._held is not None
            prev2 = self._anchor_m2
            if (held and prev2 is not None and self._inter_device
                    and self._bi_ok()):
                # a generalized-B anchor: list 0 the previous anchor (t-2),
                # list 1 the one before (t-4); per-CU uni / bi keeps the
                # quality at the two distances
                desc, ry, ru, rv = self._bi_frame(
                    fr, self._last_recon, prev2, qp, ref_dists=(2, 4))
                self._anchor_m2 = self._last_recon
                yield self._emit(desc, ry, ru, rv, fr, slice_type=SLICE_B,
                                 qp=qp, poc=poc, display_poc=t,
                                 refs_before=(poc - 2, poc - 4),
                                 l1_swap=True)
            else:
                self._anchor_m2 = self._last_recon if held else None
                desc, ry, ru, rv = self._inter_frame(fr, qp)
                yield self._emit(desc, ry, ru, rv, fr, slice_type=SLICE_P,
                                 qp=qp, poc=poc, display_poc=t,
                                 refs_before=(poc - 2 if held else poc - 1,))
        if self._held is None:
            return
        # the held B, now that its later anchor is reconstructed: a
        # non-reference picture one step down the QP ladder
        # (cfg.b_qp_offset, the reference's depth-scaled lambda)
        bt, fb = self._held
        self._held = None
        bpoc = bt - self._idr_base
        qb = min(51, self.rc.pic_qp(False) + self.cfg.b_qp_offset)
        if self._bi_ok() and self._inter_device:
            desc, ry, ru, rv = self._bi_frame(fb, prev_anchor,
                                              self._last_recon, qb)
        elif self._bi_ok():
            # the host bi B tree (no per-CTB QP map)
            desc, ry, ru, rv = self._host(
                fb, "inter.host", encode_b_frame_tree, self.ps, fb,
                tuple(np.asarray(p, np.int32) for p in prev_anchor),
                tuple(np.asarray(p, np.int32) for p in self._last_recon),
                qb, search=self._inter_search_range(),
                avg_dist=self.avg_dist)
        else:
            desc, ry, ru, rv = self._inter_frame(fb, qb, ref=prev_anchor,
                                                 is_b=True)
        yield self._emit(desc, ry, ru, rv, fb, slice_type=SLICE_B, qp=qb,
                         poc=bpoc, display_poc=bt, refs_before=(bpoc - 1,),
                         refs_after=(bpoc + 1,), is_ref=False)

    def _bi_frame(self, fr, ref0, ref1, qp, ref_dists=(1, -1)):
        """The frame fr on the device's bi-capable program, against the
        list-0 reference ref0 and the list-1 reference ref1 at POC
        distances ref_dists."""
        enc = self._inter()
        return self._inline(
            fr, lambda: enc.dispatch_b(fr, ref0, ref1, self.avg_dist, qp=qp),
            lambda out: enc.fetch(out, bi=True, ref_dists=ref_dists))

    def _dispatch_upload(self, enc) -> Iterator:
        """Dispatch the oldest uploaded batch; serialize the batch whose
        background fetch was started last cycle."""
        handle, frames = self._upload_q.pop(0)
        prev_results = None
        if self._fetch_inflight is not None:
            prev_results = self._fetch_inflight.join()
            self._fetch_inflight = None
        qp = self.rc.pic_qp(True)
        maps = ([self._aq_map(fr[0], qp) for fr in frames]
                if self.ps.cu_qp_delta_enabled else None)
        PROFILER.stamp(frames, "dispatch")
        self._pending_q.append(
            (enc.dispatch_packed(handle, [qp] * len(frames), maps),
             frames, qp, maps))
        if len(self._pending_q) >= 2:
            out, pframes, pqp, pmaps = self._pending_q.pop(0)
            self._fetch_inflight = _AsyncFetch(enc, out, pframes, pqp,
                                               pmaps)
        if prev_results is not None:
            yield from self._emit_batch(*prev_results)

    def _emit_batch(self, results, frames, qp) -> Iterator:
        for (desc, ry, ru, rv), src in zip(results, frames):
            yield self._emit(desc, ry, ru, rv, src, qp=qp)

    def _drain_intra_batches(self) -> Iterator:
        while self._upload_q:
            yield from self._dispatch_upload(self._intra())
        if self._fetch_inflight is not None:
            results = self._fetch_inflight.join()
            self._fetch_inflight = None
            yield from self._emit_batch(*results)
        while self._pending_q:
            out, pframes, qp, maps = self._pending_q.pop(0)
            PROFILER.stamp(pframes, "fetch")
            results = self._intra().fetch_frames(out, len(pframes),
                                                 qp_maps=maps)
            PROFILER.stamp(pframes, "fetched")
            yield from self._emit_batch(results, pframes, qp)

    def _scene_change(self, y: np.ndarray) -> bool:
        """Scene-change detector: mean absolute difference (MAD) between
        consecutive SOURCE lumas against an adaptive threshold (running
        MAD level and its deviation), so fast pans on noisy content do not
        cut while hard transitions on static content do. Source frames keep
        the detector independent of the device-resident reference chain.

        Two departures from the JAX package's detector, whose level
        freezes at its first cut, so that a clip whose MAD then stays a
        little above the frozen threshold cuts on every frame:

        - a declared cut drops the level, and the next delta re-seeds it
          as the first delta of the stream does: the level follows the
          new scene;
        - the threshold keeps the deviation at SCENE_DEV_FLOOR of the
          level or more, so it is at least 1.25x the level. On a steady
          noisy clip the deviation decays to well under 1 % of the level
          (hevcbench/clip.py at 720p: a MAD of 20.1 that moves by about
          0.1), and a small object jumping across the picture raises the
          MAD by 6-9 % (its 160x120 box wrapping: 21.3-22.0), which then
          is no cut; a hard cut raises it many times over."""
        prev = getattr(self, "_last_src_y", None)
        self._last_src_y = np.asarray(y, np.int16)
        if prev is None:
            return False
        mad = float(np.mean(np.abs(self._last_src_y.astype(np.int32)
                                   - prev)))
        ema = getattr(self, "_mad_ema", None)
        if ema is None:
            # the first delta of the stream or after a cut seeds the
            # running level; a cut there is still caught by the absolute
            # floor below
            self._mad_ema, self._mad_dev = mad, max(2.0, mad * 0.25)
            return mad > 30.0
        dev = max(self._mad_dev, SCENE_DEV_FLOOR * ema)
        if mad > max(12.0, ema + 5.0 * dev):
            self._mad_ema = None
            return True
        self._mad_ema = ema = 0.8 * ema + 0.2 * mad
        self._mad_dev = 0.8 * self._mad_dev + 0.2 * abs(mad - ema)
        return False

    def _pad_frame(self, y, u, v):
        dh = self.cfg.height - np.asarray(y).shape[0]
        dw = self.cfg.width - np.asarray(y).shape[1]
        if dh == 0 and dw == 0:
            return y, u, v
        if dh < 0 or dw < 0:
            raise ValueError("input larger than configured size")
        y = np.pad(np.asarray(y), ((0, dh), (0, dw)), mode="edge")
        u = np.pad(np.asarray(u), ((0, dh // 2), (0, dw // 2)), mode="edge")
        v = np.pad(np.asarray(v), ((0, dh // 2), (0, dw // 2)), mode="edge")
        return y, u, v

    def push(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> Iterator:
        trace = PROFILER.frame_trace()
        fr = self._pad_frame(y, u, v)
        if trace is not None:
            fr = _Traced(fr)
            fr.trace = trace
        self._queue.append(fr)
        if len(self._queue) >= self.batch:
            yield from self._drain_queue()

    def flush(self) -> Iterator:
        yield from self._drain_queue(final=True)
