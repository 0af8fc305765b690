"""TorchPipeline: GOP/POC flow, frame dispatch to the port's device
encoders, SAO, NAL assembly. Written from homerhevc_tpu/engine/pipeline.py
EncoderPipeline, restricted to the configurations the port covers:

  - all-intra CU16 (gop_size 0): frames are batched num_frames_in_flight
    at a time, with the upload / dispatch / background fetch pipeline;
  - all-intra CU32 / CU64 with intra_rdo (gop_size 0, the fast decision,
    no per-CTB QP maps): the intra CU-tree encoder, batched the same way,
    with deblocking and SAO inside its device program;
  - IPPP (gop_size 1) at CU16, and at CU32 / CU64 with intra_rdo (the
    CU tree: the intra tree encoder's I frames and the P program's
    CU32 / CU64 layers), in every performance mode, with the FAR motion
    search level (me_range > 32) and intra-in-P: the depth-2 P chain,
    whose motion search reads the device-resident recon of the previous
    frame; periodic and scene-change IDRs.

SAO: the tree and P programs decide and apply SAO on the device and ship
its parameters on the wire. The CU16 intra program has none, and for its
frames SAO is decided and applied on the host (hevc/sao.py sao_decide),
as the JAX package does for the same frames: this is that package's own
behaviour, not a fallback, and it keeps the two streams equal (a device
decision there would choose other, equally legal parameters). The P
chain then predicts from the filtered picture.

Rate control, WPP substreams and the native CABAC serializer work as in
the JAX package. There is no numpy golden path: a configuration outside
the slice raises NotImplementedError when the pipeline is built, naming
the ROADMAP.md Queue 1 item that will bring it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator

import numpy as np

from homerhevc_tpu_torch.config import EncoderConfig, RDMode
from homerhevc_tpu_torch.device import resolve_device
from homerhevc_tpu_torch.engine.rate_control import RateControl
from homerhevc_tpu_torch.hevc.bitstream import (
    NAL_IDR_W_RADL, NAL_TRAIL_R, BitWriter, ebsp_row_escapes, make_nal,
)
from homerhevc_tpu_torch.hevc.cabac import CabacEncoder
from homerhevc_tpu_torch.hevc.ctx_tables import init_contexts
from homerhevc_tpu_torch.hevc.headers import (
    SLICE_I, SLICE_P, ParamSets, SliceParams, write_pps, write_slice_header,
    write_sps, write_vps,
)
from homerhevc_tpu_torch.hevc.sao import sao_apply_component, sao_decide
from homerhevc_tpu_torch.hevc.syntax import SliceDataEncoder
from homerhevc_tpu_torch.utils.profiler import PROFILER

# POC distance of each reference list's first entry: every P slice of the
# slice predicts from the previous picture only
_REF_DISTS = (1, 1)


def tree_ok(cfg: EncoderConfig) -> bool:
    """The intra CU-tree device path (decision + CTB32 wavefront with
    in-loop deblocking and SAO) serves `cfg`, a config padded to whole
    CTUs: the twin of EncoderPipeline._tpu_tree_ok."""
    return (cfg.intra_rdo and cfg.cu_size in (32, 64)
            and not (cfg.aq_strength > 0 or cfg.rc_ctu)
            and cfg.rd_mode != RDMode.RD_FULL
            and cfg.width % 32 == 0 and cfg.height % 32 == 0)


def unported(cfg: EncoderConfig) -> str | None:
    """Why `cfg` (padded to whole CTUs) lies outside the configurations the
    port covers, and the ROADMAP.md Queue 1 item that brings it; None when
    it is covered."""
    inter = cfg.gop_size != 0
    checks = (
        (cfg.aq_strength > 0 or cfg.rc_ctu,
         "per-CTB QP maps, AQ and row-RC (Queue 1 item 4)"),
        ((cfg.cu_size != 16 or cfg.intra_rdo) and not tree_ok(cfg),
         "an intra configuration the JAX package encodes only on its numpy "
         "golden path (RD_FULL, intra_rdo at CU16, CU32/CU64 without "
         "intra_rdo, whose I frames have no device program in IPPP either: "
         "Queue 1 item 7)"),
        (cfg.num_b != 0, "B frames (Queue 1 item 5)"),
        (inter and cfg.gpb, "generalized-B P frames (Queue 1 item 5)"),
        (inter and cfg.num_ref_frames != 1,
         "multi-reference P frames (Queue 1 item 5)"),
        (cfg.num_devices != 1, "multi-GPU encoding (Queue 1 item 6)"),
    )
    for bad, what in checks:
        if bad:
            return what
    return None


class _AsyncFetch:
    """Background fetch of a dispatched all-intra batch's wire data: the
    device->host copy and the native unpack release the GIL, so they
    overlap the CABAC serialization of the previous batch on the main
    thread."""

    def __init__(self, enc, out, frames, qp):
        self.frames = frames
        self.qp = qp
        self._result = None
        self._err = None

        def run():
            try:
                self._result = enc.fetch_frames(out, len(frames))
            except BaseException as e:   # re-raised on join()
                self._err = e
        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def join(self):
        self._t.join()
        if self._err is not None:
            raise self._err
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
        why = unported(cfg)
        if why is not None:
            raise NotImplementedError(
                f"{why} is not ported to homerhevc_tpu_torch yet "
                f"(ROADMAP.md)")
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
        self._p_pendings: list = []  # dispatched P frames (depth 2)
        # reference planes of the next P frame: the I frame's (filtered)
        # recon, then each dispatched P frame's device-resident recon
        self._ref = None
        self._last_recon = None   # the last emitted frame's filtered recon
        self.avg_dist = 1000.0   # reference init, hmr_encoder_lib.c:913
        self.rc = RateControl(cfg)
        self._intra_enc = None
        self._inter_enc = None

    # ---- device encoders ---------------------------------------------------

    def _intra(self):
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
            self._inter_enc = TorchInterEncoder(self.ps, self.cfg,
                                                device=self.device)
        return self._inter_enc

    # ---- serialization ------------------------------------------------------

    def _slice_params(self, slice_type, nal_type, qp, offsets=None,
                      sao=False):
        refs = (self.gop_poc - 1,) if slice_type != SLICE_I else ()
        sp = SliceParams(slice_type=slice_type, nal_type=nal_type,
                         poc=self.gop_poc, qp=qp, sao_luma=sao,
                         sao_chroma=sao, ref_pocs_before=refs)
        return write_slice_header(self.ps, sp, entry_point_offsets=offsets)

    def _serialize_slice_wpp(self, desc, slice_type: int, nal_type: int,
                             qp: int, sao_params=None) -> bytes:
        """WPP slice: one CABAC substream per CTU row; contexts fork from the
        state after the second CTB of the row above (spec entropy sync)."""
        from homerhevc_tpu_torch import native
        ps = self.ps
        st = "I" if slice_type == SLICE_I else "P"
        with PROFILER.scope("ser_native"):
            res = native.encode_slice_native(
                ps, desc, init_contexts(st, qp), ps.sign_hiding,
                slice_type=slice_type, sao_params=sao_params, wpp=True,
                ref_dists=_REF_DISTS, slice_qp=qp)
        if res is not None:
            payload, row_sizes = res
        else:
            rows = []
            saved_ctx = None      # ctx snapshot after CTB 1 of the row above
            for cy in range(ps.ctus_y):
                ctx = (init_contexts(st, qp) if saved_ctx is None
                       else saved_ctx.copy())
                bw_row = BitWriter()
                enc = CabacEncoder(bw_row, ctx)
                sd = SliceDataEncoder(ps, desc, enc, slice_type, qp,
                                      sao_params=sao_params,
                                      ref_dists=_REF_DISTS)
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
            payload = b"".join(rows)
            row_sizes = [len(r) for r in rows]
        # entry points count escaped bytes (spec 7.4.7.1)
        with PROFILER.scope("ser_escapes"):
            esc = ebsp_row_escapes(payload, row_sizes)
        offsets = [s + e for s, e in zip(row_sizes[:-1], esc[:-1])]
        bw = self._slice_params(slice_type, nal_type, qp, offsets,
                                sao=sao_params is not None)
        return make_nal(nal_type, bw.get_bytes() + payload)

    def _serialize_slice(self, desc, slice_type: int, nal_type: int,
                         qp: int, sao_params=None) -> bytes:
        ps = self.ps
        if ps.wpp:
            return self._serialize_slice_wpp(desc, slice_type, nal_type, qp,
                                             sao_params)
        from homerhevc_tpu_torch import native
        bw = self._slice_params(slice_type, nal_type, qp,
                                sao=sao_params is not None)
        ctx = init_contexts("I" if slice_type == SLICE_I else "P", qp)
        with PROFILER.scope("ser_native"):
            payload = native.encode_slice_native(
                ps, desc, ctx, ps.sign_hiding, slice_type=slice_type,
                sao_params=sao_params, ref_dists=_REF_DISTS, slice_qp=qp)
        if payload is not None:
            with PROFILER.scope("ser_nal"):
                return make_nal(nal_type, bw.get_bytes() + payload)
        # no native library (no g++): the Python serializer
        enc = CabacEncoder(bw, ctx)
        sd = SliceDataEncoder(ps, desc, enc, slice_type, qp,
                              sao_params=sao_params, ref_dists=_REF_DISTS)
        n_ctus = ps.ctus_x * ps.ctus_y
        for i in range(n_ctus):
            sd.encode_ctu(i % ps.ctus_x, i // ps.ctus_x)
            sd.encode_ctu_end(end_of_slice=(i == n_ctus - 1))
        enc.finish()
        bw.write_byte_alignment()
        return make_nal(nal_type, bw.get_bytes())

    # ---- public flow -------------------------------------------------------

    def _is_intra_poc(self, poc: int) -> bool:
        if self.cfg.gop_size == 0 or poc == 0:
            return True
        ip = self.cfg.intra_period
        return ip > 0 and poc % ip == 0

    def _emit(self, desc, ry, ru, rv, src, slice_type=SLICE_I, qp=None):
        from homerhevc_tpu_torch.api import EncodedFrame
        qp = self.cfg.qp if qp is None else qp
        # device-decided SAO: the recon arrived filtered and the host only
        # writes the syntax; CU16 I frames decide and apply it here
        sao_params = getattr(desc, "sao_params", None)
        device_sao = sao_params is not None
        if self.ps.sao_enabled and not device_sao:
            ctu = self.ps.ctu_size
            with PROFILER.scope("sao"):
                ry, ru, rv = (np.asarray(ry), np.asarray(ru), np.asarray(rv))
                sao_params = sao_decide(src, (ry, ru, rv), ctu, qp)
                ry = sao_apply_component(ry, sao_params, 0, ctu)
                ru = sao_apply_component(ru, sao_params, 1, ctu // 2)
                rv = sao_apply_component(rv, sao_params, 2, ctu // 2)
        self._last_recon = (ry, ru, rv)
        nals = []
        if slice_type == SLICE_I:
            self.gop_poc = 0
            nal_type = NAL_IDR_W_RADL
            nals += [write_vps(self.ps), write_sps(self.ps),
                     write_pps(self.ps)]
        else:
            nal_type = NAL_TRAIL_R
        with PROFILER.scope("serialize"):
            nals.append(self._serialize_slice(desc, slice_type, nal_type, qp,
                                              sao_params))
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
        oh, ow = self.out_h, self.out_w

        def recon_thunk(ry=ry, ru=ru, rv=rv):
            return {"y": np.asarray(ry, np.uint8)[:oh, :ow],
                    "u": np.asarray(ru, np.uint8)[:oh // 2, :ow // 2],
                    "v": np.asarray(rv, np.uint8)[:oh // 2, :ow // 2]}
        ef = EncodedFrame(self.poc, "I" if slice_type == SLICE_I else "P",
                          nals, recon=recon_thunk, avg_qp=qp)
        self.rc.end_pic(ef.bits, slice_type == SLICE_I)
        self.poc += 1
        self.gop_poc += 1
        return ef

    def _drain_queue(self, final: bool = False) -> Iterator:
        """Dispatch the queued batch to the device, then serialize the
        PREVIOUS batch while the device runs (host/device overlap)."""
        frames = self._queue
        self._queue = []
        if len(frames) > 1:
            # all-intra batch pipeline: two batches stay in flight
            enc = self._intra()
            with PROFILER.scope("pack_upload"):
                self._upload_q.append((enc.pack_upload(frames), frames))
            yield from self._dispatch_upload(enc)
        else:
            # in-order output: finish uploaded + in-flight device batches
            # before any inline-analyzed frame is emitted
            yield from self._drain_intra_batches()
            for fr in frames:
                yield from self._encode_one(*fr)
        if final:
            yield from self._drain_p_pending()
            yield from self._drain_intra_batches()

    def _encode_one(self, y, u, v) -> Iterator:
        intra = self._is_intra_poc(self.poc)
        qp = self.rc.pic_qp(intra)
        # record the source for EVERY frame (including scheduled intras) so
        # the MAD stays a one-frame delta
        scene_cut = self._scene_change(y)
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
            with PROFILER.scope("analyze_intra_device"):
                desc, ry, ru, rv = self._intra().encode_frame(y, u, v, qp)
            ef = self._emit(desc, ry, ru, rv, (y, u, v), qp=qp)
            # the next P frame predicts from the recon as filtered by SAO
            self._ref = self._last_recon
            yield ef
            return
        # P chain: dispatch frame i on the device (its ME reads the
        # device-resident recon of frame i-1), then do frame i-1's host half
        # (download, syntax selection, CABAC) while the device runs. Depth
        # 2: the avg_dist zero-forcing feedback lags 2 frames, like the
        # reference's cross-engine RC handoff (hmr_encoder_lib.c:3268).
        enc = self._inter()
        with PROFILER.scope("dispatch_inter"):
            out = enc.dispatch((y, u, v), self._ref, self.avg_dist, qp=qp)
        self._ref = enc.last_dev
        self._p_pendings.append((out, (y, u, v), qp))
        if len(self._p_pendings) >= 2:
            yield from self._drain_p_pending(one=True)

    def _drain_p_pending(self, one: bool = False) -> Iterator:
        while self._p_pendings:
            out, src, qp = self._p_pendings.pop(0)
            with PROFILER.scope("fetch_inter"):
                desc, ry, ru, rv = self._inter().fetch(out)
            yield self._emit(desc, ry, ru, rv, src, slice_type=SLICE_P, qp=qp)
            if one:
                return

    def _dispatch_upload(self, enc) -> Iterator:
        """Dispatch the oldest uploaded batch; serialize the batch whose
        background fetch was started last cycle."""
        handle, frames = self._upload_q.pop(0)
        prev_results = None
        if self._fetch_inflight is not None:
            with PROFILER.scope("fetch_join"):
                prev_results = self._fetch_inflight.join()
            self._fetch_inflight = None
        qp = self.rc.pic_qp(True)
        with PROFILER.scope("dispatch_intra"):
            self._pending_q.append(
                (enc.dispatch_packed(handle, [qp] * len(frames)), frames, qp))
        if len(self._pending_q) >= 2:
            out, pframes, pqp = self._pending_q.pop(0)
            self._fetch_inflight = _AsyncFetch(enc, out, pframes, pqp)
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
            out, pframes, qp = self._pending_q.pop(0)
            with PROFILER.scope("fetch_intra"):
                results = self._intra().fetch_frames(out, len(pframes))
            yield from self._emit_batch(results, pframes, qp)

    def _scene_change(self, y: np.ndarray) -> bool:
        """Scene-change detector: mean absolute difference between
        consecutive SOURCE lumas against an adaptive threshold (running
        MAD level and its deviation), so fast pans on noisy content do not
        cut while hard transitions on static content do. Source frames keep
        the detector independent of the device-resident reference chain."""
        prev = getattr(self, "_last_src_y", None)
        self._last_src_y = np.asarray(y, np.int16)
        if prev is None:
            return False
        mad = float(np.mean(np.abs(self._last_src_y.astype(np.int32)
                                   - prev)))
        ema = getattr(self, "_mad_ema", None)
        if ema is None:
            # first delta seeds the running level; a cut on frame 1 is
            # still caught by the absolute floor below
            self._mad_ema, self._mad_dev = mad, max(2.0, mad * 0.25)
            return mad > 30.0
        dev = self._mad_dev
        thresh = max(12.0, ema + 5.0 * dev)
        cut = mad > thresh
        if not cut:
            self._mad_ema = 0.8 * ema + 0.2 * mad
            self._mad_dev = 0.8 * dev + 0.2 * abs(mad - self._mad_ema)
        return cut

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
        self._queue.append(self._pad_frame(y, u, v))
        if len(self._queue) >= self.batch:
            yield from self._drain_queue()

    def flush(self) -> Iterator:
        yield from self._drain_queue(final=True)
