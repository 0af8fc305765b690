"""Wavefront all-intra CU16 encoder (PyTorch port of
homerhevc_tpu/engine/intra_encoder.py TpuIntraEncoder).

All CUs on an anti-diagonal d = gx + 2*gy are mutually independent, so the
frame is coded one diagonal at a time: the JAX lax.scan over the diagonals
becomes a Python loop (168 steps at 720p), and vmap over frames becomes a
leading batch axis. The carry holds only the boundary rows/cols of the last
three diagonals in the diagonal-slot layout (slot = gy), so every
neighbour access is a shifted slice. Decisions, levels and recon are
bit-exact to the JAX encoder and the golden numpy encoder. The program
never synchronises with the host, so on the card it is captured into one
CUDA graph per batch shape and replayed: thousands of small kernels a
frame cost one launch a batch (TorchIntraEncoder._launch).

The numpy wire helpers (_split_planes, _parse_cg_wire, _unpack_cg_frame,
_wire_frame) are copies of the JAX module's: this package imports nothing
of homerhevc_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.hevc.syntax import FrameDesc
from homerhevc_tpu_torch.utils.profiler import PROFILER
from homerhevc_tpu_torch.device import FrameGraph, resolve_device
from homerhevc_tpu_torch.ops import intra as dip
from homerhevc_tpu_torch.ops.deblock import (deblock_chroma_uniform,
                                             deblock_luma_uniform)
from homerhevc_tpu_torch.ops.pack import (cg_cap, esc_capacity,
                                          pack_capacity, pack_sparse_cg,
                                          unpack_sparse_cg)
from homerhevc_tpu_torch.ops.quant import (dequantize, quantize, scan_class,
                                           sign_bit_hiding)
from homerhevc_tpu_torch.ops.transform import (forward_transform,
                                               inverse_transform)
from homerhevc_tpu_torch.state import tables_to_torch


def _mpm(left_mode: torch.Tensor, above_mode: torch.Tensor) -> torch.Tensor:
    """Vectorized spec 8.4.2.2 candModeList; inputs (B,), output (B, 3)."""
    a, b = left_mode, above_mode
    eq = a == b
    lt2 = a < 2
    eq0 = torch.where(lt2, 0, a)
    eq1 = torch.where(lt2, 1, 2 + ((a + 29) % 32))
    eq2 = torch.where(lt2, 26, 2 + ((a - 1) % 32))
    has_planar = (a == 0) | (b == 0)
    has_dc = (a == 1) | (b == 1)
    ne2 = torch.where(~has_planar, 0, torch.where(~has_dc, 1, 26))
    return torch.stack([torch.where(eq, eq0, a), torch.where(eq, eq1, b),
                        torch.where(eq, eq2, ne2)], dim=-1)


def _split_planes(buf: np.ndarray, shapes):
    """Contiguous plane views over one flat int16 buffer (no copies)."""
    planes, off = [], 0
    for h, w in shapes:
        planes.append(buf[off:off + h * w].reshape(h, w))
        off += h * w
    return planes


def _parse_cg_wire(meta_np: np.ndarray, off: int, n_tot: int, pack_C: int,
                   cg_C: int, E: int):
    """Split the per-frame CG wire out of a (F, meta_len) uint8 buffer
    starting at byte `off`. Layout (pack_sparse_cg order): cg_bitmap
    (n/128), masks16 (2*cg_C), codes (pack_C/4), esc_idx (4E),
    esc_val (2E), count/esc_count/cg_count (3 x int32)."""
    o = off
    cg_bitmaps = meta_np[:, o:o + n_tot // 128]
    o += n_tot // 128
    masks = meta_np[:, o:o + 2 * cg_C].copy().view(np.int16)
    o += 2 * cg_C
    codes = meta_np[:, o:o + pack_C // 4]
    o += pack_C // 4
    esc_idx = meta_np[:, o:o + E * 4].copy().view(np.int32)
    o += E * 4
    esc_val = meta_np[:, o:o + E * 2].copy().view(np.int16)
    o += E * 2
    tail = meta_np[:, o:o + 12].copy().view(np.int32)
    return (cg_bitmaps, masks, codes, esc_idx, esc_val,
            tail[:, 0], tail[:, 1], tail[:, 2], pack_C, cg_C, E)


def _unpack_cg_frame(wire, i: int, n_tot: int, shapes, full_fallback):
    """Expand frame i of a parsed CG wire into int16 planes; on capacity
    overflow call full_fallback() for the device-resident full planes."""
    (cg_bitmaps, masks, codes, esc_idx, esc_val, counts, esc_counts,
     cg_counts, pack_C, cg_C, E) = wire
    cnt, ec, cc = int(counts[i]), int(esc_counts[i]), int(cg_counts[i])
    if cnt > pack_C or ec > E or cc > cg_C:
        return full_fallback()
    from homerhevc_tpu_torch.native import unpack_sparse_cg_native
    buf = np.empty(n_tot, np.int16)
    if unpack_sparse_cg_native(cg_bitmaps[i], masks[i], codes[i], cnt, cc,
                               esc_idx[i, :ec], esc_val[i, :ec], n_tot,
                               buf, shapes):
        return _split_planes(buf, shapes)
    return unpack_sparse_cg(cg_bitmaps[i], masks[i], codes[i], cnt, cc,
                            esc_idx[i, :ec], esc_val[i, :ec], shapes)


def _wire_frame(wire, i: int, shapes):
    """Frame i of a parsed CG wire as a FrameDesc.cg_wire tuple, or None
    when the frame overflowed a static wire capacity."""
    (cg_bitmaps, masks, codes, esc_idx, esc_val, counts, esc_counts,
     cg_counts, pack_C, cg_C, E) = wire
    cnt, ec, cc = int(counts[i]), int(esc_counts[i]), int(cg_counts[i])
    if cnt > pack_C or ec > E or cc > cg_C:
        return None
    return (cg_bitmaps[i], masks[i], codes[i], esc_idx[i, :ec],
            esc_val[i, :ec], cnt, ec, cc, shapes)


class DevicePlane:
    """Lazy host view of a device-resident plane (frame i of a batched
    tensor, or a whole 2D tensor when i is None). numpy consumers
    (np.asarray in the pipeline and the tests) copy it to the host
    on demand; the port's own dispatch takes `.tensor` without a host
    round trip."""

    def __init__(self, arr: torch.Tensor, i=None):
        self.arr, self.i = arr, i

    @property
    def tensor(self) -> torch.Tensor:
        return self.arr if self.i is None else self.arr[self.i]

    def __array__(self, dtype=None, copy=None):
        a = self.tensor.cpu().numpy()
        PROFILER.count("d2h_bytes", a.nbytes)
        return a.astype(dtype) if dtype is not None else a


def fetch_planes(*planes):
    """The full coefficient planes of a frame whose wire overflowed a
    static capacity, as host arrays (counted as an overflow and its
    bytes)."""
    out = tuple(p.cpu().numpy() for p in planes)
    PROFILER.count("wire_overflows")
    PROFILER.count("d2h_bytes", sum(a.nbytes for a in out))
    return out


def as_device_plane(a, device: torch.device) -> torch.Tensor:
    """A reference/source plane as a uint8 tensor on `device`: tensors and
    DevicePlanes pass through without a host round trip."""
    if isinstance(a, DevicePlane):
        a = a.tensor
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.uint8)
    return torch.as_tensor(np.asarray(a, np.uint8), device=device)


def pack_frames(frames, w: int, h: int, device) -> torch.Tensor:
    """Pack a batch of (y, u, v) frames into one (F, w*h*3/2) uint8 buffer
    on the device: one upload per batch."""
    wh = w * h
    packed = np.empty((len(frames), wh * 3 // 2), np.uint8)
    for i, (y, u, v) in enumerate(frames):
        packed[i, :wh] = np.asarray(y, np.uint8).reshape(-1)
        packed[i, wh:wh + wh // 4] = np.asarray(u, np.uint8).reshape(-1)
        packed[i, wh + wh // 4:] = np.asarray(v, np.uint8).reshape(-1)
    return torch.from_numpy(packed).to(device)


def unpack_frames(handle: torch.Tensor, w: int, h: int):
    """The (F, h, w), (F, h/2, w/2), (F, h/2, w/2) planes of a buffer of
    pack_frames (views, no copy)."""
    wh = w * h
    return (handle[:, :wh].reshape(-1, h, w),
            handle[:, wh:wh + wh // 4].reshape(-1, h // 2, w // 2),
            handle[:, wh + wh // 4:].reshape(-1, h // 2, w // 2))


class WireFrameEncoder:
    """Host glue of the batched intra encoders: upload, dispatch, and the
    fetch of the compact wire. A subclass sets device, cfg, w, h, pack_C
    and cg_C, and gives _frame_impl(src_y, src_u, src_v, qp) -> (recon_y,
    recon_u, recon_v, ly, lu, lv, meta), _meta_prefix() (the bytes of a
    frame's meta row before its CG wire) and _desc(prefix) (a FrameDesc
    with the maps of that prefix; the coefficients are attached here).
    qp_maps (per-frame per-CU QP maps, the CU16 encoder's AQ program)
    reach _frame_impl as a fifth argument only when given."""

    def pack_upload(self, frames):
        with PROFILER.scope("intra.pack_upload"):
            return pack_frames(frames, self.w, self.h, self.device)

    def dispatch_packed(self, handle, qps, qp_maps=None):
        PROFILER.count("intra.frames", len(qps))
        with PROFILER.scope("intra.dispatch"):
            qp = torch.as_tensor(np.asarray(qps, np.int32),
                                 device=self.device)
            if qp_maps is None:
                return self._launch(handle, qp)
            # one upload of the batch's maps; they stay on the device
            maps = torch.as_tensor(np.asarray(qp_maps, np.int32),
                                   device=self.device)
            return self._launch(handle, qp, maps)

    def _launch(self, handle, *args):
        """_frame_impl over the packed batch `handle` and its device inputs
        (the frame QPs, and the QP maps where given)."""
        return self._frame_impl(*unpack_frames(handle, self.w, self.h),
                                *args)

    def dispatch_frames(self, ys, us, vs, qps=None, qp_maps=None):
        """Launch the batched frame program; returns device tensors (CUDA
        work is asynchronous). Pair with fetch_frames."""
        if qps is None:
            qps = [self.cfg.qp] * len(ys)
        return self.dispatch_packed(self.pack_upload(list(zip(ys, us, vs))),
                                    qps, qp_maps)

    def fetch_frames(self, out, n_frames: int, qp_maps=None):
        """Download the compact wire buffer and rebuild FrameDescs;
        reconstruction planes stay device-resident (DevicePlane). qp_maps:
        the host's per-CU maps of an AQ dispatch, attached to each desc
        for the cu_qp_delta serializer. While the tracer is on, each desc
        carries d2h_bytes: its row of the meta buffer, plus its full planes
        where its wire overflowed."""
        with PROFILER.scope("intra.fetch"):
            ry, ru, rv, ly, lu, lv, meta = out
            with PROFILER.scope("intra.fetch.d2h"):
                meta_np = meta.cpu().numpy()   # ONE device->host copy
            PROFILER.count("d2h_bytes", meta_np.nbytes)
            n_tot = self.w * self.h * 3 // 2
            off = self._meta_prefix()
            wire = _parse_cg_wire(meta_np, off, n_tot, self.pack_C,
                                  self.cg_C, esc_capacity(n_tot, self.pack_C))
            shapes = [(self.h, self.w), (self.h // 2, self.w // 2),
                      (self.h // 2, self.w // 2)]
            results = []
            with PROFILER.scope("intra.fetch.unpack"):
                for i in range(n_frames):
                    desc = self._desc(meta_np[i, :off])
                    desc.cg_wire = _wire_frame(wire, i, shapes)
                    nbytes = meta_np.shape[1]
                    if desc.cg_wire is None:   # a wire capacity overflowed
                        planes = fetch_planes(ly[i], lu[i], lv[i])
                        nbytes += sum(p.nbytes for p in planes)
                        desc.coef_y, desc.coef_u, desc.coef_v = (
                            np.ascontiguousarray(p, np.int16)
                            for p in planes)
                    else:     # wire-direct: FrameDesc.densify on demand
                        desc.coef_y = desc.coef_u = desc.coef_v = None
                    if qp_maps is not None:
                        # per-8x8 targets (the device quantized with
                        # exactly these per-CU QPs)
                        r = self.cu // 8
                        desc.qp_map = np.repeat(np.repeat(
                            np.asarray(qp_maps[i], np.int8), r, 0), r, 1)
                    if PROFILER.on:
                        desc.d2h_bytes = nbytes
                    results.append((desc, DevicePlane(ry, i),
                                    DevicePlane(ru, i), DevicePlane(rv, i)))
            return results

    def encode_frames(self, ys, us, vs, qps=None, qp_maps=None):
        """Batched: lists of F frames -> list of (desc, ry, ru, rv)."""
        return self.fetch_frames(
            self.dispatch_frames(ys, us, vs, qps=qps, qp_maps=qp_maps),
            len(ys), qp_maps=qp_maps)

    def encode_frame(self, y, u, v, qp: int, qp_map=None):
        return self.encode_frames([y], [u], [v], qps=[qp],
                                  qp_maps=None if qp_map is None
                                  else [qp_map])[0]


def _sh1(a: torch.Tensor) -> torch.Tensor:
    """Shift along the slot axis (dim 1): out[:, s] = a[:, s-1], 0 at s=0."""
    return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], dim=1)


class TorchIntraEncoder(WireFrameEncoder):
    """Wavefront all-intra CU16 encoder on one torch device. QP is a
    per-frame input; everything static is precomputed at init."""

    def __init__(self, ps: ParamSets, cfg: EncoderConfig, cu: int = 16, *,
                 device):
        self.device = resolve_device(device)
        self.ps = ps
        self.cfg = cfg
        w, h = cfg.width, cfg.height
        assert w % cu == 0 and h % cu == 0, \
            f"device path needs dims divisible by {cu}"
        self.cu = cu
        self.w, self.h = w, h
        self.gw, self.gh = w // cu, h // cu
        # capacities sized from the nominal QP with headroom for RC dips
        # (overflow falls back to full-plane fetches)
        self.pack_C = pack_capacity(w * h * 3 // 2, max(0, cfg.qp - 4))
        self.cg_C = cg_cap(w * h * 3 // 2, max(0, cfg.qp - 4))
        self.tab = tables_to_torch(ps, cfg, self.device, cu)
        self.ndiag = self.tab["ndiag"]
        flat = self.tab["d_flat"].reshape(-1)
        valid = self.tab["d_valid"].reshape(-1)
        self._flat_valid = flat[valid]             # block index per slot
        self._slot_valid = torch.nonzero(valid).reshape(-1)
        # by batch shape (_launch): None once dispatched, then its graph
        self._graphs: dict[tuple[int, int], FrameGraph | None] = {}

    # -- helpers -----------------------------------------------------------

    def _refs_from_prev(self, p1_brow, p1_rcol, p2_brow, p3_brow, n, mask):
        """Substituted (top[2n+1], left[2n+1]) per (frame, slot) from the
        boundary vectors (F, gh, n) of the previous three diagonals;
        returned flattened to (F*gh, 2n+1)."""
        F, gh = p1_brow.shape[:2]
        top1 = _sh1(p2_brow)             # above (d-2, s-1)
        top2 = _sh1(p1_brow)             # above-right (d-1, s-1)
        corner = _sh1(p3_brow)[:, :, -1:]  # above-left (d-3, s-1)
        zeros = torch.zeros_like(p1_rcol)
        # substitution sequence: [below-left, left bottom..top, corner, top]
        seq = torch.cat([zeros, p1_rcol.flip(-1), corner, top1, top2], dim=2)
        seq = seq.reshape(F * gh, -1)
        seq = dip.substitute_refs(seq, mask.expand(F, -1, -1)
                                  .reshape(F * gh, -1))
        return dip.seq_to_refs(seq, n)

    def _component(self, best, src_blk, refs, n, qp, is_luma,
                   preds=None):
        """TU pipeline for one component over (B,) blocks: lvl, rec."""
        if preds is None:
            top, left = refs
            preds = dip.predict_all_modes(top, left, n, is_luma)
        B = best.shape[0]
        pred = preds[torch.arange(B, device=best.device), best.long()]
        resid = src_blk - pred
        is_dst = is_luma and n == 4
        sl = self.ps.scaling_list_enabled
        coef = forward_transform(resid, is_dst)
        lvl = quantize(coef, n, qp, True, sl)
        if self.ps.sign_hiding:
            lvl = sign_bit_hiding(lvl, coef, n, qp, True,
                                  scan_class(best, n, is_luma), sl)
        deq = dequantize(lvl, n, qp, True, sl)
        rres = inverse_transform(deq, is_dst)
        any_nz = (lvl != 0).any(dim=-1).any(dim=-1)
        rec = torch.where(any_nz[:, None, None],
                          torch.clamp(pred + rres, 0, 255), pred)
        return lvl, rec

    def _assemble(self, blocks, n, hh, ww):
        """(ndiag, F, gh, n, n) diagonal-slot blocks -> (F, hh, ww) planes."""
        F = blocks.shape[1]
        gh, gw = self.gh, self.gw
        slots = blocks.permute(1, 0, 2, 3, 4).reshape(F, -1, n, n)
        buf = torch.zeros((F, gh * gw, n, n), dtype=blocks.dtype,
                          device=blocks.device)
        buf[:, self._flat_valid] = slots[:, self._slot_valid]
        return buf.reshape(F, gh, gw, n, n).permute(0, 1, 3, 2, 4) \
            .reshape(F, hh, ww)

    # -- whole-frame program --------------------------------------------------

    def _frame_impl(self, src_y, src_u, src_v, qp, qp_map=None):
        """src_*: (F, H, W) / (F, H/2, W/2) uint8 tensors; qp: (F,) int32;
        qp_map: None, or per-CU luma QPs (F, gh, gw) int32 (per-CU
        adaptive quantization, the twin of the JAX package's
        _encode_frame_impl_aq; deblocking must be off, as there). Returns
        (recon_y, recon_u, recon_v (uint8), ly, lu, lv (int16), meta (F,
        meta_len) uint8)."""
        tab = self.tab
        cu, cuc = self.cu, self.cu // 2
        gw, gh = self.gw, self.gh
        F = src_y.shape[0]
        dev = self.device
        qp = qp.to(torch.int32)
        qp_c = tab["chroma_qp_map"][
            torch.clamp(qp + self.ps.cb_qp_offset, 0, 57).long()]
        bits_mpm = tab["bits_mpm"][qp.long()]
        bits_rem = tab["bits_rem"][qp.long()]
        # per-block QP vectors in the (F*gh,) slot order of every step
        qp_b = qp[:, None].expand(F, gh).reshape(-1)
        qpc_b = qp_c[:, None].expand(F, gh).reshape(-1)
        bmpm_b = bits_mpm[:, None].expand(F, gh).reshape(-1, 1)
        brem_b = bits_rem[:, None].expand(F, gh).reshape(-1, 1)
        per_diag = None
        if qp_map is not None:
            if self.ps.deblocking_enabled:
                raise ValueError("per-CU QP maps need deblocking off (the "
                                 "decoder-view QP)")
            # the slot QPs of every diagonal through the padded d_flat
            # index, the pad slot at the slice QP; (ndiag, F*gh) so that
            # each step takes a view
            flat_q = torch.cat([qp_map.reshape(F, -1).to(torch.int32),
                                qp[:, None]], dim=1)
            qp_d = flat_q[:, tab["d_flat"]].permute(1, 0, 2) \
                .reshape(self.ndiag, F * gh).contiguous()
            qpc_d = tab["chroma_qp_map"][
                torch.clamp(qp_d + self.ps.cb_qp_offset, 0, 57).long()]
            per_diag = (qp_d, qpc_d,
                        tab["bits_mpm"][qp_d.long()][..., None],
                        tab["bits_rem"][qp_d.long()][..., None])

        def diag_blocks(plane, n):
            hh, ww = plane.shape[1:]
            b = plane.reshape(F, hh // n, n, ww // n, n) \
                .permute(0, 1, 3, 2, 4).reshape(F, -1, n, n)
            b = torch.cat([b, torch.zeros_like(b[:, :1])], dim=1)
            return b[:, tab["d_flat"]]                # (F, ndiag, gh, n, n)
        by = diag_blocks(src_y, cu)
        bu = diag_blocks(src_u, cuc)
        bv = diag_blocks(src_v, cuc)

        zs = lambda n: torch.zeros((F, gh, n), dtype=torch.int32, device=dev)
        p1b, p1r, p2b, p3b = zs(cu), zs(cu), zs(cu), zs(cu)
        p1b_u, p1r_u, p2b_u, p3b_u = zs(cuc), zs(cuc), zs(cuc), zs(cuc)
        p1b_v, p1r_v, p2b_v, p3b_v = zs(cuc), zs(cuc), zs(cuc), zs(cuc)
        p1m = torch.ones((F, gh), dtype=torch.int32, device=dev)
        p2m = torch.ones((F, gh), dtype=torch.int32, device=dev)
        modes_r = torch.arange(35, dtype=torch.int32, device=dev)
        outs = []
        for d in range(self.ndiag):
            if per_diag is not None:
                qp_b, qpc_b, bmpm_b, brem_b = (t[d] for t in per_diag)
            mask_y, mask_c = tab["d_mask_y"][d], tab["d_mask_c"][d]
            above_ok = tab["d_above_ok"][d]
            has_left = tab["d_has_left"][d]
            src_blk = by[:, d].reshape(F * gh, cu, cu).to(torch.int32)
            # ---- luma mode decision ----
            top, left = self._refs_from_prev(p1b, p1r, p2b, p3b, cu, mask_y)
            preds = dip.predict_all_modes(top, left, cu, True)
            preds = dip.edge_fixes(preds, top, left, cu, True)
            sad = torch.abs(src_blk[:, None] - preds).sum(
                dim=(-1, -2), dtype=torch.int32)
            left_mode = torch.where(has_left, p1m, 1).reshape(-1)
            above_mode = torch.where(above_ok, _sh1(p2m), 1).reshape(-1)
            mpm = _mpm(left_mode, above_mode)
            in_mpm = (modes_r[None, :, None] == mpm[:, None, :]).any(dim=-1)
            cost = sad + torch.where(in_mpm, bmpm_b, brem_b)
            best = cost.argmin(dim=-1).to(torch.int32)

            lvl, rec = self._component(best, src_blk, None, cu, qp_b, True,
                                       preds=preds)
            refs_u = self._refs_from_prev(p1b_u, p1r_u, p2b_u, p3b_u, cuc,
                                          mask_c)
            lvl_u, rec_u = self._component(
                best, bu[:, d].reshape(F * gh, cuc, cuc).to(torch.int32),
                refs_u, cuc, qpc_b, False)
            refs_v = self._refs_from_prev(p1b_v, p1r_v, p2b_v, p3b_v, cuc,
                                          mask_c)
            lvl_v, rec_v = self._component(
                best, bv[:, d].reshape(F * gh, cuc, cuc).to(torch.int32),
                refs_v, cuc, qpc_b, False)

            rec = rec.reshape(F, gh, cu, cu)
            rec_u = rec_u.reshape(F, gh, cuc, cuc)
            rec_v = rec_v.reshape(F, gh, cuc, cuc)
            best = best.reshape(F, gh)
            p1b, p1r, p2b, p3b = rec[:, :, -1, :], rec[:, :, :, -1], p1b, p2b
            p1b_u, p1r_u, p2b_u, p3b_u = (rec_u[:, :, -1, :],
                                          rec_u[:, :, :, -1], p1b_u, p2b_u)
            p1b_v, p1r_v, p2b_v, p3b_v = (rec_v[:, :, -1, :],
                                          rec_v[:, :, :, -1], p1b_v, p2b_v)
            p1m, p2m = best, p1m
            outs.append((rec, rec_u, rec_v, lvl.reshape(F, gh, cu, cu),
                         lvl_u.reshape(F, gh, cuc, cuc),
                         lvl_v.reshape(F, gh, cuc, cuc), best))
        rec, rec_u, rec_v, lvl, lvl_u, lvl_v, best = (
            torch.stack(x) for x in zip(*outs))

        mode_grid = torch.zeros((F, gh * gw), dtype=torch.int32, device=dev)
        mode_grid[:, self._flat_valid] = best.permute(1, 0, 2) \
            .reshape(F, -1)[:, self._slot_valid]
        hc, wc = self.h // 2, self.w // 2
        ry = self._assemble(rec, cu, self.h, self.w)
        ru = self._assemble(rec_u, cuc, hc, wc)
        rv = self._assemble(rec_v, cuc, hc, wc)
        # in-loop deblocking (post full-frame; intra prediction used the
        # pre-deblock samples above)
        if self.ps.deblocking_enabled:
            ry = deblock_luma_uniform(ry, cu, qp)
            ru = deblock_chroma_uniform(ru, cu, qp, self.ps.cb_qp_offset)
            rv = deblock_chroma_uniform(rv, cu, qp, self.ps.cr_qp_offset)
        recon_y, recon_u, recon_v = (ry.to(torch.uint8), ru.to(torch.uint8),
                                     rv.to(torch.uint8))
        ly = self._assemble(lvl.to(torch.int16), cu, self.h, self.w)
        lu = self._assemble(lvl_u.to(torch.int16), cuc, hc, wc)
        lv = self._assemble(lvl_v.to(torch.int16), cuc, hc, wc)
        # compact two-tier CG wire for the host CABAC handoff, all in ONE
        # uint8 buffer per frame (the full level planes stay on the device
        # as the capacity-overflow fallback)
        cg_bitmap, masks16, codes, esc_idx, esc_val, count, esc_count, \
            cg_count = pack_sparse_cg([ly, lu, lv], self.pack_C, self.cg_C)
        meta = torch.cat(
            [mode_grid.to(torch.uint8), cg_bitmap, _u8(masks16), codes,
             _u8(esc_idx), _u8(esc_val), _u8(count[:, None]),
             _u8(esc_count[:, None]), _u8(cg_count[:, None])], dim=1)
        return recon_y, recon_u, recon_v, ly, lu, lv, meta

    # -- host glue (WireFrameEncoder) ---------------------------------------

    def _launch(self, handle, *args):
        """_frame_impl, on the card from one CUDA graph per batch shape (the
        batch size, and whether QP maps are given). A shape's first
        dispatch runs eagerly and fills the cached device tables; its
        second captures the whole program into a graph and replays it;
        each later one copies its inputs into the graph's and replays. The
        graphs share one memory pool. On the CPU every dispatch runs
        eagerly."""
        key = (handle.shape[0], len(args))
        on_card = self.device.type == "cuda"
        if not on_card or key not in self._graphs:
            PROFILER.count("intra.eager")
            if on_card:
                self._graphs[key] = None
            return super()._launch(handle, *args)
        if self._graphs[key] is None:
            PROFILER.count("intra.graph_captures")
            shared = next((g for g in self._graphs.values() if g), None)
            self._graphs[key] = FrameGraph(super()._launch,
                                           (handle, *args), shared)
        else:
            PROFILER.count("intra.graph_replays")
        return self._graphs[key].replay(handle, *args)

    def _meta_prefix(self) -> int:
        return self.gh * self.gw                   # the mode grid

    def _desc(self, prefix):
        cu = self.cu
        desc = FrameDesc.alloc(self.w, self.h)
        desc.cu_depth[:] = self.ps.log2_ctu - (cu.bit_length() - 1)
        desc.tr_depth[:] = 0
        mode_all = prefix.reshape(self.gh, self.gw)
        r = cu // 4
        desc.luma_mode[:] = np.repeat(np.repeat(mode_all, r, 0), r, 1)
        r8 = cu // 8
        desc.chroma_mode[:] = np.repeat(np.repeat(mode_all, r8, 0), r8, 1)
        return desc


def _u8(a: torch.Tensor) -> torch.Tensor:
    """Byte view along the last axis (little-endian, as the JAX bitcast):
    (..., k) of a b-byte type -> (..., b*k) uint8."""
    return a.contiguous().view(torch.uint8)
