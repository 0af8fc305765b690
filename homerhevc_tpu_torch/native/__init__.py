"""ctypes bindings for the native host entropy coder (hevcenc.cpp).

Builds libhevcenc.so into the package's _build/ directory on first use
(g++ -O3); falls back to the pure-Python serializer when no compiler is
available. The first use is under a lock: the slot threads of a mesh
(parallel/mesh.py) may reach it at once, and each must get the library
the first one built, not the Python serializer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "hevcenc.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(_BUILD, "libhevcenc.so")
_lib = None
_lock = threading.Lock()     # guards _build and the loading in get_lib

_I32P = ctypes.c_void_p


def _build(force: bool = False) -> bool:
    try:
        if (not force and os.path.exists(_SO)
                and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
            return True
        os.makedirs(_BUILD, exist_ok=True)
        # build under a private name, then rename: concurrent test
        # workers never load a half-written library
        tmp = f"{_SO}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-funroll-loops", "-pthread",
             "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True)
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


_load_failed = False


def get_lib():
    if _lib is not None:
        return _lib
    with _lock:
        return _load()


def _load():
    """Build (if stale) and load the library; the caller holds _lock."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    if not _build():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        # stale/incompatible binary (git does not preserve mtimes): rebuild
        # once from source, then fall back to the Python serializer
        if not _build(force=True):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _load_failed = True
            return None
    lib.hevcenc_encode_slice2.restype = ctypes.c_long
    lib.hevcenc_encode_slice2.argtypes = (
        [ctypes.c_char_p]
        + [ctypes.c_int] * 15            # geometry/flags + dists + dqp/qp
        + [ctypes.c_char_p] * 6          # cu_depth..pred_mode
        + [_I32P]                        # qp_map (int8, nullable)
        + [_I32P] * 3                    # coef planes (int16)
        + [ctypes.c_char_p] * 5 + [_I32P]  # inter maps + mv
        + [_I32P, ctypes.c_char_p]       # mv_l1 + mvp_flag_l1 (B)
        + [ctypes.c_char_p]              # inter_dir (B, mixed uni/bi)
        + [ctypes.c_char_p]              # inter_part (rect PUs, P)
        + [ctypes.c_char_p] * 2 + [_I32P] * 6  # sao
        + [_I32P, ctypes.c_long, _I32P]
        + [ctypes.c_int]                 # n_threads (WPP row pool)
        + [_I32P] * 5                    # CG wire (nullable)
        + [ctypes.c_long] * 3)           # count / esc_count / cg_count
    lib.hevcenc_prof_read.restype = None
    lib.hevcenc_prof_read.argtypes = [_I32P]
    lib.hevcenc_unpack_sparse8.restype = ctypes.c_long
    lib.hevcenc_unpack_sparse8.argtypes = [
        _I32P, _I32P, ctypes.c_long, _I32P, _I32P, ctypes.c_long,
        ctypes.c_long, _I32P]
    lib.hevcenc_unpack_sparse2.restype = ctypes.c_long
    lib.hevcenc_unpack_sparse2.argtypes = [
        _I32P, _I32P, ctypes.c_long, _I32P, _I32P, ctypes.c_long,
        ctypes.c_long, _I32P]
    lib.hevcenc_unpack_sparse_cg.restype = ctypes.c_long
    lib.hevcenc_unpack_sparse_cg.argtypes = [
        _I32P, _I32P, _I32P, ctypes.c_long, ctypes.c_long,
        _I32P, _I32P, ctypes.c_long, ctypes.c_long, _I32P]  \
        + [ctypes.c_int] * 6             # plane dims (w, h) x 3
    _lib = lib
    return lib


def unpack_sparse8_native(bitmap, vals8, esc_idx, esc_val, n_total: int,
                          out: np.ndarray):
    """Expand the sparse wire format into `out` (int16, n_total). Returns
    False when the native library is unavailable or the data mismatches."""
    lib = get_lib()
    if lib is None:
        return False

    def p(a, dt):
        arr = np.ascontiguousarray(a, dt)
        return arr, arr.ctypes.data_as(ctypes.c_void_p)
    bm, p_bm = p(bitmap, np.uint8)
    v8, p_v8 = p(vals8, np.int8)
    ei, p_ei = p(esc_idx, np.int32)
    ev, p_ev = p(esc_val, np.int16)
    assert out.dtype == np.int16 and out.flags.c_contiguous
    n = lib.hevcenc_unpack_sparse8(
        p_bm, p_v8, len(v8), p_ei, p_ev, len(ei), n_total,
        out.ctypes.data_as(ctypes.c_void_p))
    return n >= 0


def unpack_sparse2_native(bitmap, codes, count: int, esc_idx, esc_val,
                          n_total: int, out: np.ndarray):
    """Expand the 2-bit wire format into `out` (int16, n_total). Returns
    False when the native library is unavailable or the data mismatches."""
    lib = get_lib()
    if lib is None:
        return False

    def p(a, dt):
        arr = np.ascontiguousarray(a, dt)
        return arr, arr.ctypes.data_as(ctypes.c_void_p)
    bm, p_bm = p(bitmap, np.uint8)
    cd, p_cd = p(codes, np.uint8)
    ei, p_ei = p(esc_idx, np.int32)
    ev, p_ev = p(esc_val, np.int16)
    assert out.dtype == np.int16 and out.flags.c_contiguous
    n = lib.hevcenc_unpack_sparse2(
        p_bm, p_cd, int(count), p_ei, p_ev, len(ei), n_total,
        out.ctypes.data_as(ctypes.c_void_p))
    return n >= 0


def unpack_sparse_cg_native(cg_bitmap, masks16, codes, count: int,
                            cg_count: int, esc_idx, esc_val, n_total: int,
                            out: np.ndarray, shapes):
    """Expand the two-tier CG wire format into `out` (int16, n_total;
    raster planes laid out consecutively). shapes: [(h, w)] x 3 of the
    planes (the wire rides in spatial 4x4-block order). Returns False
    when the native library is unavailable or the data mismatches
    (caller falls back to ops/pack.unpack_sparse_cg)."""
    lib = get_lib()
    if lib is None:
        return False

    def p(a, dt):
        arr = np.ascontiguousarray(a, dt)
        return arr, arr.ctypes.data_as(ctypes.c_void_p)
    bm, p_bm = p(cg_bitmap, np.uint8)
    mk, p_mk = p(masks16, np.int16)
    cd, p_cd = p(codes, np.uint8)
    ei, p_ei = p(esc_idx, np.int32)
    ev, p_ev = p(esc_val, np.int16)
    assert out.dtype == np.int16 and out.flags.c_contiguous
    (h0, w0), (h1, w1), (h2, w2) = shapes
    n = lib.hevcenc_unpack_sparse_cg(
        p_bm, p_mk, p_cd, int(count), int(cg_count), p_ei, p_ev, len(ei),
        n_total, out.ctypes.data_as(ctypes.c_void_p),
        w0, h0, w1, h1, w2, h2)
    return n >= 0


def prof_read():
    """Fetch-and-reset the serializer's HEVCENC_PROF counters (set the env
    var before the first native call; zeros otherwise). None if the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = (ctypes.c_uint64 * 10)()
    lib.hevcenc_prof_read(ctypes.cast(buf, ctypes.c_void_p))
    return {"slice_cycles": int(buf[0]), "setup_cycles": int(buf[1]),
            "residual_cycles": int(buf[2]), "ctx_bins": int(buf[3]),
            "bypass_bins": int(buf[4]), "payload_bytes": int(buf[5]),
            "slices": int(buf[6]), "luma_res_bins": int(buf[7]),
            "chroma_res_bins": int(buf[8])}


def wpp_threads() -> int:
    """WPP row-substream serializer pool size: HEVCENC_THREADS env
    override, else the host's core count (rows fork their CABAC context
    from the row above after CTB 1, so rows parallelize with one atomic
    wait each — the analog of the reference's per-row WPP entropy
    threads, hmr_encoder_lib.c:1071-1090)."""
    v = os.environ.get("HEVCENC_THREADS", "")
    if v.isdigit() and int(v) > 0:
        return int(v)
    return os.cpu_count() or 1


def encode_slice_native(ps, desc, ctx_init: np.ndarray, sign_hiding: bool,
                        slice_type: int = 2, sao_params=None,
                        wpp: bool = False, ref_dists=(1, 1),
                        slice_qp: int = 0):
    """Run the C++ serializer. Returns payload bytes, or (payload,
    row_sizes) when wpp. None if the library is unavailable.
    ref_dists: POC(cur) - POC(first ref) per list (AMVP scaling).
    slice_qp seeds the cu_qp_delta predictor chain when the PPS flag
    is on (desc.qp_map carries the per-8x8 targets; None = flat)."""
    lib = get_lib()
    if lib is None:
        return None
    if (desc.inter_part is not None and desc.inter_part.any()
            and slice_type == 0):
        # rect PUs in B slices: python serializer path (this encoder
        # emits rect in P slices only; native implements the P syntax)
        return None
    cap = desc.width * desc.height * 4 + 65536
    out = np.empty(cap, np.uint8)   # only payload[:n] is ever read
    ctus_y = -(-desc.height // ps.ctu_size)
    row_sizes = np.zeros(ctus_y, np.int64)

    def b(a, dt=np.uint8):
        return np.ascontiguousarray(a, dt).tobytes()

    def ptr(a, dt):
        arr = np.ascontiguousarray(a, dt)
        return arr, arr.ctypes.data_as(ctypes.c_void_p)

    wire = getattr(desc, "cg_wire", None)
    if wire is not None:
        # wire-direct: residual syntax reads the device CG wire; the
        # dense planes never materialize on this path
        w_bm, p_wbm = ptr(wire[0], np.uint8)
        w_mk, p_wmk = ptr(wire[1], np.int16)
        w_cd, p_wcd = ptr(wire[2], np.uint8)
        w_ei, p_wei = ptr(wire[3], np.int32)
        w_ev, p_wev = ptr(wire[4], np.int16)
        w_cnt, w_ec, w_cc = int(wire[5]), int(wire[6]), int(wire[7])
        py_ = pu_ = pv_ = None
    else:
        p_wbm = p_wmk = p_wcd = p_wei = p_wev = None
        w_cnt = w_ec = w_cc = 0
        coef_y, py_ = ptr(desc.coef_y, np.int16)
        coef_u, pu_ = ptr(desc.coef_u, np.int16)
        coef_v, pv_ = ptr(desc.coef_v, np.int16)
    mv_arr, pmv = ptr(desc.mv, np.int32)
    if desc.mv_l1 is not None:
        mv1_arr, pmv1 = ptr(desc.mv_l1, np.int32)
        mvp1 = b(desc.mvp_flag_l1)
    else:
        pmv1, mvp1 = None, None
    idir = b(desc.inter_dir) if desc.inter_dir is not None else None
    ipart = b(desc.inter_part) if desc.inter_part is not None else None
    if sao_params is not None:
        sp = sao_params
        sml = b(sp.merge_left.astype(np.uint8))
        smu = b(sp.merge_up.astype(np.uint8))
        stl, p_stl = ptr(sp.type_luma, np.int32)
        stc, p_stc = ptr(sp.type_chroma, np.int32)
        sel, p_sel = ptr(sp.eo_class_luma, np.int32)
        sec, p_sec = ptr(sp.eo_class_chroma, np.int32)
        sbd, p_sbd = ptr(sp.band_pos, np.int32)
        sof, p_sof = ptr(sp.offsets, np.int32)
    else:
        sml = smu = None
        p_stl = p_stc = p_sel = p_sec = p_sbd = p_sof = None

    if getattr(ps, "cu_qp_delta_enabled", False) and desc.qp_map is not None:
        qpm_arr, p_qpm = ptr(desc.qp_map, np.int8)
    else:
        p_qpm = None
    n = lib.hevcenc_encode_slice2(
        ctx_init.tobytes(),
        desc.width, desc.height, ps.log2_ctu, ps.log2_min_cb,
        ps.log2_min_tb, ps.log2_max_tb,
        ps.max_tr_depth_intra, ps.max_tr_depth_inter,
        int(sign_hiding), slice_type, int(wpp),
        int(ref_dists[0]), int(ref_dists[1]),
        int(getattr(ps, "cu_qp_delta_enabled", False)), int(slice_qp),
        b(desc.cu_depth), b(desc.part_nxn.astype(np.uint8)),
        b(desc.luma_mode), b(desc.chroma_mode), b(desc.tr_depth),
        b(desc.pred_mode), p_qpm,
        py_, pu_, pv_,
        b(desc.skip), b(desc.inter_mode), b(desc.merge_idx),
        b(desc.mvp_flag), b(desc.root_cbf), pmv,
        pmv1, mvp1, idir, ipart,
        sml, smu, p_stl, p_stc, p_sel, p_sec, p_sbd, p_sof,
        out.ctypes.data_as(ctypes.c_void_p), cap,
        row_sizes.ctypes.data_as(ctypes.c_void_p),
        wpp_threads() if wpp else 1,
        p_wbm, p_wmk, p_wcd, p_wei, p_wev, w_cnt, w_ec, w_cc)
    if n < 0:
        return None
    payload = out[:n].tobytes()
    if wpp:
        return payload, row_sizes.tolist()
    return payload
