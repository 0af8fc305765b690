"""Coarse motion-search SAD sweep: the hand-written CUDA kernel
(csrc/me_sad.cu), its plain PyTorch version and the wrapper that picks
between them by the tensors' device.

Port of homerhevc_tpu/ops/pallas/me_sad.py (coarse_sweep_sads and its
oracle coarse_sweep_sads_ref). The reference is always 8-bit (the edge
padding of a decimated recon, uint8). The source's dtype names the entry
point, and no source is ever cast:
  - uint8, the samples [0, 255] of a decimated source plane (the P
    program, and the B program's searches against the source);
  - int16, any int16 values, for the B program's bi target
    2 * src - pred, in [-255, 510]: the kernel's wide entry point sweeps
    the source clamped to [0, 255] and adds each block's excess
    sum |s - clamp(s, 0, 255)| as it stores (csrc/me_sad.cu).
Any other dtype raises TypeError. The JAX function takes the same values
as int16 in both cases. The wrapper never probes and never falls back: a
CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises.

The kernel is compiled with nvcc for sm_90a into _build/ at first use and
loaded with ctypes (a plain C entry point; no PyTorch headers).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

from homerhevc_tpu_torch.device import count_launch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "me_sad.cu")
_BUILD = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD, "libme_sad.so")
_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return path


NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3"]


def compile_library(path: str, extra_flags=(), src: str = _SRC
                    ) -> ctypes.CDLL:
    """nvcc `src` (csrc/me_sad.cu or a variant of it) into the shared
    library `path` and load it with its entry point typed."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run([_nvcc(), *NVCC_FLAGS, *extra_flags, "-shared",
                    "-Xcompiler", "-fPIC", "-o", tmp, src], check=True)
    os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.coarse_sweep_sads_launch.restype = ctypes.c_int
    lib.coarse_sweep_sads_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.coarse_sweep_sads_wide_launch.restype = ctypes.c_int
    lib.coarse_sweep_sads_wide_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return lib


def build() -> ctypes.CDLL:
    """Compile csrc/me_sad.cu into _build/libme_sad.so and load it, once
    per process. Returns the library."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = compile_library(_SO)
        return _lib


def launch(lib, sd: torch.Tensor, ref_pad: torch.Tensor, out: torch.Tensor,
           R: int, m: int, excess: torch.Tensor | None = None) -> None:
    """Launch `lib`'s sweep on the current stream of the tensors' card (the
    wide entry point when the per-block excess is given); raises if the
    launch is refused."""
    gh, gw = sd.shape[0] // m, sd.shape[1] // m
    with torch.cuda.device(sd.device):
        stream = torch.cuda.current_stream(sd.device).cuda_stream
        if excess is None:
            err = lib.coarse_sweep_sads_launch(
                sd.data_ptr(), ref_pad.data_ptr(), out.data_ptr(), gh, gw, m,
                R, stream)
        else:
            err = lib.coarse_sweep_sads_wide_launch(
                sd.data_ptr(), ref_pad.data_ptr(), excess.data_ptr(),
                out.data_ptr(), gh, gw, m, R, stream)
    if err != 0:
        raise RuntimeError(f"coarse_sweep_sads launch failed: CUDA error "
                           f"{err}")


def coarse_sweep_sads_plain(sd: torch.Tensor, ref_pad: torch.Tensor,
                            R: int, m: int) -> torch.Tensor:
    """Plain PyTorch twin (the unrolled shifted-plane sweep of
    coarse_sweep_sads_ref) for either source dtype, |s - r| summed in
    int32: (side^2, gh, gw) int32."""
    gh = sd.shape[0] // m
    gw = sd.shape[1] // m
    side = 2 * R + 1
    s = sd.to(torch.int32)
    outs = []
    for k in range(side * side):
        dy, dx = k // side - R, k % side - R
        sh = ref_pad[R + dy:R + dy + gh * m, R + dx:R + dx + gw * m]
        d = torch.abs(s - sh.to(torch.int32))
        outs.append(d.reshape(gh, m, gw, m).sum(dim=(1, 3),
                                                dtype=torch.int32))
    return torch.stack(outs)


def _check(sd: torch.Tensor, ref_pad: torch.Tensor, R: int, m: int):
    if m < 1 or R < 1:
        raise ValueError(f"need m >= 1 and R >= 1, got m={m} R={R}")
    if sd.dtype not in (torch.uint8, torch.int16):
        raise TypeError(f"sd must be uint8 or int16, got {sd.dtype}")
    if ref_pad.dtype != torch.uint8:
        raise TypeError(f"ref_pad must be uint8, got {ref_pad.dtype}")
    for name, t in (("sd", sd), ("ref_pad", ref_pad)):
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sd.device != ref_pad.device:
        raise ValueError("sd and ref_pad lie on different devices")
    h, w = sd.shape
    if h % m or w % m or h == 0 or w == 0:
        raise ValueError(f"sd shape {tuple(sd.shape)} is not a grid of "
                         f"{m}x{m} blocks")
    if tuple(ref_pad.shape) != (h + 2 * R, w + 2 * R):
        raise ValueError(f"ref_pad shape {tuple(ref_pad.shape)} != "
                         f"{(h + 2 * R, w + 2 * R)}")


def coarse_sweep_sads(sd: torch.Tensor, ref_pad: torch.Tensor, R: int,
                      m: int) -> torch.Tensor:
    """(side^2, gh, gw) int32 block SADs of the decimated source vs every
    (dy, dx) in [-R, R]^2 of the edge-padded decimated reference.

    sd:      (gh*m, gw*m) decimated source, contiguous: uint8 (8-bit
             entry point) or int16 (wide entry point, any int16 values)
    ref_pad: (gh*m + 2R, gw*m + 2R) uint8 reference, edge-padded by R

    The CUDA kernel takes m a multiple of 8 (m = cu/2 of the CU16 and CU32
    grids) and R <= 255; the plain CPU version takes any m >= 1, R >= 1.
    """
    _check(sd, ref_pad, R, m)
    if sd.device.type == "cpu":
        return coarse_sweep_sads_plain(sd, ref_pad, R, m)
    if sd.device.type != "cuda":
        raise ValueError(f"unsupported device {sd.device}")
    if m % 8 or R > 255:
        raise ValueError(f"the CUDA sweep takes m a multiple of 8 and "
                         f"R <= 255, got m={m} R={R}")
    lib = build()
    out = sads_like(sd, R, m)
    if sd.dtype == torch.uint8:
        launch(lib, sd, ref_pad, out, R, m)
        count_launch("coarse_sweep_sads")
        return out
    clamped, excess = wide_parts(sd, m)
    launch(lib, clamped, ref_pad, out, R, m, excess)
    count_launch("coarse_sweep_sads_wide")
    return out


def sads_like(sd: torch.Tensor, R: int, m: int) -> torch.Tensor:
    """An empty (side^2, gh, gw) int32 tensor on sd's device: the shape of
    the sweep of sd at radius R over m x m blocks."""
    side = 2 * R + 1
    return torch.empty((side * side, sd.shape[0] // m, sd.shape[1] // m),
                       dtype=torch.int32, device=sd.device)


def wide_parts(sd: torch.Tensor, m: int):
    """The wide entry point's inputs from an int16 source: the source
    clamped to [0, 255] (so its uint8 copy is exact) and each m x m
    block's excess, the int32 sum of |s - clamp(s, 0, 255)|."""
    clamped = sd.clamp(0, 255)
    excess = (sd.to(torch.int32) - clamped).abs() \
        .reshape(sd.shape[0] // m, m, sd.shape[1] // m, m) \
        .sum(dim=(1, 3), dtype=torch.int32)
    return clamped.to(torch.uint8), excess
