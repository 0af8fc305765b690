"""Coarse motion-search SAD sweep: the hand-written CUDA kernel
(csrc/me_sad.cu), its plain PyTorch version and the wrapper that picks
between them by the tensors' device.

Port of homerhevc_tpu/ops/pallas/me_sad.py (coarse_sweep_sads and its
oracle coarse_sweep_sads_ref). The samples are 8-bit: both call sites
sweep uint8 planes (a decimated mean and its edge padding), so the port
takes uint8 tensors where the JAX function takes int16 ones. The wrapper
never probes and never falls back: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.

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

from homerhevc_tpu_torch.device import LAUNCHES

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
    return lib


def build() -> str:
    """Compile csrc/me_sad.cu into _build/libme_sad.so and load it, once
    per process. Returns the library path."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = compile_library(_SO)
        return _SO


def launch(lib, sd: torch.Tensor, ref_pad: torch.Tensor, out: torch.Tensor,
           R: int, m: int) -> None:
    """Launch `lib`'s sweep on the current stream of the tensors' card;
    raises if the launch is refused."""
    gh, gw = sd.shape[0] // m, sd.shape[1] // m
    with torch.cuda.device(sd.device):
        stream = torch.cuda.current_stream(sd.device).cuda_stream
        err = lib.coarse_sweep_sads_launch(
            sd.data_ptr(), ref_pad.data_ptr(), out.data_ptr(), gh, gw, m, R,
            stream)
    if err != 0:
        raise RuntimeError(f"coarse_sweep_sads launch failed: CUDA error "
                           f"{err}")


def coarse_sweep_sads_plain(sd: torch.Tensor, ref_pad: torch.Tensor,
                            R: int, m: int) -> torch.Tensor:
    """Plain PyTorch twin (the unrolled shifted-plane sweep of
    coarse_sweep_sads_ref): (side^2, gh, gw) int32."""
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
    for name, t in (("sd", sd), ("ref_pad", ref_pad)):
        if t.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8, got {t.dtype}")
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

    sd:      (gh*m, gw*m) uint8 decimated source, contiguous
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
    build()
    side = 2 * R + 1
    out = torch.empty((side * side, sd.shape[0] // m, sd.shape[1] // m),
                      dtype=torch.int32, device=sd.device)
    launch(_lib, sd, ref_pad, out, R, m)
    LAUNCHES["coarse_sweep_sads"] += 1
    return out
