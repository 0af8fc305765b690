"""Device resolution, numeric pins and kernel launch counters.

The port's entry points run on the card unless the caller asks for the
CPU: there is no "cuda if present, else cpu" fallback, and asking for
"cuda" without a card raises. Importing this module pins TF32 off for
both cuBLAS matmuls and cuDNN: the intra predictor's float32 contraction
(ops/intra.py predict_all_modes) is exact only in full fp32.
"""

from __future__ import annotations

import threading

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# launches of each hand-written kernel; a wrapper adds one where it
# launches its kernel and nowhere else (the plain CPU version never counts)
# (the sweep's 8-bit and wide-source entry points count apart); the slot
# threads of a mesh (parallel/mesh.py) launch at once, so every change
# goes through count_launch / reset_launches under one lock
LAUNCHES: dict[str, int] = {"coarse_sweep_sads": 0,
                            "coarse_sweep_sads_wide": 0}
_LAUNCHES_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """Add one to LAUNCHES[name] (a read-modify-write: under the lock)."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def resolve_device(device) -> torch.device:
    """Explicit torch.device from a device or its name ("cpu", "cuda",
    "cuda:1"). A bare "cuda" resolves to the current CUDA device."""
    if device is None:
        raise ValueError("name the device explicitly (e.g. 'cuda' or 'cpu')")
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but CUDA is unavailable")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}")
    return d
