"""The run's surroundings, printed before the result, and the isolation
check made once the window has closed."""

from __future__ import annotations

import os
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "homerhevc_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that are JAX's or the JAX package's,
    compared whole (homerhevc_tpu_torch is the system under test)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def smi(fields: str) -> str:
    """nvidia-smi's line of the given --query-gpu fields for each card, or
    "not read" where the tool does not answer."""
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return r.stdout.strip().replace("\n", " | ") or "not read"


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "not read"


def lines(torch) -> list[str]:
    n = torch.cuda.device_count()
    names = sorted({torch.cuda.get_device_name(i) for i in range(n)})
    return [
        f"[env] cards: {n} x {', '.join(names)}",
        f"[env] power limit, SM clock now / max: "
        f"{smi('power.limit,clocks.sm,clocks.max.sm')}",
        f"[env] host CPU: {cpu_model()}, {os.cpu_count()} cores, this "
        f"process on {sorted(os.sched_getaffinity(0))}, load average "
        f"{' '.join(f'{x:.2f}' for x in os.getloadavg())}, "
        f"PYTHONHASHSEED {os.environ.get('PYTHONHASHSEED', 'not set')}, "
        f"personality {_personality()}",
    ]


def _personality() -> str:
    """The process's personality flags (0x0040000: no address-space
    randomisation), or "not read"."""
    try:
        with open("/proc/self/personality") as f:
            return "0x" + f.read().strip()
    except OSError:
        return "not read"


def max_sm_clock_hz() -> float | None:
    out = smi("clocks.max.sm").split("|")[0].split()
    try:
        return float(out[0]) * 1e6
    except (IndexError, ValueError):
        return None
