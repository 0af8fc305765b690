"""Compare two inner-loop forms of csrc/me_sad.cu on the card.

    python3 -m homerhevc_tpu_torch.tools.me_sad_forms

The sweep adds |a - b| over packed uint8 pairs. The kernel does it with the
packed-byte absolute difference that accumulates (PTX vabsdiff4 .add: 4
pairs per instruction). The scalar form, which unpacks the bytes and calls
__usad once per pair, is not in the kernel's source: this script writes it
into _build/forms/ as a copy of csrc/me_sad.cu whose sad4 body is replaced.
It builds both (printing ptxas' registers / shared memory / spills), counts
each kernel's SASS instructions by opcode (cuobjdump), holds both bit-exact
against the plain PyTorch version, and times them in turns (packed, scalar,
scalar, packed) at the 720p shapes (m = 8, R = 16 and 24) with CUDA
events. Then it measures the card's issue rate of the packed instruction
alone (vabsdiff4_rate.cu: independent accumulator chains) in lanes per
clock per SM. One JSON line per measurement, then the card's name, power
limit and maximum SM clock.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import shutil
import subprocess

import numpy as np
import torch

from homerhevc_tpu_torch.ops import me_sad

# sad4's body in csrc/me_sad.cu, and the scalar form that replaces it
PACKED_SAD4 = """\
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
"""
SCALAR_SAD4 = """\
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = __usad((a >> (8 * i)) & 0xffu, (b >> (8 * i)) & 0xffu, acc);
  }
  return acc;
"""
# "/*0a30*/  @!P0 VABSDIFF4.U8.ACC R25, ..." -> the opcode
_SASS_LINE = re.compile(
    r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_histogram(so_path: str,
                   kernel: str = "coarse_sweep_kernel") -> collections.Counter:
    """Opcode counts of `kernel`'s SASS in `so_path`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    ops = collections.Counter()
    inside = False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        m = _SASS_LINE.match(line)
        if inside and m:
            ops[m.group(1).split(".")[0]] += 1
    return ops


def scalar_source(build: str) -> str:
    """Write the scalar form of csrc/me_sad.cu into `build`; its path."""
    with open(me_sad._SRC) as f:
        text = f.read()
    if text.count(PACKED_SAD4) != 1:
        raise RuntimeError("sad4's packed body not found in csrc/me_sad.cu")
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, "me_sad_scalar.cu")
    with open(path, "w") as f:
        f.write(text.replace(PACKED_SAD4, SCALAR_SAD4))
    return path


def ms_per_call(lib, sd, rp, out, R, m, reps=100):
    me_sad.launch(lib, sd, rp, out, R, m)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        me_sad.launch(lib, sd, rp, out, R, m)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def vabsdiff4_rate(build: str) -> dict:
    """Lanes per clock per SM of VABSDIFF4.U8.ACC alone, at the maximum
    SM clock nvidia-smi reports."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "vabsdiff4_rate.cu")
    path = os.path.join(build, "libvabsdiff4_rate.so")
    subprocess.run([me_sad._nvcc(), *me_sad.NVCC_FLAGS, "-shared",
                    "-Xcompiler", "-fPIC", "-o", path, src], check=True)
    lib = ctypes.CDLL(path)
    lib.vabsdiff4_rate_launch.restype = ctypes.c_int
    lib.vabsdiff4_rate_launch.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 16 * sms, 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if lib.vabsdiff4_rate_launch(out.data_ptr(), blocks, threads, iters,
                                     stream):
            raise RuntimeError("vabsdiff4_rate launch failed")
    run()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(10):
        run()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / 10
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    lanes = blocks * threads * 8 * iters
    return {"instruction": "VABSDIFF4.U8.ACC", "ms": ms,
            "sass_by_opcode": dict(sass_histogram(path, "vabsdiff4_chains")
                                   .most_common(6)),
            "lanes_per_clock_per_sm":
                lanes / (ms * 1e-3) / (sms * clock_mhz * 1e6)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("me_sad_forms: no CUDA device available")
    build = os.path.join(os.path.dirname(me_sad._SO), "forms")
    libs = {}
    for name, src in (("packed", me_sad._SRC),
                      ("scalar", scalar_source(build))):
        path = os.path.join(build, f"libme_sad_{name}.so")
        print(f"[ptxas] {name}:", flush=True)
        libs[name] = me_sad.compile_library(path, ["-Xptxas", "-v"], src)
        hist = sass_histogram(path)
        print(json.dumps({"form": name, "sass_total": sum(hist.values()),
                          "sass_by_opcode": dict(hist.most_common())}),
              flush=True)
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    m, gh, gw = 8, 45, 80
    for R in (16, 24):
        side = 2 * R + 1
        sd = torch.from_numpy(rng.randint(0, 256, (gh * m, gw * m))
                              .astype(np.uint8)).to(dev)
        rp = torch.from_numpy(rng.randint(0, 256, (gh * m + 2 * R,
                                                   gw * m + 2 * R))
                              .astype(np.uint8)).to(dev)
        want = me_sad.coarse_sweep_sads_plain(sd, rp, R, m)
        times = collections.defaultdict(list)
        for name in ("packed", "scalar", "scalar", "packed"):
            out = torch.empty((side * side, gh, gw), dtype=torch.int32,
                              device=dev)
            times[name].append(ms_per_call(libs[name], sd, rp, out, R, m))
            if not torch.equal(out, want):
                raise AssertionError(f"{name} != plain at R={R}")
        for name, t in times.items():
            print(json.dumps({"form": name, "R": R, "m": m, "gh": gh,
                              "gw": gw, "ms": t, "bit_exact": True}),
                  flush=True)
    print(json.dumps(vabsdiff4_rate(build)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
