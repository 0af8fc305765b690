"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m hevcbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The system under test is the PyTorch and CUDA port,
`homerhevc_tpu_torch.api.Encoder(cfg, device="cuda")`, driven by one
closed-loop client (drive.py) over the clip of the seed (clip.py). Set-up
(process start to the first timed frame: imports, the card, the encoder,
the kernels' builds, `warmup_periods` periods of frames) is `setup_s`.
The process runs on HOST_CORES cores of the host (`steady_process`).
The window then submits frames for `--seconds` and on to the next period
boundary; the end-to-end metrics are those of the frames it emits.

--trace 1 wraps the program's layer entry points in spans (spans.py) for
the window, then profiles a sub-window of whole frames on the device
(devtrace.py) and counts aten operations by layer over another
(opcount.py); it prints the per-layer metrics, each read by
metrics/<name>.py, and a breakdown. --trace 0 installs none of that and
prints the end-to-end metrics.

After the window, the peak device memory is read, the encoder drained and
freed, and the sample of the window's frames is judged by the plain
reference (check.py). The numbers compared are printed beside their
limits as the last lines of standard error and, under `limits`, last in
the result line, the last line of standard output.

Exits 2 without a result where the card or cards the cell asks for are
missing, 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time

# set-up counts from the start of the process, across the re-execution below
T_START = float(os.environ.get("HEVCBENCH_T_START", time.perf_counter()))

HOST_CORES = 4
ADDR_NO_RANDOMIZE = 0x0040000


def steady_process() -> None:
    """Run on the first HOST_CORES cores the process may use, with the CPU
    thread pools sized to them, string hashing fixed (PYTHONHASHSEED) and,
    where the kernel allows it, no address-space randomisation: the last
    two take effect only at interpreter start, so the run re-executes
    itself once, before numpy or torch is imported. The program's host
    loop sets the pace, so every run gets the same host set-up; the host's
    own speed still drifts within and between runs (PERF.md)."""
    if os.environ.get("HEVCBENCH_T_START") is not None:
        return
    cores = sorted(os.sched_getaffinity(0))[:HOST_CORES]
    os.sched_setaffinity(0, cores)
    env = dict(os.environ, PYTHONHASHSEED="0",
               HEVCBENCH_T_START=repr(T_START))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        env[var] = str(len(cores))
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        libc.personality(libc.personality(0xFFFFFFFF) | ADDR_NO_RANDOMIZE)
    except (OSError, AttributeError):
        pass
    os.execve(sys.executable, [sys.executable, "-m", "hevcbench.run",
                               *sys.argv[1:]], env)


if __name__ == "__main__":
    steady_process()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402

from hevcbench import cells, check, drive, env, quality  # noqa: E402
from hevcbench.clip import Clip  # noqa: E402

PROFILE_MIN_FRAMES = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class TraceData:
    """What the per-layer metric readers (metrics/<name>.py) read."""
    spans: list             # spans.Span of the window
    window: list            # drive.Emitted of the window
    ops: dict               # layer -> aten ops over the op-count frames
    ops_frames: dict        # frame type -> frames emitted over them
    trace: object           # devtrace.DeviceTrace of the sub-window or None
    records: dict           # what the metrics' span hooks kept, by key
    layers: dict            # the layers installed (spans.Spans.layers)
    sms: int | None
    clock_hz: float | None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        log(f"this cell needs {n} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count() = {torch.cuda.device_count()}")
        sys.exit(2)


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = cells.HERE, fault=None,
             t_start: float = T_START) -> dict:
    """One run of `cell`; returns the result object (the last line). The
    card check is the caller's; tests pass device="cpu" and a fault."""
    import contextlib

    import torch

    from hevcbench import faults
    from hevcbench import spans as spans_mod
    from hevcbench.reference import config as ref_config
    from homerhevc_tpu_torch import config as port_config
    from homerhevc_tpu_torch.api import Encoder

    on_card = device != "cpu"
    cfg = cells.encoder_config(cell, port_config)
    ref_cfg = cells.encoder_config(cell, ref_config)
    clip = Clip(cfg.width, cfg.height, seed)
    period = cell.period
    sp = spans_mod.Spans() if trace else None
    with contextlib.ExitStack() as stack:
        if sp is not None:
            stack.callback(sp.uninstall)
            sp.install([cells.metric_module(m["name"], root)
                        for m in cell.per_layer])
        if fault:
            stack.enter_context(faults.planted(fault, cell.batch))
        enc = Encoder(cfg, device=device)
        build_native()
        client = drive.Client(enc, clip, sp)
        client.run(int(cell.traffic.get("warmup_periods", 1)) * period,
                   "setup")
        if sp is not None:
            sp.recording = True
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0, t1 = client.window(seconds, period)
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        if sp is not None:
            sp.recording = False
        setup_s = t0 - t_start
        window = client.in_phase("window")
        tdata = None
        if trace:
            tdata = _traced_phases(client, cell, sp, on_card)
            tdata.window = window
        peak = (torch.cuda.max_memory_allocated() if on_card else 0)
        client.flush()
    log(f"[run] set-up {setup_s:.3f} s; window {t1 - t0:.3f} s, "
        f"{len(window)} frames "
        f"({sum(f.ftype == 'I' for f in window)} I); sub-phases done")
    log(_window_host_line(window, period, t1 - t0, ru0, ru1))
    # keep the window's frames and what the check reads, as host planes;
    # the encoder and everything it holds on the device go
    frames = client.frames
    win_pocs = {f.poc for f in window}
    check_frames = int(cell.traffic.get("check_frames", 2))
    picked = check.sample_pocs(window, frames, seed, check_frames,
                               cfg.gop_size != 0, cell.batch)
    keep = win_pocs | check.needed_pocs(picked, frames, window)
    for p in list(frames):
        if p in keep:
            frames[p].ef.recon   # materialised once, on the host
        else:
            del frames[p]
    del enc, client
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    mse_y = {f.poc: quality.mse(frames[f.poc].ef.recon["y"],
                                clip.frame(f.poc)[0]) for f in window}
    psnr = sum(quality.capped_psnr_of_mse(m) for m in mse_y.values()) \
        / len(window)
    verdict = check.judge(window, frames, mse_y, ref_cfg, seed,
                          check_frames, cell.batch, log)
    found = env.forbidden_modules()
    if found:
        raise IsolationError(found)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name() if on_card else "cpu"),
           "count": cell.chips if on_card else 1,
           "memory_peak_bytes": int(peak)}
    result = {"correct": verdict.correct, "attempted": len(window),
              "failed": verdict.failed}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cells.metric_module(m["name"], root).read(tdata)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        if tdata.trace is not None:
            dev["busy_s"] = tdata.trace.busy_s
            dev["window_s"] = tdata.trace.wall_s
        result["device"] = dev
        if tdata.trace is not None:
            from hevcbench import devtrace
            result["breakdown"] = {
                "device_ops": devtrace.top_kernels(tdata.trace),
                "idle_gaps": devtrace.idle_gaps(tdata.trace)}
    else:
        e2e = drive.end_to_end(window, t0, t1, cfg.frame_rate)
        e2e.update(setup_s=setup_s, psnr_y_db=psnr)
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = dev
    result["limits"] = {k: {"value": verdict.numbers[k],
                            "limit": check.LIMITS[k]}
                        for k in check.LIMITS}
    return result


def build_native() -> None:
    """Build (in a fresh checkout) and load the program's native CABAC
    library in set-up, before the first frame: without it the program
    falls back to its Python serializer, which is not what is measured."""
    from homerhevc_tpu_torch import native
    if native.get_lib() is None:
        raise RuntimeError("the native CABAC library did not build or load")


def _window_host_line(window, period, wall, ru0, ru1) -> str:
    """The window's host side: CPU seconds of the process (all threads)
    against the wall, context switches, and the seconds between the
    emissions that close each period."""
    cpu = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
    ends = [f.t_emit for i, f in enumerate(window) if (i + 1) % period == 0]
    gaps = sorted(b - a for a, b in zip(ends, ends[1:]))
    q = (f"{gaps[0]:.3f} / {gaps[len(gaps) // 2]:.3f} / {gaps[-1]:.3f}"
         if gaps else "-")
    return (f"[run] window host: {cpu:.3f} CPU s in {wall:.3f} s, context "
            f"switches {ru1.ru_nvcsw - ru0.ru_nvcsw} voluntary, "
            f"{ru1.ru_nivcsw - ru0.ru_nivcsw} involuntary; s between "
            f"period ends min / median / max {q}")


def _traced_phases(client, cell, sp, on_card) -> TraceData:
    """After the window: count aten operations by layer over whole frames
    (an IDR segment's I frame first where the window ended before one),
    then profile the device over whole frames of the cell's batch, or
    PROFILE_MIN_FRAMES frames where frames are not batched."""
    from hevcbench import devtrace
    from hevcbench.opcount import OpCounter
    n = max(cell.batch, PROFILE_MIN_FRAMES)
    counter = OpCounter()
    sp.on_layer = lambda layer: setattr(counter, "stage", layer or "other")
    with counter:
        client.run(n, "ops")
    sp.on_layer = None
    ops_frames: dict[str, int] = {}
    for f in client.in_phase("ops"):
        ops_frames[f.ftype] = ops_frames.get(f.ftype, 0) + 1
    if cell.idr_period > 1 and client.next % cell.idr_period == 0:
        client.run(1, "post")      # the profiled frames hold no I frame
    trace, sms, clock = None, None, None
    if on_card:
        import torch
        sp.profiling = True
        trace = devtrace.profile(lambda: client.run(n, "profiled"))
        sp.profiling = False
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock = env.max_sm_clock_hz()
    return TraceData(sp.spans, [], dict(counter.ops), ops_frames,
                     trace, sp.records, sp.layers, sms, clock)


class IsolationError(RuntimeError):
    pass


def main(argv=None) -> int:
    args = parse_args(argv)
    manifest = os.path.join(os.getcwd(), "BENCHMARK.json")
    cell = cells.load_cell(args.workload, manifest)
    require_cards(cell.chips)
    import torch
    for line in env.lines(torch):
        log(line)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except IsolationError as e:
        log(f"modules of JAX or the JAX package were loaded: {e.args[0]}")
        return 3
    for k, v in result["limits"].items():
        log(f"{k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
