"""What decides `correct`: the frames the timed window produced, judged
after the window by the plain reference decoder (reference/decode.py).

Every frame of the window carries or follows parameter sets (VPS, SPS,
PPS), which are parsed and held to those the configuration states, and a
slice header, which is read. For each frame of a sample drawn from the seed
(the window's frame with the most bits, and `check_frames` more, each from
another group of the batch's slots, so that the sample spans the batch;
and, in an IPPP configuration, an I frame: one of the window's, or else
the IDR that set-up coded, the start of the chain), the reference decodes
the access unit the encoder emitted under the parameter sets the stream
carries and compares the picture with the reconstruction the encoder
reported. A P slice is decoded from the encoder's reported reconstruction
of the frame before it: the reference follows the program's chain step by
step from the program's own state, and the I frame of the sample checks
the chain's start from nothing.

Numbers compared, each with its limit:
- `mismatch`: samples (Y, U and V) where the decoded picture and the
  reported reconstruction differ. Exact: 0.
- `bad_streams`: access units whose parameter sets or slice header do
  not parse or state another configuration, and sampled ones that do not
  decode or use syntax the reference does not decode. 0.
- `missing`: frames of the window not emitted once each, in order. 0.
- `mse_q2`: the largest luma MSE against its source, over the square of
  the quantiser step (2 ** ((QP - 4) / 6)), of the reconstruction the
  encoder reported for each frame of the window (the sampled ones equal
  their decoded pictures where `mismatch` is 0): a stream that decodes to
  its reconstruction but codes the wrong picture (a frame left out, a
  state left unchanged) reads far above a sound one. Its limit is set
  from readings on the card (PERF.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MSE_Q2_LIMIT = 0.5

LIMITS = {"mismatch": 0, "bad_streams": 0, "missing": 0,
          "mse_q2": MSE_Q2_LIMIT}


@dataclasses.dataclass
class Verdict:
    numbers: dict
    sampled: list
    failed: int       # frames missing, not decoded, or decoded otherwise

    @property
    def correct(self) -> bool:
        return all(self.numbers[k] <= LIMITS[k] for k in LIMITS)


def sample_pocs(window, frames, seed: int, check_frames: int,
                inter: bool, batch: int = 1) -> list[int]:
    """The POCs to decode: the window's frame with the most bits, then
    `check_frames` more drawn from the seed, one from each other group of
    the batch's slots (POC modulo `batch`, cut into check_frames + 1
    groups), then (inter) an I frame."""
    pocs = [f.poc for f in window]
    biggest = max(window, key=lambda f: f.bits).poc
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7])
    groups = check_frames + 1

    def group(p):
        return (p % batch) * groups // batch
    picked = [biggest]
    if batch >= groups:
        for g in range(groups):
            rest = [p for p in pocs if group(p) == g != group(biggest)]
            if rest:
                picked.append(int(rng.choice(rest)))
    rest = [p for p in pocs if p not in picked]
    k = min(check_frames + 1 - len(picked), len(rest))
    if k > 0:
        picked += [int(p) for p in rng.choice(rest, k, replace=False)]
    if inter and not any(frames[p].ftype == "I" for p in picked):
        idrs = [p for p in pocs if frames[p].ftype == "I"]
        if idrs:
            picked.append(int(rng.choice(idrs)))
        else:
            before = [p for p, f in frames.items()
                      if f.ftype == "I" and p < pocs[0]]
            if before:
                picked.append(max(before))
    return sorted(picked)


def carries_parameter_sets(nals) -> bool:
    return any((n[0] >> 1) & 0x3F == 33 for n in nals)


def needed_pocs(picked, frames, window) -> set[int]:
    """The frames the check reads beside the window's: the sampled ones,
    the picture each predicts from, and the last access unit at or before
    each, and before the window, that carries parameter sets."""
    need = set(picked) | {p - 1 for p in picked}
    for p in list(picked) + [window[0].poc]:
        q = max((q for q, f in frames.items()
                 if q <= p and carries_parameter_sets(f.ef.nals)),
                default=None)
        if q is not None:
            need.add(q)
    return need


def missing_frames(window) -> int:
    """Frames of the window not emitted once each in POC order."""
    pocs = [f.poc for f in window]
    if not pocs:
        return 1
    expect = list(range(pocs[0], pocs[0] + len(pocs)))
    return sum(1 for a, b in zip(pocs, expect) if a != b) + \
        (len(pocs) - len(set(pocs)))


def _coded(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    ph, pw = h - plane.shape[0], w - plane.shape[1]
    if ph or pw:
        plane = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    return plane


def judge(window, frames, mse_y: dict, ref_cfg, seed: int,
          check_frames: int, batch: int = 1, log=print) -> Verdict:
    """Read every window frame's parameter sets and slice header, decode
    the sample with the reference and compare (see the module's
    docstring). mse_y: POC -> luma MSE of the reported reconstruction
    against the source, for every window frame; ref_cfg: the cell's
    configuration as the reference's frozen EncoderConfig."""
    from hevcbench.reference.decode import (
        decode_picture, slice_header, stated_param_sets)
    from hevcbench.reference.headers import (
        differences, parse_parameter_sets)
    stated = stated_param_sets(ref_cfg)
    w, h = ref_cfg.width, ref_cfg.height
    cw, ch = stated.pic_width, stated.pic_height
    inter = ref_cfg.gop_size != 0
    qstep2 = 2.0 ** ((ref_cfg.qp - 4) / 3.0)
    nums = {"mismatch": 0, "bad_streams": 0,
            "missing": missing_frames(window),
            "mse_q2": max(mse_y.values()) / qstep2}
    unread, wrong = set(), set()     # POCs not read / decoded otherwise
    active: dict[int, object] = {}     # POC -> the parameter sets it is under
    ps = None
    for poc in sorted(frames):
        f = frames[poc]
        try:
            if carries_parameter_sets(f.ef.nals):
                ps = parse_parameter_sets(f.ef.nals)
                differ = differences(ps, stated)
                if differ:
                    ps = None
                    raise ValueError(f"parameter sets differ: {differ}")
            if ps is None:
                raise ValueError("no parameter sets before it")
            active[poc] = ps
            if f.phase == "window":
                slice_header(ps, f.ef.nals)
        except Exception as e:   # any failure to read counts against it
            if f.phase == "window" and poc not in unread:
                unread.add(poc)
                log(f"[check] POC {poc} {f.ftype}: not read: "
                    f"{type(e).__name__}: {e}")
    picked = sample_pocs(window, frames, seed, check_frames, inter, batch)
    for poc in picked:
        f = frames[poc]
        ref = None
        try:
            if poc not in active:
                raise ValueError("its parameter sets were not read")
            if f.ftype != "I":
                prev = frames.get(poc - 1)
                if prev is None:
                    raise ValueError("no reference picture emitted")
                r = prev.ef.recon
                ref = tuple(_coded(r[c], ch >> (c != "y"), cw >> (c != "y"))
                            for c in "yuv")
            st, pic = decode_picture(active[poc], f.ef.nals, ref, (w, h))
        except Exception as e:   # any failure to decode counts against it
            unread.add(poc)
            log(f"[check] POC {poc} {f.ftype}: not decoded: "
                f"{type(e).__name__}: {e}")
            continue
        rec = f.ef.recon
        mm = sum(int(np.count_nonzero(a != rec[c])) for a, c in
                 zip(pic, "yuv"))
        nums["mismatch"] += mm
        if mm:
            wrong.add(poc)
        log(f"[check] POC {poc} {f.ftype}: {mm} samples differ from the "
            f"reported reconstruction")
    nums["bad_streams"] = len(unread)
    worst = max(mse_y, key=mse_y.get)
    log(f"[check] largest luma MSE against the source: POC {worst}, "
        f"{mse_y[worst]:.4f}")
    return Verdict(nums, picked, nums["missing"] + len(unread | wrong))
