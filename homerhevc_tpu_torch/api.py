"""Public encoder API of the port (written from homerhevc_tpu/api.py):

    enc = Encoder(cfg)                       # on the card; device="cpu" asks
    for ef in enc.encode(y, u, v): ...       # for the plain CPU path
    for ef in enc.flush(): ...
    stream = b"".join(ef.annex_b() for ef in frames)

An Encoder codes on its one device whatever num_devices says, as the JAX
Encoder does; parallel/mesh.py spreads all-intra frames or IPPP GOP
segments over several devices.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.device import resolve_device
from homerhevc_tpu_torch.engine.pipeline import TorchPipeline
from homerhevc_tpu_torch.hevc.bitstream import annex_b


class EncodedFrame:
    """Output unit: NAL payloads + reconstruction (analog of output_set_t).

    `recon` may be passed as a zero-arg callable; it is then materialized
    on first access, so reconstruction planes stay on the device unless a
    consumer (recon dump, PSNR, tests) reads them. `trace`: the frame's
    lifecycle stamps (utils.profiler.FrameTrace) where the tracer was on
    when it was pushed, else None."""

    def __init__(self, poc: int, frame_type: str, nals: list[bytes],
                 recon=None, avg_qp: float = 0.0, trace=None):
        self.poc = poc
        self.frame_type = frame_type
        self.nals = nals
        self._recon = recon  # {'y','u','v'} uint8 planes, or thunk
        self.avg_qp = avg_qp
        self.trace = trace

    @property
    def recon(self) -> Optional[dict]:
        if callable(self._recon):
            self._recon = self._recon()
        return self._recon

    @property
    def bits(self) -> int:
        return sum(len(n) + 4 for n in self.nals) * 8

    def annex_b(self) -> bytes:
        return annex_b(self.nals)


class Encoder:
    """Session object owning config, GOP state and the torch device
    pipeline. The device defaults to the card ("cuda"); pass device="cpu"
    for the plain CPU path."""

    # config fields whose change keeps the device encoder objects (QP and
    # the source planes are per-call inputs; these live in host GOP/RC
    # logic only)
    _SOFT_FIELDS = frozenset({
        "qp", "bitrate_kbps", "bitrate_mode", "frame_rate", "vbv_size",
        "vbv_init", "intra_period", "gop_size", "num_b", "b_qp_offset",
        "reinit_gop_on_scene_change",
    })

    def __init__(self, cfg: EncoderConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._pipeline = TorchPipeline(cfg, self.device)

    def encode(self, y: np.ndarray, u: np.ndarray,
               v: np.ndarray) -> Iterator[EncodedFrame]:
        """Submit one YUV420 8-bit frame; yields finished frames (possibly
        none yet while the pipeline fills) in decode order: under IBP each
        B frame comes after the anchor that follows it in display order.
        EncodedFrame.poc is the display index, frame_type "I", "P" or
        "B"."""
        yield from self._pipeline.push(y, u, v)

    def flush(self) -> Iterator[EncodedFrame]:
        """Drain the pipeline."""
        yield from self._pipeline.flush()

    def reconfigure(self, **changes) -> list[EncodedFrame]:
        """Drain the in-flight GOP, then restart the pipeline with the
        updated config (the next frame is an IDR). Device encoder objects
        are kept when every changed field is RC/GOP-side."""
        drained = list(self.flush())
        unknown = [k for k in changes if not hasattr(self.cfg, k)]
        if unknown:
            raise ValueError(f"unknown config fields: {unknown}")
        old = self._pipeline
        cfg = dataclasses.replace(self.cfg, **changes)
        self._pipeline = TorchPipeline(cfg, self.device)
        self.cfg = cfg
        if all(k in self._SOFT_FIELDS for k in changes):
            self._pipeline._intra_enc = old._intra_enc
            self._pipeline._inter_enc = old._inter_enc
        return drained
