"""The port's slice-data parser (homerhevc_tpu_torch/hevc/parse.py, a copy
of the JAX package's with a stream-level reader added) on the port's own
streams, encoded on the CPU once per module: every slice of an IPPP CU16
stream with SAO (the I frame's decided on the host, the P frames' on the
device), of an IPPP CU16 stream with WPP, SAO and per-CTB AQ maps
(cu_qp_delta), of a 96x64 IBP stream at CTU 32 (bi anchors and B
frames), of a three-reference stream with AQ and deblocking (per-CU
ref_idx_l0 under a num_ref_idx_active override) and of a 64x64 IBP
stream at CU16 with intra_rdo (rectangular PUs in its B slices) parses
back into the FrameDesc and SAO parameters that were serialized. The JAX package's parser agrees on the same slices except
where a B slice codes an AMVP PU at the left picture edge with mvp flag
1: there the JAX package's two-list AMVP list differs from the spec's
(ROADMAP Queue 3), so it derives other motion vectors."""

import numpy as np
import pytest
import torch

from homerhevc_tpu.hevc.parse import SliceDataParser as JaxParser
from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.hevc.parse import (SerializedSlices,
                                            desc_mismatches,
                                            parse_slice_nal, split_annexb)
from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip
from tests.test_intra_tree import _mixed_frame
from tests.test_multiref import _flicker_frames

torch.set_num_threads(1)    # one intra-op thread per test worker


def _pan_frames(n, seed, noise=3):
    """The mixed frame panning right by 2 px a frame (ROADMAP Queue 3's
    left-edge input at seed 43)."""
    rng = np.random.RandomState(seed)
    y, u, v = _mixed_frame(rng, 96, 64)
    return [(np.clip(np.roll(y, 2 * t, 1).astype(int)
                     + rng.randint(-noise, noise + 1, y.shape), 0, 255)
             .astype(np.uint8), np.roll(u, t, 1), np.roll(v, t, 1))
            for t in range(n)]


def _banded(frames):
    """frames with a flat band over the top CTB row (AQ lowers its QP)."""
    for y, _, _ in frames:
        y[:16] = 90
    return frames


_STREAMS = {
    "ippp-sao": (dict(width=128, height=64, cu_size=16, gop_size=1,
                      sao=True), lambda: bench_clip(128, 64, 3, 5)),
    "ippp-wpp-sao-aq": (dict(width=128, height=64, cu_size=16, gop_size=1,
                             sao=True, wpp=True, aq_strength=2.0,
                             deblocking=False),
                        lambda: _banded(bench_clip(128, 64, 3, 6))),
    "ibp-ctu32": (dict(width=96, height=64, cu_size=32, gop_size=2,
                       intra_rdo=True, sao=True), lambda: _pan_frames(7, 43)),
    "ippp-3refs-aq-deblock": (dict(width=128, height=64, cu_size=16,
                                   gop_size=1, num_ref_frames=3,
                                   aq_strength=2.0, sao=True),
                              lambda: _flicker_frames(
                                  np.random.RandomState(4), 128, 64, 4)),
    "ibp-intra_rdo-cu16": (dict(width=64, height=64, cu_size=16,
                                gop_size=2, intra_rdo=True),
                           lambda: bench_clip(64, 64, 5, 8)),
}


@pytest.fixture(scope="module")
def streams():
    """name -> (ParamSets, Annex-B stream, [(FrameDesc, SAO parameters,
    NAL)] in decode order) of each port stream."""
    out = {}
    for name, (kw, frames) in _STREAMS.items():
        enc = Encoder(EncoderConfig(qp=32, **kw), device="cpu")
        with SerializedSlices() as spy:
            efs = [e for f in frames() for e in enc.encode(*f)]
            efs += list(enc.flush())
        out[name] = (enc._pipeline.ps, b"".join(e.annex_b() for e in efs),
                     [s[1:] for s in spy.slices])
    return out


def _slice_nals(stream):
    return [n for n in split_annexb(stream) if (n[0] >> 1) & 0x3F < 32]


@pytest.mark.parametrize("name", list(_STREAMS))
def test_port_parser_recovers_the_serialized_slices(streams, name):
    ps, stream, slices = streams[name]
    nals = _slice_nals(stream)
    assert nals == [nal for _, _, nal in slices]
    types, qp_off = set(), 0
    for desc, sao, nal in slices:
        hdr, p = parse_slice_nal(ps, nal)
        types.add(hdr["slice_type"])
        assert desc_mismatches(p.d, desc, p.sao, sao) == [], hdr
        if desc.qp_map is not None:
            qp_off += int((desc.qp_map != hdr["qp"]).sum())
    assert len(types) == (3 if name.startswith("ibp") else 2)
    assert (qp_off > 0) == ("aq" in name)
    if name == "ippp-3refs-aq-deblock":
        assert [d.ref_idx is not None for d, _, _ in slices] == \
            [False, False, True, True]
        assert any((d.ref_idx >= 1).any() for d, _, _ in slices[2:])
    if name == "ibp-intra_rdo-cu16":
        assert any(d.inter_part is not None and d.inter_part.any()
                   for d, _, _ in slices[2::2])


@pytest.mark.parametrize("name", list(_STREAMS))
def test_jax_parser_agrees_outside_the_left_edge_case(streams, name):
    ps, stream, slices = streams[name]
    edge_slices = 0
    for desc, sao, nal in slices:
        _, p = parse_slice_nal(ps, nal, parser=JaxParser)
        bad = desc_mismatches(p.d, desc, p.sao, sao)
        edge = False
        if desc.inter_dir is not None and desc.inter_mode is not None:
            # AMVP PUs of a B slice in the first 8x8 column, mvp flag 1
            amvp = desc.inter_mode[:, 0] == 2
            d = desc.inter_dir[:, 0]
            edge = bool((amvp & ((((d & 1) != 0) & (desc.mvp_flag[:, 0] == 1))
                                 | (((d & 2) != 0)
                                    & (desc.mvp_flag_l1[:, 0] == 1)))).any())
        if edge:
            assert set(bad) <= {"mv", "mv_l1"}, bad
            edge_slices += bool(bad)
        else:
            assert bad == []
    if name == "ibp-ctu32":
        # the input of ROADMAP Queue 3: a bi anchor codes such a PU, and
        # the JAX parser derives another MV there
        assert edge_slices >= 1
