"""The plain reference decoder rebuilds what the port's CPU path reports,
sample for sample, over the syntax the configurations produce: all-intra
CU16, and IPPP with deblocking, SAO and full-pel ME, each under the
parameter sets the stream carries; and it names the parameter sets that
are not the configuration's."""

import dataclasses

import numpy as np
import pytest

from hevcbench.clip import Clip
from hevcbench.reference import config as RC
from hevcbench.reference.decode import (decode_picture, sao_filter,
                                        stated_param_sets)
from hevcbench.reference.headers import differences, parse_parameter_sets
from hevcbench.reference.sao import SaoFrameParams

W, H = 160, 96


@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("kind,sbh", [("ai", False), ("ai", True),
                                      ("ippp", True)])
def test_reference_decode_equals_the_reported_recon(kind, sbh, qp):
    import torch
    torch.set_num_threads(1)
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.config import EncoderConfig
    kw = dict(width=W, height=H, qp=qp, sign_hiding=sbh, cu_size=16)
    kw.update(dict(gop_size=0, sao=False, deblocking=False,
                   num_frames_in_flight=2) if kind == "ai" else
              dict(gop_size=1, sao=True, deblocking=True,
                   motion_estimation_precision=0, intra_period=0))
    enc = Encoder(EncoderConfig(**kw), device="cpu")
    stated = stated_param_sets(RC.EncoderConfig(**kw))
    clip = Clip(W, H, 2 ** 31 + 3)
    out = []
    for t in range(4):
        out += list(enc.encode(*clip.frame(t)))
    out += list(enc.flush())
    assert [ef.poc for ef in out] == [0, 1, 2, 3]
    ref, ps = None, None
    for ef in out:
        if ef.frame_type == "I":
            ps = parse_parameter_sets(ef.nals)
            assert differences(ps, stated) == []
            assert ps.sign_hiding is sbh
        st, pic = decode_picture(ps, ef.nals, ref)
        r = ef.recon
        for got, c in zip(pic, "yuv"):
            assert np.array_equal(got, r[c]), (ef.poc, c)
        ref = (r["y"], r["u"], r["v"])


def test_other_parameter_sets_are_named():
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.config import EncoderConfig
    kw = dict(width=W, height=H, qp=32, gop_size=0, cu_size=16, sao=False,
              deblocking=False, num_frames_in_flight=1, sign_hiding=True)
    ef = next(iter(Encoder(EncoderConfig(**kw), device="cpu")
                   .encode(*Clip(W, H, 1).frame(0))))
    ps = parse_parameter_sets(ef.nals)
    stated = RC.EncoderConfig(**dict(kw, sign_hiding=False))
    assert differences(ps, stated_param_sets(stated)) == ["sign_hiding "
                                                          "True/False"]
    assert differences(ps, stated_param_sets(
        dataclasses.replace(stated, sign_hiding=True))) == []
    assert [d.split()[0] for d in differences(ps, stated_param_sets(
        dataclasses.replace(stated, sign_hiding=True, width=W + 16)))] \
        == ["pic_width"]


def _sao(kind, c_idx, offsets, band=0, eo=0):
    sp = SaoFrameParams.alloc(1, 1)
    (sp.type_luma if c_idx == 0 else sp.type_chroma)[0, 0] = kind
    (sp.eo_class_luma if c_idx == 0 else sp.eo_class_chroma)[0, 0] = eo
    sp.band_pos[0, 0, c_idx] = band
    sp.offsets[0, 0, c_idx] = offsets
    return sp


def test_sao_follows_the_spec_on_hand_made_cases():
    rec = np.array([[10, 20, 10, 30],
                    [20, 20, 20, 20],
                    [16, 24, 255, 8],
                    [0, 40, 41, 42]], np.int32)
    # band offset: band position 1 covers 8..15, 16..23, 24..31, 32..39
    out = sao_filter(rec, _sao(1, 0, [1, -2, 3, 7], band=1), 0, 4)
    assert out.tolist() == [[11, 18, 11, 33], [18, 18, 18, 18],
                            [14, 27, 255, 9], [0, 40, 41, 42]]
    # horizontal edge offset: local minimum +, maximum -, the first and
    # last columns (a neighbour outside the picture) left as they are
    out = sao_filter(rec, _sao(2, 0, [5, 1, 2, 4], eo=0), 0, 4)
    assert out.tolist() == [[10, 16, 15, 30], [20, 20, 20, 20],
                            [16, 24, 251, 8], [0, 40, 41, 42]]
    # vertical: only the middle rows have both neighbours
    out = sao_filter(rec, _sao(2, 0, [5, 1, 2, 4], eo=1), 0, 4)
    assert out.tolist() == [[10, 20, 10, 30], [16, 21, 20, 20],
                            [16, 24, 251, 13], [0, 40, 41, 42]]
