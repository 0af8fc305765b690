"""Tests of the torch port that need an NVIDIA card: the hand-written CUDA
kernel (its 8-bit and wide-source entry points) against its plain
version, the wrapper's checks on CUDA tensors, and the encoders (flat
CU16 I and P, the intra CU tree, device SAO, the CU-tree P program with
the FAR level and intra-in-P, the bi-capable B program, the
generalized-B chain, the intra and P programs with per-CTB QP maps, the
CLI, an IPPP stream whose I frame takes the host programs, a
three-reference stream whose later frames take the host P programs, an
IBP stream with per-CTB QP maps, the mesh's slots) and the ops they add
on the card against the same code on the CPU, the intra program's CUDA
graph replays against its eager dispatches, the P and B programs' graph
replays (split at the sweep) against eager dispatches and the CPU, the
sweep's launch count
under four slot threads,
and the port's parser on a stream coded on the card. They
skip here with a reason. This file imports no jax, so on the card's machine it runs
without the JAX package's conftest:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from homerhevc_tpu_torch.config import EncoderConfig
from homerhevc_tpu_torch.device import LAUNCHES
from homerhevc_tpu_torch.engine.inter_encoder import TorchInterEncoder
from homerhevc_tpu_torch.engine.intra_encoder import TorchIntraEncoder
from homerhevc_tpu_torch.engine.intra_tree_encoder import \
    TorchIntraTreeEncoder
from homerhevc_tpu_torch.hevc.headers import ParamSets
from homerhevc_tpu_torch.ops import intra, me_sad, sao_dev
from homerhevc_tpu_torch.state import reference_from_numpy

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _sweep_inputs(seed, gh, gw, R, m, device):
    rng = np.random.RandomState(seed)
    sd = rng.randint(0, 256, (gh * m, gw * m)).astype(np.uint8)
    rp = np.pad(rng.randint(0, 256, (gh * m, gw * m)), R, mode="edge")
    return (torch.from_numpy(sd).to(device),
            torch.from_numpy(rp.astype(np.uint8)).to(device))


# 720p slice shapes (R=16 IPPP, R=24 IBP), the 1080p shapes of the CU-tree
# P frames (1088 coded lines: gh 68; and gh 72), ragged grids, a large
# radius, and the tiling's edges: gw past one 16-column tile and ragged,
# gh = 1, R not a multiple of the 8-dx run, m = 16 with R = 24, m = 32
@pytest.mark.parametrize("gh,gw,R,m", [(45, 80, 16, 8), (45, 80, 24, 8),
                                       (68, 120, 16, 8), (72, 120, 16, 8),
                                       (3, 5, 16, 8), (4, 9, 48, 8),
                                       (2, 3, 24, 16), (2, 21, 4, 8),
                                       (1, 5, 8, 8), (2, 3, 13, 8),
                                       (22, 40, 24, 16), (2, 3, 5, 32)])
def test_kernel_matches_plain(card, gh, gw, R, m):
    sd, rp = _sweep_inputs(gh * gw + R, gh, gw, R, m, card)
    before = LAUNCHES["coarse_sweep_sads"]
    got = me_sad.coarse_sweep_sads(sd, rp, R, m)
    torch.cuda.synchronize()
    assert LAUNCHES["coarse_sweep_sads"] == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got, me_sad.coarse_sweep_sads_plain(sd, rp, R, m))


# the B program's bi target (2 * src - pred, in [-255, 510]) at the 720p
# and 1088-line IBP shapes (R = 24), a ragged grid, m = 16, and sources
# at the int16 extremes
@pytest.mark.parametrize("gh,gw,R,m,lo,hi", [
    (45, 80, 24, 8, -255, 510), (68, 120, 24, 8, -255, 510),
    (3, 5, 16, 8, -255, 510), (22, 40, 24, 16, -255, 510),
    (2, 21, 4, 8, -32768, 32767)])
def test_wide_kernel_matches_plain(card, gh, gw, R, m, lo, hi):
    rng = np.random.RandomState(gh * gw + R)
    sd = torch.from_numpy(rng.randint(lo, hi + 1, (gh * m, gw * m))
                          .astype(np.int16)).to(card)
    rp = _sweep_inputs(gh + R, gh, gw, R, m, card)[1]
    before = dict(LAUNCHES)
    got = me_sad.coarse_sweep_sads(sd, rp, R, m)
    torch.cuda.synchronize()
    assert LAUNCHES["coarse_sweep_sads_wide"] == \
        before["coarse_sweep_sads_wide"] + 1
    assert LAUNCHES["coarse_sweep_sads"] == before["coarse_sweep_sads"]
    assert torch.equal(got, me_sad.coarse_sweep_sads_plain(sd, rp, R, m))


@pytest.mark.parametrize("s_val,r_val", [(0, 255), (255, 0), (255, 255)])
def test_kernel_extremes_match_plain(card, s_val, r_val):
    gh, gw, R, m = 45, 80, 16, 8
    sd = torch.full((gh * m, gw * m), s_val, dtype=torch.uint8, device=card)
    rp = torch.full((gh * m + 2 * R, gw * m + 2 * R), r_val,
                    dtype=torch.uint8, device=card)
    got = me_sad.coarse_sweep_sads(sd, rp, R, m)
    torch.cuda.synchronize()
    assert torch.equal(got, me_sad.coarse_sweep_sads_plain(sd, rp, R, m))
    assert int(got.max()) == abs(s_val - r_val) * m * m


def test_wrapper_rejects_bad_cuda_inputs(card):
    sd, rp = _sweep_inputs(1, 2, 2, 4, 8, card)
    with pytest.raises(TypeError):
        me_sad.coarse_sweep_sads(sd.to(torch.int32), rp, 4, 8)
    with pytest.raises(ValueError):
        me_sad.coarse_sweep_sads(sd.t(), rp, 4, 8)
    with pytest.raises(ValueError):
        me_sad.coarse_sweep_sads(sd, rp.cpu(), 4, 8)
    # the kernel takes m a multiple of 8 (the plain CPU version any m)
    sd5, rp5 = _sweep_inputs(2, 3, 5, 3, 5, card)
    with pytest.raises(ValueError):
        me_sad.coarse_sweep_sads(sd5, rp5, 3, 5)


def _frame(rng, w, h):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    y = np.clip(60 + 0.1 * xx + 25 * np.sin(xx / 11.0) + 15 * np.cos(yy / 7.0)
                + rng.rand(h, w) * 12, 0, 255).astype(np.uint8)
    u = np.clip(128 + 20 * np.sin(xx[::2, ::2] / 23.0), 0, 255) \
        .astype(np.uint8)
    return y, u, u[::-1].copy()


@pytest.mark.parametrize("deblock,sao", [(False, False), (True, False),
                                        (True, True)])
def test_encoders_on_card_match_cpu(card, deblock, sao):
    w, h = 128, 64
    rng = np.random.RandomState(7)
    y, u, v = _frame(rng, w, h)
    cfg = EncoderConfig(width=w, height=h, qp=32, gop_size=1, intra_period=0,
                        sao=sao, deblocking=deblock, sign_hiding=True,
                        cu_size=16)
    ps = ParamSets.from_config(cfg)
    out = {}
    for dev in ("cpu", card):
        di, ry, ru, rv = TorchIntraEncoder(ps, cfg, device=dev).encode_frame(
            y, u, v, 32)
        di.densify()
        src = (np.roll(y, 3, 1), np.roll(u, 1, 1), np.roll(v, 1, 1))
        before = LAUNCHES["coarse_sweep_sads"]
        dp, py, pu, pv = TorchInterEncoder(ps, cfg, device=dev).encode_frame(
            src, reference_from_numpy((ry, ru, rv), dev))
        assert LAUNCHES["coarse_sweep_sads"] == before + (dev == card)
        out[str(dev)] = (di, dp, [np.asarray(p) for p in
                                  (ry, ru, rv, py, pu, pv)])
    (ci, cp, crec), (gi, gp, grec) = out["cpu"], out[str(card)]
    for f in ("luma_mode", "coef_y", "coef_u", "coef_v"):
        assert np.array_equal(getattr(ci, f), getattr(gi, f)), f
    for f in ("mv", "coef_y", "coef_u", "coef_v", "skip", "merge_idx",
              "mvp_flag"):
        assert np.array_equal(getattr(cp, f), getattr(gp, f)), f
    for a, b in zip(crec, grec):
        assert np.array_equal(a, b)
    if sao:
        _assert_sao_equal(cp.sao_params, gp.sao_params)


@pytest.mark.parametrize("cu,perf,me_range,intra_in_p", [
    (32, 0, 32, False), (64, 0, 32, False), (32, 1, 32, False),
    (64, 2, 32, False), (64, 0, 64, False), (32, 0, 32, True),
    (64, 1, 32, True)])
def test_tree_p_frame_on_card_matches_cpu(card, cu, perf, me_range,
                                          intra_in_p):
    """The CU-tree P program with deblocking and SAO (FULL, FAST, UFAST,
    the FAR level, intra-in-P) from a shifted reference: every desc
    field, recon and SAO parameter equals the CPU path's; the sweep runs
    once."""
    w, h = 128, 128
    rng = np.random.RandomState(cu + perf)
    y, u, v = _frame(rng, w, h)
    y[64:] = (60 + np.arange(w) // 2)[None, :]    # smooth: large CUs win
    cfg = EncoderConfig(width=w, height=h, qp=32, gop_size=1, intra_period=0,
                        sao=True, deblocking=True, sign_hiding=True,
                        cu_size=cu, intra_rdo=True, performance_mode=perf,
                        me_range=me_range, intra_in_p=intra_in_p)
    ps = ParamSets.from_config(cfg)
    src = (np.roll(y, 5, 1), np.roll(u, 2, 1), np.roll(v, 2, 1))
    src[0][8:40, 40:88] = 200                  # a patch motion misses
    out = {}
    for dev in ("cpu", card):
        before = LAUNCHES["coarse_sweep_sads"]
        d, *rec = TorchInterEncoder(ps, cfg, device=dev).encode_frame(
            src, reference_from_numpy((y, u, v), dev), 700.0)
        assert LAUNCHES["coarse_sweep_sads"] == before + (dev == card)
        out[str(dev)] = (d, [np.asarray(p) for p in rec])
    (cd, crec), (gd, grec) = out["cpu"], out[str(card)]
    for f in ("cu_depth", "tr_depth", "pred_mode", "mv", "coef_y", "coef_u",
              "coef_v", "skip", "inter_mode", "merge_idx", "root_cbf",
              "mvp_flag", "luma_mode", "chroma_mode", "row_ssd_y"):
        assert np.array_equal(getattr(cd, f), getattr(gd, f)), f
    for a, b in zip(crec, grec):
        assert np.array_equal(a, b)
    _assert_sao_equal(cd.sao_params, gd.sao_params)
    assert (cd.cu_depth < ps.log2_ctu - 4).any()


def test_b_program_on_card_matches_cpu(card):
    """The bi-capable program (_impl_b) at CTU 32 with deblocking and SAO
    from two noisy shifted references: every desc field (both lists),
    recon and SAO parameter equals the CPU path's; the sweep runs twice
    on the source (8-bit) and once on the bi target (wide)."""
    w, h = 128, 96
    rng = np.random.RandomState(17)
    y, u, v = _frame(rng, w, h)
    cfg = EncoderConfig(width=w, height=h, qp=32, gop_size=2, intra_period=0,
                        sao=True, deblocking=True, sign_hiding=True,
                        cu_size=32, intra_rdo=True)
    ps = ParamSets.from_config(cfg)
    refs = [tuple(np.clip(np.roll(p, s, 1).astype(int)
                          + rng.randint(-a, a + 1, p.shape), 0, 255)
                  .astype(np.uint8) for p, a in ((y, 16), (u, 3), (v, 3)))
            for s in (2, -2)]
    out = {}
    for dev in ("cpu", card):
        before = dict(LAUNCHES)
        d, *rec = TorchInterEncoder(ps, cfg, search=24, device=dev) \
            .encode_frame_b((y, u, v), reference_from_numpy(refs[0], dev),
                            reference_from_numpy(refs[1], dev), 700.0)
        on_card = dev == card
        assert LAUNCHES["coarse_sweep_sads"] == \
            before["coarse_sweep_sads"] + 2 * on_card
        assert LAUNCHES["coarse_sweep_sads_wide"] == \
            before["coarse_sweep_sads_wide"] + on_card
        out[str(dev)] = (d, [np.asarray(p) for p in rec])
    (cd, crec), (gd, grec) = out["cpu"], out[str(card)]
    for f in ("cu_depth", "tr_depth", "pred_mode", "mv", "mv_l1",
              "inter_dir", "coef_y", "coef_u", "coef_v", "skip",
              "inter_mode", "merge_idx", "root_cbf", "mvp_flag",
              "mvp_flag_l1", "row_ssd_y"):
        assert np.array_equal(getattr(cd, f), getattr(gd, f)), f
    for a, b in zip(crec, grec):
        assert np.array_equal(a, b)
    _assert_sao_equal(cd.sao_params, gd.sao_params)
    assert (cd.inter_dir == 3).any()


def test_gpb_chain_on_card_matches_cpu(card):
    """Generalized-B at CTU 32 with two references through api.Encoder
    (I P B B B): the card's stream equals the CPU's byte for byte."""
    from homerhevc_tpu_torch.api import Encoder
    w, h = 128, 96
    rng = np.random.RandomState(23)
    y, u, v = _frame(rng, w, h)
    frames = [(np.roll(y, 3 * t, 1), np.roll(u, t, 1), v) for t in range(5)]
    cfg = EncoderConfig(width=w, height=h, qp=32, gop_size=1, intra_period=0,
                        sao=True, deblocking=True, sign_hiding=True,
                        cu_size=32, intra_rdo=True, num_ref_frames=2,
                        reinit_gop_on_scene_change=False)
    streams = {}
    for dev in ("cpu", card):
        enc = Encoder(cfg, device=dev)
        efs = [e for f in frames for e in enc.encode(*f)] + \
            list(enc.flush())
        assert [e.frame_type for e in efs] == ["I", "P", "B", "B", "B"]
        streams[str(dev)] = b"".join(e.annex_b() for e in efs)
    assert streams["cpu"] == streams[str(card)]


def _assert_sao_equal(p, q):
    for f in ("type_luma", "type_chroma", "eo_class_luma", "eo_class_chroma",
              "band_pos", "offsets", "merge_left", "merge_up"):
        assert np.array_equal(getattr(p, f), getattr(q, f)), f


def test_sao_on_card_matches_cpu(card):
    """Device SAO over a batch of two 128x64 frames at CTU 32."""
    rng = np.random.RandomState(11)
    src = [rng.randint(0, 256, (2, hh, ww)).astype(np.int32)
           for hh, ww in ((64, 128), (32, 64), (32, 64))]
    rec = [np.clip(s + rng.randint(-6, 7, s.shape), 0, 255).astype(np.int32)
           for s in src]
    lam = sao_dev.sao_lambda_x256(torch.tensor([32, 27]))
    out = {}
    for dev in ("cpu", card):
        r = sao_dev.sao_analyze_apply(
            *(torch.from_numpy(p).to(dev) for p in src + rec), 32,
            lam.to(dev))
        out[str(dev)] = [t.cpu() for t in r[:3]] + [
            sao_dev.pack_params(r[3]).cpu()]
    for a, b in zip(out["cpu"], out[str(card)]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,luma", [(4, True), (8, True), (16, True),
                                    (32, True), (4, False), (16, False)])
def test_predict_mode_on_card_matches_cpu(card, n, luma):
    rng = np.random.RandomState(n)
    top = torch.from_numpy(rng.randint(0, 256, (70, 2 * n + 1)))
    left = torch.from_numpy(rng.randint(0, 256, (70, 2 * n + 1)))
    mode = torch.arange(35).repeat(2)
    want = intra.predict_mode(top.int(), left.int(), n, mode, luma)
    got = intra.predict_mode(top.int().to(card), left.int().to(card), n,
                             mode.to(card), luma)
    assert torch.equal(want, got.cpu())


@pytest.mark.parametrize("cu", [32, 64])
def test_tree_encoder_on_card_matches_cpu(card, cu):
    """The intra CU tree with deblocking and SAO, a batch of two frames:
    maps, levels, recon and SAO parameters equal the CPU path's."""
    w, h = 128, 64
    rng = np.random.RandomState(cu)
    frames = [_frame(rng, w, h) for _ in range(2)]
    cfg = EncoderConfig(width=w, height=h, qp=30, gop_size=0, cu_size=cu,
                        intra_rdo=True, sao=True, deblocking=True,
                        sign_hiding=True)
    ps = ParamSets.from_config(cfg)
    out = {}
    for dev in ("cpu", card):
        res = TorchIntraTreeEncoder(ps, cfg, device=dev).encode_frames(
            *zip(*frames), qps=[30, 34])
        out[str(dev)] = [(d.densify(), [np.asarray(p) for p in rec])
                         for d, *rec in res]
    for (cd, crec), (gd, grec) in zip(out["cpu"], out[str(card)]):
        for f in ("cu_depth", "luma_mode", "chroma_mode", "coef_y", "coef_u",
                  "coef_v"):
            assert np.array_equal(getattr(cd, f), getattr(gd, f)), f
        for a, b in zip(crec, grec):
            assert np.array_equal(a, b)
        _assert_sao_equal(cd.sao_params, gd.sao_params)


def test_intra_aq_encoder_on_card_matches_cpu(card):
    """The CU16 intra program with per-CU QP maps (AQ), a batch of two
    frames at different QPs: modes, levels, recon and qp_map equal the
    CPU path's."""
    from homerhevc_tpu_torch.engine.rate_control import aq_qp_map
    w, h = 128, 64
    rng = np.random.RandomState(5)
    frames = [_frame(rng, w, h) for _ in range(2)]
    for y, _, _ in frames:
        y[:16] = 90                             # a flat band: AQ deltas
    qps = [30, 34]
    maps = [aq_qp_map(f[0], 16, q, 2.0) for f, q in zip(frames, qps)]
    cfg = EncoderConfig(width=w, height=h, qp=30, gop_size=0, cu_size=16,
                        sao=False, deblocking=False, sign_hiding=True,
                        aq_strength=2.0)
    ps = ParamSets.from_config(cfg)
    out = {}
    for dev in ("cpu", card):
        res = TorchIntraEncoder(ps, cfg, device=dev).encode_frames(
            *zip(*frames), qps=qps, qp_maps=maps)
        out[str(dev)] = [(d.densify(), [np.asarray(p) for p in rec])
                         for d, *rec in res]
    for (cd, crec), (gd, grec) in zip(out["cpu"], out[str(card)]):
        for f in ("luma_mode", "coef_y", "coef_u", "coef_v", "qp_map"):
            assert np.array_equal(getattr(cd, f), getattr(gd, f)), f
        for a, b in zip(crec, grec):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("deblock,maps,current", [
    (False, False, True), (True, False, True), (False, True, True),
    (True, False, False)])
def test_intra_graph_replays_match_eager(card, deblock, maps, current):
    """The CU16 intra program from its CUDA graph: four dispatches of one
    batch shape over other frames and QPs (eager, capture, two replays),
    with deblocking off and on and with QP maps, equal a fresh eager
    encoder's seven outputs bit for bit, each read after every later
    dispatch ran (no batch's outputs are the graph's buffers); the
    counters read eager 1, capture 1, replays 2, and a batch size seen
    once stays eager. With `current` false the encoders are on the second
    card while the first is current, as "cuda:1" places them (skipped
    with one card)."""
    from homerhevc_tpu_torch.engine.rate_control import aq_qp_map
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    w, h = 128, 64
    rng = np.random.RandomState(19)
    cfg = EncoderConfig(width=w, height=h, qp=30, gop_size=0, cu_size=16,
                        sao=False, deblocking=deblock, sign_hiding=True,
                        aq_strength=2.0 if maps else 0.0)
    ps = ParamSets.from_config(cfg)
    batches = []
    for k, n in enumerate((2, 2, 2, 2, 1)):
        frames = [_frame(rng, w, h) for _ in range(n)]
        qps = [28 + k, 35 - k][:n]
        batches.append((frames, qps, [aq_qp_map(f[0], 16, q, 2.0) for f, q
                                      in zip(frames, qps)] if maps else None))
    if not current:
        if torch.cuda.device_count() < 2:
            pytest.skip("needs a second CUDA card, not the current one")
        card = torch.device("cuda", 1)

    def dispatch(enc, frames, qps, qp_maps):
        return enc.dispatch_packed(enc.pack_upload(frames), qps, qp_maps)
    enc = TorchIntraEncoder(ps, cfg, device=card)
    try:
        with PROFILER.enabled(), torch.cuda.device(0):
            PROFILER.reset()
            got = [dispatch(enc, *b) for b in batches]
            counters = PROFILER.counters
    finally:
        PROFILER.reset()
    want = [dispatch(TorchIntraEncoder(ps, cfg, device=card), *b)
            for b in batches]
    for g, e in zip(got, want):
        assert len(g) == len(e) == 7
        for a, b in zip(g, e):
            assert a.dtype == b.dtype and torch.equal(a, b)
    for k in range(1, 4):       # the batches differ, so an overwrite shows
        assert not torch.equal(got[k - 1][0], got[k][0])
    assert (counters["intra.eager"], counters["intra.graph_captures"],
            counters["intra.graph_replays"]) == (2, 1, 2)
    key = 2 if maps else 1
    assert enc._graphs[(1, key)] is None and enc._graphs[(2, key)]


def test_intra_graphs_of_two_batch_sizes_share_a_pool(card):
    """Two batch sizes dispatched in turns (as full batches and a flush's
    partial ones): each is captured on its second dispatch into the first
    graph's memory pool, and all eight dispatches, read after the last,
    equal a fresh eager encoder's bit for bit."""
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    w, h = 128, 64
    rng = np.random.RandomState(23)
    cfg = EncoderConfig(width=w, height=h, qp=30, gop_size=0, cu_size=16,
                        sao=False, deblocking=True, sign_hiding=True)
    ps = ParamSets.from_config(cfg)
    batches = [[_frame(rng, w, h) for _ in range(n)]
               for n in (2, 1, 2, 1, 2, 1, 2, 1)]

    def dispatch(enc, frames):
        return enc.dispatch_packed(enc.pack_upload(frames),
                                   [30 + len(frames)] * len(frames))
    enc = TorchIntraEncoder(ps, cfg, device=card)
    try:
        with PROFILER.enabled():
            PROFILER.reset()
            got = [dispatch(enc, b) for b in batches]
            counters = PROFILER.counters
    finally:
        PROFILER.reset()
    want = [dispatch(TorchIntraEncoder(ps, cfg, device=card), b)
            for b in batches]
    for g, e in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, e))
    assert (counters["intra.eager"], counters["intra.graph_captures"],
            counters["intra.graph_replays"]) == (2, 2, 4)
    assert enc._graphs[(1, 1)].graph.pool() == enc._graphs[(2, 1)].graph.pool()


@pytest.mark.parametrize("program", ["p", "p_tree", "b"])
def test_inter_graph_replays_match_eager_and_cpu(card, program, monkeypatch):
    """The inter programs from their CUDA graphs split at the sweep: P at
    128x64 CU16 (deblocking, SAO) over QPs 32 x 5, 30 x 3, then 28, 29 and
    31 twice each; the CTU-64 P program with the FAR level and
    intra-in-P; the B program at CTU 32 (dispatch_b, search 24), 4
    dispatches each at QP 32. Each dispatch codes another frame; its
    seven outputs, read after the last dispatch ran, equal a fresh card
    encoder's eager dispatch and the CPU's bit for bit. The counters read
    one capture and the rest replays per key, a fifth key past the cap
    of four graphs stays eager, and the graphs share one pool. Every
    dispatch calls the module's coarse_sweep_sads once (B: three times,
    one of them wide) and launches the kernel as often."""
    from homerhevc_tpu_torch.engine import inter_encoder
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    bi, tree = program == "b", program == "p_tree"
    w, h = (128, 128) if tree else (128, 96) if bi else (128, 64)
    qps = ([32] * 5 + [30] * 3 + [28, 28, 29, 29, 31, 31]
           if program == "p" else [32] * 4)
    cfg = EncoderConfig(width=w, height=h, qp=32, gop_size=2 if bi else 1,
                        intra_period=0, sao=True, deblocking=True,
                        sign_hiding=True, cu_size=64 if tree else 32 if bi
                        else 16, intra_rdo=tree or bi, me_range=64 if tree
                        else 32, intra_in_p=tree)
    ps = ParamSets.from_config(cfg)
    rng = np.random.RandomState(29)
    y, u, v = _frame(rng, w, h)
    frames = [(np.roll(y, 2 * t, 1), np.roll(u, t, 1), np.roll(v, t, 0))
              for t in range(len(qps) + 2)]
    calls = []
    sweep = inter_encoder.coarse_sweep_sads

    def counted(*a):
        calls.append(a[0].dtype)
        return sweep(*a)
    monkeypatch.setattr(inter_encoder, "coarse_sweep_sads", counted)

    def dispatch(enc, k, dev):
        refs = [reference_from_numpy(frames[k + j], dev) for j in (0, 2)]
        if bi:
            return enc.dispatch_b(frames[k + 1], *refs, 700.0, qps[k])
        return enc.dispatch(frames[k + 1], refs[0], 700.0, qps[k])

    def encoder(dev):
        return TorchInterEncoder(ps, cfg, search=24 if bi else 16,
                                 device=dev)
    enc = encoder(card)
    got, per = [], []
    try:
        with PROFILER.enabled():
            PROFILER.reset()
            for k in range(len(qps)):
                before = dict(LAUNCHES)
                del calls[:]
                got.append(dispatch(enc, k, card))
                per.append((list(calls), {n: LAUNCHES[n] - before[n]
                                          for n in LAUNCHES}))
            counters = PROFILER.counters
    finally:
        PROFILER.reset()
    want = {"eager": [dispatch(encoder(card), k, card)
                      for k in range(len(qps))],
            "cpu": [dispatch(encoder("cpu"), k, "cpu")
                    for k in range(len(qps))]}
    for name, outs in want.items():
        for k, (g, e) in enumerate(zip(got, outs)):
            assert len(g) == len(e) == 7
            for a, b in zip(g, e):
                assert a.dtype == b.dtype and torch.equal(a, b.to(card)), \
                    (name, k)
    sweeps = ([torch.uint8, torch.uint8, torch.int16] if bi
              else [torch.uint8])
    launches = {"coarse_sweep_sads": 2 if bi else 1,
                "coarse_sweep_sads_wide": int(bi)}
    assert per == [(sweeps, launches)] * len(qps)
    assert (counters["inter.eager"], counters["inter.graph_captures"],
            counters["inter.graph_replays"]) == \
        ((6, 4, 4) if program == "p" else (1, 1, 2))
    assert len({g.parts[0].graph.pool() for g in enc._graphs.values()}) == 1
    assert all(len(g.parts) == len(sweeps) + 1
               for g in enc._graphs.values())


def test_frame_graph_holds_the_collector_off_while_it_captures(card):
    """FrameGraph captures with the garbage collector off (a dead cycle
    holding a dropped encoder's graph, collected mid-capture, would end
    the capture) and turns it back on; the graph replays."""
    import gc
    from homerhevc_tpu_torch.device import FrameGraph
    seen = []

    def program(x):
        seen.append(gc.isenabled())
        return (x * 2,)
    assert gc.isenabled()
    graph = FrameGraph(program, (torch.ones(4, device=card),))
    assert seen == [False] and gc.isenabled()
    x = torch.arange(4.0, device=card)
    assert torch.equal(graph.replay(x)[0], 2 * x)


@pytest.mark.parametrize("gop", [0, 1])
def test_graph_replayed_streams_on_card_match_cpu(card, gop):
    """Streams whose I frames reach the intra program's CUDA graph through
    the pipeline (128x64, 8 frames, deblocking): all-intra in batches of 2
    (eager, capture, two replays; the background fetch reads each batch
    after the next one replayed) and IPPP with an IDR every 2 frames
    (batches of 1); the stream and recon equal the CPU path's byte for
    byte."""
    from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip
    from homerhevc_tpu_torch.utils.profiler import PROFILER
    cfg = EncoderConfig(width=128, height=64, qp=32, cu_size=16,
                        gop_size=gop, intra_period=2 if gop else 0,
                        num_frames_in_flight=2, deblocking=True, sao=False,
                        sign_hiding=True, reinit_gop_on_scene_change=False)
    try:
        with PROFILER.enabled():
            PROFILER.reset()
            out, types, _ = _card_and_cpu_streams(cfg,
                                                  bench_clip(128, 64, 8, 43))
            counters = PROFILER.counters
    finally:
        PROFILER.reset()
    assert types.count("I") == (8 if gop == 0 else 4)
    # the CPU's four dispatches and the card's first are eager
    assert (counters["intra.eager"], counters["intra.graph_captures"],
            counters["intra.graph_replays"]) == (5, 1, 2)
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("cu", [16, 64])
def test_p_program_with_map_on_card_matches_cpu(card, cu):
    """The P program with a per-CTB QP map (deblocking off, SAO on) at
    CU16 and at CTU 64 (QP vectors of every level): every desc field,
    recon and SAO parameter equals the CPU path's; the sweep runs once."""
    from homerhevc_tpu_torch.engine.rate_control import aq_qp_map
    w, h = 128, 128
    rng = np.random.RandomState(cu + 3)
    y, u, v = _frame(rng, w, h)
    y[64:] = (60 + np.arange(w) // 2)[None, :]    # smooth: large CUs win
    cfg = EncoderConfig(width=w, height=h, qp=32, gop_size=1, intra_period=0,
                        sao=True, deblocking=False, sign_hiding=True,
                        cu_size=cu, intra_rdo=cu > 16)
    ps = ParamSets.from_config(cfg)
    src = (np.roll(y, 5, 1), np.roll(u, 2, 1), np.roll(v, 2, 1))
    qp_map = aq_qp_map(src[0], cu, 32, 2.0)
    assert len(np.unique(qp_map)) >= 2
    out = {}
    for dev in ("cpu", card):
        before = LAUNCHES["coarse_sweep_sads"]
        d, *rec = TorchInterEncoder(ps, cfg, device=dev).encode_frame(
            src, reference_from_numpy((y, u, v), dev), 700.0, qp_map=qp_map)
        assert LAUNCHES["coarse_sweep_sads"] == before + (dev == card)
        out[str(dev)] = (d, [np.asarray(p) for p in rec])
    (cd, crec), (gd, grec) = out["cpu"], out[str(card)]
    for f in ("cu_depth", "tr_depth", "pred_mode", "mv", "coef_y", "coef_u",
              "coef_v", "skip", "inter_mode", "merge_idx", "root_cbf",
              "mvp_flag", "qp_map", "row_ssd_y"):
        assert np.array_equal(getattr(cd, f), getattr(gd, f)), f
    for a, b in zip(crec, grec):
        assert np.array_equal(a, b)
    _assert_sao_equal(cd.sao_params, gd.sao_params)


def test_cli_on_card_matches_cpu(card, tmp_path):
    """The CLI at 128x64 (IPPP CU16 with half-pel ME, scaling lists and
    WPP): the card's stream and recon equal the CPU's byte for byte; the
    sweep runs once per P frame on the card."""
    from homerhevc_tpu_torch import cli
    from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip, write_yuv
    write_yuv(tmp_path / "in.yuv", bench_clip(128, 64, 4, 21))
    out = {}
    for dev in ("cpu", "cuda"):
        before = LAUNCHES["coarse_sweep_sads"]
        assert cli.main([
            "-i", str(tmp_path / "in.yuv"), "-o", str(tmp_path / f"{dev}.265"),
            "-o-raw", str(tmp_path / f"{dev}.yuv"), "-widthxheight",
            "128x64", "-n_frames", "4", "-motion_estimation_precision", "1",
            "-scaling_lists", "1", "-wpp", "1", "-device", dev]) == 0
        assert LAUNCHES["coarse_sweep_sads"] - before == (3 if dev == "cuda"
                                                          else 0)
        out[dev] = ((tmp_path / f"{dev}.265").read_bytes(),
                    (tmp_path / f"{dev}.yuv").read_bytes())
    assert out["cuda"] == out["cpu"]


def test_parser_round_trip_of_a_card_stream(card):
    """Every slice of an IPPP CU16 stream with SAO and WPP coded on the
    card parses back into the FrameDesc and SAO parameters that were
    serialized."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.hevc.parse import (SerializedSlices,
                                                desc_mismatches,
                                                parse_slice_nal,
                                                split_annexb)
    from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip
    enc = Encoder(EncoderConfig(width=128, height=64, qp=32, cu_size=16,
                                gop_size=1, sao=True, wpp=True), device=card)
    with SerializedSlices() as spy:
        efs = [e for f in bench_clip(128, 64, 3, 22) for e in enc.encode(*f)]
        efs += list(enc.flush())
    nals = [n for n in split_annexb(b"".join(e.annex_b() for e in efs))
            if (n[0] >> 1) & 0x3F < 32]
    assert nals == [nal for *_, nal in spy.slices] and len(nals) == 3
    for ps, desc, sao, nal in spy.slices:
        _, p = parse_slice_nal(ps, nal)
        assert desc_mismatches(p.d, desc, p.sao, sao) == []


def test_host_i_frame_ippp_stream_on_card_matches_cpu(card):
    """IPPP at CTU 32 without intra_rdo, deblocking and SAO (128x64, 4
    frames): the I frame on the host's fixed-CU32 program, the P frames on
    the card, each predicting from the host recon as SAO filtered it,
    uploaded to the card; the stream and recon equal the CPU path's byte
    for byte, the sweep once per P frame, no device intra encoder
    built."""
    from homerhevc_tpu_torch.api import Encoder
    from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip
    cfg = EncoderConfig(width=128, height=64, qp=32, cu_size=32, gop_size=1,
                        deblocking=True, sao=True, sign_hiding=True)
    frames = bench_clip(128, 64, 4, 23)
    out = {}
    for dev in ("cpu", "cuda"):
        enc = Encoder(cfg, device=dev)
        before = LAUNCHES["coarse_sweep_sads"]
        efs = [e for f in frames for e in enc.encode(*f)]
        efs += list(enc.flush())
        assert LAUNCHES["coarse_sweep_sads"] - before == (3 if dev == "cuda"
                                                          else 0)
        assert enc._pipeline._intra_enc is None
        out[dev] = (b"".join(e.annex_b() for e in efs),
                    [e.recon[c].tobytes() for e in efs for c in "yuv"])
    assert [e.frame_type for e in efs] == ["I", "P", "P", "P"]
    assert out["cuda"] == out["cpu"]


def _card_and_cpu_streams(cfg, frames):
    """cfg's stream of frames on the CPU and on the card: {device: (bytes,
    recon planes)}, the frame types (decode order) and the sweep's CUDA
    launches."""
    from homerhevc_tpu_torch.api import Encoder
    out = {}
    for dev in ("cpu", "cuda"):
        enc = Encoder(cfg, device=dev)
        before = LAUNCHES["coarse_sweep_sads"]
        efs = [e for f in frames for e in enc.encode(*f)]
        efs += list(enc.flush())
        launches = LAUNCHES["coarse_sweep_sads"] - before
        out[dev] = (b"".join(e.annex_b() for e in efs),
                    [e.recon[c].tobytes() for e in efs for c in "yuv"])
    return out, "".join(e.frame_type for e in efs), launches


def test_multireference_stream_on_card_matches_cpu(card):
    """Three references at CU16 (128x64, 6 frames, deblocking): I0, P1 and
    P2 on the card's depth-2 chain, P3-P5 three-reference frames on the
    host programs from the card's recon; the stream and recon equal the
    CPU path's byte for byte, the sweep once per device P frame."""
    from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip
    cfg = EncoderConfig(width=128, height=64, qp=32, cu_size=16, gop_size=1,
                        deblocking=True, sao=True, sign_hiding=True,
                        num_ref_frames=3, intra_period=0)
    out, types, launches = _card_and_cpu_streams(cfg,
                                                 bench_clip(128, 64, 6, 29))
    assert types == "IPPPPP"
    assert launches == 2
    assert out["cuda"] == out["cpu"]


def test_ibp_with_maps_stream_on_card_matches_cpu(card):
    """IBP at CU16 with AQ and row-RC under CBR, deblocking off (128x64,
    decode order I0 P2 B1 A4 B3): the anchors on the card with their maps,
    the B frames without; the stream and recon equal the CPU path's byte
    for byte, the sweep once per anchor and B frame."""
    from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip
    cfg = EncoderConfig(width=128, height=64, qp=30, cu_size=16, gop_size=2,
                        num_b=1, deblocking=False, sao=False,
                        sign_hiding=True, aq_strength=2.0, rc_ctu=True,
                        bitrate_mode=1, bitrate_kbps=300)
    out, types, launches = _card_and_cpu_streams(cfg,
                                                 bench_clip(128, 64, 5, 31))
    assert types == "IPBPB"
    assert launches == 4
    assert out["cuda"] == out["cpu"]


def _mesh_clip():
    """Four 128x64 frames of the bench clip (two GOP segments of two, or
    two all-intra frames per slot)."""
    from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip
    return bench_clip(128, 64, 4, 37)


@pytest.mark.parametrize("fn", ["sharded", "gop"])
def test_mesh_on_card_matches_cpu_slots(card, fn):
    """encode_frames_sharded (all-intra CU16, deblocking) and
    gop_parallel_encode (IPPP CU16, deblocking: 2 segments of I + P) over
    2 slots on the card give the streams of the same over 2 CPU slots;
    the sweep launches once per P frame of each segment."""
    from homerhevc_tpu_torch.parallel.mesh import (encode_frames_sharded,
                                                   gop_parallel_encode,
                                                   make_mesh)
    cfg = EncoderConfig(width=128, height=64, qp=32, cu_size=16,
                        gop_size=0 if fn == "sharded" else 1,
                        deblocking=True, sao=False, sign_hiding=True,
                        num_devices=2, reinit_gop_on_scene_change=False)
    encode = encode_frames_sharded if fn == "sharded" else \
        gop_parallel_encode
    frames = _mesh_clip()
    slots = [card] * 2 if torch.cuda.device_count() < 2 else "cuda"
    before = LAUNCHES["coarse_sweep_sads"]
    got = encode(cfg, frames, make_mesh(2, slots))
    launches = LAUNCHES["coarse_sweep_sads"] - before
    assert got == encode(cfg, frames, make_mesh(2, "cpu"))
    assert launches == (0 if fn == "sharded" else 2)


def test_launches_count_exactly_under_four_slot_threads(card):
    """gop_parallel_encode over 4 slot threads on the card (4 segments of
    I + 3 P): the sweep's launches read 12, one per P frame, none lost to
    the threads' concurrent counting."""
    from homerhevc_tpu_torch.device import reset_launches
    from homerhevc_tpu_torch.parallel.mesh import (gop_parallel_encode,
                                                   make_mesh)
    from homerhevc_tpu_torch.tools.p_frame_ops import bench_clip
    cfg = EncoderConfig(width=128, height=64, qp=32, cu_size=16, gop_size=1,
                        deblocking=True, sao=False, sign_hiding=True,
                        num_devices=4, reinit_gop_on_scene_change=False)
    reset_launches()
    segs = gop_parallel_encode(cfg, bench_clip(128, 64, 16, 41),
                               make_mesh(4, [card] * 4))
    assert len(segs) == 4
    assert LAUNCHES["coarse_sweep_sads"] == 12
