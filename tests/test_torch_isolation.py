"""The port stands alone: no module of homerhevc_tpu_torch (the CLI, the
parser and the tools included) and no line of chip_smoke.py imports jax
or the JAX package, nor does a run of `python -m
homerhevc_tpu_torch.cli`; a 64x64 I + P encode, an
intra CU-tree encode, a CTU-32 IPPP encode, an IBP encode and a
generalized-B encode, all with SAO, run with both blocked; more than one
device encodes on the Encoder's one device, as in the JAX package, and
the configurations the last slices brought encode on the CPU and decode
(FFmpeg) to the port's recon; the Encoder defaults to the card."""

import ast
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import (BitrateMode, EncoderConfig,
                                        PerformanceMode, RDMode)
from tests.conftest import decode_annexb
from tests.torch_golden import cli_matches_the_jax_cli

torch.set_num_threads(1)    # one intra-op thread per test worker

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ("jax", "homerhevc_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


def _sources():
    pkg = os.path.join(_ROOT, "homerhevc_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(_ROOT, "chip_smoke.py")


_ENTRY_POINTS = ("cli.py", "hevc/parse.py", "hevc/cabac_dec.py",
                 "hevc/interp.py", "hevc/rd_bits.py", "hevc/inter_frame.py",
                 "tools/measure_rd.py", "tools/prof_device.py",
                 "hevc/transform.py", "hevc/quantize.py",
                 "hevc/intra_frame.py", "hevc/intra_tree.py",
                 "hevc/deblock.py")


def test_no_source_imports_jax_or_the_jax_package():
    found = []
    paths = list(_sources())
    for f in _ENTRY_POINTS:
        assert os.path.join(_ROOT, "homerhevc_tpu_torch", f) in paths, f
    for path in paths:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and isinstance(node.args[0].value, str)
                  and getattr(node.func, "attr",
                              getattr(node.func, "id", "")) in
                  ("import_module", "__import__")):
                names = [node.args[0].value]
            found += [f"{os.path.relpath(path, _ROOT)}:{node.lineno} {n}"
                      for n in names if _forbidden(n)]
    assert not found, found


def test_port_encodes_with_jax_and_the_jax_package_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['homerhevc_tpu'] = None\n"
        "import numpy as np\n"
        "import chip_smoke\n"
        "import homerhevc_tpu_torch\n"
        "for m in pkgutil.walk_packages(homerhevc_tpu_torch.__path__,\n"
        "                               'homerhevc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from homerhevc_tpu_torch.api import Encoder\n"
        "from homerhevc_tpu_torch.config import EncoderConfig\n"
        "yy, xx = np.mgrid[0:64, 0:64]\n"
        "y = (100 + 60 * np.sin(xx / 5.0) + yy).astype(np.uint8)\n"
        "c = np.full((32, 32), 128, np.uint8)\n"
        "for kw, want in ((dict(cu_size=16, gop_size=1), ['I', 'P']),\n"
        "                 (dict(cu_size=32, gop_size=0, intra_rdo=True),\n"
        "                  ['I', 'I']),\n"
        "                 (dict(cu_size=32, gop_size=1, intra_rdo=True),\n"
        "                  ['I', 'P']),\n"
        "                 (dict(cu_size=32, gop_size=2, intra_rdo=True),\n"
        "                  ['I', 'P']),\n"
        "                 (dict(cu_size=32, gop_size=1, intra_rdo=True,\n"
        "                       gpb=True), ['I', 'P']),\n"
        "                 (dict(cu_size=16, gop_size=1, aq_strength=2.0,\n"
        "                       rc_ctu=True, deblocking=False),\n"
        "                  ['I', 'P'])):\n"
        "    cfg = EncoderConfig(width=64, height=64, qp=32, sao=True, **kw)\n"
        "    enc = Encoder(cfg, device='cpu')\n"
        "    efs = list(enc.encode(y, c, c))\n"
        "    efs += list(enc.encode(np.roll(y, 2, 1), c, c))\n"
        "    efs += list(enc.flush())\n"
        "    assert [e.frame_type for e in efs] == want\n"
        "    assert all(len(e.annex_b()) > 0 for e in efs)\n"
        "from homerhevc_tpu_torch.engine.intra_tree_encoder import \\\n"
        "    TorchIntraTreeEncoder\n"
        "from homerhevc_tpu_torch.ops import sao_dev\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


def _cli(tmp_path, *extra):
    """python -X importtime -m homerhevc_tpu_torch.cli on a 64x64 clip of
    two frames with -device cpu: the completed process and the modules it
    imported."""
    yy, xx = np.mgrid[0:64, 0:64]
    y = (100 + 60 * np.sin(xx / 5.0) + yy).astype(np.uint8)
    c = np.full((32, 32), 128, np.uint8)
    (tmp_path / "in.yuv").write_bytes(
        b"".join(p.tobytes() for t in range(2)
                 for p in (np.roll(y, 2 * t, 1), c, c)))
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "homerhevc_tpu_torch.cli",
         "-i", str(tmp_path / "in.yuv"), "-o", str(tmp_path / "out.265"),
         "-o-raw", str(tmp_path / "rec.yuv"), "-widthxheight", "64x64",
         "-device", "cpu", *extra],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=300)
    mods = [ln.split("|")[-1].strip() for ln in r.stderr.splitlines()
            if ln.startswith("import time:") and "|" in ln]
    return r, mods


def test_cli_module_runs_without_jax(tmp_path):
    """python -m homerhevc_tpu_torch.cli encodes on the CPU, prints the JAX
    CLI's summary line, and imports no module of jax or the JAX
    package."""
    r, mods = _cli(tmp_path, "-sao", "0")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines()[-1].startswith("2 frames in ")
    assert "homerhevc_tpu_torch.api" in mods
    assert not [m for m in mods if _forbidden(m)]
    dec = decode_annexb(tmp_path / "out.265")
    rec = np.fromfile(tmp_path / "rec.yuv", np.uint8).reshape(2, 96, 64)
    assert len(dec) == 2
    for d, e in zip(dec, rec):
        assert np.array_equal(d, e[:64])


def test_cli_refuses_an_unported_config_before_any_output(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """The configuration this test once saw the CLI refuse, intra_rdo at
    CU16 in IPPP (its P frames on the host P programs since they were
    ported), now encodes: the port's CLI gives the JAX CLI's config and
    bytes, and an FFmpeg decode equal to its -o-raw. The CLI has no
    -num_devices, so it refuses no configuration."""
    cli_matches_the_jax_cli(["-intra_rdo", "1", "-cu_size", "16",
                             "-gop_size", "1"], tmp_path, monkeypatch,
                            capsys)


_BASE = dict(width=64, height=64, cu_size=16, gop_size=1, qp=32, sao=False)


def _lifted(changes, types, index):
    """A case refused until the host intra programs were ported, under the
    id it had in test_unported_config_raises."""
    return pytest.param(changes, types, id=f"changes{index}")


_TREE = dict(gop_size=0, cu_size=32, intra_rdo=True)


def _case(changes, item, index, named=None):
    """A case of test_unported_config_raises under the id it had when that
    list also held the cases that now encode (test_lifted_config_encodes,
    test_host_intra_config_encodes_and_decodes and
    test_host_inter_config_encodes_and_decodes), so that each keeps its
    name; named: the item in that id where the case once expected
    another."""
    return pytest.param(changes, item,
                        id=f"changes{index}-{named or item}")


@pytest.mark.parametrize("changes,item", [
    _case(dict(num_devices=2), "item 6", 9)])
def test_unported_config_raises(changes, item):
    """More than one device (Queue 1 item 6), the last configuration the
    port refused, encodes as the JAX Encoder encodes it: on the Encoder's
    one device (neither pipeline reads num_devices; parallel/mesh.py
    spreads frames over several). I + P at CU16 with intra_rdo, coded on
    the host programs of both packages (so no JAX program is traced here;
    the device programs with num_devices 8 are held to the JAX package in
    test_torch_mesh.py): the JAX Encoder's bytes. The port refuses no
    configuration of the JAX package."""
    from homerhevc_tpu.api import Encoder as JaxEncoder
    from homerhevc_tpu.config import EncoderConfig as JaxConfig
    kw = {**_BASE, "intra_rdo": True, **changes}
    yy, xx = np.mgrid[0:64, 0:64]
    y = (100 + 60 * np.sin(xx / 5.0) + yy).astype(np.uint8)
    c = np.full((32, 32), 128, np.uint8)
    frames = [(np.roll(y, 3 * t, 1), c, c) for t in range(2)]
    streams = []
    for enc in (Encoder(EncoderConfig(**kw), device="cpu"),
                JaxEncoder(JaxConfig(**kw))):
        efs = [e for f in frames for e in enc.encode(*f)]
        efs += list(enc.flush())
        assert [e.frame_type for e in efs] == ["I", "P"]
        streams.append(b"".join(e.annex_b() for e in efs))
    assert streams[0] == streams[1]


@pytest.mark.parametrize("changes,types", [
    # per-CTB QP maps with deblocking on (the default) in IPPP
    _case(dict(intra_rdo=True, cu_size=32, aq_strength=1.0), "IPP", 4,
          "item 4"),
    _case(dict(aq_strength=1.0), "IPP", 5, "item 4"),
    _case(dict(rc_ctu=True), "IPP", 6, "item 4"),
    # three references: the fourth frame predicts from the three before
    # it (the first three ride the device chain)
    _case(dict(num_ref_frames=3), "IPPP", 14, "item 7"),
    # maps with B frames, deblocking off: the device programs
    _case(dict(aq_strength=1.0, deblocking=False, num_b=1), "IPB", 17,
          "item 4"),
    _case(dict(rc_ctu=True, deblocking=False, gop_size=2), "IPB", 18,
          "item 4"),
    # intra_rdo at CU16, maps with intra-in-P at CU64
    _case(dict(intra_rdo=True), "IPP", 19, "item 7"),
    _case(dict(cu_size=64, aq_strength=1.0, deblocking=False,
               intra_in_p=True), "IPP", 20, "item 7")])
def test_host_inter_config_encodes_and_decodes(changes, types, tmp_path):
    """Configurations refused until the host P programs and IBP with maps
    were ported (under the ids they had in test_unported_config_raises)
    encode on the CPU, 3 frames (4 with three references) with deblocking
    on unless they set it off, and decode to the port's recon (in display
    order); the fourth frame of the three-reference case codes per-CU
    reference indices."""
    yy, xx = np.mgrid[0:64, 0:64]
    y = (100 + 60 * np.sin(xx / 5.0) + yy).astype(np.uint8)
    y[:16] = 90                                  # a flat band: AQ deltas
    c = np.full((32, 32), 128, np.uint8)
    enc = Encoder(EncoderConfig(**{**_BASE, "deblocking": True,
                                   "reinit_gop_on_scene_change": False,
                                   **changes}), device="cpu")
    descs = []
    emit = enc._pipeline._emit

    def spy(desc, *a, **k):
        descs.append(desc)
        return emit(desc, *a, **k)
    enc._pipeline._emit = spy
    n = len(types)
    efs = [e for t in range(n) for e in enc.encode(np.roll(y, 3 * t, 1),
                                                   c, c)]
    efs += list(enc.flush())
    assert "".join(e.frame_type for e in efs) == types
    if "num_ref_frames" in changes:
        assert [d.ref_idx is not None for d in descs] == [False] * 3 + [True]
    path = tmp_path / "host_inter.265"
    path.write_bytes(b"".join(e.annex_b() for e in efs))
    dec = decode_annexb(path)
    assert len(dec) == n
    for e in efs:
        assert np.array_equal(dec[e.poc], e.recon["y"]), e.poc


@pytest.mark.parametrize("changes,types", [
    # IPPP at CU32 / CU64 without intra_rdo (host fixed-CU32 I frames)
    _lifted(dict(cu_size=32), "IPP", 0),
    _lifted(dict(cu_size=64), "IPP", 3),
    # RD_FULL, the tree with a map and deblocking, intra_rdo at CU16, CU64
    # without intra_rdo: all-intra on the host programs
    _lifted(dict(_TREE, rd_mode=RDMode.RD_FULL), "III", 10),
    _lifted(dict(_TREE, aq_strength=1.0), "III", 11),
    _lifted(dict(gop_size=0, intra_rdo=True), "III", 12),
    _lifted(dict(gop_size=0, cu_size=64), "III", 13),
    # maps with deblocking off and tree I frames, all-intra and IPPP (the
    # CU64 P program with its map)
    _lifted(dict(_TREE, aq_strength=1.0, deblocking=False), "III", 15),
    _lifted(dict(intra_rdo=True, cu_size=64, rc_ctu=True, deblocking=False),
            "IPP", 16)])
def test_host_intra_config_encodes_and_decodes(changes, types, tmp_path):
    """Configurations refused until the host intra programs were ported
    (under the ids they had in test_unported_config_raises) encode on the
    CPU, 3 frames with deblocking on unless they set it off, and decode to
    the port's recon; their I frames take the host route, their P frames
    the device programs."""
    yy, xx = np.mgrid[0:64, 0:64]
    y = (100 + 60 * np.sin(xx / 5.0) + yy).astype(np.uint8)
    y[:16] = 90                                  # a flat band: AQ deltas
    c = np.full((32, 32), 128, np.uint8)
    enc = Encoder(EncoderConfig(**{**_BASE, "deblocking": True,
                                   "reinit_gop_on_scene_change": False,
                                   **changes}), device="cpu")
    efs = [e for t in range(3) for e in enc.encode(np.roll(y, 3 * t, 1),
                                                   c, c)]
    efs += list(enc.flush())
    assert "".join(e.frame_type for e in efs) == types
    assert enc._pipeline._intra_enc is None
    path = tmp_path / "host.265"
    path.write_bytes(b"".join(e.annex_b() for e in efs))
    dec = decode_annexb(path)
    assert len(dec) == 3
    for d, e in zip(dec, efs):
        assert np.array_equal(d, e.recon["y"])


@pytest.mark.parametrize("changes,types", [
    pytest.param(dict(gop_size=0, aq_strength=2.0, num_frames_in_flight=2),
                 ["I"] * 3, id="aq-all-intra"),
    pytest.param(dict(aq_strength=2.0), ["I", "P", "P"], id="aq-ippp"),
    pytest.param(dict(rc_ctu=True, bitrate_mode=BitrateMode.VBR,
                      bitrate_kbps=100), ["I", "P", "P"], id="rc_ctu-vbr"),
    pytest.param(dict(aq_strength=2.0, rc_ctu=True, sao=True, wpp=True,
                      intra_in_p=True, bitrate_mode=BitrateMode.CBR,
                      bitrate_kbps=100), ["I", "P", "P"],
                 id="aq-rc_ctu-cbr-sao-wpp-intra_in_p")])
def test_map_config_encodes_and_decodes(changes, types, tmp_path):
    """Per-CTB QP maps (AQ, row-RC) at CU16 with deblocking off, where the
    JAX package runs them on its device, encode on the CPU (3 frames)
    and decode to the port's recon; the frames carry their maps."""
    yy, xx = np.mgrid[0:64, 0:64]
    y = (100 + 60 * np.sin(xx / 5.0) + yy).astype(np.uint8)
    y[:16] = 90                                  # a flat band: AQ deltas
    c = np.full((32, 32), 128, np.uint8)
    enc = Encoder(EncoderConfig(**{**_BASE, "deblocking": False,
                                   "reinit_gop_on_scene_change": False,
                                   **changes}), device="cpu")
    maps = []
    emit = enc._pipeline._emit

    def spy(desc, *a, **k):
        maps.append(desc.qp_map)
        return emit(desc, *a, **k)
    enc._pipeline._emit = spy
    efs = [e for t in range(3) for e in enc.encode(np.roll(y, 3 * t, 1),
                                                   c, c)]
    efs += list(enc.flush())
    assert [e.frame_type for e in efs] == types
    assert len(maps) == 3 and all(m is not None for m in maps)
    path = tmp_path / "maps.265"
    path.write_bytes(b"".join(e.annex_b() for e in efs))
    dec = decode_annexb(path)
    assert len(dec) == 3
    for d, e in zip(dec, efs):
        assert np.array_equal(d, e.recon["y"])


@pytest.mark.parametrize("changes,types", [
    pytest.param(dict(num_b=1), ["I", "P", "B"], id="num_b1"),
    pytest.param(dict(gpb=True), ["I", "P", "P"], id="gpb"),
    pytest.param(dict(num_ref_frames=2), ["I", "P", "P"],
                 id="num_ref_frames2"),
    pytest.param(dict(intra_rdo=True, cu_size=64, num_b=1),
                 ["I", "P", "B"], id="cu64-num_b1")])
def test_lifted_config_encodes(changes, types):
    """Configurations that raised before B frames and generalized-B were
    ported encode on the CPU, every frame coming out (decode order): IBP
    at CU16 and at CTU 64 (uni-L0 B frames), and gpb / two references at
    CU16, where the JAX package codes plain P frames (it bi-predicts at
    CTU 32 only)."""
    yy, xx = np.mgrid[0:64, 0:64]
    y = (100 + 60 * np.sin(xx / 5.0) + yy).astype(np.uint8)
    c = np.full((32, 32), 128, np.uint8)
    enc = Encoder(EncoderConfig(**{**_BASE, "deblocking": True, **changes}),
                  device="cpu")
    efs = [e for t in range(3) for e in enc.encode(np.roll(y, 3 * t, 1),
                                                   c, c)]
    efs += list(enc.flush())
    assert [e.frame_type for e in efs] == types
    assert sorted(e.poc for e in efs) == [0, 1, 2]
    assert all(e.recon["y"].shape == (64, 64) and len(e.annex_b()) > 0
               for e in efs)


_P = PerformanceMode


@pytest.mark.parametrize("changes", [
    pytest.param(dict(intra_rdo=True, cu_size=cu, sao=True,
                      performance_mode=perf), id=f"cu{cu}-{perf.name}")
    for cu, perf in ((32, _P.FULL_COMPUTATION), (32, _P.FAST),
                     (64, _P.FULL_COMPUTATION), (64, _P.FAST),
                     (64, _P.UFAST))
] + [pytest.param(dict(me_range=64), id="me_range64"),
     pytest.param(dict(intra_in_p=True), id="intra_in_p"),
     pytest.param(dict(intra_rdo=True, cu_size=64, sao=True, me_range=64,
                       intra_in_p=True), id="cu64-far-intra_in_p")])
def test_lifted_config_encodes_and_decodes(changes, tmp_path):
    """Configurations that raised before the CU-tree P program, the FAR
    level and intra-in-P were ported: IPPP at CTU 32 and 64 with
    intra_rdo, deblocking, SAO and sign hiding in every performance mode
    (UFAST at CTU 32 is the FAST program), me_range 64, intra-in-P, and
    both in the CTU-64 tree encode on the CPU (I + 2 P), and the stream
    decodes to the port's recon."""
    yy, xx = np.mgrid[0:64, 0:64]
    y = (100 + 60 * np.sin(xx / 5.0) + yy).astype(np.uint8)
    c = np.full((32, 32), 128, np.uint8)
    cfg = EncoderConfig(**{**_BASE, "deblocking": True, "sign_hiding": True,
                           **changes})
    enc = Encoder(cfg, device="cpu")
    efs = [e for t in range(3) for e in enc.encode(np.roll(y, 3 * t, 1),
                                                   c, c)]
    efs += list(enc.flush())
    assert [e.frame_type for e in efs] == ["I", "P", "P"]
    path = tmp_path / "lifted.265"
    path.write_bytes(b"".join(e.annex_b() for e in efs))
    dec = decode_annexb(path)
    assert len(dec) == 3
    for d, e in zip(dec, efs):
        assert np.array_equal(d, e.recon["y"])


def test_slice_check_reads_the_padded_config():
    """1080p is 1088 lines at CTU 32 and 64: the tree paths (all-intra and
    IPPP) take it, as the JAX package does (its check reads the padded
    config too); SAO on the CU16 paths is covered."""
    for cu in (32, 64):
        Encoder(EncoderConfig(width=1920, height=1080, **{**_TREE,
                                                           "cu_size": cu}),
                device="cpu")
        # BASELINE config 4's IPPP shape
        Encoder(EncoderConfig(width=1920, height=1080, **{
            **_TREE, "cu_size": cu, "gop_size": 1, "sao": True}),
            device="cpu")
    Encoder(EncoderConfig(**{**_BASE, "sao": True}), device="cpu")


def test_encoder_defaults_to_the_card():
    assert inspect.signature(Encoder).parameters["device"].default == "cuda"
    cfg = EncoderConfig(**_BASE)
    if torch.cuda.is_available():
        assert Encoder(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Encoder(cfg)
    assert Encoder(cfg, device="cpu").device.type == "cpu"
    # all-intra ignores the P-frame tools it never runs
    Encoder(EncoderConfig(**{**_BASE, "gop_size": 0, "me_range": 64,
                             "intra_in_p": True}), device="cpu")
