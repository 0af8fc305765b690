"""The port stands alone: no module of homerhevc_tpu_torch and no line of
chip_smoke.py imports jax or the JAX package; a 64x64 I + P encode and an
intra CU-tree encode, both with SAO, run with both blocked; every
configuration outside the port's slices raises NotImplementedError when
the Encoder is built (there is no golden fallback); the Encoder defaults
to the card."""

import ast
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import EncoderConfig, RDMode

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


def test_no_source_imports_jax_or_the_jax_package():
    found = []
    for path in _sources():
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
        "                  ['I', 'I'])):\n"
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
    env = dict(os.environ, PYTHONPATH=_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


_BASE = dict(width=64, height=64, cu_size=16, gop_size=1, qp=32, sao=False)


_TREE = dict(gop_size=0, cu_size=32, intra_rdo=True)


@pytest.mark.parametrize("changes,item", [
    (dict(cu_size=32), "item 1"),
    (dict(num_b=1), "item 5"),
    (dict(gpb=True), "item 5"),
    (dict(me_range=64), "item 2"),
    (dict(intra_in_p=True), "item 3"),
    (dict(aq_strength=1.0), "item 4"),
    (dict(rc_ctu=True), "item 4"),
    (dict(intra_rdo=True, cu_size=32), "item 1"),
    (dict(num_ref_frames=2), "item 5"),
    (dict(num_devices=2), "item 6"),
    (dict(_TREE, rd_mode=RDMode.RD_FULL), "item 7"),
    (dict(_TREE, aq_strength=1.0), "item 4"),
    (dict(gop_size=0, intra_rdo=True), "item 7"),
    (dict(gop_size=0, cu_size=64), "item 7")])
def test_unported_config_raises(changes, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        Encoder(EncoderConfig(**{**_BASE, **changes}), device="cpu")


def test_slice_check_reads_the_padded_config():
    """1080p is 1088 lines at CTU 32 and 64: the tree path takes it, as
    the JAX package does (its check reads the padded config too); SAO on
    the CU16 paths is covered."""
    for cu in (32, 64):
        Encoder(EncoderConfig(width=1920, height=1080, **{**_TREE,
                                                           "cu_size": cu}),
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
