"""The port stands alone: no module of homerhevc_tpu_torch and no line of
chip_smoke.py imports jax or the JAX package; a 64x64 I + P encode runs
with both blocked; every configuration outside the port's slice raises
NotImplementedError when the Encoder is built (there is no golden
fallback); the Encoder defaults to the card."""

import ast
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from homerhevc_tpu_torch.api import Encoder
from homerhevc_tpu_torch.config import EncoderConfig

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
        "cfg = EncoderConfig(width=64, height=64, cu_size=16, gop_size=1,\n"
        "                    qp=32, sao=False)\n"
        "enc = Encoder(cfg, device='cpu')\n"
        "yy, xx = np.mgrid[0:64, 0:64]\n"
        "y = (100 + 60 * np.sin(xx / 5.0) + yy).astype(np.uint8)\n"
        "c = np.full((32, 32), 128, np.uint8)\n"
        "efs = list(enc.encode(y, c, c))\n"
        "efs += list(enc.encode(np.roll(y, 2, 1), c, c))\n"
        "efs += list(enc.flush())\n"
        "assert [e.frame_type for e in efs] == ['I', 'P']\n"
        "assert all(len(e.annex_b()) > 0 for e in efs)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


_BASE = dict(width=64, height=64, cu_size=16, gop_size=1, qp=32, sao=False)


@pytest.mark.parametrize("changes,item", [
    (dict(sao=True), "item 1"),
    (dict(cu_size=32), "items 2 and 3"),
    (dict(num_b=1), "item 7"),
    (dict(gpb=True), "item 7"),
    (dict(me_range=64), "item 4"),
    (dict(intra_in_p=True), "item 5"),
    (dict(aq_strength=1.0), "item 6"),
    (dict(rc_ctu=True), "item 6"),
    (dict(intra_rdo=True, cu_size=32), "items 2 and 3"),
    (dict(num_ref_frames=2), "item 7"),
    (dict(num_devices=2), "item 8")])
def test_unported_config_raises(changes, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        Encoder(EncoderConfig(**{**_BASE, **changes}), device="cpu")


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
