"""Nothing of JAX or the JAX package in a run; nothing of the program in
the reference."""

import ast
import os
import sys
import types

from hevcbench import env

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(d):
    for root, _, files in os.walk(d):
        yield from (os.path.join(root, f) for f in files
                    if f.endswith(".py"))


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "homerhevc_tpu_torch_x",
                        types.ModuleType("homerhevc_tpu_torch_x"))
    monkeypatch.setitem(sys.modules, "jaxtyping",
                        types.ModuleType("jaxtyping"))
    assert "homerhevc_tpu" not in env.forbidden_modules()
    assert "jax" not in env.forbidden_modules()
    monkeypatch.setitem(sys.modules, "homerhevc_tpu.api",
                        types.ModuleType("homerhevc_tpu.api"))
    assert "homerhevc_tpu" in env.forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(HERE, "reference")):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("homerhevc_tpu_torch", "homerhevc_tpu",
                               "jax", "jaxlib", "torch"), (path, mod)


def test_the_harness_imports_no_jax():
    for path in _sources(HERE):
        for mod in _imports(path):
            assert mod.split(".")[0] not in env.FORBIDDEN, (path, mod)
