"""Nothing under portbench/ imports JAX, the JAX package or grain, compared
by whole top-level name (``vqa_tpu_torch`` begins with ``vqa_tpu``), and the
reference imports nothing of the program."""

import ast
import os
import sys

from conftest import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "grain", "vqa_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere():
    found = {(p, m) for p in _sources() for m in _imports(p)
             if m.split(".")[0] in FORBIDDEN}
    assert not found
    # a prefix match would be wrong: the program's name begins with the JAX package's
    assert any(m.split(".")[0] == "vqa_tpu_torch" for p in _sources() for m in _imports(p))


def test_the_reference_takes_nothing_of_the_program():
    found = {(p, m) for p in _sources("reference") for m in _imports(p)
             if m.split(".")[0] in FORBIDDEN | {"vqa_tpu_torch"}}
    assert not found


def test_the_run_checks_loaded_modules_by_whole_name(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "vqa_tpu_torch_probe", object())
    assert "vqa_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
