"""The benchmark's parts that are files found by name.

``load(kind, name)`` is the module ``<base>/<kind>/<name>.py`` of the first
base on ``PATH`` that holds it (``portbench/`` by default; ``spec.load_cell``
puts a cell's own base in front). The kinds:

- ``metrics``: one per-layer metric, ``read(run)``;
- ``reference/archs``: one model architecture by its ``model.arch`` (its
  parameters, its plain forward and its matrix products);
- ``reference/encoders``: one question encoder by its ``seq2vec.arch``;
- ``lengths``: one kind of question-length distribution, ``draw``;
- ``tables``: one kind of feature table, ``make`` and ``rows``.

Nothing here imports the program.
"""

from __future__ import annotations

import importlib.util
import os
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
PATH: List[str] = [HERE]
_LOADED: Dict[str, ModuleType] = {}


def add(base: str) -> None:
    """Search ``base`` before the bases already on ``PATH``."""
    base = os.path.abspath(base)
    if base not in PATH:
        PATH.insert(0, base)


def load(kind: str, name: str) -> ModuleType:
    for base in PATH:
        path = os.path.join(base, kind, f"{name}.py")
        if os.path.exists(path):
            break
    else:
        known = sorted({f[:-3] for base in PATH if os.path.isdir(os.path.join(base, kind))
                        for f in os.listdir(os.path.join(base, kind)) if f.endswith(".py")})
        raise KeyError(f"no {kind}/{name}.py under {PATH}; known: {known}")
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            "portbench_" + f"{kind}_{name}".replace("/", "_").replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]
