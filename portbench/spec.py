"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

``configs/<config>.json`` (the model section, answer and word counts, the
compute dtype and the optimizer), ``traffic/<traffic>.json`` (split sizes,
lengths, batch, buckets, table), ``limits/<workload>.json`` (the limits of
the numbers that decide ``correct``) and ``metrics/<metric>.py`` (one
reader per per-layer metric, a ``read(run)`` function that returns a number
or None). What those files name is a file too (``plugins``): the model's
architecture and encoder (``reference/archs/<arch>.py``,
``reference/encoders/<seq2vec arch>.py``), the kind of length distribution
(``lengths/<kind>.py``) and of table (``tables/<kind>.py``). A new
configuration, mix, cell, metric, architecture or kind is new files and a
new entry in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, List, Optional

from portbench import plugins

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    moves: Optional[str] = None
    read: Optional[Callable] = None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_reader(name: str, base: str = HERE) -> Callable:
    """``metrics/<name>.py``'s ``read``, under ``base`` or ``portbench/``."""
    plugins.add(base)
    return plugins.load("metrics", name).read


def load_cell(workload: str, bench: Optional[dict] = None, base: str = HERE) -> Cell:
    """The cell ``workload`` of ``bench`` (``BENCHMARK.json`` at the root by
    default) with its files under ``base``."""
    bench = bench if bench is not None else _json(os.path.join(ROOT, "BENCHMARK.json"))
    plugins.add(base)   # the cell's own architectures, encoders, kinds and readers first
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(entries)}")
    w = entries[workload]
    cfg = _json(os.path.join(base, "configs", f"{w['config']}.json"))
    traffic = _json(os.path.join(base, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(base, "limits", f"{workload}.json"))
    e2e = [Metric(m["name"], m["unit"]) for m in bench["end_to_end"] if _reports(m, workload)]
    layer = [Metric(m["name"], m["unit"], m["moves"], load_reader(m["name"], base))
             for m in bench["per_layer"] if _reports(m, workload)]
    return Cell(workload, int(w["chips"]), w["config"], w["traffic"], cfg, traffic, limits,
                e2e, layer)
