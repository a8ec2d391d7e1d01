"""Every cell, configuration, mix and per-layer metric of BENCHMARK.json is
found by its name, and a new one is new files and a new entry only."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT, _json, tiny_harness
from portbench.spec import load_cell

BENCH = _json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads(workload):
    cell = load_cell(workload)
    assert cell.traffic["kind"] in ("eval", "train")
    assert set(cell.limits) and all(isinstance(v, (int, float)) for v in cell.limits.values())
    assert "setup_s" in [m.name for m in cell.end_to_end] and len(cell.end_to_end) >= 2
    assert cell.per_layer and all(callable(m.read) for m in cell.per_layer)
    for m in cell.per_layer:
        assert m.moves in [e.name for e in cell.end_to_end]
    # what the cell's files name is a file too
    from portbench import plugins
    from portbench.reference import models

    assert callable(plugins.load("lengths", cell.traffic["length"]["kind"]).draw)
    assert callable(plugins.load("tables", cell.traffic["table"]["kind"]).make)
    assert callable(models.arch(cell.cfg).forward) and callable(models.encoder(cell.cfg).encode)


def test_config_files_are_the_named_ones():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_a_new_cell_is_new_files(tmp_path):
    """A configuration, a mix, a cell's limits and a per-layer metric added
    as files under a base, and a workload entry: the harness finds them all
    and a run reports the new metric."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        (tmp_path / sub).mkdir()
    from conftest import tiny_config, tiny_traffic

    (tmp_path / "configs" / "newcfg.json").write_text(json.dumps(tiny_config("mutan_att")))
    (tmp_path / "traffic" / "newmix.json").write_text(json.dumps(tiny_traffic("eval.butd36")))
    (tmp_path / "limits" / "newcfg.newmix.json").write_text(
        json.dumps({"logit_gap": 1.0, "unanswered": 0}))
    (tmp_path / "metrics" / "questions_per_epoch.eval.py").write_text(
        "def read(run):\n    return run.questions / max(len(run.epoch_tails), 1)\n")
    bench = {"workloads": [{"name": "newcfg.newmix", "config": "newcfg", "traffic": "newmix",
                            "chips": 1, "why": "new"}],
             "end_to_end": [{"name": "eval_qa_per_s", "unit": "QA/s", "source": "host_clock"},
                            {"name": "setup_s", "unit": "s", "source": "host_clock"}],
             "per_layer": [{"name": "questions_per_epoch.eval", "unit": "questions",
                            "source": "program_counter", "moves": "eval_qa_per_s"}]}
    h = tiny_harness((str(tmp_path), bench), "newcfg.newmix")
    h.setup()
    h.window(0.0)
    from portbench.run import result

    h.free_program()
    h.check()
    line = result(h, trace=False)
    assert set(line["metrics"]) == {"eval_qa_per_s", "setup_s"}
    assert h.cell.per_layer[0].read(h.run) == 300


# an architecture the benchmark's reference does not have: MutanNoAtt
# (options/vqa2/mutan_noatt.yaml), the question fused with the mean of the
# regions by MUTAN, then the classifier
NOATT_ARCH = """
from portbench.reference import params as P_
from portbench.reference.models import dense, mutan


def params(cfg, dim_q, dim_v):
    fus = cfg["model"]["fusion"]
    return (P_.mutan("fusion", dim_q, dim_v, fus)
            + P_.dense("classifier/logits", fus["dim_mm"], cfg["num_answers"]))


def forward(cfg, P, q, visual, drop, p):
    fus = cfg["model"]["fusion"]
    z = mutan(P, "fusion", fus, q, p.st(visual.mean(dim=1)), drop, p)
    return dense(P, "classifier/logits", drop(z, cfg["model"]["classif"]["dropout"]), p)


def products(cfg, regions, dim_q, dim_v):
    fus = cfg["model"]["fusion"]
    rm = fus["R"] * fus["dim_mm"]
    return [(2.0 * dim_q * fus["dim_hq"], 2), (2.0 * dim_v * fus["dim_hv"], 1),
            (2.0 * fus["dim_hq"] * rm, 2), (2.0 * fus["dim_hv"] * rm, 2),
            (2.0 * fus["dim_mm"] * cfg["num_answers"], 2)]
"""

# a kind of length distribution: every question one of two lengths
TWO_LENGTHS = """
import numpy as np


def draw(spec, n, rng):
    return np.where(rng.random(n) < spec["share_long"], spec["long"], spec["short"]).astype(np.int32)
"""

# a kind of table: int8 rows under one float32 scale a region (the
# program's ``features_dtype: int8`` layout, gathered by
# ``gather_rows_dequant``)
INT8_ROWS = """
import numpy as np
import torch

from portbench import traffic as traffic_lib


def _quantize(rows):
    scales = rows.float().abs().amax(-1, keepdim=True) / 127.0 + 1e-12
    return torch.clamp(torch.round(rows.float() / scales), -127, 127).to(torch.int8), scales


def make(traffic, seed, device, mesh=None):
    return _quantize(traffic_lib.make_table(traffic, seed, device))


def rows(traffic, seed, images, device, table=None):
    values, scales = _quantize(traffic_lib.image_rows(traffic, seed, images, device))
    return values.float() * scales
"""


def test_a_new_architecture_length_kind_and_table_kind_are_new_files(tmp_path, monkeypatch):
    """A model architecture the reference lacks, a kind of length
    distribution and a kind of table, each a new file under a cell's base
    (``reference/archs/``, ``lengths/``, ``tables/``) beside its
    configuration, mix and limits: the run finds them by the names in those
    files, counts the new architecture's FLOPs, draws the new lengths,
    serves the new table, and its answers hold against the new reference."""
    from conftest import tiny_config, tiny_traffic
    from portbench import flops, plugins
    from portbench.run import result

    monkeypatch.setattr(plugins, "PATH", list(plugins.PATH))
    for sub in ("configs", "traffic", "limits", "metrics", "reference/archs", "lengths",
                "tables"):
        (tmp_path / sub).mkdir(parents=True)
    (tmp_path / "reference/archs/MutanNoAtt.py").write_text(NOATT_ARCH)
    (tmp_path / "lengths/two_lengths.py").write_text(TWO_LENGTHS)
    (tmp_path / "tables/int8_rows.py").write_text(INT8_ROWS)
    cfg = tiny_config("mutan_att")
    cfg["model"]["arch"] = "MutanNoAtt"
    del cfg["model"]["attention"]
    (tmp_path / "configs" / "noatt.json").write_text(json.dumps(cfg))
    t = tiny_traffic("eval.butd36")
    t["length"] = {"kind": "two_lengths", "short": 4, "long": 11, "share_long": 0.25,
                   "draw_seed": 3}
    t["table"] = {**t["table"], "kind": "int8_rows"}
    (tmp_path / "traffic" / "twolen.json").write_text(json.dumps(t))
    # the tiny MutanAtt cell's limits (conftest.TINY_LIMITS)
    (tmp_path / "limits" / "noatt.twolen.json").write_text(
        json.dumps({"logit_gap": 0.012, "mean_gap": 1e-4, "unanswered": 0}))
    bench = {"workloads": [{"name": "noatt.twolen", "config": "noatt", "traffic": "twolen",
                            "chips": 1, "why": "new"}],
             "end_to_end": [{"name": "eval_qa_per_s", "unit": "QA/s", "source": "host_clock"},
                            {"name": "setup_s", "unit": "s", "source": "host_clock"}],
             "per_layer": []}
    h = tiny_harness((str(tmp_path), bench), "noatt.twolen")
    h.setup()
    assert set(np.unique(h.data["lengths"])) == {4, 11}
    assert isinstance(h.table, tuple) and h.table[0].dtype == torch.int8
    assert flops.question_flops(cfg, 4, 4, 16) == (2 * 4 * 16 * 128 + 2 * 3 * 32 * 128
                                                    + 2 * 32 * 12 + 2 * 16 * 12
                                                    + 2 * 12 * 32 + 2 * 12 * 32 + 2 * 16 * 50)
    h.window(0.0)
    h.free_program()
    h.check()
    line = result(h, trace=False)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 300
