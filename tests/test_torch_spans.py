"""The port's spans (``vqa_tpu_torch/utils/spans.py``) in an eval epoch of a
tiny MutanAtt over a fixture, on the CPU, with and without the loader's
producer thread.

With no profiler running the epoch creates no ``record_function``. Under
``torch.profiler`` it records, on the main thread, one
``vqa_tpu_torch.loader.take`` before each batch's
``vqa_tpu_torch.eval.step``, then one ``vqa_tpu_torch.eval.readback`` after
every step and one ``vqa_tpu_torch.eval.results`` after the readback.
"""

import dataclasses
import json
import os
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vqa_tpu_torch.config import load_options
from vqa_tpu_torch.datasets import factory as port_factory
from vqa_tpu_torch.datasets.fixtures import generate
from vqa_tpu_torch.datasets.pipeline import BatchIterator
from vqa_tpu_torch.engine import engine as port_engine
from vqa_tpu_torch.engine.steps import make_eval_step
from vqa_tpu_torch.models.factory import factory as model_factory

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH_OPT = os.path.join(REPO, "options", "vqa2", "mutan_att.yaml")
TINY = ["vqa.nans=12", "model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=16",
        "model.attention.dim_hv=8", "model.attention.dim_hq=8", "model.attention.dim_mm=8",
        "model.attention.R=2", "model.fusion.dim_hv=8", "model.fusion.dim_hq=8",
        "model.fusion.dim_mm=8", "model.fusion.R=2"]
BATCH = 16
SPANS = ("vqa_tpu_torch.loader.take", "vqa_tpu_torch.eval.step",
         "vqa_tpu_torch.eval.readback", "vqa_tpu_torch.eval.results")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """44 val questions (three batches of 16, the last padded) and a tiny
    MutanAtt with its initial weights."""
    d = str(tmp_path_factory.mktemp("torch_spans"))
    generate(d, n_images=8, n_questions=44, seed=4, splits=("train", "val"))
    opt = load_options(PATH_OPT, [f"vqa.dir={d}/vqa2", f"coco.dir={d}/coco"] + TINY)
    ds = port_factory.factory("val", opt)
    model = model_factory(dataclasses.asdict(opt.model), ds.num_words, ds.num_answers,
                          dim_v=ds.feature_shape[-1]).eval()
    return ds, model


def _epoch(fixture, prefetch):
    """One eval epoch through ``validate``; the loader's batches and the
    results rows."""
    ds, model = fixture
    loader = BatchIterator(ds, BATCH, shuffle=False, pad_last=True, sort_by_length=True,
                           length_buckets=(7, 13, 26), prefetch=prefetch,
                           transform=port_engine.make_device_transform("cpu"))
    _, rows = port_engine.validate(loader, model, make_eval_step(), ds.vocabs.aid_to_ans,
                                   None, 0)
    return loader.steps_per_epoch(), rows


@pytest.mark.parametrize("prefetch", [2, 0], ids=["producer_thread", "inline"])
def test_no_profiler_creates_no_record_function(fixture, prefetch, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function created with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _, rows = _epoch(fixture, prefetch)
    assert len(rows) == len(fixture[0])


@pytest.mark.parametrize("prefetch", [2, 0], ids=["producer_thread", "inline"])
def test_a_profiled_epoch_records_its_spans_in_order(fixture, prefetch, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batches, rows = _epoch(fixture, prefetch)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"] in SPANS), key=lambda e: float(e["ts"]))
    assert len(rows) == len(fixture[0]) and batches == 3
    assert {e["tid"] for e in spans} == {threading.main_thread().native_id}
    names = [e["name"][len("vqa_tpu_torch."):] for e in spans]
    assert names == ["loader.take", "eval.step"] * batches + ["eval.readback", "eval.results"]
    end = [float(e["ts"]) + float(e["dur"]) for e in spans]
    assert all(a <= float(e["ts"]) for a, e in zip(end, spans[1:]))   # none overlaps the next
