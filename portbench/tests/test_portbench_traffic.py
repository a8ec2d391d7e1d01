"""The traffic generator is a pure function of the traffic file and the
seed, gives every seed the same work in another order, and rebuilds any
image's rows without the table."""

import numpy as np
import pytest
import torch

from conftest import tiny_traffic
from portbench import traffic


def test_same_seed_same_split():
    t = tiny_traffic("train.butd36")
    a, b = traffic.generate(t, 100, 50, 2 ** 33 + 1), traffic.generate(t, 100, 50, 2 ** 33 + 1)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_seeds_share_the_work():
    t = tiny_traffic("eval.butd36")
    a, b = traffic.generate(t, 100, 50, 1), traffic.generate(t, 100, 50, 2)
    assert not np.array_equal(a["questions"], b["questions"])
    assert np.array_equal(np.sort(a["lengths"]), np.sort(b["lengths"]))
    assert np.array_equal(a["image_index"], b["image_index"])
    assert np.all(np.diff(a["image_index"]) >= 0)          # in image order
    assert np.bincount(a["image_index"]).min() >= t["split"]["min_per_image"]
    assert a["lengths"].min() >= 3 and a["lengths"].max() <= 26
    assert np.array_equal((a["questions"] != 0).sum(1), a["lengths"])


def test_vqa_lengths():
    """The full val mix: a normal of mean 6.2 clipped to [3, 26] (the clip
    at 3 lifts the mean to about 6.27)."""
    lengths, image = traffic.lengths_and_images(
        {**tiny_traffic("eval.butd36"), "split": {"questions": 214354, "images": 40504,
                                                   "min_per_image": 3}})
    assert 6.2 < lengths.mean() < 6.3 and lengths.min() == 3
    assert len(image) == 214354 and image.max() == 40503


def test_table_rows_rebuilt_from_the_seed(monkeypatch):
    monkeypatch.setattr(traffic, "CHUNK", 8)   # several chunks over the tiny table
    t = tiny_traffic("eval.butd36")
    table = traffic.make_table(t, 5, "cpu")
    again = traffic.make_table(t, 5, "cpu")
    assert torch.equal(table, again)
    idx = np.array([49, 0, 17, 17, 8])
    assert torch.equal(traffic.image_rows(t, 5, idx, "cpu"), table[torch.from_numpy(idx)])
    assert not torch.equal(traffic.make_table(t, 6, "cpu"), table)


@pytest.mark.parametrize("spec", [
    {"kind": "normal", "mean": 6.2, "sd": 2.2, "min": 3, "max": 26},
    {"kind": "uniform", "min": 5, "max": 26},
    {"kind": "histogram", "lengths": [4, 6, 9], "weights": [20, 70, 10]},
])
def test_each_length_kind_draws_whole_words_in_its_range(spec):
    from portbench import plugins

    draw = plugins.load("lengths", spec["kind"]).draw
    a = draw(spec, 20000, np.random.default_rng(1))
    assert np.array_equal(a, draw(spec, 20000, np.random.default_rng(1)))
    assert a.dtype == np.int32 and len(a) == 20000
    allowed = spec.get("lengths") or range(spec["min"], spec["max"] + 1)
    assert set(np.unique(a)) <= set(allowed)
    if spec["kind"] == "uniform":
        assert set(np.unique(a)) == set(allowed)
    if spec["kind"] == "histogram":
        assert abs((a == 6).mean() - 0.7) < 0.02
