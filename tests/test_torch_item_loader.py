"""The port's per-item loader (vqa_tpu_torch/datasets/vqa2.py: VQA2ItemSource,
item_loader) against the JAX package's Grain adapter (GrainVQA2Source,
grain_loader) on the same fixture, and the port's numpy copy of Grain's
shuffle permutation (datasets/index_shuffle.py) against Grain's compiled
module.

The counterparts of tests/test_grain_loader.py's four tests, each also held
batch for batch (every key, dtype and shape) against grain_loader at the
same arguments: shuffle off and on, seeds 0, 7 and 8 at epochs 0 and 1,
worker_count 0 and 1, the label draws under samplingans, num_epochs 2 and
None.
"""

import os

import numpy as np
import pytest
import torch

from vqa_tpu_torch import config as port_config
from vqa_tpu_torch.datasets import factory as port_factory
from vqa_tpu_torch.datasets.index_shuffle import epoch_permutation, index_shuffle
from vqa_tpu_torch.datasets.vqa2 import VQA2ItemSource, item_loader

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH_OPT = os.path.join(REPO, "options", "vqa2", "concat_att.yaml")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """tests/test_grain_loader.py's fixture (8 images, 48 questions, seed 2,
    20 answers), prepared by the JAX factory and read by both packages.
    Returns a function (split, visual_mode) -> (port dataset, JAX dataset)."""
    from vqa_tpu.config import load_options as jax_load_options
    from vqa_tpu.datasets import factory as jax_factory
    from vqa_tpu_torch.datasets.fixtures import generate

    d = str(tmp_path_factory.mktemp("itemfix"))
    generate(d, n_images=8, n_questions=48, seed=2)
    overrides = [f"vqa.dir={d}/vqa2", f"coco.dir={d}/coco", "vqa.nans=20"]
    jax_opt = jax_load_options(PATH_OPT, overrides)
    port_opt = port_config.load_options(PATH_OPT, overrides)
    jax_factory("val", jax_opt)

    def build(split, visual_mode="gather"):
        return (port_factory.factory(split, port_opt, visual_mode=visual_mode),
                jax_factory(split, jax_opt, visual_mode=visual_mode))

    return build


def _grain(jax_ds, *args, **kwargs):
    from vqa_tpu.datasets.vqa2 import grain_loader

    return grain_loader(jax_ds, *args, **kwargs)


def _assert_same_stream(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert isinstance(g[key], np.ndarray), key
            assert (g[key].dtype, g[key].shape) == (w[key].dtype, w[key].shape), key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    return got


@pytest.mark.parametrize("shuffle", [False, True], ids=["in_order", "shuffled"])
@pytest.mark.parametrize("visual_mode", ["gather", "index"])
def test_item_loader_batches(datasets, shuffle, visual_mode):
    port_ds, jax_ds = datasets("val", visual_mode)
    got = _assert_same_stream(item_loader(port_ds, batch_size=16, shuffle=shuffle, seed=0),
                              _grain(jax_ds, batch_size=16, shuffle=shuffle, seed=0))
    assert len(got) == 3
    if visual_mode == "gather":
        assert got[0]["visual"].shape == (16, 36, 2048)
    else:
        assert got[0]["image_index"].shape == (16,)
    assert got[0]["question"].shape == (16, 26) and got[0]["question"].dtype == np.int32
    assert got[0]["question_id"].dtype == np.int64
    qids = np.concatenate([b["question_id"] for b in got])
    assert len(set(qids.tolist())) == 48
    assert np.array_equal(qids, np.sort(qids)) != shuffle


def test_item_loader_short_last_batch(datasets):
    port_ds, jax_ds = datasets("val")
    got = _assert_same_stream(item_loader(port_ds, 20, shuffle=True, seed=4),
                              _grain(jax_ds, 20, shuffle=True, seed=4))
    assert [len(b["question_id"]) for b in got] == [20, 20, 8]


@pytest.mark.parametrize("epoch", [0, 1])
def test_item_loader_deterministic_shuffle(datasets, epoch):
    port_ds, jax_ds = datasets("val")
    streams = {}
    for seed in (0, 7, 8):
        streams[seed] = np.concatenate([b["question_id"] for b in _assert_same_stream(
            item_loader(port_ds, 16, shuffle=True, seed=seed, epoch=epoch),
            _grain(jax_ds, 16, shuffle=True, seed=seed, epoch=epoch))])
    again = np.concatenate([b["question_id"] for b in item_loader(
        port_ds, 16, shuffle=True, seed=7, epoch=epoch)])
    np.testing.assert_array_equal(streams[7], again)
    assert not np.array_equal(streams[7], streams[8])
    assert not np.array_equal(streams[0], streams[7])


@pytest.mark.parametrize("worker_count", [0, 1])
def test_item_loader_multiprocess_workers(datasets, worker_count):
    """worker_count>0: the per-item source pickles into worker processes and
    the stream matches grain_loader's in-process one."""
    port_ds, jax_ds = datasets("train")
    _assert_same_stream(item_loader(port_ds, 16, shuffle=True, seed=5, worker_count=worker_count),
                        _grain(jax_ds, 16, shuffle=True, seed=5))


def _labels_by_qid(loader):
    out = {}
    for b in loader:
        for qid, ans in zip(b["question_id"].tolist(), b["answer"].tolist()):
            out[qid] = ans
    return out


def test_item_loader_per_epoch_label_resampling(datasets):
    """samplingans on the per-item path re-draws labels per epoch (the
    reference's semantics) while staying deterministic, with grain_loader's
    draws at each (seed, epoch)."""
    port_ds, jax_ds = datasets("train")
    assert port_ds.sampling
    e0 = _labels_by_qid(item_loader(port_ds, 16, seed=3, epoch=0))
    e0_again = _labels_by_qid(item_loader(port_ds, 16, seed=3, epoch=0))
    e1 = _labels_by_qid(item_loader(port_ds, 16, seed=3, epoch=1))
    assert e0 == e0_again == _labels_by_qid(_grain(jax_ds, 16, seed=3, epoch=0))
    assert e1 == _labels_by_qid(_grain(jax_ds, 16, seed=3, epoch=1))
    assert any(e0[q] != e1[q] for q in e0), "labels did not resample across epochs"


@pytest.mark.parametrize("shuffle", [False, True], ids=["in_order", "shuffled"])
def test_item_loader_two_epochs(datasets, shuffle):
    """num_epochs=2: the second epoch re-shuffles ((seed + 1) % 2**32) and a
    batch runs across the epoch boundary, as grain's does."""
    port_ds, jax_ds = datasets("val")
    got = _assert_same_stream(item_loader(port_ds, 20, shuffle=shuffle, seed=6, num_epochs=2),
                              _grain(jax_ds, 20, shuffle=shuffle, seed=6, num_epochs=2))
    qids = np.concatenate([b["question_id"] for b in got])
    assert len(qids) == 96 and sorted(qids[:48]) == sorted(qids[48:])
    assert np.array_equal(qids[:48], qids[48:]) != shuffle


def test_item_loader_without_end(datasets):
    port_ds, jax_ds = datasets("val")
    got = item_loader(port_ds, 16, shuffle=True, seed=2, num_epochs=None)
    want = _grain(jax_ds, 16, shuffle=True, seed=2, num_epochs=None)
    _assert_same_stream((b for b, _ in zip(got, range(7))), (b for b, _ in zip(want, range(7))))
    with pytest.raises(TypeError):
        len(got)


@pytest.mark.parametrize("kwargs", [dict(num_epochs=0), dict(num_epochs=-1)])
def test_item_loader_refusals_match_grain(datasets, kwargs):
    port_ds, jax_ds = datasets("val")
    with pytest.raises(ValueError):
        _grain(jax_ds, 16, **kwargs)
    with pytest.raises(ValueError):
        item_loader(port_ds, 16, **kwargs)


def test_item_source_matches_grain_source(datasets):
    """Per item, sampled labels included, and after a pickle round trip."""
    import pickle

    from vqa_tpu.datasets.vqa2 import GrainVQA2Source

    port_ds, jax_ds = datasets("train")
    got = pickle.loads(pickle.dumps(VQA2ItemSource(port_ds, label_seed=9, epoch=2)))
    want = GrainVQA2Source(jax_ds, label_seed=9, epoch=2)
    assert len(got) == len(want)
    assert not hasattr(got, "set_epoch")
    for idx in range(len(want)):
        g, w = got[idx], want[idx]
        assert sorted(g) == sorted(w)
        for key in w:
            assert (g[key].dtype, np.shape(g[key])) == (w[key].dtype, np.shape(w[key]))
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("seed", [0, 1, 123, 2**31 - 1, 2**32 - 1])
@pytest.mark.parametrize("n", [1, 2, 3, 48, 1000, 65539])
def test_index_shuffle_matches_grains_compiled_module(n, seed):
    from grain._src.python.experimental.index_shuffle.python import (
        index_shuffle_module as compiled,
    )

    got = index_shuffle(np.arange(n), n - 1, seed)
    want = np.fromiter((compiled.index_shuffle(i, max_index=n - 1, seed=seed, rounds=4)
                        for i in range(n)), np.int64, n)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n))
    if n > 2:
        np.testing.assert_array_equal(epoch_permutation(n, seed - 1 if seed else 2**32 - 1, 1),
                                      want)


def test_index_shuffle_rounds_and_wide_ranges():
    """Other round counts, a range past 32 bits, and a scalar index."""
    from grain._src.python.experimental.index_shuffle.python import (
        index_shuffle_module as compiled,
    )

    for rounds in (6, 8):
        got = index_shuffle(np.arange(300), 299, 11, rounds)
        want = [compiled.index_shuffle(i, max_index=299, seed=11, rounds=rounds)
                for i in range(300)]
        np.testing.assert_array_equal(got, want)
    for max_index in (2**16, 2**33 + 5, 2**62 + 1):
        idx = np.arange(0, 4000, 7) * (max_index // 4000)
        want = [compiled.index_shuffle(int(i), max_index=max_index, seed=3, rounds=4)
                for i in idx]
        np.testing.assert_array_equal(index_shuffle(idx, max_index, 3), want)
    assert int(index_shuffle(5, 47, 123)) == compiled.index_shuffle(5, max_index=47, seed=123,
                                                                    rounds=4)
    with pytest.raises(ValueError):
        index_shuffle(0, 47, 1, rounds=3)
