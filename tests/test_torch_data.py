"""The port's data layer against the JAX package's, on the JAX fixture
generator's raw files.

Prep: the port's run_prep writes the same artifacts as vqa_tpu's on copies
of the same raw files: vocab.json byte for byte, each processed split array
by array (values, dtype and shape: the .npz files are zips with timestamps),
and the interim json. The dataset's batches, the BatchIterator's batch
stream (shuffled, length-sorted and bucketed, bucket-windowed, padded,
dropped, sharded) and the feature store's reads equal the originals'.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from vqa_tpu_torch import config as port_config
from vqa_tpu_torch.datasets import features as port_features
from vqa_tpu_torch.datasets import factory as port_factory
from vqa_tpu_torch.datasets import pipeline as port_pipeline
from vqa_tpu_torch.datasets import processed as port_processed

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH_OPT = os.path.join(REPO, "options", "vqa2", "mutan_att.yaml")
SUBDIR = {"VQA2": "vqa2", "VQA": "vqa1", "COCOQA": "cocoqa", "TDIUC": "tdiuc"}


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """One fixture per dataset: {dataset: the fixture's root dir}."""
    from vqa_tpu.datasets.fixtures import generate

    roots = {}
    for i, dataset in enumerate(SUBDIR):
        d = str(tmp_path_factory.mktemp(f"raw_{SUBDIR[dataset]}"))
        generate(d, n_images=6, n_questions=40, seed=20 + i, dataset=dataset)
        roots[dataset] = d
    return roots


def _both_options(overrides):
    from vqa_tpu.config import load_options as jax_load_options

    return (jax_load_options(PATH_OPT, overrides),
            port_config.load_options(PATH_OPT, overrides))


def _assert_same_tree(port_dir, jax_dir):
    """Every file under the two dirs: json byte-equal, npz array by array."""
    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    assert files(port_dir) == files(jax_dir)
    assert files(port_dir)
    for rel in files(jax_dir):
        a, b = os.path.join(port_dir, rel), os.path.join(jax_dir, rel)
        if rel.endswith(".npz"):
            with np.load(a) as got, np.load(b) as want:
                assert sorted(got.files) == sorted(want.files), rel
                for key in want.files:
                    assert got[key].dtype == want[key].dtype, (rel, key)
                    assert got[key].shape == want[key].shape, (rel, key)
                    np.testing.assert_array_equal(got[key], want[key], err_msg=f"{rel}:{key}")
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


# (dataset, splits, extra overrides)
PREP_CASES = {
    "vqa2": ("VQA2", ("train", "val", "test", "testdev"), []),
    "vqa2_trainval": ("VQA2", ("train", "val", "test", "testdev"), ["vqa.trainsplit=trainval"]),
    "vqa2_augment": ("VQA2", ("train", "val"), ["augment"]),
    "vqa2_left_naive_minw1": ("VQA2", ("train", "val"),
                              ["vqa.pad=left", "vqa.nlp=naive", "vqa.minwcount=1",
                               "vqa.maxlength=5"]),
    "vqa1": ("VQA", ("train", "val", "test", "testdev"), []),
    "cocoqa": ("COCOQA", ("train", "val"), []),
    "tdiuc": ("TDIUC", ("train", "val"), []),
}


@pytest.mark.parametrize("case", list(PREP_CASES))
def test_run_prep_writes_the_jax_prep_artifacts(raw, tmp_path, case):
    from vqa_tpu.datasets.processed import run_prep as jax_run_prep

    dataset, splits, extra = PREP_CASES[case]
    overrides = [f"vqa.dataset={dataset}", "vqa.nans=12"]
    if extra == ["augment"]:
        aug = tmp_path / "vg"
        aug.mkdir()
        (aug / "vg_qa.json").write_text(json.dumps([
            {"image_name": "COCO_train2014_000000000001", "question": f"what is thing {i}?",
             "answer": ["red", "blue", "zebra"][i % 3]} for i in range(7)]))
        extra = [f"vqa.augment_dir={aug}"]
    jax_opt, port_opt = _both_options(overrides + extra)
    roots = {}
    for side in ("port", "jax"):
        roots[side] = str(tmp_path / side)
        shutil.copytree(os.path.join(raw[dataset], SUBDIR[dataset], "raw"),
                        os.path.join(roots[side], "raw"))
    got = port_processed.run_prep(roots["port"], port_opt.vqa, splits)
    want = jax_run_prep(roots["jax"], jax_opt.vqa, splits)
    assert os.path.relpath(got, roots["port"]) == os.path.relpath(want, roots["jax"])
    _assert_same_tree(roots["port"], roots["jax"])
    vocabs = port_processed.load_vocabs(got)
    assert vocabs.num_answers <= 12 and vocabs.wid_to_word[:2] == ["<pad>", "<unk>"]


def test_run_prep_refuses_missing_train_split_as_the_original(tmp_path):
    from vqa_tpu.datasets.processed import run_prep as jax_run_prep

    jax_opt, port_opt = _both_options([])
    with pytest.raises(FileNotFoundError) as want:
        jax_run_prep(str(tmp_path), jax_opt.vqa, ("val",))
    with pytest.raises(FileNotFoundError) as got:
        port_processed.run_prep(str(tmp_path), port_opt.vqa, ("val",))
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def datasets(raw):
    """The VQA2 fixture prepared by the JAX factory; each package's factory
    then reads the same processed files. Returns a function (split,
    visual_mode) -> (port dataset, JAX dataset)."""
    from vqa_tpu.datasets import factory as jax_factory

    d = raw["VQA2"]
    jax_opt, port_opt = _both_options([f"vqa.dir={d}/vqa2", f"coco.dir={d}/coco",
                                       "vqa.nans=12"])
    jax_factory("val", jax_opt)

    def build(split, visual_mode="gather"):
        return (port_factory.factory(split, port_opt, visual_mode=visual_mode),
                jax_factory(split, jax_opt, visual_mode=visual_mode))

    return build


def _assert_same_batch(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("split,visual_mode", [("val", "gather"), ("train", "gather"),
                                               ("train", "index"), ("testdev", "index")])
def test_dataset_batch_matches_jax(datasets, split, visual_mode):
    """``train`` samples its labels from the annotators' answers
    (samplingans); ``val`` takes the consensus; ``testdev`` has none."""
    port_ds, jax_ds = datasets(split, visual_mode)
    assert port_ds.sampling == jax_ds.sampling == (split == "train")
    assert (len(port_ds), port_ds.num_words, port_ds.num_answers, port_ds.feature_shape) == \
        (len(jax_ds), jax_ds.num_words, jax_ds.num_answers, jax_ds.feature_shape)
    idx = np.random.default_rng(1).integers(0, len(jax_ds), 23)
    for seed in (None, 5):
        def rng():
            return None if seed is None else np.random.default_rng(seed)

        _assert_same_batch(port_ds.batch(idx, rng=rng()), jax_ds.batch(idx, rng=rng()))


LOADER_CASES = {
    "plain": dict(),
    "shuffle": dict(shuffle=True, seed=3),
    "eval_buckets_pad_last": dict(sort_by_length=True, length_buckets=(4, 7, 13), pad_last=True),
    "bucket_window_drop_last": dict(shuffle=True, seed=1, bucket_window=2,
                                    length_buckets=(7, 13), drop_last=True),
    "bucket_window": dict(shuffle=True, seed=2, bucket_window=3, length_buckets=(7,)),
    "pad_last": dict(pad_last=True),
    "pad_last_beyond_the_split": dict(pad_last=True, batch_size=64),
    "drop_last": dict(shuffle=True, drop_last=True),
    "shard_1_of_2": dict(shuffle=True, shard_index=1, shard_count=2),
    "shard_0_of_2_even": dict(shuffle=True, shard_index=0, shard_count=2, shard_even=True),
    "no_prefetch": dict(shuffle=True, prefetch=0),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_batch_iterator_stream_matches_jax(datasets, case):
    """Two epochs of the train split (labels sampled from the epoch's rng):
    the same batches, in the same order, through the background thread."""
    from vqa_tpu.datasets.pipeline import BatchIterator as JaxBatchIterator

    port_ds, jax_ds = datasets("train")
    kwargs = {"batch_size": 7, **LOADER_CASES[case]}
    got_it = port_pipeline.BatchIterator(port_ds, **kwargs)
    want_it = JaxBatchIterator(jax_ds, **kwargs)
    assert got_it.steps_per_epoch() == want_it.steps_per_epoch()
    for epoch in (0, 1):
        got, want = list(got_it.epoch(epoch)), list(want_it.epoch(epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_same_batch(g, w)


def test_batch_iterator_transform_runs_on_the_stream(datasets):
    port_ds, _ = datasets("val")
    it = port_pipeline.BatchIterator(port_ds, 8, pad_last=True,
                                     transform=lambda b: {"n": len(b["question_id"])})
    assert [b["n"] for b in it.epoch(0)] == [8] * it.steps_per_epoch()


@pytest.mark.parametrize("kwargs", [dict(drop_last=True, pad_last=True),
                                    dict(sort_by_length=True, shuffle=True),
                                    dict(bucket_window=2),
                                    dict(shard_index=2, shard_count=2)])
def test_batch_iterator_refusals_match_jax(datasets, kwargs):
    from vqa_tpu.datasets.pipeline import BatchIterator as JaxBatchIterator

    port_ds, jax_ds = datasets("val")
    with pytest.raises(ValueError) as want:
        JaxBatchIterator(jax_ds, 4, **kwargs)
    with pytest.raises(ValueError) as got:
        port_pipeline.BatchIterator(port_ds, 4, **kwargs)
    assert str(got.value) == str(want.value)


def test_epoch_order_and_bucket_ladder_match_jax():
    from vqa_tpu.datasets.pipeline import epoch_order, normalize_buckets

    for n, seed, epoch, shuffle in ((0, 0, 0, True), (17, 0, 0, False), (17, 3, 1, True),
                                    (1000, 4, 0, True), (1000, 3, 1, True)):
        got = port_pipeline.epoch_order(n, seed, epoch, shuffle)
        want = epoch_order(n, seed, epoch, shuffle)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # (seed, epoch) is keyed without collisions: (3, 1) is not (4, 0)
    assert not np.array_equal(port_pipeline.epoch_order(50, 3, 1, True),
                              port_pipeline.epoch_order(50, 4, 0, True))
    for buckets, maxlength in (((7, 13), 26), ((7, 13, 26), 26), ((30,), 26), ((), 5)):
        assert port_pipeline.normalize_buckets(buckets, maxlength) == \
            normalize_buckets(buckets, maxlength)
    for bad in ((0, 7), (13, 7), (7, 7)):
        with pytest.raises(ValueError) as want:
            normalize_buckets(bad, 26)
        with pytest.raises(ValueError) as got:
            port_pipeline.normalize_buckets(bad, 26)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cache", ["ram", "h5"])
def test_feature_store_reads_the_fixture_as_the_original(raw, cache):
    from vqa_tpu.datasets.features import FeatureStore as JaxFeatureStore

    args = (os.path.join(raw["VQA2"], "coco"), "bottomup36", "att", cache)
    got, want = port_features.FeatureStore(*args), JaxFeatureStore(*args)
    try:
        assert (len(got), got.shape, got.dtype, got.feature_shape) == \
            (len(want), want.shape, want.dtype, want.feature_shape)
        assert got.names == want.names
        names = want.names[::-3] + want.names[:2]
        np.testing.assert_array_equal(got.index_of(names), want.index_of(names))
        assert got.index_of(names).dtype == want.index_of(names).dtype
        idx = np.array([3, 0, 3, 7, 1, 1])
        np.testing.assert_array_equal(got.get(idx), want.get(idx))
        np.testing.assert_array_equal(got.as_array(), want.as_array())
        with pytest.raises(KeyError, match="no-such-image"):
            got.index_of(["no-such-image"])
    finally:
        got.close()
        want.close()
    with pytest.raises(FileNotFoundError, match="feature table"):
        port_features.FeatureStore(str(raw["VQA2"]), "bottomup36", "att", cache)


def test_feature_store_in_memory_and_write_features(raw, tmp_path):
    """The in-memory store (for a machine without h5py) reads as the file
    store over the same table; a table written by the port's write_features
    reads back through the original's store."""
    from vqa_tpu.datasets.features import FeatureStore as JaxFeatureStore

    store = port_features.FeatureStore(os.path.join(raw["VQA2"], "coco"), "bottomup36", "att")
    table = store.as_array()
    mem = port_features.FeatureStore.in_memory(store.names, table)
    idx = np.array([5, 2, 2, 0])
    assert (mem.names, mem.feature_shape, len(mem)) == (store.names, store.feature_shape,
                                                        len(store))
    np.testing.assert_array_equal(mem.index_of(store.names), store.index_of(store.names))
    np.testing.assert_array_equal(mem.get(idx), store.get(idx))
    with pytest.raises(ValueError, match="names for"):
        port_features.FeatureStore.in_memory(store.names[:-1], table)

    port_features.write_features(str(tmp_path), "grid", "att", store.names[::-1], table[::-1])
    back = JaxFeatureStore(str(tmp_path), "grid", "att")
    assert back.names == store.names[::-1]
    np.testing.assert_array_equal(back.as_array(), table[::-1])
