"""Dataset factory, a copy of ``vqa_tpu/datasets/factory.py`` (the port
imports nothing of the JAX package).

``factory(split, opt)`` returns a ready VQA2Dataset, running the port's
raw->interim->processed prep (``processed.run_prep``) on first use. Feature
stores are cached per (coco dir, arch, mode, cache mode) in ``_STORE_CACHE``;
a caller without h5py stands a ``FeatureStore.in_memory`` there first with
``place_store`` (and takes it away with ``drop_stores``).
"""

from __future__ import annotations

import os
from typing import Dict

from vqa_tpu_torch.config import Options
from vqa_tpu_torch.datasets.features import FeatureStore
from vqa_tpu_torch.datasets.interim import RAW_FILES_BY_DATASET
from vqa_tpu_torch.datasets.processed import load_split, load_vocabs, processed_dir, run_prep
from vqa_tpu_torch.datasets.vqa2 import VQA2Dataset

_STORE_CACHE: Dict[tuple, FeatureStore] = {}


def _store_key(coco_dir: str, arch: str, mode: str, cache: str = "ram") -> tuple:
    return (os.path.normpath(coco_dir), arch, mode, cache)


def place_store(coco_dir: str, arch: str, mode: str, store: FeatureStore) -> tuple:
    """Stand ``store`` where ``factory`` looks for the ``<coco_dir>/extract/
    <arch>_<mode>.h5`` table (its default ``feature_cache='ram'``), so a
    dataset reads it in place of the HDF5 file; returns its cache key."""
    key = _store_key(coco_dir, arch, mode)
    _STORE_CACHE[key] = store
    return key


def drop_stores(coco_dir: str) -> None:
    """Forget every store cached for ``coco_dir``, placed or opened."""
    coco_dir = os.path.normpath(coco_dir)
    for key in [k for k in _STORE_CACHE if k[0] == coco_dir]:
        del _STORE_CACHE[key]


def _feature_store(opt: Options, cache: str = "ram") -> FeatureStore:
    key = _store_key(opt.coco.dir, opt.coco.arch, opt.coco.mode, cache)
    if key not in _STORE_CACHE:
        _STORE_CACHE[key] = FeatureStore(opt.coco.dir, opt.coco.arch, opt.coco.mode, cache)
    return _STORE_CACHE[key]


def factory(
    split: str, opt: Options, feature_cache: str = "ram", visual_mode: str = "gather"
) -> VQA2Dataset:
    dataset = opt.vqa.dataset
    if dataset not in ("VQA2", "VQA", "COCOQA", "TDIUC"):
        raise NotImplementedError(
            f"dataset {dataset!r}; known: VQA2 (graded target), VQA (v1), COCOQA, "
            "TDIUC (SURVEY.md C24) — new adapters plug in via datasets/interim.py"
        )
    dir_proc = processed_dir(opt.vqa.dir, opt.vqa)
    if not os.path.exists(os.path.join(dir_proc, f"{split}.npz")):
        if dataset == "COCOQA":
            present = [
                s for s in ("train", "val")
                if os.path.exists(
                    os.path.join(
                        opt.vqa.dir, "raw",
                        "train" if s == "train" else "test", "questions.txt",
                    )
                )
            ]
        else:
            raw_files = RAW_FILES_BY_DATASET[dataset]
            present = [
                s
                for s in raw_files
                if os.path.exists(os.path.join(opt.vqa.dir, "raw", raw_files[s][0]))
            ]
        run_prep(opt.vqa.dir, opt.vqa, splits=tuple(present))

    vocabs = load_vocabs(dir_proc)
    processed = load_split(dir_proc, split)
    store = _feature_store(opt, feature_cache)
    sampling = split in ("train", "trainval") and opt.vqa.samplingans
    return VQA2Dataset(
        processed, vocabs, store, opt.vqa, split,
        sampling=sampling, visual_mode=visual_mode,
    )
