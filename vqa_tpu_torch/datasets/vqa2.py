"""VQA v2 dataset: processed arrays joined with the feature store, a copy of
``vqa_tpu/datasets/vqa2.py`` (the port imports nothing of the JAX package).

A dataset here is columnar (dense numpy arrays), not per-item: batches are
assembled by fancy-indexing, which keeps the host side fast enough to feed the
card (``pipeline.BatchIterator``). For the map-style per-item view, with
worker processes, ``VQA2ItemSource`` and ``item_loader`` stand in for the
original's Grain adapter (``GrainVQA2Source``, ``grain_loader``) on
``torch.utils.data``: the port cannot call grain, whose import loads jax,
so the loader reads records in the order of Grain's ``IndexSampler``
(``datasets/index_shuffle.py``) and stacks them as ``grain.Batch`` does.
tests/test_torch_item_loader.py holds the two loaders batch for batch.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np
import torch.utils.data

from vqa_tpu_torch.config import VQAOptions
from vqa_tpu_torch.datasets.features import FeatureStore
from vqa_tpu_torch.datasets.index_shuffle import epoch_permutation
from vqa_tpu_torch.datasets.processed import ProcessedSplit, Vocabs


class VQA2Dataset:
    def __init__(
        self,
        split: ProcessedSplit,
        vocabs: Vocabs,
        features: FeatureStore,
        opt: VQAOptions,
        name: str,
        sampling: bool = False,
        visual_mode: str = "gather",
    ):
        if visual_mode not in ("gather", "index"):
            raise ValueError(f"visual_mode must be 'gather' or 'index', got {visual_mode!r}")
        self.split = split
        self.vocabs = vocabs
        self.features = features
        self.opt = opt
        self.name = name
        self.sampling = sampling and split.answer_pool is not None
        self.visual_mode = visual_mode
        self.image_index = features.index_of(split.image_names.tolist())

    def __len__(self) -> int:
        return len(self.split)

    @property
    def num_words(self) -> int:
        return self.vocabs.num_words

    @property
    def num_answers(self) -> int:
        return self.vocabs.num_answers

    @property
    def feature_shape(self) -> tuple:
        return self.features.feature_shape

    def batch(
        self, indices: np.ndarray, rng: Optional[np.random.Generator] = None
    ) -> Dict[str, np.ndarray]:
        """Assemble one batch: {visual, question, length, answer?, question_id}.

        With ``sampling`` (train-time ``samplingans`` [K]), the label is drawn
        uniformly from the 10 annotator answers that are in-vocab — equivalent
        to count-weighted sampling over distinct answers — falling back to the
        consensus answer when none are.
        """
        out: Dict[str, np.ndarray] = {
            "question": self.split.questions[indices],
            "length": self.split.lengths[indices],
            "question_id": self.split.question_ids[indices],
        }
        if self.visual_mode == "index":
            # device-resident feature table: ship indices, gather on the card
            out["image_index"] = self.image_index[indices]
        else:
            out["visual"] = self.features.get(self.image_index[indices])
        if self.split.answers is not None:
            answers = self.split.answers[indices]
            if self.sampling and rng is not None:
                pool = self.split.answer_pool[indices]          # [B, 10]
                valid = pool >= 0                                # [B, 10]
                n_valid = valid.sum(axis=1)
                # uniform pick over valid slots per row
                pick = (rng.random(len(indices)) * np.maximum(n_valid, 1)).astype(np.int64)
                # index of the pick-th valid slot
                order = np.cumsum(valid, axis=1) - 1             # rank of each slot
                slot = np.argmax(order == pick[:, None], axis=1)
                sampled = pool[np.arange(len(indices)), slot]
                answers = np.where(n_valid > 0, sampled, answers)
            out["answer"] = answers
        return out


class VQA2ItemSource(torch.utils.data.Dataset):
    """Map-style per-item view over VQA2Dataset, the counterpart of the
    original's ``GrainVQA2Source``.

    Label sampling (``samplingans``) stays active and deterministic: each
    item draws from an rng keyed by (label_seed, epoch, idx), so workers
    agree whatever their number. A source does not see the epoch number
    itself, so per-epoch label resampling (the reference's exact semantics)
    works by building one ``item_loader(..., epoch=e, num_epochs=1)`` per
    epoch, which re-keys BOTH the shuffle order and the label draws.
    (Mutating a source after a worker-backed loader is built would not reach
    the pickled worker copies, so there is deliberately no set_epoch.)
    epoch=0 reproduces the fixed-draw default.
    """

    def __init__(self, dataset: VQA2Dataset, label_seed: int = 0, epoch: int = 0):
        self._ds = dataset
        self._label_seed = label_seed
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return len(self._ds)

    def __getitem__(self, idx):
        rng = (
            np.random.default_rng(
                np.random.SeedSequence([self._label_seed, self._epoch, int(idx)])
            )
            if self._ds.sampling
            else None
        )
        batch = self._ds.batch(np.asarray([idx]), rng=rng)
        return {k: v[0] for k, v in batch.items()}


class _IndexOrder(torch.utils.data.Sampler):
    """The records Grain's ``IndexSampler`` (no sharding) reads, in order:
    position ``i`` of epoch ``e`` reads ``index_shuffle(i, n - 1, (seed + e)
    % 2**32, 4)`` when shuffling, else ``i``; ``num_epochs=None`` never
    ends."""

    def __init__(self, n: int, shuffle: bool, seed: int, num_epochs: Optional[int]):
        if n <= 0:
            raise ValueError(f"the loader needs at least one record, got {n}")
        if num_epochs is not None and num_epochs <= 0:
            raise ValueError(f"num_epochs must be positive or None, got {num_epochs}")
        self._n, self._shuffle, self._seed, self._num_epochs = n, shuffle, seed, num_epochs

    def __iter__(self):
        epochs = itertools.count() if self._num_epochs is None else range(self._num_epochs)
        for e in epochs:
            if self._shuffle:
                yield from epoch_permutation(self._n, self._seed, e).tolist()
            else:
                yield from range(self._n)

    def __len__(self) -> int:
        if self._num_epochs is None:
            raise TypeError("an endless order has no length")
        return self._n * self._num_epochs


def _stack(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """One batch from per-item rows, key by key, as ``grain.Batch`` stacks
    them."""
    return {k: np.stack([item[k] for item in items]) for k in items[0]}


def item_loader(
    dataset: VQA2Dataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    num_epochs: Optional[int] = 1,
    worker_count: int = 0,
    epoch: int = 0,
) -> torch.utils.data.DataLoader:
    """Per-item loader with worker processes, the counterpart of the
    original's ``grain_loader`` (SURVEY.md C7 equivalent), batch for batch.

    The columnar BatchIterator is the default (faster for RAM-resident
    arrays); this is the multiprocess-worker path for datasets that do real
    per-item IO (h5-streaming FeatureStore, decode-heavy sources).
    Deterministic: order is a pure function of (seed, epoch) like the
    reference's seeded DataLoader. For the reference's per-epoch answer
    resampling, build one loader per epoch with ``epoch=e, num_epochs=1``;
    both the shuffle order and the label draws re-key on the epoch. Batches
    are dicts of numpy arrays, the last short one kept; batches run across
    epoch boundaries, as grain's do.
    """
    # key the sampler by (seed, epoch) without collisions: seed+epoch would
    # alias (3, 1) with (4, 0), the same trap pipeline.epoch_order avoids
    sampler_seed = int(
        np.random.SeedSequence([seed, epoch]).generate_state(1)[0] & 0x7FFFFFFF
    )
    return torch.utils.data.DataLoader(
        VQA2ItemSource(dataset, label_seed=seed, epoch=epoch),
        batch_size=batch_size,
        sampler=_IndexOrder(len(dataset), shuffle, sampler_seed, num_epochs),
        num_workers=worker_count,
        collate_fn=_stack,
        # workers start from a fresh interpreter, as grain's do: forking a
        # process that runs threads (CUDA's, a prefetch thread) is unsafe
        multiprocessing_context="spawn" if worker_count else None,
    )
