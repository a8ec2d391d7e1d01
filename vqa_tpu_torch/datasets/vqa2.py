"""VQA v2 dataset: processed arrays joined with the feature store, a copy of
``vqa_tpu/datasets/vqa2.py``'s ``VQA2Dataset`` (the port imports nothing of
the JAX package). The original's Grain adapter (``GrainVQA2Source``,
``grain_loader``) needs ``grain`` and is not ported (ROADMAP.md queue 1,
item 14).

A dataset here is columnar (dense numpy arrays), not per-item: batches are
assembled by fancy-indexing, which keeps the host side fast enough to feed the
card.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from vqa_tpu_torch.config import VQAOptions
from vqa_tpu_torch.datasets.features import FeatureStore
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
