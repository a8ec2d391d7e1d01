"""Inference API, the port of ``vqa_tpu/predictor.py``.

    from vqa_tpu_torch.predictor import Predictor
    p = Predictor.from_run("logs/vqa2/mutan_att", resume="best", device="cuda")
    p = Predictor.from_run(run_dir, params="exported/params.npz")   # an npz instead
    answers = p.answer("What color is the cat?", "COCO_val2014_000000000042")
    # -> [(answer, prob), ...] top-k

The weights come from the run's own checkpoint (``resume``: best, latest or
an epoch of ``<dir_logs>/ckpt``, which the port's train CLI writes), or
from a '/'-keyed npz (``params``, or the run's ``model.pretrained_params``;
``python -m vqa_tpu_torch.cli.export --params external`` writes one, as
the JAX package's export CLI does for a JAX run). ``from_run`` reads the
run's options YAML and builds the val dataset through the port's own
``datasets.factory``, which prepares the raw VQA files on first use
(``datasets.processed.run_prep``, as the port's eval CLI ``python -m
vqa_tpu_torch.cli.train -e`` does); it needs yaml and h5py, nothing of the
JAX package. ``Predictor(...)`` builds from in-memory parts
and needs neither. Both run on the card unless the caller asks for the CPU
(``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import types
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from vqa_tpu_torch.datasets.processed import encode_question_batch
from vqa_tpu_torch.datasets.tokenizer import get_tokenizer
from vqa_tpu_torch.models.factory import factory as model_factory
from vqa_tpu_torch.ops.gather import gather_rows
from vqa_tpu_torch.utils.decode import topk_answers
from vqa_tpu_torch.weights import load_params, pretrained_params


@dataclasses.dataclass
class Catalog:
    """The host-side lookups answering needs: the word vocabulary, the
    answer list and the image-name -> table-row map. ``num_answers`` and
    ``split.image_names`` are what ``cli.serve.AnswerService`` reads
    from ``predictor.dataset``."""

    word_to_wid: Mapping[str, int]
    aid_to_ans: Sequence[str]
    image_rows: Mapping[str, int]

    @property
    def num_answers(self) -> int:
        return len(self.aid_to_ans)

    @property
    def split(self):
        return types.SimpleNamespace(image_names=list(self.image_rows))

    def index_of(self, names: Sequence[str]) -> np.ndarray:
        try:
            return np.asarray([self.image_rows[n] for n in names], dtype=np.int64)
        except KeyError as e:
            raise KeyError(f"image {e.args[0]!r} missing from the feature table") from None


class Predictor:
    """Answers questions about images of ``table`` ([N, R, D] regions, or the
    NoAtt archs' pooled [N, D]), which may live
    on the host (rows are gathered there, then uploaded) or on the model's
    device (gathered there by the kernel)."""

    def __init__(self, model, catalog: Catalog, table: torch.Tensor, maxlength: int = 26,
                 pad: str = "right", nlp: str = "mcb"):
        self.model = model.eval()
        self.dataset = catalog
        self.table = table
        self.maxlength = maxlength
        self.pad = pad
        self._tok = get_tokenizer(nlp)
        self.device = next(model.parameters()).device
        self.opt = None      # from_run's: the run's options and its val dataset,
        self.val_set = None  # which the export CLI reads

    @classmethod
    def from_run(
        cls,
        dir_logs: str,
        path_opt: Optional[str] = None,
        params: Optional[str] = None,
        overrides: Optional[List[str]] = None,
        device="cuda",
        resume: Optional[str] = None,
    ) -> "Predictor":
        """Load a run's config, its val dataset (prepared on first use, as the
        JAX package's ``from_run`` does) with the vocabularies and the feature
        table, and the weights: with ``resume`` (best, latest or an epoch)
        those of the run's checkpoint under ``<dir_logs>/ckpt``, as the JAX
        ``from_run(resume=...)`` restores them; else the ``params`` npz
        (default: the config's ``model.pretrained_params``) over the config's
        ``seq2vec.pretrained_emb`` / ``pretrained_encoder`` grafts, as the
        eval CLI and the JAX ``from_run(resume=None)`` compose them. With no
        ``path_opt`` the run's own options.yaml is used. The model computes in
        the config's ``engine.dtype`` on every device
        (``config.compute_dtype``)."""
        import os

        from vqa_tpu_torch.config import compute_dtype, load_options
        from vqa_tpu_torch.datasets.factory import factory as dataset_factory
        from vqa_tpu_torch.engine.checkpoint import CheckpointManager

        if path_opt is None:
            path_opt = os.path.join(dir_logs, "options.yaml")
        opt = load_options(path_opt, overrides, default_path=None)
        seq2vec = opt.model.seq2vec or {}
        if resume is not None and params is not None:
            raise ValueError("pass resume= (the run's checkpoint) or params= (an npz), not both")
        if resume is None and not (params or opt.model.pretrained_params
                                   or seq2vec.get("pretrained_emb")
                                   or seq2vec.get("pretrained_encoder")):
            raise ValueError(
                "no weights named: pass resume= (best, latest or an epoch of the run's "
                "checkpoint) or params= (an npz; python -m vqa_tpu_torch.cli.export --params "
                "external writes one)"
            )
        device = torch.device(device)
        dtype = compute_dtype(opt)
        val_set = dataset_factory("val", opt)
        features = val_set.features
        model = model_factory(
            dataclasses.asdict(opt.model), val_set.num_words, val_set.num_answers,
            dtype=dtype, device=device, dim_v=features.feature_shape[-1],
        )
        if resume is not None:
            CheckpointManager(os.path.join(dir_logs, "ckpt")).restore_params(model, resume)
        else:
            load_params(model, pretrained_params(opt.model, params))
        vocabs = val_set.vocabs
        catalog = Catalog(vocabs.word_to_wid, vocabs.aid_to_ans, features._name_to_index)
        table = torch.from_numpy(features.as_array())
        predictor = cls(model, catalog, table, opt.vqa.maxlength, opt.vqa.pad, opt.vqa.nlp)
        predictor.opt, predictor.val_set = opt, val_set
        return predictor

    def encode_questions(self, questions: Sequence[str]):
        rows, lengths = encode_question_batch(
            questions, self._tok, self.dataset.word_to_wid, self.maxlength, self.pad
        )
        return (torch.from_numpy(rows).to(self.device),
                torch.from_numpy(lengths).to(self.device))

    def answer_batch(
        self, questions: Sequence[str], image_names: Sequence[str], topk: int = 5
    ) -> List[List[Tuple[str, float]]]:
        rows = self.dataset.index_of(list(image_names))
        visual = gather_rows(self.table, rows).to(self.device)
        q, lengths = self.encode_questions(questions)
        with torch.inference_mode():
            logits = self.model(visual, q, lengths)
        return topk_answers(logits, self.dataset.aid_to_ans, topk)

    def answer(self, question: str, image_name: str, topk: int = 5):
        return self.answer_batch([question], [image_name], topk)[0]
