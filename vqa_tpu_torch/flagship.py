"""The flagship model: MutanAtt at ``options/vqa2/mutan_att.yaml`` dims, the
port's counterpart of ``__graft_entry__._flagship_model`` and ``entry``.

The model section is kept here as a dict so the GPU path builds the model
without a YAML parser; tests/test_torch_weights.py holds it equal to
``load_options("options/vqa2/mutan_att.yaml").model``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from vqa_tpu_torch.models.factory import factory

NUM_WORDS = 12_000
NUM_ANSWERS = 2_000

MODEL = {
    "arch": "MutanAtt",
    "seq2vec": {"arch": "lstm", "emb_size": 620, "hidden_size": 2400, "num_layers": 1,
                "dropout": 0.0},
    "attention": {
        "nb_glimpses": 2, "dim_hv": 310, "dim_hq": 310, "dim_mm": 510, "R": 5,
        "dropout_v": 0.5, "dropout_q": 0.5, "dropout_mm": 0.5, "dropout_hv": 0.0,
        "dropout_hq": 0.0, "activation_v": "tanh", "activation_q": "tanh",
    },
    "fusion": {
        "arch": "mutan", "dim_hv": 620, "dim_hq": 310, "dim_mm": 510, "R": 5,
        "dropout_v": 0.5, "dropout_q": 0.5, "dropout_hv": 0.0, "dropout_hq": 0.0,
        "activation_v": "tanh", "activation_q": "tanh",
    },
    "classif": {"dropout": 0.5},
    "pretrained_params": None,
    "extra": {},
}

# the tiny variant of __graft_entry__._flagship_model(tiny=True)
_TINY = {
    "seq2vec": {"emb_size": 16, "hidden_size": 32},
    "attention": {"dim_hv": 12, "dim_hq": 12, "dim_mm": 16, "R": 2},
    "fusion": {"dim_hv": 12, "dim_hq": 12, "dim_mm": 16, "R": 2},
}


def model_options(tiny: bool = False) -> dict:
    opt = copy.deepcopy(MODEL)
    if tiny:
        for section, values in _TINY.items():
            opt[section].update(values)
    return opt


def build(num_words: int = NUM_WORDS, num_answers: int = NUM_ANSWERS, tiny: bool = False,
          dtype=torch.float32, device="cpu", dim_v: int = 2048):
    return factory(model_options(tiny), num_words, num_answers, dtype=dtype, device=device,
                   dim_v=dim_v)


def example_batch(batch: int = 64, seq: int = 26, regions: int = 36, dim: int = 2048,
                  num_words: int = NUM_WORDS, seed: int = 0) -> dict:
    """The seeded forward inputs of ``__graft_entry__.entry`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    return {
        "visual": rng.standard_normal((batch, regions, dim)).astype(np.float32),
        "question": rng.integers(1, num_words, (batch, seq)).astype(np.int32),
        "length": np.full((batch,), seq, np.int32),
    }
