"""Model factory, the port of ``vqa_tpu/models/factory.py`` (MutanAtt).

factory(model_opt, num_words, num_answers) -> nn.Module with
``forward(visual, question, lengths=None) -> logits``.

``model_opt`` is the ``model`` section of an options YAML as a plain dict
(``dataclasses.asdict(load_options(path).model)``, or ``flagship.py``'s
copy), so building a model needs no YAML parser. Only MutanAtt is ported;
every other arch raises NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from vqa_tpu_torch.models import fusion as fusion_lib
from vqa_tpu_torch.models import seq2vec as seq2vec_lib
from vqa_tpu_torch.models.att import AttModel, GlimpseAttention
from vqa_tpu_torch.models.classifier import Classifier

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# same typo guard as vqa_tpu/models/factory.py:31-52: each config section is
# checked against the union of its archs' knobs
_VALID_KEYS = {
    "seq2vec": {
        "arch", "emb_size", "hidden_size", "num_layers", "dropout",
        "return_sequence", "pretrained_emb", "pretrained_encoder",
    },
    "attention": {
        "nb_glimpses", "question_glimpses", "dim_h", "dim_hq", "dim_hv",
        "dim_mm", "R", "dropout", "dropout_q", "dropout_v", "dropout_mm",
        "dropout_hq", "dropout_hv", "activation", "activation_q", "activation_v",
        "core_bias",
    },
    "classif": {"dim_h", "activation", "dropout"},
    "chain": {"steps", "unroll", "remat"},
    "fusion": {
        "arch", "dim_h", "dim_hq", "dim_hv", "dim_mm", "R", "pool_factor",
        "mfh_order", "dropout", "dropout_pre", "dropout_q", "dropout_v",
        "dropout_hq", "dropout_hv", "activation_q", "activation_v",
        "activation_hq", "activation_hv", "project_inputs", "core_bias",
    },
}

_NOT_PORTED = {
    "ConcatAtt": "queue 1 item 6",
    "MLBAtt": "queue 1 item 6",
    "MLBNoAtt": "queue 1 item 6",
    "MutanNoAtt": "queue 1 item 6",
    "ConcatNoAtt": "queue 1 item 6",
    "MFBCoAtt": "queue 1 item 7",
    "MFHCoAtt": "queue 1 item 7",
    "CoR": "queue 1 item 8",
}


def _check_keys(section: str, opt: Mapping) -> None:
    unknown = set(opt or {}) - _VALID_KEYS[section]
    if unknown:
        raise KeyError(
            f"model.{section} got unknown option(s) {sorted(unknown)}; "
            f"valid: {sorted(_VALID_KEYS[section])}"
        )


def _dtype(name: Any) -> torch.dtype:
    return _DTYPES[name] if isinstance(name, str) else (name or torch.float32)


def factory(
    model_opt: Mapping[str, Any],
    num_words: int,
    num_answers: int,
    dtype: Any = torch.float32,
    device="cpu",
    dim_v: int = 2048,
) -> AttModel:
    """``dim_v`` is the region feature width (flax infers it at init)."""
    dtype = _dtype(dtype)
    arch = model_opt["arch"]
    extra = model_opt.get("extra") or {}
    sections = {name: model_opt.get(name) or {} for name in ("seq2vec", "attention",
                                                              "classif", "fusion")}
    for name, opt in sections.items():
        _check_keys(name, opt)
    _check_keys("chain", extra.get("chain", {}))
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"model arch {arch!r} is not ported yet: ROADMAP.md {_NOT_PORTED[arch]}"
        )
    if arch != "MutanAtt":
        raise KeyError(f"unknown model arch {arch!r}; known: MutanAtt, {', '.join(_NOT_PORTED)}")

    encoder = seq2vec_lib.factory(num_words, sections["seq2vec"], dtype=dtype, device=device)
    att = sections["attention"]
    scoring = fusion_lib.MutanFusion(
        dim_q=encoder.hidden_size,
        dim_v=dim_v,
        dim_hq=att.get("dim_hq", 310),
        dim_hv=att.get("dim_hv", 310),
        dim_mm=att.get("dim_mm", 510),
        R=att.get("R", 5),
        activation_q=att.get("activation_q", "tanh"),
        activation_v=att.get("activation_v", "tanh"),
        core_bias=att.get("core_bias", True),
        dtype=dtype,
        device=device,
    )
    nb_glimpses = att.get("nb_glimpses", 1)
    attention = GlimpseAttention(scoring, nb_glimpses, dtype, device)
    final = fusion_lib.factory(
        sections["fusion"], encoder.hidden_size, nb_glimpses * dim_v, dtype=dtype, device=device
    )
    classif = sections["classif"]
    classifier = Classifier(
        final.dim_mm, num_answers, dim_h=classif.get("dim_h"),
        activation=classif.get("activation", "tanh"), dtype=dtype, device=device,
    )
    return AttModel(encoder, attention, final, classifier,
                    l2norm_visual=extra.get("l2norm_visual", False))
