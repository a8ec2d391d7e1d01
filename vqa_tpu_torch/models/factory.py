"""Model factory, the port of ``vqa_tpu/models/factory.py``: all nine archs
(the attention family ConcatAtt, MLBAtt and MutanAtt; the no-attention
MLBNoAtt, MutanNoAtt and ConcatNoAtt; MFBCoAtt, MFHCoAtt and CoR), each with
the question encoder its ``seq2vec`` section names (``lstm``, ``gru`` or
``skipthoughts``).

factory(model_opt, num_words, num_answers) -> nn.Module with
``forward(visual, question, lengths=None) -> logits``.

``train=True`` builds for training: float32 master parameters that take
grads, cast to the compute ``dtype`` inside each layer (flax's
``param_dtype`` split), and the recurrence's backward ``rnn_bwd``
(``engine.rnn_bwd``, for the LSTM and the GRU alike). Every arch and
encoder trains.

``model_opt`` is the ``model`` section of an options YAML as a plain dict
(``dataclasses.asdict(load_options(path).model)``, or ``flagship.py``'s
copies), so building a model needs no YAML parser.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from vqa_tpu_torch.models import fusion as fusion_lib
from vqa_tpu_torch.models import seq2vec as seq2vec_lib
from vqa_tpu_torch.models import cor, mfb
from vqa_tpu_torch.models.att import AttModel, GlimpseAttention
from vqa_tpu_torch.models.classifier import Classifier
from vqa_tpu_torch.models.noatt import NoAttModel

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

_NOATT = ("MLBNoAtt", "MutanNoAtt", "ConcatNoAtt")
_ARCHS = ("ConcatAtt", "MLBAtt", "MutanAtt") + _NOATT + ("MFBCoAtt", "MFHCoAtt", "CoR")


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
    train: bool = False,
    rnn_bwd: str = "bigmatmul",
) -> nn.Module:
    """``dim_v`` is the width of a region feature, or of the pooled image
    vector for the NoAtt archs (flax infers it at init)."""
    model = _build(model_opt, num_words, num_answers, _dtype(dtype), device, dim_v, rnn_bwd)
    return model.float().requires_grad_(True) if train else model


def _build(model_opt: Mapping[str, Any], num_words: int, num_answers: int,
           dtype: torch.dtype, device, dim_v: int, rnn_bwd: str) -> nn.Module:
    arch = model_opt["arch"]
    extra = model_opt.get("extra") or {}
    sections = {name: model_opt.get(name) or {} for name in ("seq2vec", "attention",
                                                              "classif", "fusion")}
    for name, opt in sections.items():
        _check_keys(name, opt)
    _check_keys("chain", extra.get("chain", {}))
    if arch not in _ARCHS:
        raise KeyError(f"unknown model arch {arch!r}; known: {', '.join(_ARCHS)}")
    if arch in ("MFBCoAtt", "MFHCoAtt"):
        return mfb.MFBCoAttModel.build(model_opt, num_words, num_answers, dtype, device, dim_v,
                                       rnn_bwd)
    if arch == "CoR":
        return cor.CoRModel.build(model_opt, num_words, num_answers, dtype, device, dim_v,
                                  rnn_bwd)

    encoder = seq2vec_lib.factory(num_words, sections["seq2vec"], dtype=dtype, device=device,
                                  rnn_bwd=rnn_bwd)
    classif = sections["classif"]

    def classifier(d_in: int) -> Classifier:
        return Classifier(d_in, num_answers, dim_h=classif.get("dim_h"),
                          activation=classif.get("activation", "tanh"),
                          dropout=classif.get("dropout", 0.5), dtype=dtype, device=device)

    l2norm_visual = extra.get("l2norm_visual", False)
    if arch in _NOATT:  # the final fusion sees the one pooled image vector
        final = fusion_lib.factory(sections["fusion"], encoder.hidden_size, dim_v, dtype=dtype,
                                   device=device)
        return NoAttModel(encoder, final, classifier(final.out_dim), l2norm_visual=l2norm_visual)

    att = sections["attention"]
    scoring, head = _att_scoring_fusion(arch, att, encoder.hidden_size, dim_v, dtype, device)
    nb_glimpses = att.get("nb_glimpses", 1)
    attention = GlimpseAttention(scoring, nb_glimpses, dtype, device,
                                 dropout_mm=att.get("dropout_mm", 0.0), **head)
    final = fusion_lib.factory(
        sections["fusion"], encoder.hidden_size, nb_glimpses * dim_v, dtype=dtype, device=device
    )
    return AttModel(encoder, attention, final, classifier(final.out_dim),
                    l2norm_visual=l2norm_visual)


def _att_scoring_fusion(arch: str, att: Mapping, dim_q: int, dim_v: int, dtype, device):
    """The per-region scoring fusion of an attention-family arch and the
    glimpse head's ``dim_h``/``activation``, as
    ``vqa_tpu/models/factory.py::_att_scoring_fusion`` builds them (with its
    dropout defaults, which are not the fusions' own)."""
    drop = dict(dropout_q=att.get("dropout_q", 0.5), dropout_v=att.get("dropout_v", 0.5))
    if arch == "ConcatAtt":
        return (fusion_lib.ConcatFusion(dim_q, dim_v, dtype=dtype, device=device, **drop),
                dict(dim_h=att.get("dim_h", 1024), activation=att.get("activation", "tanh")))
    if arch == "MLBAtt":
        # attention.activation, where given, sets both sides
        return (fusion_lib.MLBFusion(
            dim_q, dim_v, dim_h=att.get("dim_h", 1200), **drop,
            activation_q=att.get("activation", att.get("activation_q", "tanh")),
            activation_v=att.get("activation", att.get("activation_v", "tanh")),
            dtype=dtype, device=device), {})
    return (fusion_lib.MutanFusion(
        dim_q, dim_v,
        dim_hq=att.get("dim_hq", 310),
        dim_hv=att.get("dim_hv", 310),
        dim_mm=att.get("dim_mm", 510),
        R=att.get("R", 5),
        **drop,
        dropout_hq=att.get("dropout_hq", 0.0),
        dropout_hv=att.get("dropout_hv", 0.0),
        activation_q=att.get("activation_q", "tanh"),
        activation_v=att.get("activation_v", "tanh"),
        core_bias=att.get("core_bias", True),
        dtype=dtype,
        device=device,
    ), {})
