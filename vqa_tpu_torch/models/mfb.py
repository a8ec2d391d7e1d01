"""MFB/MFH with co-attention, the port of ``vqa_tpu/models/mfb.py``.

The question LSTM returns its whole (masked) hidden sequence; a question
self-attention pools it over the tokens; a question-guided MFB attention
pools the image regions over several glimpses; the final MFB (or cascaded
MFH) fusion feeds the classifier.

Model contract: model(visual [B, R, Dv], question int[B, T]) -> logits
[B, num_answers].
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from vqa_tpu_torch.models import seq2vec as seq2vec_lib
from vqa_tpu_torch.models.att import GlimpseAttention
from vqa_tpu_torch.models.classifier import Classifier
from vqa_tpu_torch.models.fusion import MFBFusion, MFHFusion, l2_normalize
from vqa_tpu_torch.models.layers import Dense, dropout
from vqa_tpu_torch.models.seq2vec import SeqEncoder
from vqa_tpu_torch.ops.attention import glimpse_attend


class QuestionSelfAttention(nn.Module):
    """seq [B, T, H], mask [B, T] bool -> [B, glimpses*H].

    Softmax over the valid tokens: padded logits take ``finfo(dtype).min``
    (never -inf), so an all-padding row gets uniform weights over its zeroed
    steps, as ``jax.nn.softmax`` gives. The softmax and the weighted sum are
    ``ops.attention.glimpse_attend`` (the hand-written kernel on the card).
    Dropout (with the train step's ``rng``) drops the logits' input only:
    the weighted sum is over the un-dropped ``seq``, as in flax."""

    def __init__(self, dim_q: int, glimpses: int = 2, dim_h: int = 512, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, device="cpu"):
        super().__init__()
        self.out_dim = glimpses * dim_q
        self.dropout = dropout
        self.hidden = Dense(dim_q, dim_h, dtype, device)
        self.logits = Dense(dim_h, glimpses, dtype, device)

    def forward(self, seq: torch.Tensor, mask: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(seq, self.dropout, rng)
        logits = self.logits(torch.relu(self.hidden(x)))                 # [B, T, G]
        logits = logits.masked_fill(~mask[..., None], torch.finfo(logits.dtype).min)
        pooled = glimpse_attend(logits.contiguous(), seq.contiguous())  # [B, G, H]
        return pooled.reshape(pooled.shape[0], -1)


class MFBCoAttModel(nn.Module):
    """Encoder (whole sequence) -> question self-attention -> MFB region
    attention -> final MFB/MFH fusion -> classifier."""

    def __init__(self, encoder: SeqEncoder, q_attention: QuestionSelfAttention,
                 v_attention: GlimpseAttention, final_fusion: nn.Module,
                 classifier: Classifier, l2norm_visual: bool = True):
        super().__init__()
        self.encoder = encoder
        self.q_attention = q_attention
        self.v_attention = v_attention
        self.final_fusion = final_fusion
        self.classifier = classifier
        self.l2norm_visual = l2norm_visual

    def forward(self, visual: torch.Tensor, question: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, train: bool = False,
                return_attention: bool = False, rng: Optional[torch.Generator] = None):
        """``train`` selects the train path's backwards; ``rng`` (the train
        step's generator) switches dropout on."""
        v = visual.to(self.encoder.dtype)
        if self.l2norm_visual:
            v = l2_normalize(v)
        seq = self.encoder(question, lengths, train=train, rng=rng)   # [B, T, H]
        q = self.q_attention(seq, question != 0, rng=rng)             # [B, Gq*H]
        v_att, alpha = self.v_attention(q, v, rng=rng)                # [B, Gv*Dv]
        z = self.final_fusion(q, v_att, rng=rng)
        if isinstance(z, tuple):
            z = z[0]
        logits = self.classifier(z, rng=rng)
        if return_attention:
            return logits, alpha
        return logits

    @classmethod
    def build(cls, model_opt: Mapping[str, Any], num_words: int, num_answers: int,
              dtype: torch.dtype, device, dim_v: int,
              rnn_bwd: str = "bigmatmul") -> "MFBCoAttModel":
        """``vqa_tpu/models/mfb.py::MFBCoAttModel.build`` with the same
        defaults (dropout rates included: ``attention.dropout`` for the
        question attention and as the region attention's ``dropout_mm``,
        ``fusion.dropout_pre`` for both fusions, ``classif.dropout`` 0.1);
        the encoder always returns its whole sequence."""
        seq_cfg = dict(model_opt.get("seq2vec") or {})
        seq_cfg["return_sequence"] = True
        encoder = seq2vec_lib.factory(num_words, seq_cfg, dtype=dtype, device=device,
                                      rnn_bwd=rnn_bwd)
        att = model_opt.get("attention") or {}
        fus = model_opt.get("fusion") or {}
        classif = model_opt.get("classif") or {}
        extra = model_opt.get("extra") or {}

        q_attention = QuestionSelfAttention(
            encoder.hidden_size, glimpses=att.get("question_glimpses", 2),
            dim_h=att.get("dim_h", 512), dropout=att.get("dropout", 0.1), dtype=dtype,
            device=device,
        )
        dim_q = q_attention.out_dim
        dropout_pre = fus.get("dropout_pre", 0.1)
        att_fusion = MFBFusion(
            dim_q, dim_v, pool_factor=fus.get("pool_factor", 5),
            dim_mm=att.get("dim_mm", fus.get("dim_mm", 1000)), dropout_pre=dropout_pre,
            dtype=dtype, device=device,
        )
        nb_glimpses = att.get("nb_glimpses", 2)
        v_attention = GlimpseAttention(att_fusion, nb_glimpses, dtype, device,
                                       dim_h=att.get("dim_h", 512), activation="relu",
                                       dropout_mm=att.get("dropout", 0.1))
        kwargs = dict(pool_factor=fus.get("pool_factor", 5), dim_mm=fus.get("dim_mm", 1000),
                      dropout_pre=dropout_pre, dtype=dtype, device=device)
        if model_opt["arch"] == "MFHCoAtt" or fus.get("arch") == "mfh":
            final = MFHFusion(dim_q, nb_glimpses * dim_v, mfh_order=fus.get("mfh_order", 2),
                              **kwargs)
        else:
            final = MFBFusion(dim_q, nb_glimpses * dim_v, **kwargs)
        classifier = Classifier(
            final.out_dim, num_answers, dim_h=classif.get("dim_h"),
            activation=classif.get("activation", "relu"), dropout=classif.get("dropout", 0.1),
            dtype=dtype, device=device,
        )
        return cls(encoder, q_attention, v_attention, final, classifier,
                   l2norm_visual=extra.get("l2norm_visual", True))
