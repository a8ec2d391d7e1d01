"""Chain-of-Reasoning, the port of ``vqa_tpu/models/cor.py``.

A T-step relational chain over the region objects: each step forms
question-guided pairwise relations (``ops.relation.relation_attend``, the
hand-written kernel on the card), folds them back into a refreshed object
set and pools a per-step decision; the answer comes from a question-gated
sum of the per-step decisions. ONE step module (``chain``) runs all T
steps, so its weights are shared and carry no step index, as flax's
``nn.scan(variable_broadcast="params")`` names them (``chain/rel_src/...``).

Model contract: model(visual [B, N, Dv], question int[B, T]) -> logits
[B, num_answers]; with ``return_attention`` also betas [B, N, steps].
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from vqa_tpu_torch.models import seq2vec as seq2vec_lib
from vqa_tpu_torch.models.classifier import Classifier
from vqa_tpu_torch.models.fusion import l2_normalize
from vqa_tpu_torch.models.layers import Dense, dropout
from vqa_tpu_torch.models.seq2vec import SeqEncoder
from vqa_tpu_torch.ops.relation import relation_attend


class CoRStep(nn.Module):
    """(objects [B, N, Do], q [B, Dq]) -> (objects' [B, N, Do],
    decision [B, D], beta [B, N]).

    With the train step's ``rng``, dropout at flax's three sites: the
    objects before ``rel_src`` and, by an independent draw, before
    ``rel_dst``, and q before ``rel_guide``; each step draws anew."""

    def __init__(self, dim_q: int, dim_obj: int, dim_h: int, dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32, device="cpu"):
        super().__init__()
        self.dropout = dropout
        self.rel_src = Dense(dim_obj, dim_h, dtype, device)
        self.rel_dst = Dense(dim_obj, dim_h, dtype, device)
        self.rel_guide = Dense(dim_q, dim_h, dtype, device)
        self.rel_to_obj = Dense(dim_h, dim_obj, dtype, device)
        self.pool_hidden = Dense(dim_obj, dim_h, dtype, device)
        self.pool_logits = Dense(dim_h, 1, dtype, device)
        self.decision = Dense(dim_obj, dim_h, dtype, device)

    def forward(self, objects: torch.Tensor, q: torch.Tensor,
                rng: Optional[torch.Generator] = None):
        p = torch.tanh(self.rel_src(dropout(objects, self.dropout, rng)))
        r = torch.tanh(self.rel_dst(dropout(objects, self.dropout, rng)))
        g = torch.tanh(self.rel_guide(dropout(q, self.dropout, rng)))[:, None, :]
        pg = p * g
        # factorized pairwise relations: no [B, N, N, D] tensor
        absorbed = relation_attend(pg.contiguous(), r.contiguous())
        new_objects = objects + torch.tanh(self.rel_to_obj(absorbed * pg))
        pool_logits = self.pool_logits(torch.tanh(self.pool_hidden(new_objects)) * g)
        beta = torch.softmax(pool_logits, dim=1)                      # [B, N, 1]
        pooled = (beta * new_objects).sum(dim=1)                      # [B, Do]
        decision = torch.tanh(self.decision(pooled)) * g[:, 0]
        return new_objects, decision, beta[..., 0]


class CoRModel(nn.Module):
    def __init__(self, encoder: SeqEncoder, obj_proj: Dense, chain: CoRStep,
                 step_gates: Dense, classifier: Classifier, steps: int,
                 l2norm_visual: bool = True):
        super().__init__()
        self.encoder = encoder
        self.obj_proj = obj_proj
        self.chain = chain
        self.step_gates = step_gates
        self.classifier = classifier
        self.steps = steps
        self.l2norm_visual = l2norm_visual

    def forward(self, visual: torch.Tensor, question: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, train: bool = False,
                return_attention: bool = False, rng: Optional[torch.Generator] = None):
        """``train`` selects the train path's backwards; ``rng`` (the train
        step's generator) switches dropout on."""
        v = visual.to(self.encoder.dtype)
        if self.l2norm_visual:
            v = l2_normalize(v)
        q = self.encoder(question, lengths, train=train, rng=rng)     # [B, Dq]
        objects = torch.tanh(self.obj_proj(v))                        # [B, N, Do]
        decisions, betas = [], []
        for _ in range(self.steps):
            objects, decision, beta = self.chain(objects, q, rng=rng)
            decisions.append(decision)
            betas.append(beta)
        gates = torch.softmax(self.step_gates(q), dim=-1)             # [B, T]
        decision = torch.einsum("bt,tbd->bd", gates, torch.stack(decisions))
        logits = self.classifier(decision, rng=rng)
        if return_attention:
            # per-step object attention on the glimpse axis: [B, N, steps]
            return logits, torch.stack(betas, dim=-1)
        return logits

    @classmethod
    def build(cls, model_opt: Mapping[str, Any], num_words: int, num_answers: int,
              dtype: torch.dtype, device, dim_v: int, rnn_bwd: str = "bigmatmul") -> "CoRModel":
        """``vqa_tpu/models/cor.py::CoRModel.build`` with the same defaults
        (``fusion.dropout`` 0.2 in the chain, ``classif.dropout`` 0.5).
        ``chain.unroll`` and ``chain.remat`` change no value or grad: the
        steps run one after another either way."""
        encoder = seq2vec_lib.factory(num_words, model_opt.get("seq2vec") or {}, dtype=dtype,
                                      device=device, rnn_bwd=rnn_bwd)
        fus = model_opt.get("fusion") or {}
        classif = model_opt.get("classif") or {}
        extra = model_opt.get("extra") or {}
        steps = extra.get("chain", {}).get("steps", 3)
        dim_h = fus.get("dim_h", 1024)
        dim_obj = dim_h
        return cls(
            encoder,
            Dense(dim_v, dim_obj, dtype, device),
            CoRStep(encoder.hidden_size, dim_obj, dim_h, dropout=fus.get("dropout", 0.2),
                    dtype=dtype, device=device),
            Dense(encoder.hidden_size, steps, dtype, device),
            Classifier(dim_h, num_answers, dim_h=classif.get("dim_h"),
                       activation=classif.get("activation", "tanh"),
                       dropout=classif.get("dropout", 0.5), dtype=dtype, device=device),
            steps=steps,
            l2norm_visual=extra.get("l2norm_visual", True),
        )
