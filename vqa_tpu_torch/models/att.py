"""Question-conditioned glimpse attention and the attention-family model, the
port of ``vqa_tpu/models/att.py``: ConcatAtt, MLBAtt and MutanAtt, which
differ in the scoring fusion GlimpseAttention applies per region (and
ConcatAtt's hidden layer before the glimpse logits); MFB co-attention's
region attention is the same GlimpseAttention over an MFB fusion.

Model contract: model(visual [B, R, Dv], question int[B, T]) -> logits
[B, num_answers].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vqa_tpu_torch.models.classifier import Classifier
from vqa_tpu_torch.models.fusion import _ACT, l2_normalize
from vqa_tpu_torch.models.layers import Dense, dropout, param
from vqa_tpu_torch.models.seq2vec import SeqEncoder
from vqa_tpu_torch.ops.attention import glimpse_head


class _GlimpseTail(nn.Module):
    """Glimpse logits + softmax over regions + weighted sums in one call to
    ``ops.attention.glimpse_head``, with the params of a Dense layer
    (``kernel [M, G]``, ``bias [G]``) as in flax."""

    def __init__(self, d_in: int, nb_glimpses: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = param(d_in, nb_glimpses, dtype=dtype, device=device)
        self.bias = param(nb_glimpses, dtype=dtype, device=device)

    def forward(self, joint: torch.Tensor, v: torch.Tensor):
        # the card's kernel takes contiguous operands in the compute dtype
        return glimpse_head(joint.contiguous(), self.kernel.to(self.dtype),
                            self.bias.to(self.dtype), v.contiguous())


class GlimpseAttention(nn.Module):
    """q [B, Dq], v [B, R, Dv] -> (attended [B, G*Dv], alpha [B, R, G]).

    ``dim_h`` adds a ``hidden`` Dense + activation between the fusion and the
    glimpse logits (MFB co-attention: 512, relu; ConcatAtt: 1024, tanh;
    MutanAtt and MLBAtt: none); ``dropout_mm`` drops the fused joint before
    it."""

    def __init__(self, fusion: nn.Module, nb_glimpses: int, dtype: torch.dtype, device,
                 dim_h: Optional[int] = None, activation: str = "tanh",
                 dropout_mm: float = 0.0):
        super().__init__()
        self.fusion = fusion
        self.dropout_mm = dropout_mm
        self.act = _ACT[activation]
        d_joint = fusion.out_dim
        if dim_h is not None:
            self.hidden = Dense(d_joint, dim_h, dtype, device)
            d_joint = dim_h
        self.glimpse_logits = _GlimpseTail(d_joint, nb_glimpses, dtype, device)

    def forward(self, q: torch.Tensor, v: torch.Tensor,
                rng: Optional[torch.Generator] = None):
        joint = self.fusion(q[:, None, :], v, rng=rng)          # [B, R, M]
        if isinstance(joint, tuple):  # MFB-style fusions return (pooled, pre_pool)
            joint = joint[0]
        joint = dropout(joint, self.dropout_mm, rng)
        if hasattr(self, "hidden"):
            joint = self.act(self.hidden(joint))
        attended, logits = self.glimpse_logits(joint, v)
        alpha = torch.softmax(logits, dim=1)
        return attended.reshape(attended.shape[0], -1), alpha


class AttModel(nn.Module):
    """Encoder -> glimpse attention -> final fusion -> classifier."""

    def __init__(self, encoder: SeqEncoder, attention: GlimpseAttention,
                 final_fusion: nn.Module, classifier: Classifier, l2norm_visual: bool = False):
        super().__init__()
        self.encoder = encoder
        self.attention = attention
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
        q = self.encoder(question, lengths, train=train, rng=rng)
        v_att, alpha = self.attention(q, v, rng=rng)
        z = self.final_fusion(q, v_att, rng=rng)
        if isinstance(z, tuple):
            z = z[0]
        logits = self.classifier(z, rng=rng)
        if return_attention:
            return logits, alpha
        return logits
