"""Question-conditioned glimpse attention and the attention-family model, the
port of ``vqa_tpu/models/att.py`` (the MutanAtt path).

Model contract: model(visual [B, R, Dv], question int[B, T]) -> logits
[B, num_answers].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vqa_tpu_torch.models.classifier import Classifier
from vqa_tpu_torch.models.fusion import MutanFusion, l2_normalize
from vqa_tpu_torch.models.layers import param
from vqa_tpu_torch.models.seq2vec import SeqEncoder
from vqa_tpu_torch.ops.attention import glimpse_head


class _GlimpseTail(nn.Module):
    """Glimpse logits + softmax over regions + weighted sums in one call to
    ``ops.attention.glimpse_head``, with the params of a Dense layer
    (``kernel [M, G]``, ``bias [G]``) as in flax."""

    def __init__(self, d_in: int, nb_glimpses: int, dtype: torch.dtype, device):
        super().__init__()
        self.kernel = param(d_in, nb_glimpses, dtype=dtype, device=device)
        self.bias = param(nb_glimpses, dtype=dtype, device=device)

    def forward(self, joint: torch.Tensor, v: torch.Tensor):
        return glimpse_head(joint.contiguous(), self.kernel, self.bias, v.contiguous())


class GlimpseAttention(nn.Module):
    """q [B, Dq], v [B, R, Dv] -> (attended [B, G*Dv], alpha [B, R, G])."""

    def __init__(self, fusion: MutanFusion, nb_glimpses: int, dtype: torch.dtype, device):
        super().__init__()
        self.fusion = fusion
        self.glimpse_logits = _GlimpseTail(fusion.dim_mm, nb_glimpses, dtype, device)

    def forward(self, q: torch.Tensor, v: torch.Tensor):
        joint = self.fusion(q[:, None, :], v)                   # [B, R, M]
        attended, logits = self.glimpse_logits(joint, v)
        alpha = torch.softmax(logits, dim=1)
        return attended.reshape(attended.shape[0], -1), alpha


class AttModel(nn.Module):
    """Encoder -> glimpse attention -> final fusion -> classifier."""

    def __init__(self, encoder: SeqEncoder, attention: GlimpseAttention,
                 final_fusion: MutanFusion, classifier: Classifier, l2norm_visual: bool = False):
        super().__init__()
        self.encoder = encoder
        self.attention = attention
        self.final_fusion = final_fusion
        self.classifier = classifier
        self.l2norm_visual = l2norm_visual

    def forward(self, visual: torch.Tensor, question: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, train: bool = False,
                return_attention: bool = False):
        v = visual.to(self.encoder.dtype)
        if self.l2norm_visual:
            v = l2_normalize(v)
        q = self.encoder(question, lengths, train=train)  # train=True raises there
        v_att, alpha = self.attention(q, v)
        logits = self.classifier(self.final_fusion(q, v_att))
        if return_attention:
            return logits, alpha
        return logits
