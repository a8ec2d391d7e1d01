"""No-attention models, the port of ``vqa_tpu/models/noatt.py`` (MLBNoAtt,
MutanNoAtt, ConcatNoAtt).

The question vector and one global image vector (the pooled 2048-d table of
``coco.mode: noatt``, or region features mean-pooled here) -> fusion ->
classifier: model(visual [B, Dv] or [B, R, Dv], question int[B, T]) ->
logits [B, num_answers].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vqa_tpu_torch.models.classifier import Classifier
from vqa_tpu_torch.models.fusion import l2_normalize
from vqa_tpu_torch.models.seq2vec import SeqEncoder


class NoAttModel(nn.Module):
    """Encoder -> fusion of q with the global image vector -> classifier."""

    def __init__(self, encoder: SeqEncoder, fusion: nn.Module, classifier: Classifier,
                 l2norm_visual: bool = False):
        super().__init__()
        self.encoder = encoder
        self.fusion = fusion
        self.classifier = classifier
        self.l2norm_visual = l2norm_visual

    def forward(self, visual: torch.Tensor, question: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, train: bool = False,
                rng: Optional[torch.Generator] = None):
        """``train`` and ``rng`` as ``AttModel.forward``'s."""
        v = visual.to(self.encoder.dtype)
        if v.ndim == 3:  # region features given: mean-pool to a global vector
            v = v.mean(dim=1)
        if self.l2norm_visual:
            v = l2_normalize(v)
        q = self.encoder(question, lengths, train=train, rng=rng)
        z = self.fusion(q, v, rng=rng)
        if isinstance(z, tuple):
            z = z[0]
        return self.classifier(z, rng=rng)
