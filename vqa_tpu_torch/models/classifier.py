"""Answer classifier head, the port of ``vqa_tpu/models/classifier.py``:
[hidden?] -> num_answers logits (dropout is training-time and not applied)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vqa_tpu_torch.models.fusion import _ACT
from vqa_tpu_torch.models.layers import Dense


class Classifier(nn.Module):
    def __init__(self, d_in: int, num_answers: int, dim_h: Optional[int] = None,
                 activation: str = "tanh", dtype: torch.dtype = torch.float32, device="cpu"):
        super().__init__()
        self.act = _ACT[activation]
        if dim_h is not None:
            self.hidden = Dense(d_in, dim_h, dtype, device)
            d_in = dim_h
        self.logits = Dense(d_in, num_answers, dtype, device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "hidden"):
            z = self.act(self.hidden(z))
        return self.logits(z)
