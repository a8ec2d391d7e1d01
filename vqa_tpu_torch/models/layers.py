"""Parameter layouts shared by the port's modules.

Parameters keep flax's names and layouts, so a '/'-flattened flax param tree
loads by renaming alone (vqa_tpu_torch/weights.py). Parameters start at
zero; ``weights.load_params`` or ``weights.random_params`` fills them.
"""

from __future__ import annotations

import torch
from torch import nn


def param(*shape: int, dtype: torch.dtype, device) -> nn.Parameter:
    # inference only so far: no autograd bookkeeping until the train step is ported
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device), requires_grad=False)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel [in, out]``, ``bias [out]``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device):
        super().__init__()
        self.kernel = param(d_in, d_out, dtype=dtype, device=device)
        self.bias = param(d_out, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding [vocab, features]``."""

    def __init__(self, vocab_size: int, features: int, dtype: torch.dtype, device):
        super().__init__()
        self.embedding = param(vocab_size, features, dtype=dtype, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding[tokens.long()]
