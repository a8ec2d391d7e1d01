"""Parameter layouts and dropout shared by the port's modules.

Parameters keep flax's names and layouts, so a '/'-flattened flax param tree
loads by renaming alone (vqa_tpu_torch/weights.py). Parameters start at
zero; ``weights.load_params`` or ``weights.random_params`` fills them.

An eval build holds its parameters in the compute dtype, without grads. A
training build (``models.factory(..., train=True)``) converts them to
float32 master parameters that take grads, and each module casts them to
its compute dtype in ``forward``, as flax keeps ``param_dtype`` float32 and
casts to ``dtype`` inside each layer.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def param(*shape: int, dtype: torch.dtype, device) -> nn.Parameter:
    # an eval build takes no grads; a training build turns them on
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device), requires_grad=False)


def dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: with ``rng`` (a generator on x's device; the train
    step's) each element is kept with probability 1 - rate and scaled by
    1 / (1 - rate); without one (eval), or at rate 0, x itself."""
    if rng is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=rng, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel [in, out]``, ``bias [out]``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = param(d_in, d_out, dtype=dtype, device=device)
        self.bias = param(d_out, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding [vocab, features]``."""

    def __init__(self, vocab_size: int, features: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.embedding = param(vocab_size, features, dtype=dtype, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        # the rows cast after the gather: the same values as flax's cast table
        return self.embedding[tokens.long()].to(self.dtype)
