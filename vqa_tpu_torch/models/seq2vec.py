"""Question encoder, the port of ``vqa_tpu/models/seq2vec.py`` (LSTM).

Embedding + LSTM over padded token ids. The input-side gate projection for
all T steps is one GEMM; the recurrence is ``ops.lstm.lstm_seq`` (the
hand-written kernel on the card). The mask comes from the token ids
(0 is <pad>), not from lengths, so left- and right-padded rows both end on
their last real step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from vqa_tpu_torch.models.layers import Embed, param
from vqa_tpu_torch.ops.lstm import lstm_seq


class LSTMLayer(nn.Module):
    """x [T, B, E], mask [T, B, 1] -> (h_last [B, H], seq [T, B, H]).

    flax layout: ``wx [E, 4H]``, ``wh [H, 4H]``, ``b [4H]``, gates i, f, g, o."""

    def __init__(self, d_in: int, hidden_size: int, dtype: torch.dtype, device):
        super().__init__()
        self.wx = param(d_in, 4 * hidden_size, dtype=dtype, device=device)
        self.wh = param(hidden_size, 4 * hidden_size, dtype=dtype, device=device)
        self.b = param(4 * hidden_size, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False):
        xg = x @ self.wx + self.b
        return lstm_seq(xg, mask, self.wh, train=train)


class SeqEncoder(nn.Module):
    """tokens [B, T] -> sentence vector [B, H] (or [B, T, H] with
    ``return_sequence``, padded steps zeroed)."""

    def __init__(
        self,
        vocab_size: int,
        emb_size: int = 620,
        hidden_size: int = 2400,
        num_layers: int = 1,
        return_sequence: bool = False,
        dtype: torch.dtype = torch.float32,
        device="cpu",
    ):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.return_sequence = return_sequence
        self.dtype = dtype
        self.embed = Embed(vocab_size, emb_size, dtype, device)
        for layer in range(num_layers):
            d_in = emb_size if layer == 0 else hidden_size
            setattr(self, f"lstm_{layer}", LSTMLayer(d_in, hidden_size, dtype, device))

    def forward(self, tokens: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        x = self.embed(tokens).transpose(0, 1)                      # [T, B, E]
        mask = (tokens != 0).to(self.dtype).T.unsqueeze(-1).contiguous()  # [T, B, 1]
        h_last = None
        for layer in range(self.num_layers):
            h_last, x = getattr(self, f"lstm_{layer}")(x, mask, train=train)
        if self.return_sequence:
            return x.transpose(0, 1)
        return h_last


def factory(vocab_size: int, opt: Dict[str, Any], dtype=torch.float32,
            device="cpu") -> SeqEncoder:
    """Build the question encoder from the model.seq2vec config dict."""
    arch = opt.get("arch", "lstm")
    if arch in ("gru", "skipthoughts"):
        raise NotImplementedError(
            f"seq2vec arch {arch!r} is not ported yet: the GRU is ROADMAP.md queue 1 item 6"
        )
    if arch != "lstm":
        raise KeyError(f"unknown seq2vec arch {arch!r}")
    return SeqEncoder(
        vocab_size=vocab_size,
        emb_size=opt.get("emb_size", 620),
        hidden_size=opt.get("hidden_size", 1024),
        num_layers=opt.get("num_layers", 1),
        return_sequence=opt.get("return_sequence", False),
        dtype=dtype,
        device=device,
    )
