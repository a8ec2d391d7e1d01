"""Question encoder, the port of ``vqa_tpu/models/seq2vec.py`` (``lstm``,
``gru`` and ``skipthoughts``).

Embedding + a stack of LSTM or GRU layers over padded token ids. The
input-side gate projection for all T steps is one GEMM; the recurrence is
``ops.lstm.lstm_seq`` (the hand-written kernel on the card) or
``ops.gru.gru_seq`` (plain PyTorch: the JAX package's GRU is no Pallas
kernel). ``skipthoughts`` is the skip-thoughts encoder's shape, as in the
JAX package: one GRU layer, 2400 units by default, trained from scratch
(the pretrained weights are not available offline). The mask comes from
the token ids (0 is <pad>), not from lengths, so left- and right-padded
rows both end on their last real step. Dropout (``dropout``) applies to the
embeddings and between layers, as in the JAX encoder.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from vqa_tpu_torch.models.layers import Embed, dropout, param
from vqa_tpu_torch.ops.gru import gru_seq
from vqa_tpu_torch.ops.lstm import lstm_seq


class LSTMLayer(nn.Module):
    """x [T, B, E], mask [T, B, 1] -> (h_last [B, H], seq [T, B, H]).

    flax layout: ``wx [E, 4H]``, ``wh [H, 4H]``, ``b [4H]``, gates i, f, g, o."""

    def __init__(self, d_in: int, hidden_size: int, dtype: torch.dtype, device,
                 rnn_bwd: str = "bigmatmul"):
        super().__init__()
        self.dtype = dtype
        self.rnn_bwd = rnn_bwd
        self.wx = param(d_in, 4 * hidden_size, dtype=dtype, device=device)
        self.wh = param(hidden_size, 4 * hidden_size, dtype=dtype, device=device)
        self.b = param(4 * hidden_size, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False):
        xg = x @ self.wx.to(self.dtype) + self.b.to(self.dtype)
        return lstm_seq(xg, mask, self.wh.to(self.dtype), train=train, rnn_bwd=self.rnn_bwd)


class GRULayer(nn.Module):
    """x [T, B, E], mask [T, B, 1] -> (h_last [B, H], seq [T, B, H]).

    flax layout: ``wx [E, 3H]``, ``wh [H, 3H]``, ``bx [3H]``, ``bh [3H]``,
    gates r, z, n."""

    def __init__(self, d_in: int, hidden_size: int, dtype: torch.dtype, device,
                 rnn_bwd: str = "bigmatmul"):
        super().__init__()
        self.dtype = dtype
        self.rnn_bwd = rnn_bwd
        self.wx = param(d_in, 3 * hidden_size, dtype=dtype, device=device)
        self.wh = param(hidden_size, 3 * hidden_size, dtype=dtype, device=device)
        self.bx = param(3 * hidden_size, dtype=dtype, device=device)
        self.bh = param(3 * hidden_size, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False):
        # bh goes in raw, as flax's GRULayer passes it: gru_seq casts it inside
        # the cell, and its grad keeps the parameter's dtype
        gx = x @ self.wx.to(self.dtype) + self.bx.to(self.dtype)
        return gru_seq(gx, mask, self.wh.to(self.dtype), self.bh, train=train,
                       rnn_bwd=self.rnn_bwd)


_CELLS = {"lstm": LSTMLayer, "gru": GRULayer}


class SeqEncoder(nn.Module):
    """tokens [B, T] -> sentence vector [B, H] (or [B, T, H] with
    ``return_sequence``, padded steps zeroed)."""

    def __init__(
        self,
        vocab_size: int,
        emb_size: int = 620,
        hidden_size: int = 2400,
        num_layers: int = 1,
        dropout: float = 0.0,
        cell: str = "lstm",
        return_sequence: bool = False,
        dtype: torch.dtype = torch.float32,
        device="cpu",
        rnn_bwd: str = "bigmatmul",
    ):
        super().__init__()
        if cell not in _CELLS:
            raise ValueError(f"unknown cell {cell!r}")
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.cell = cell
        self.return_sequence = return_sequence
        self.dtype = dtype
        self.embed = Embed(vocab_size, emb_size, dtype, device)
        for layer in range(num_layers):
            d_in = emb_size if layer == 0 else hidden_size
            setattr(self, f"{cell}_{layer}",
                    _CELLS[cell](d_in, hidden_size, dtype, device, rnn_bwd=rnn_bwd))

    def forward(self, tokens: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                train: bool = False, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train`` selects the recurrence's backward (``ops.lstm``,
        ``ops.gru``);
        ``rng``, the train step's generator, switches dropout on."""
        x = dropout(self.embed(tokens), self.dropout, rng).transpose(0, 1)   # [T, B, E]
        mask = (tokens != 0).to(self.dtype).T.unsqueeze(-1).contiguous()  # [T, B, 1]
        h_last = None
        for layer in range(self.num_layers):
            h_last, x = getattr(self, f"{self.cell}_{layer}")(x, mask, train=train)
            if layer + 1 < self.num_layers:
                x = dropout(x, self.dropout, rng)
        if self.return_sequence:
            return x.transpose(0, 1)
        return h_last


def factory(vocab_size: int, opt: Dict[str, Any], dtype=torch.float32,
            device="cpu", rnn_bwd: str = "bigmatmul") -> SeqEncoder:
    """Build the question encoder from the model.seq2vec config dict, as
    ``vqa_tpu/models/seq2vec.py::factory`` does."""
    arch = opt.get("arch", "lstm")
    if arch == "skipthoughts":  # the skip-thoughts shape: one GRU layer, 2400 units
        hidden_size, num_layers, cell = opt.get("hidden_size", 2400), 1, "gru"
    elif arch in ("lstm", "gru"):
        hidden_size, num_layers, cell = opt.get("hidden_size", 1024), opt.get("num_layers", 1), arch
    else:
        raise KeyError(f"unknown seq2vec arch {arch!r}")
    return SeqEncoder(
        vocab_size=vocab_size,
        emb_size=opt.get("emb_size", 620),
        hidden_size=hidden_size,
        num_layers=num_layers,
        dropout=opt.get("dropout", 0.0),
        cell=cell,
        return_sequence=opt.get("return_sequence", False),
        dtype=dtype,
        device=device,
        rnn_bwd=rnn_bwd,
    )
