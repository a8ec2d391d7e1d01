"""The one-layer LSTM question encoder (``seq2vec.arch: lstm``): a word
embedding, then an LSTM whose last hidden state at each question's last
word is the question vector.

Parameters ``encoder/embed/embedding [words, E]``, ``encoder/lstm_0/wx
[E, 4H]``, ``wh [H, 4H]`` and ``b [4H]``, the gates in the order i, f, g, o.
"""

from __future__ import annotations

import torch

from portbench.reference.models import Dropout, Params, Precision
from portbench.reference.params import Spec


def _check(cfg: dict) -> dict:
    s2v = cfg["model"]["seq2vec"]
    if s2v.get("num_layers", 1) != 1:
        raise NotImplementedError(f"the reference has a one-layer LSTM, not {s2v}")
    return s2v


def width(cfg: dict) -> int:
    return _check(cfg)["hidden_size"]


def params(cfg: dict) -> Spec:
    s2v = _check(cfg)
    e, h = s2v["emb_size"], s2v["hidden_size"]
    return [("encoder/embed/embedding", (cfg["num_words"], e)),
            ("encoder/lstm_0/wx", (e, 4 * h)), ("encoder/lstm_0/wh", (h, 4 * h)),
            ("encoder/lstm_0/b", (4 * h,))]


def encode(cfg: dict, P: Params, tokens: torch.Tensor, drop: Dropout, p: Precision):
    """The last hidden state of each question; the gates' arithmetic in
    float32, h and c stored after each step, the state frozen on padding."""
    rate = cfg["model"]["seq2vec"].get("dropout", 0.0)
    x = drop(p.st(P["encoder/embed/embedding"][tokens.long()]), rate)   # [B, T, E]
    xg = p.st(p.mm(x, P["encoder/lstm_0/wx"]) + P["encoder/lstm_0/b"])  # [B, T, 4H]
    wh = P["encoder/lstm_0/wh"]
    B, T = tokens.shape
    h = xg.new_zeros(B, wh.shape[0])
    c = torch.zeros_like(h)
    for t in range(T):
        i, f, g, o = (xg[:, t] + p.mm(h, wh)).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        real = (tokens[:, t] != 0)[:, None]
        h, c = p.st(torch.where(real, h_new, h)), p.st(torch.where(real, c_new, c))
    return h


def products(cfg: dict, t: int) -> list:
    """(flops, backward products) of a question of ``t`` words: the input
    product at each word, the recurrent product at the ``t - 1`` words after
    the first (the state before the first is zero)."""
    s2v = _check(cfg)
    E, H = s2v["emb_size"], s2v["hidden_size"]
    return [(2.0 * t * E * 4 * H, 2), (2.0 * max(t - 1, 0) * H * 4 * H, 2)]
