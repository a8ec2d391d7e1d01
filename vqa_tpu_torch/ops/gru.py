"""Masked GRU recurrence, the port of ``vqa_tpu/ops/gru.py`` (forward).

gru_seq(gx [T, B, 3H], mask [T, B, 1], wh [H, 3H], bh [3H]) -> (h_last [B, H],
seq [T, B, H])

``gx`` is the input-side projection for all T steps (``x @ wx + bx``),
computed beforehand by one GEMM (models/seq2vec.py). Gates are in r, z, n
order, and ``bh`` enters inside the reset gate's product:
n = tanh(gx_n + r * (h @ wh_n + bh_n)). Where the mask is 0, h stays frozen
and ``seq`` is 0, so ``h_last`` is each row's last real step whichever side
the padding is on.

The JAX package runs this recurrence as an XLA ``lax.scan``, not as a Pallas
kernel, so the port's version is plain PyTorch on every device: a loop of T
steps, each one matmul and the gate math. As there, the recurrent product is
taken in the compute dtype (``gx``'s) and ``bh`` is cast to it. The training
path (the big-matmul backward, ``vqa_tpu/ops/gru.py::_bm_bwd``) is not
ported yet: ``train=True`` raises ``TRAIN_NOT_PORTED``.
"""

from __future__ import annotations

import torch

TRAIN_NOT_PORTED = (
    "training the GRU encoder (gru, skipthoughts) is not ported yet: its "
    "big-matmul backward is ROADMAP.md queue 2, section A7, with the MFB/MFH and "
    "CoR train steps in queue 1, item 5c"
)


def gru_seq_reference(gx: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
                      bh: torch.Tensor):
    T, B, _ = gx.shape
    H = wh.shape[0]
    h = gx.new_zeros(B, H)
    bh = bh.to(gx.dtype)
    seq = []
    for t in range(T):
        gh = h @ wh + bh  # rounded after the product, then after the add, as in JAX
        rx, zx, nx = gx[t].chunk(3, dim=-1)
        rh, zh, nh = gh.chunk(3, dim=-1)
        r = torch.sigmoid(rx + rh)
        z = torch.sigmoid(zx + zh)
        n = torch.tanh(nx + r * nh)
        new_h = (1.0 - z) * n + z * h
        m = mask[t]
        h = torch.where(m != 0, new_h, h)
        seq.append(new_h * m)
    return h, torch.stack(seq)


def gru_seq(gx: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
            train: bool = False):
    if train:
        raise NotImplementedError(TRAIN_NOT_PORTED)
    return gru_seq_reference(gx, mask, wh, bh)
