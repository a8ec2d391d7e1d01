"""Masked LSTM recurrence, the port of ``vqa_tpu/ops/lstm.py`` (forward).

lstm_seq(xg [T, B, 4H], mask [T, B, 1], wh [H, 4H]) -> (h_last [B, H],
seq [T, B, H])

``xg`` is the input-side projection for all T steps, computed beforehand by
one GEMM (models/seq2vec.py). Gates are in i, f, g, o order. Where the mask
is 0, h and c stay frozen and ``seq`` is 0, so ``h_last`` is each row's last
real step whichever side the padding is on.

On CUDA tensors this launches the hand-written kernel in ``csrc/lstm.cu``
(bf16, one launch per step); on CPU tensors it takes the plain version. The
training path (the hand-written big-matmul backward,
``vqa_tpu/ops/lstm.py::_lstm_seq_bigmatmul``) is not ported yet.
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops import _build

TRAIN_NOT_PORTED = (
    "training is not ported yet: the LSTM backward and the train step are "
    "ROADMAP.md queue 1, item 5"
)


def lstm_seq_reference(xg: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor):
    T, B, _ = xg.shape
    H = wh.shape[0]
    h = xg.new_zeros(B, H)
    c = xg.new_zeros(B, H)
    seq = []
    for t in range(T):
        gates = xg[t] + h @ wh
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        m = mask[t]
        keep = m != 0
        h = torch.where(keep, new_h, h)
        c = torch.where(keep, new_c, c)
        seq.append(new_h * m)
    return h, torch.stack(seq)


def lstm_seq(xg: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor, train: bool = False):
    if train:
        raise NotImplementedError(TRAIN_NOT_PORTED)
    if xg.device.type == "cpu":
        return lstm_seq_reference(xg, mask, wh)
    if xg.ndim != 3 or wh.ndim != 2:
        raise ValueError(f"expected xg [T, B, 4H] and wh [H, 4H], got {tuple(xg.shape)}, "
                         f"{tuple(wh.shape)}")
    T, B, G4 = xg.shape
    H = wh.shape[0]
    if T < 1 or G4 != 4 * H:
        raise ValueError(f"xg {tuple(xg.shape)} does not match wh {tuple(wh.shape)}")
    dev, dt = xg.device, torch.bfloat16
    _build.require("xg", xg, dev, dt, (T, B, 4 * H))
    _build.require("mask", mask, dev, dt, (T, B, 1))
    _build.require("wh", wh, dev, dt, (H, 4 * H))
    h_last = torch.empty(B, H, dtype=dt, device=dev)
    seq = torch.empty(T, B, H, dtype=dt, device=dev)
    h_tmp = torch.empty(B, H, dtype=dt, device=dev)
    c = torch.empty(B, H, dtype=dt, device=dev)
    err = _build.library().vqa_lstm_seq(
        xg.data_ptr(), mask.data_ptr(), wh.data_ptr(), h_last.data_ptr(), seq.data_ptr(),
        h_tmp.data_ptr(), c.data_ptr(), T, B, H, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "lstm_seq")
    lstm_seq.launches += T  # one kernel launch per step
    return h_last, seq


lstm_seq.launches = 0
