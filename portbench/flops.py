"""Peaks of the card, the least time of a kernel call from its shapes, and
the model FLOPs of one question.

The peaks and the bounds of ``lstm_seq`` and ``relation_attend`` are
frozen copies of ``chip_smoke.py``'s (``PEAK_*``, ``HBM``, ``_bound``,
``_lstm_bound``, ``_glimpse_head_bound`` and the relation bound of
``_check_relation``), so that a change to the program cannot move the
yardstick. Bytes count each input read once and each output written once;
operations are those of the matrix products.

The model FLOPs count the matrix products of one question at its own
length ``t`` (the padding of a length bucket is not the model's work), as
the encoder's and the architecture's files under ``reference/`` list them
(``products``): for the LSTM its input product at each of its ``t`` words
and its recurrent product at the ``t - 1`` words after the first (the
state before the first is zero); for the architectures every dense layer,
MUTAN's core products, the glimpses' logits and weighted sums, and each
CoR step's relation scores and weighted sum. Elementwise work is not
counted. A training question adds the backward:
the gradient of each weight (one product as large as the forward's) and
of each input that needs one (another); the region features, which take
no gradient, need none.
"""

from __future__ import annotations

# published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
PEAK_BF16 = 989e12   # FLOP/s on the tensor cores
PEAK_FP32 = 67e12    # FLOP/s outside them
PEAK_TF32 = 495e12   # FLOP/s on the tensor cores in TF32
HBM = 3.35e12        # bytes/s


def bound_s(nbytes: float, flops: float = 0.0, peak: float = PEAK_BF16) -> float:
    """The least time the card could take: the larger of ``nbytes`` over
    HBM's rate and ``flops`` over ``peak``, in seconds."""
    return max(nbytes / HBM, flops / peak)


def lstm_seq_bound_s(T: int, B: int, H: int, elem: int = 2) -> float:
    """``lstm_seq(xg [T, B, 4H], mask [T, B, 1], wh [H, 4H])``: xg, mask and
    wh read once, h_last and seq written once; the T - 1 products
    h [B, H] x wh [H, 4H] (step 0 has none)."""
    flops = 2.0 * (T - 1) * B * H * 4 * H
    nbytes = elem * (T * B * 4 * H + T * B + 4 * H * H + B * H + T * B * H)
    return bound_s(nbytes, flops, PEAK_BF16 if elem == 2 else PEAK_FP32)


def relation_attend_bound_s(B: int, N: int, D: int, elem: int = 2) -> float:
    """``relation_attend(pg [B, N, D], r [B, N, D])``: pg and r read once,
    the output written once; the scores and the weighted sum, 2 B N N D
    multiply-adds each, whatever design serves the call."""
    return bound_s(elem * 3 * B * N * D, 2.0 * 2 * B * N * N * D,
                   PEAK_BF16 if elem == 2 else PEAK_FP32)


def glimpse_head_bound_s(B: int, R: int, M: int, G: int, D: int, elem: int = 2) -> float:
    """``glimpse_head(joint [B, R, M], w [M, G], b [G], v [B, R, D])``."""
    return bound_s(elem * (B * R * M + M * G + G + B * R * D + B * G * D + B * R * G),
                   2.0 * B * R * G * (M + D), PEAK_BF16 if elem == 2 else PEAK_FP32)


def _products(cfg: dict, t: int, regions: int, dim_v: int):
    """(flops, backward products) of each matrix product of one question
    of ``t`` words: the encoder's file's, then the architecture's file's
    (``reference.models.encoder``, ``reference.models.arch``)."""
    from portbench.reference import models

    enc = models.encoder(cfg)
    return enc.products(cfg, t) + models.arch(cfg).products(cfg, regions, enc.width(cfg), dim_v)


def question_flops(cfg: dict, t: int, regions: int, dim_v: int, train: bool = False) -> float:
    """Model FLOPs of one question of ``t`` words: the forward's, and with
    ``train`` the backward's too."""
    return sum(f * (1 + (n if train else 0)) for f, n in _products(cfg, t, regions, dim_v))


def flops_by_length(cfg: dict, maxlength: int, regions: int, dim_v: int, train: bool):
    """``question_flops`` for every length 0..maxlength, as a list."""
    return [question_flops(cfg, t, regions, dim_v, train) for t in range(maxlength + 1)]
