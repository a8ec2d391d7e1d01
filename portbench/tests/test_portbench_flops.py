"""The FLOP and byte counters against hand-worked numbers."""

import pytest

from portbench import flops
from conftest import HERE, _json


def test_mutan_att_per_question_at_seven_words():
    cfg = _json(f"{HERE}/configs/mutan_att.json")
    hand = (2 * 7 * 620 * 9600            # LSTM input product, 7 words
            + 2 * 6 * 2400 * 9600         # recurrent product after the first word
            + 2 * 2400 * 310 + 2 * 36 * 2048 * 310        # attention: q_proj, v_proj
            + 2 * 310 * 2550 + 2 * 36 * 310 * 2550        # attention: the core products
            + 2 * 36 * 510 * 2 + 2 * 36 * 2 * 2048        # glimpse logits, weighted sums
            + 2 * 2400 * 310 + 2 * 4096 * 620             # final fusion: q_proj, v_proj
            + 2 * 310 * 2550 + 2 * 620 * 2550             # final fusion: the core products
            + 2 * 510 * 2000)                             # classifier
    assert hand == 479_222_752
    assert flops.question_flops(cfg, 7, 36, 2048) == hand


def test_mutan_att_training_adds_the_backward():
    cfg = _json(f"{HERE}/configs/mutan_att.json")
    fwd = flops.question_flops(cfg, 7, 36, 2048)
    # the backward is twice the forward but for the product over the
    # features (v_proj of the attention) and the weighted sums, whose
    # inputs take no gradient: once each
    once = 2 * 36 * 2048 * 310 + 2 * 36 * 2 * 2048
    assert flops.question_flops(cfg, 7, 36, 2048, train=True) == 3 * fwd - once


def test_cor_per_question():
    cfg = _json(f"{HERE}/configs/cor.json")
    step = 4 * 2 * 36 * 1024 * 1024 + 2 * 1024 * 1024 + 2 * 36 * 1024 + 2 * 1024 * 1024 \
        + 2 * 2 * 36 * 36 * 1024
    hand = (2 * 7 * 620 * 4096 + 2 * 6 * 1024 * 4096 + 2 * 36 * 2048 * 1024 + 3 * step
            + 2 * 1024 * 3 + 2 * 1024 * 1024 + 2 * 1024 * 3000)
    assert flops.question_flops(cfg, 7, 36, 2048) == hand


def test_relation_attend_bound_at_the_cor_eval_shape():
    # B=1024 N=36 D=1024 bf16: pg, r in, out written, 226,492,416 bytes at
    # 3.35 TB/s (0.0676 ms) against 5.4 GFLOP at 989 TFLOP/s (0.0055 ms)
    nbytes = 2 * 3 * 1024 * 36 * 1024
    assert nbytes == 226_492_416
    assert flops.relation_attend_bound_s(1024, 36, 1024) == pytest.approx(nbytes / 3.35e12)
    assert flops.relation_attend_bound_s(1024, 36, 1024) * 1e3 == pytest.approx(0.0676, abs=1e-4)


def test_lstm_seq_bound_at_the_eval_shape():
    # T=7 B=1024 H=2400: six products of [1024, 2400] x [2400, 9600] at the
    # bf16 peak, 0.2862 ms; its bytes (223 MB) need 0.0666 ms
    flops_ = 2.0 * 6 * 1024 * 2400 * 9600
    assert flops.lstm_seq_bound_s(7, 1024, 2400) == pytest.approx(flops_ / 989e12)
    nbytes = 2 * (7 * 1024 * 9600 + 7 * 1024 + 2400 * 9600 + 1024 * 2400 + 7 * 1024 * 2400)
    assert nbytes / 3.35e12 < flops_ / 989e12


def test_glimpse_head_bound_at_the_mutan_eval_shape():
    # B=1024 R=36 M=510 G=2 D=2048 bf16: joint, v in; attended, logits out
    nbytes = 2 * (1024 * 36 * 510 + 510 * 2 + 2 + 1024 * 36 * 2048 + 1024 * 2 * 2048
                  + 1024 * 36 * 2)
    assert flops.glimpse_head_bound_s(1024, 36, 510, 2, 2048) == pytest.approx(nbytes / 3.35e12)


def test_classes_name_the_ports_kernels():
    from portbench.trace import classify

    assert classify("void (anonymous namespace)::lstm_seq_kernel<2, 4, 2>(CUtensorMap_st)") \
        == "lstm_seq"
    assert classify("void (anonymous namespace)::relation_element_kernel<true>(bf16*)") \
        == "relation_attend"
    assert classify("cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm>") == "gemm"
    assert classify("at::native::vectorized_elementwise_kernel<8, tanh_kernel_cuda>") \
        == "elementwise"
