"""The port's kernels (vqa_tpu_torch/ops) against the JAX package's.

On the CPU each wrapper takes its plain PyTorch version; that version is
held to 1e-5 (float32) of both the JAX jnp reference and the JAX Pallas
kernel run in TPU interpret mode, on the same numpy inputs. The CUDA kernels
themselves run only on a card: those tests carry the ``cuda`` marker and
skip here (chip_smoke.py runs the same comparisons at the flagship shapes).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vqa_tpu.ops import attention as jax_attention
from vqa_tpu.ops import gather as jax_gather
from vqa_tpu.ops import gru as jax_gru
from vqa_tpu.ops import lstm as jax_lstm
from vqa_tpu.ops import mfb_pool as jax_mfb_pool
from vqa_tpu.ops import relation as jax_relation
from vqa_tpu_torch.engine.steps import quantize_features
from vqa_tpu_torch.ops import _build
from vqa_tpu_torch.ops.attention import (SMEM_LIMIT as GLIMPSE_SMEM_LIMIT, glimpse_attend,
                                         glimpse_attend_reference, glimpse_head,
                                         glimpse_head_reference, glimpse_plan)
from vqa_tpu_torch.ops.gather import (gather_rows, gather_rows_dequant,
                                      gather_rows_dequant_reference, gather_rows_reference)
from vqa_tpu_torch.ops.gru import gru_seq, gru_seq_reference
from vqa_tpu_torch.ops.lstm import (SMEM_LIMIT, SMS, gate_strips, launch_geometry, lstm_plan,
                                    lstm_seq, lstm_seq_reference, pad_odd_hidden)
from vqa_tpu_torch.ops.mfb_pool import mfb_pool, mfb_pool_reference
from vqa_tpu_torch.ops.relation import launch_geometry as relation_geometry
from vqa_tpu_torch.ops.relation import (relation_attend, relation_attend_reference,
                                        relation_plan)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)  # float32 on both sides; sums in another order
# lstm_seq on the card against its plain version in float32: twice the worst
# error chip_smoke.py measured over its shapes (as its LSTM_ATOL)
LSTM_ATOL = 0.0092


@pytest.fixture(autouse=True)
def _interpret_kernels():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _lstm_inputs(seed, T, B, H):
    """Mixed lengths (1 and T included), a third of the rows left-padded."""
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B)
    lengths[:2] = (1, T)
    left = np.arange(B) % 3 == 0
    t = np.arange(T)[:, None]
    valid = np.where(left[None, :], t >= T - lengths[None, :], t < lengths[None, :])
    return xg, valid[..., None].astype(np.float32), wh


@pytest.mark.parametrize("T,B,H,block_b", [(6, 12, 20, 4), (5, 7, 13, 7), (1, 3, 8, 3)])
def test_lstm_seq_plain_matches_jax(T, B, H, block_b):
    """H not a multiple of 8, B not a multiple of the CUDA kernel's 64-row
    tile, left padding, length-1 rows."""
    xg, mask, wh = _lstm_inputs(T * 100 + B, T, B, H)
    h, seq = lstm_seq(torch.from_numpy(xg), torch.from_numpy(mask), torch.from_numpy(wh))
    args = (jnp.asarray(xg), jnp.asarray(mask), jnp.asarray(wh))
    for want_h, want_seq in (jax_lstm.lstm_seq_reference(*args),
                             jax_lstm._pallas_fwd(*args, block_b=block_b)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
        np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), **TOL)


def test_lstm_seq_left_padding_ends_on_last_token():
    """A left-padded row's h_last equals the same tokens right-padded."""
    T, H = 5, 6
    xg, _, wh = _lstm_inputs(3, T, 2, H)
    xg[:, 1] = np.roll(xg[:, 0], 2, axis=0)     # row 1 = row 0 shifted right by 2
    mask = np.zeros((T, 2, 1), np.float32)
    mask[:3, 0] = 1                             # row 0: right-padded, length 3
    mask[2:, 1] = 1                             # row 1: left-padded, length 3
    h, _ = lstm_seq(*(torch.from_numpy(a) for a in (xg, mask, wh)))
    np.testing.assert_allclose(h[0].numpy(), h[1].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,H", [(1024, 2400), (1024, 1024), (64, 2400), (64, 1024)])
def test_lstm_plan_fills_the_card_within_its_limits(B, H):
    """The tile class csrc/lstm.cu runs at the archs' eval (B=1024) and
    serving (B=64) shapes: at the eval batch at least 132 CTAs and 1.8
    waves; at the serving batch one CTA per tile, all in one wave; always
    shared memory within a Hopper block's 232,448 bytes and a wgmma N that is
    a multiple of 8 and at most 256.

    The serving batch misses the target the design set out with (at least
    132 CTAs or 1.8 waves at every one of these shapes): it runs 38 CTAs at
    H=2400 and 16 at H=1024, because split-K and narrower tiles measured no
    faster there (PERF.md, Findings, PR 4, the serving-batch paragraph)."""
    plan = lstm_plan(B, H)
    if B >= 512:
        assert plan["ctas"] >= SMS and plan["waves"] >= 1.8
    else:
        assert plan["ctas"] == plan["tiles"] and plan["waves"] <= 1
    assert plan["smem_bytes"] <= SMEM_LIMIT
    assert plan["n"] % 8 == 0 and plan["n"] <= 256
    assert plan["hp"] % 8 == 0 and plan["hp"] >= H


def test_lstm_plan_pairs_the_large_batch_in_clusters():
    big, small = lstm_plan(1024, 2400), lstm_plan(1024, 1024)
    assert (big["wg"], big["cluster"], big["bm"], big["tiles"]) == (2, 2, 128, 304)
    # 152 pair-tiles on 66 pairs: two full rounds, then 20 tiles x 3 K ranges
    assert (big["full_rounds"], big["tail_tiles"], big["tail_split"]) == (2, 20, 3)
    assert (small["wg"], small["cluster"], small["bm"], small["tiles"]) == (1, 1, 64, 256)
    # wh crosses L2 once per 256 rows, h once per 64 units
    assert big["l2_bytes_per_step"] == 2 * 2400 * 1024 * 9600 * (1 / 256 + 1 / 256)
    # an odd number of 128-row tiles is paired with an empty one
    assert lstm_plan(1100, 2400)["tiles"] == 10 * 38


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(1024, 2400), (1024, 1024), (64, 2400), (64, 1024),
                                 (1100, 2400), (37, 42)])
def test_lstm_plan_matches_the_card(cuda_device, B, H):
    """lstm_plan reckons the schedule in Python; the kernel reckons it in
    C++ from the card's occupancy. On a card with 132 SMs they agree on the
    CTAs, the tiles, the tail and the shared memory."""
    if torch.cuda.get_device_properties(cuda_device).multi_processor_count != SMS:
        pytest.skip(f"lstm_plan reckons with the {SMS} SMs of an H100 SXM")
    plan = lstm_plan(B, H)
    geometry = launch_geometry(B, H, plan["wg"], cuda_device.index or 0)
    assert {k: plan[k] for k in geometry if k != "part_bytes"} == \
        {k: v for k, v in geometry.items() if k != "part_bytes"}


@pytest.mark.parametrize("B,H", [(64, 41), (1024, 2399), (0, 64), (8, 0)])
def test_lstm_plan_refuses_shapes_it_cannot_describe(B, H):
    with pytest.raises(ValueError, match="lstm_seq"):
        lstm_plan(B, H)


@pytest.mark.parametrize("H", [40, 42, 96])
def test_gate_strips_start_on_16_bytes(H):
    """wh as the kernel's tensor map reads it: the four gate strips gs
    elements apart, gs a multiple of 8; a padded copy keeps every strip in
    order (no permutation) with zeros after it."""
    wh = torch.randn(H, 4 * H)
    padded, gs = gate_strips(wh)
    assert gs % 8 == 0 and H <= gs < H + 8
    if gs == H:
        assert padded is wh
    strips = padded.view(H, 4, gs)
    torch.testing.assert_close(strips[:, :, :H], wh.view(H, 4, H), rtol=0, atol=0)
    assert bool((strips[:, :, H:] == 0).all())


def test_lstm_seq_train_is_not_ported():
    """The train path is ported: lstm_seq(train=True) gives the eval
    forward bit for bit and, with rnn_bwd bigmatmul, the grads of
    jax.vjp(_lstm_seq_bigmatmul) (float32; dmask 0); an unknown rnn_bwd is
    refused."""
    xg, mask, wh = _lstm_inputs(0, 5, 6, 4)
    args = [torch.from_numpy(a).requires_grad_() for a in (xg, mask, wh)]
    h, seq = lstm_seq(*args, train=True)
    want_h, want_seq = lstm_seq(*(torch.from_numpy(a) for a in (xg, mask, wh)))
    assert torch.equal(h.detach(), want_h) and torch.equal(seq.detach(), want_seq)
    got = torch.autograd.grad((h.sum(), seq.sum()), args)
    _, vjp = jax.vjp(jax_lstm._lstm_seq_bigmatmul, *(jnp.asarray(a) for a in (xg, mask, wh)))
    want = vjp((jnp.ones_like(want_h.numpy()), jnp.ones_like(want_seq.numpy())))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert bool((got[1] == 0).all())
    with pytest.raises(ValueError, match="rnn_bwd"):
        lstm_seq(*args, train=True, rnn_bwd="scan")


def _gru_inputs(seed, T, B, H):
    """The LSTM's masks (mixed lengths, 1 and T included, a third of the rows
    left-padded) with row 2 fully padded; gx [T, B, 3H], wh [H, 3H], a
    non-zero bh."""
    xg, mask, _ = _lstm_inputs(seed, T, B, H)
    rng = np.random.default_rng(seed + 1)
    mask[:, 2] = 0
    wh = (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    bh = (0.3 * rng.standard_normal(3 * H)).astype(np.float32)
    return np.ascontiguousarray(xg[..., : 3 * H]), mask, wh, bh


@pytest.mark.parametrize("T,B,H", [(6, 12, 20), (5, 7, 13), (1, 3, 8)])
def test_gru_seq_matches_jax(T, B, H):
    """The plain GRU recurrence (the only one: the JAX package's is no Pallas
    kernel) against gru_seq_reference, float32: h_last and seq, a fully
    padded row staying at zero."""
    gx, mask, wh, bh = _gru_inputs(T, T, B, H)
    h, seq = gru_seq(*(torch.from_numpy(a) for a in (gx, mask, wh, bh)))
    want_h, want_seq = jax_gru.gru_seq_reference(*(jnp.asarray(a) for a in (gx, mask, wh, bh)))
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), **TOL)
    assert bool((h[2] == 0).all()) and bool((seq[:, 2] == 0).all())


def test_gru_seq_left_padding_ends_on_last_token():
    """A left-padded row ends where its right-padded twin does."""
    gx, _, wh, bh = _gru_inputs(3, 5, 3, 6)
    gx[:, 1] = np.roll(gx[:, 0], 2, axis=0)
    mask = np.zeros((5, 3, 1), np.float32)
    mask[:3, 0] = 1
    mask[2:, 1] = 1
    h, _ = gru_seq(*(torch.from_numpy(a) for a in (gx, mask, wh, bh)))
    torch.testing.assert_close(h[1], h[0], rtol=0, atol=0)


def test_gru_seq_bf16_matches_jax():
    """bf16 on both sides: the recurrent product in bf16 and bh cast to it,
    as the JAX reference computes it; within the watch list's bf16
    tolerance of JAX's bf16 run, and of the float32 one."""
    gx, mask, wh, bh = _gru_inputs(4, 13, 16, 24)
    h, seq = gru_seq(*(torch.from_numpy(a).bfloat16() for a in (gx, mask, wh)),
                     torch.from_numpy(bh))
    assert h.dtype == seq.dtype == torch.bfloat16
    want = jax_gru.gru_seq_reference(*(jnp.asarray(a, jnp.bfloat16) for a in (gx, mask, wh)),
                                     jnp.asarray(bh))
    exact = jax_gru.gru_seq_reference(*(jnp.asarray(a) for a in (gx, mask, wh, bh)))
    for got, w, e in zip((h, seq), want, exact):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(w, np.float32), atol=0.05,
                                   rtol=0)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(e), atol=0.05, rtol=0)


@pytest.mark.parametrize("H", [41, 43])
def test_odd_hidden_padding_is_exact(H):
    """lstm_seq's wrapper runs an odd H as H + 1 units (the kernel takes an
    even H): the plain version over the padded inputs, sliced back to H,
    equals the plain version on the originals bit for bit, and the padded
    unit stays 0 at every step."""
    xg, mask, wh = (torch.from_numpy(a) for a in _lstm_inputs(H, 6, 9, H))
    xp, wp = pad_odd_hidden(xg, wh)
    assert xp.shape == (6, 9, 4 * (H + 1)) and wp.shape == (H + 1, 4 * (H + 1))
    h, seq = lstm_seq_reference(xg, mask, wh)
    hp, seqp = lstm_seq_reference(xp, mask, wp)
    assert torch.equal(hp[:, :H], h) and torch.equal(seqp[..., :H], seq)
    assert bool((hp[:, H] == 0).all()) and bool((seqp[..., H] == 0).all())


@pytest.mark.parametrize("G", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("R", [7, 36, 196])
@pytest.mark.parametrize("M", [510, 512, 4096])
def test_glimpse_plan_takes_every_glimpse_count(G, R, M):
    """Any G, R up to the 196-region grid and M up to 4096 plan within a
    Hopper block's shared memory, at the eval and the serving batch and on
    the generic path (D % 8 != 0): the parent kernel only for G <= 4, else
    the ring, whose split CTAs keep >= 512 columns on a multiple of 8; the
    serving batch fills the SMs where D allows."""
    for B, D, vec in ((1024, 2048, True), (64, 2048, True), (64, 1024, True), (5, 75, False)):
        plan = glimpse_plan(B, R, M, G, D, vec=vec)
        dc = D // plan["split"]
        assert plan["smem_bytes"] <= GLIMPSE_SMEM_LIMIT
        assert plan["split"] == 1 or (dc % 8 == 0 and dc >= 512 and plan["split"] <= 8)
        assert plan["ctas"] == B * plan["split"]
        assert plan["copy"] != "parent" or (G <= 4 and B >= 4 * 132 and M > 0)
        if not vec:
            assert (plan["copy"], plan["split"], plan["stages"]) == ("plain", 1, 1)
        if B == 64 and vec:
            assert plan["ctas"] >= 128


def test_glimpse_plan_at_the_archs_shapes():
    """The schedules the archs run: the parent kernel where it measured
    fastest (glimpse_head at batch 1024, MutanAtt and MFB/MFH); the ring
    elsewhere: the serving batch over clusters of 4 (256 CTAs), all of a
    CTA's v, w and joint slice in flight at once; glimpse_attend (MFB's
    question self-attention, D=1024) one CTA a row at batch 1024 and CTA
    pairs at the serving batch; 8 glimpses and the 196-region grid (a ring
    refilled as it drains)."""
    assert [glimpse_plan(1024, 36, m, 2, 2048)["copy"] for m in (510, 512)] == ["parent"] * 2
    serve = glimpse_plan(64, 36, 510, 2, 2048)
    assert (serve["copy"], serve["split"], serve["ctas"], serve["staged"], serve["resident"]) == \
        ("bulk", 4, 256, True, True)
    assert {glimpse_plan(1024, t, 0, 2, 1024)["copy"] for t in (7, 13, 26)} == {"bulk"}
    assert glimpse_plan(64, 26, 0, 2, 1024)["split"] == 2
    assert glimpse_plan(1024, 36, 510, 8, 2048)["copy"] == "bulk"
    ring = glimpse_plan(64, 196, 510, 2, 2048)
    assert ring["copy"] == "bulk" and not ring["resident"] and ring["stages"] == 4


@pytest.mark.parametrize("M,G", [(1024, 1), (1200, 2)])
def test_glimpse_plan_at_the_concat_and_mlb_shapes(M, G):
    """ConcatAtt (its 1024-wide hidden layer, one glimpse) and MLBAtt (the
    1200-wide MLB fusion, two glimpses): the parent kernel at batch 1024
    within its shared memory, the ring at the serving batch over clusters
    of 4 with w and the joint slice staged."""
    parent = glimpse_plan(1024, 36, M, G, 2048)
    assert parent["copy"] == "parent" and parent["smem_bytes"] == (M + 36) * G * 4
    serve = glimpse_plan(64, 36, M, G, 2048)
    assert (serve["copy"], serve["split"], serve["ctas"], serve["staged"], serve["resident"]) == \
        ("bulk", 4, 256, True, True)
    assert serve["smem_bytes"] <= GLIMPSE_SMEM_LIMIT


def test_glimpse_plan_refuses_only_past_shared_memory():
    """alpha [R, G] past shared memory takes the split design where forced
    (by default in bf16 the tc design; R=196 with G=512: alpha alone is 196
    x 512 floats; every region in one block, the glimpses in groups small
    enough to fill 264 blocks at B=8, the two largest groups that fit at
    B=1024), as does a card too small for the ring; only a limit below one
    region of one glimpse group refuses."""
    assert glimpse_plan(8, 196, 510, 512, 2048)["copy"] == "tc"
    big = glimpse_plan(8, 196, 510, 512, 2048, copy="split")
    assert (big["copy"], big["groups"], big["chunks"], big["ctas"]) == ("split", 16, 1, 256)
    assert big["smem_bytes"] == 196 * 16 * 4
    eval_batch = glimpse_plan(1024, 196, 510, 512, 2048, copy="split")
    assert (eval_batch["groups"], eval_batch["chunks"]) == (256, 1)
    assert eval_batch["smem_bytes"] == 196 * 256 * 4 <= GLIMPSE_SMEM_LIMIT
    small = glimpse_plan(8, 36, 510, 2, 2048, smem_limit=1024)
    assert small["copy"] == "split" and small["smem_bytes"] <= 1024
    with pytest.raises(ValueError, match="shared memory"):
        glimpse_plan(8, 36, 510, 2, 2048, smem_limit=4)  # one region of 2 glimpses: 8 bytes
    with pytest.raises(ValueError, match="B, R, G, D >= 1"):
        glimpse_plan(8, 36, 510, 0, 2048)
    assert glimpse_plan(8, 36, 510, 2, 2048, smem_limit=8192)["smem_bytes"] <= 8192


@pytest.mark.parametrize("B,N,D,smem_limit,vec,design,split", [
    (1024, 36, 1024, 232_448, True, "element", 2),   # CoR eval: a CTA pair an element
    (64, 36, 1024, 232_448, True, "element", 2),     # serving
    (1024, 48, 1024, 232_448, True, "element", 1),   # a pair would hold an SM alone
    (1024, 48, 1024, 120_000, True, "element", 4),   # a CTA pair does not fit
    (1024, 64, 1024, 232_448, True, "tiled", 1),     # measured faster than the element design
    (1024, 36, 1024, 48_000, True, "element", 8),    # a smaller card: split further
    (5, 7, 33, 232_448, False, "element", 1),        # plain copies: one CTA an element
    (1024, 65, 1024, 232_448, True, "tiled", 1),
    (1024, 196, 1024, 232_448, True, "tiled", 1),    # the extract CLI's grid
    (8, 64, 4000, 232_448, True, "tiled", 1),        # r past an element CTA even split
    (8, 784, 1024, 232_448, True, "tc", 1),          # the grid of a 896-pixel image
    (8, 784, 1024, 232_448, False, "wide", 1),       # the same with no TMA
])
def test_relation_entry_by_shape(B, N, D, smem_limit, vec, design, split):
    """relation_plan: N <= 48 takes the element design, D split over a CTA
    pair where two fit on an SM (else the fewest CTAs that fit), anything
    else the tiled design (past its shared memory the tc one, two wgmma
    kernels, or with no TMA the wide one); only shared memory refuses a
    shape."""
    plan = relation_plan(B, N, D, vec=vec, smem_limit=smem_limit)
    assert (plan["design"], plan["split"]) == (design, split)
    assert plan["smem_bytes"] <= smem_limit
    if design == "element":
        assert plan["ctas"] == B * split and plan["cluster"] == split
        assert split == 1 or (D // split) % 16 == 0
    elif design == "tc":  # the scores' launch: a CTA 128 rows x a column tile of s
        assert plan["ctas"] == B * -(-N // plan["rows"]) * plan["tiles"] and plan["stages"] == 4
        assert plan["weighted"]["ctas"] == B * -(-N // plan["rows"]) * -(-D // plan["tile"])
    else:
        assert plan["ctas"] == B * -(-N // plan["rows"]) and 1 <= plan["stages"] <= 4
    with pytest.raises(ValueError, match="shared memory"):
        relation_plan(B, N, D, vec=vec, smem_limit=1024)


def test_relation_plan_takes_the_most_stages_that_fit():
    """The tiled ring keeps up to 4 stages, fewer where shared memory is
    short; a forced split that the columns cannot take is refused."""
    assert relation_plan(1024, 196, 1024)["stages"] == 4
    assert relation_plan(1024, 196, 1024, smem_limit=150_000)["stages"] == 2
    assert relation_plan(64, 300, 1024)["stages"] >= 1
    with pytest.raises(ValueError, match="split=4"):
        relation_plan(8, 36, 40, design="element", split=4)


@pytest.mark.parametrize("B,R,M,G,D,block_b", [(8, 36, 48, 2, 64, 8), (6, 9, 13, 3, 10, 3),
                                               (8, 36, 24, 8, 16, 8), (8, 196, 20, 2, 16, 8)])
def test_glimpse_head_plain_matches_jax(B, R, M, G, D, block_b):
    rng = np.random.default_rng(B * R)
    joint = np.tanh(rng.standard_normal((B, R, M))).astype(np.float32)
    w = rng.standard_normal((M, G)).astype(np.float32)
    b = rng.standard_normal((G,)).astype(np.float32)
    v = rng.standard_normal((B, R, D)).astype(np.float32)
    att, logits = glimpse_head(*(torch.from_numpy(a) for a in (joint, w, b, v)))
    args = tuple(jnp.asarray(a) for a in (joint, w, b, v))
    for want_att, want_logits in (jax_attention.glimpse_head_reference(*args),
                                  jax_attention._head_pallas(*args, block_b=block_b)):
        np.testing.assert_allclose(att.numpy(), np.asarray(want_att), **TOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)


def _masked_logits(rng, B, R, G):
    """Logits masked as MFB's question self-attention masks them: mixed
    lengths, a left-padded row and one fully masked row."""
    logits = rng.standard_normal((B, R, G)).astype(np.float32)
    valid = np.arange(R)[None, :] < rng.integers(1, R + 1, B)[:, None]
    valid[1] = valid[1][::-1]          # left-padded
    valid[2] = False                   # all padding
    return np.where(valid[..., None], logits, np.finfo(np.float32).min).astype(np.float32)


@pytest.mark.parametrize("B,R,G,D,masked", [(8, 7, 2, 16, False), (16, 13, 2, 24, True),
                                            (8, 36, 3, 10, False), (8, 36, 8, 16, True),
                                            (8, 196, 2, 16, True)])
def test_glimpse_attend_plain_matches_jax(B, R, G, D, masked):
    """B a multiple of the Pallas kernel's 8-row block; masked rows use
    finfo.min, and a fully masked row gives uniform weights, as in JAX."""
    rng = np.random.default_rng(B * R + G)
    logits = (_masked_logits(rng, B, R, G) if masked
              else rng.standard_normal((B, R, G)).astype(np.float32))
    v = rng.standard_normal((B, R, D)).astype(np.float32)
    got = glimpse_attend(torch.from_numpy(logits), torch.from_numpy(v))
    args = (jnp.asarray(logits), jnp.asarray(v))
    for want in (jax_attention.glimpse_attend_reference(*args),
                 jax_attention._pallas_fwd(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked:
        np.testing.assert_allclose(got[2].numpy(), np.broadcast_to(v[2].mean(0), (G, D)), **TOL)


def test_glimpse_attend_odd_shape_matches_the_jnp_reference():
    rng = np.random.default_rng(5)
    logits = _masked_logits(rng, 5, 9, 3)
    v = rng.standard_normal((5, 9, 11)).astype(np.float32)
    got = glimpse_attend(torch.from_numpy(logits), torch.from_numpy(v))
    want = jax_attention.glimpse_attend_reference(jnp.asarray(logits), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("lead,k,m", [((2, 3), 3, 7), ((256,), 5, 16), ((2, 64), 5, 12),
                                      ((100,), 2, 9)])
def test_mfb_pool_plain_matches_jax(lead, k, m):
    """Row counts up to 128 or a multiple of it (the Pallas grid drops a
    ragged tail); odd m; leading batch and region axes."""
    z = np.random.default_rng(m * k).standard_normal(lead + (k * m,)).astype(np.float32)
    got = mfb_pool(torch.from_numpy(z), k)
    for want in (jax_mfb_pool.mfb_pool_reference(jnp.asarray(z), k),
                 jax_mfb_pool._pallas_fwd(jnp.asarray(z), k)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mfb_pool_odd_row_count_matches_the_jnp_reference():
    z = np.random.default_rng(3).standard_normal((131, 3 * 5)).astype(np.float32)
    got = mfb_pool(torch.from_numpy(z), 3)
    want = jax_mfb_pool.mfb_pool_reference(jnp.asarray(z), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mfb_pool_groups_are_strided_not_contiguous():
    """pooled[d] = sum_j z[j*m + d]: on a row where the two groupings differ,
    the port gives the strided one."""
    k, m = 2, 3
    z = np.array([[1.0, 2.0, 3.0, 10.0, 20.0, 30.0]], np.float32)
    strided = z.reshape(1, k, m).sum(1)       # [11, 22, 33]
    contiguous = z.reshape(1, m, k).sum(2)    # [3, 13, 50]
    assert not np.allclose(strided / np.linalg.norm(strided),
                           contiguous / np.linalg.norm(contiguous))

    def finish(pooled):
        ss = np.sign(pooled) * np.sqrt(np.abs(pooled) + 1e-12)
        return ss / np.sqrt((ss * ss).sum(-1, keepdims=True) + 1e-12)

    got = mfb_pool(torch.from_numpy(z), k).numpy()
    np.testing.assert_allclose(got, finish(strided), **TOL)
    assert not np.allclose(got, finish(contiguous), atol=1e-2)


@pytest.mark.parametrize("B,N,D", [(8, 36, 16), (16, 5, 33), (8, 196, 16)])
def test_relation_attend_plain_matches_jax(B, N, D):
    rng = np.random.default_rng(B + N + D)
    pg = np.tanh(rng.standard_normal((B, N, D))).astype(np.float32)
    r = np.tanh(rng.standard_normal((B, N, D))).astype(np.float32)
    got = relation_attend(torch.from_numpy(pg), torch.from_numpy(r))
    args = (jnp.asarray(pg), jnp.asarray(r))
    for want in (jax_relation.relation_attend_reference(*args), jax_relation._pallas_fwd(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_relation_attend_odd_shape_matches_the_jnp_reference():
    rng = np.random.default_rng(7)
    pg, r = (rng.standard_normal((5, 7, 33)).astype(np.float32) for _ in range(2))
    got = relation_attend(torch.from_numpy(pg), torch.from_numpy(r))
    want = jax_relation.relation_attend_reference(jnp.asarray(pg), jnp.asarray(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("N", [36, 196])
def test_relation_alpha_split_keeps_fp32_accuracy(N):
    """The kernel's weighted sum takes alpha as two bf16 halves, hi =
    bf16(alpha) and lo = bf16(alpha - hi), each product summed in fp32.
    Emulated here in plain torch on bf16 inputs: within 1e-3 of the fp32
    plain version and of the JAX reference, and far closer than alpha
    rounded to bf16 once."""
    rng = np.random.default_rng(N)
    B, D = 4, 64
    pg, r = (torch.from_numpy(np.tanh(rng.standard_normal((B, N, D))).astype(np.float32))
             .bfloat16().float() for _ in range(2))
    alpha = torch.softmax(torch.einsum("bnd,bmd->bnm", pg, r) * D ** -0.5, dim=-1)
    hi = alpha.bfloat16().float()
    lo = (alpha - hi).bfloat16().float()
    split = torch.einsum("bnm,bmd->bnd", hi, r) + torch.einsum("bnm,bmd->bnd", lo, r)
    want = relation_attend_reference(pg, r)
    jax_want = np.asarray(jax_relation.relation_attend_reference(jnp.asarray(pg.numpy()),
                                                                 jnp.asarray(r.numpy())))
    err = (split - want).abs().max().item()
    assert err <= 1e-3
    np.testing.assert_allclose(split.numpy(), jax_want, atol=1e-3, rtol=0)
    hi_only = (torch.einsum("bnm,bmd->bnd", hi, r) - want).abs().max().item()
    assert err * 8 < hi_only


@pytest.mark.parametrize("n,tail,b", [(10, (4, 16), 16), (7, (3,), 5), (9, (2048,), 16)])
def test_gather_rows_plain_matches_jax(n, tail, b):
    rng = np.random.default_rng(n)
    table = rng.standard_normal((n,) + tail).astype(np.float32)
    idx = rng.integers(0, n, b).astype(np.int32)
    idx[: b // 2] = idx[0]  # repeated rows
    out = gather_rows(torch.from_numpy(table), idx)
    for want in (jax_gather.gather_rows_reference(jnp.asarray(table), jnp.asarray(idx)),
                 jax_gather._pallas_fwd(jnp.asarray(table), jnp.asarray(idx))):
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_gather_rows_checks_indices_on_the_host():
    table = torch.zeros(4, 3)
    for bad in ([0, 4], [-1], torch.tensor([5])):
        with pytest.raises(IndexError, match="out of range"):
            gather_rows(table, bad)
    with pytest.raises(TypeError, match="1-D integer"):
        gather_rows(table, np.zeros((2, 2), np.int64))
    assert gather_rows(table, torch.tensor([3, 3, 0])).shape == (3, 3)


def _jax_steps():
    """vqa_tpu.engine.steps, imported where it is used: it needs flax and
    optax, which the cuda-marked tests of this file do not."""
    from vqa_tpu.engine import steps

    return steps


@pytest.mark.parametrize("shape", [(6, 4, 16), (5, 33)])
def test_quantize_features_matches_jax(shape):
    """The port's copy of the int8 quantizer is byte-equal to the original,
    an all-zero row included."""
    jax_steps = _jax_steps()
    table = 3 * np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    table[0] = 0
    for got, want in zip(quantize_features(table), jax_steps.quantize_features(table)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("scale_dtype", ["bfloat16", "float32"])
def test_gather_rows_dequant_plain_matches_jax(scale_dtype):
    """int8 rows gathered, then dequantized in the scales' dtype, as JAX's
    _resolve_visual does with a (values, scales) table: through its jnp path
    and through the Pallas gather (interpret mode) on the int8 rows followed
    by its dequant. Exact (tolerance 0): int8 -> bf16 is exact (|v| <= 127)
    and each product is rounded once, on both sides."""
    _check_dequant_matches_jax(scale_dtype, (4, 16))


@pytest.mark.parametrize("scale_dtype", ["bfloat16", "float32"])
def test_gather_rows_dequant_plain_matches_jax_on_pooled_rows(scale_dtype):
    """The same on the NoAtt archs' pooled table: 2-D rows [N, 2048], one
    scale a row ([N, 1])."""
    _check_dequant_matches_jax(scale_dtype, (2048,))


def _check_dequant_matches_jax(scale_dtype, tail):
    jax_steps = _jax_steps()
    rng = np.random.default_rng(11)
    values, scales = quantize_features(rng.standard_normal((10,) + tail).astype(np.float32))
    idx = rng.integers(0, 10, 16).astype(np.int32)
    idx[:5] = idx[0]  # repeated rows
    got = gather_rows_dequant(torch.from_numpy(values),
                              torch.from_numpy(scales).to(getattr(torch, scale_dtype)), idx)
    jv, js, ji = jnp.asarray(values), jnp.asarray(scales, getattr(jnp, scale_dtype)), jnp.asarray(idx)
    via_jnp = jax_steps._resolve_visual({"image_index": ji}, (jv, js), allow_kernel=False)
    via_pallas = jax_gather._pallas_fwd(jv, ji).astype(js.dtype) * jnp.take(js, ji, axis=0)
    assert got.dtype == getattr(torch, scale_dtype) and got.shape == (16,) + tail
    for want in (via_jnp, via_pallas):
        assert want.dtype == js.dtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_gather_rows_dequant_checks_its_inputs():
    """The host checks of the int8 path: index range and rank, an int8
    table, bf16 or f32 scales of shape values.shape[:-1] + (1,)."""
    values, scales = torch.zeros(4, 3, 8, dtype=torch.int8), torch.ones(4, 3, 1)
    for bad in ([0, 4], [-1], torch.tensor([9])):
        with pytest.raises(IndexError, match="out of range"):
            gather_rows_dequant(values, scales, bad)
    with pytest.raises(TypeError, match="1-D integer"):
        gather_rows_dequant(values, scales, np.zeros((2, 2), np.int64))
    for bad_scales in (torch.ones(4, 3), torch.ones(4, 1, 1), torch.ones(3, 3, 1)):
        with pytest.raises(ValueError, match="one per row segment"):
            gather_rows_dequant(values, bad_scales, [0])
    with pytest.raises(TypeError, match="int8 table"):
        gather_rows_dequant(values.float(), scales, [0])
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        gather_rows_dequant(values, scales.half(), [0])
    out = gather_rows_dequant(values, scales.bfloat16(), np.array([3, 3, 0], np.uint8))
    assert out.shape == (3, 3, 8) and out.dtype == torch.bfloat16


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """A CPU tensor never reaches the kernel library, and counts no launch."""
    def no_library():
        raise AssertionError("CPU tensors must not build or load the CUDA kernels")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(_build, "build", no_library)
    wrappers = (gather_rows, gather_rows_dequant, lstm_seq, glimpse_head, glimpse_attend,
                mfb_pool, relation_attend)
    counts = [fn.launches for fn in wrappers]
    xg, mask, wh = (torch.from_numpy(a) for a in _lstm_inputs(1, 3, 4, 8))
    h, seq = lstm_seq(xg, mask, wh)
    ref_h, ref_seq = lstm_seq_reference(xg, mask, wh)
    assert torch.equal(h, ref_h) and torch.equal(seq, ref_seq)
    joint, w, b, v = torch.randn(2, 5, 6), torch.randn(6, 2), torch.randn(2), torch.randn(2, 5, 4)
    for got, want in zip(glimpse_head(joint, w, b, v), glimpse_head_reference(joint, w, b, v)):
        assert torch.equal(got, want)
    table = torch.randn(5, 3)
    assert torch.equal(gather_rows(table, [4, 0]),
                       gather_rows_reference(table, torch.tensor([4, 0])))
    values, scales = torch.randint(-127, 128, (5, 2, 3), dtype=torch.int8), torch.rand(5, 2, 1)
    assert torch.equal(gather_rows_dequant(values, scales, [4, 0]),
                       gather_rows_dequant_reference(values, scales, torch.tensor([4, 0])))
    logits = torch.randn(2, 5, 2)
    assert torch.equal(glimpse_attend(logits, v), glimpse_attend_reference(logits, v))
    z = torch.randn(3, 4, 10)
    assert torch.equal(mfb_pool(z, 5), mfb_pool_reference(z, 5))
    pg, r = torch.randn(2, 5, 6), torch.randn(2, 5, 6)
    assert torch.equal(relation_attend(pg, r), relation_attend_reference(pg, r))
    assert [fn.launches for fn in wrappers] == counts


_FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: logs its call, fails on a source named in FAIL_ON,
# and writes the file named after -o
echo "$@" >> "$NVCC_LOG"
out=""; prev=""
for a in "$@"; do
  case "$a" in *"$FAIL_ON"*) if [ -n "$FAIL_ON" ]; then echo "error in $a"; exit 2; fi;; esac
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "ptxas info    : Used 1 registers"
echo built > "$out"
"""


def test_build_compiles_each_source_then_links_one_library(tmp_path, monkeypatch):
    """One nvcc per csrc/*.cu (compile only, sm_90a), one link of all the
    objects into the library, which lands in place only when everything
    built; a failed source is named in the error and leaves no library."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    log = tmp_path / "calls.log"
    monkeypatch.setenv("NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_SO", str(tmp_path / "build" / "lib.so"))

    monkeypatch.setenv("FAIL_ON", "relation.cu")
    with pytest.raises(RuntimeError, match="relation.cu"):
        _build.build()
    assert not (tmp_path / "build" / "lib.so").exists()

    monkeypatch.setenv("FAIL_ON", "")
    log.unlink()
    out = _build.build()
    calls = log.read_text().splitlines()
    sources = _build._sources()
    assert {os.path.basename(s) for s in sources} >= {
        "gather.cu", "lstm.cu", "glimpse_head.cu", "mfb_pool.cu", "relation.cu"}
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert sorted(c.split(" -c ")[1].split()[0] for c in compiles) == sources
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    links = [c for c in calls if "-shared" in c.split()]
    assert len(links) == 1 and len(calls) == len(sources) + 1
    assert "Used 1 registers" in out
    assert (tmp_path / "build" / "lib.so").read_text() == "built\n"
    assert _build.build() == ""  # up to date: nothing rebuilt


# ------------------------------------------------------- on the card only


@pytest.mark.cuda
def test_gather_rows_kernel_is_bit_exact(cuda_device):
    table = torch.randn(37, 36, 72, device=cuda_device).to(torch.bfloat16)
    idx = np.random.default_rng(0).integers(0, 37, 53)
    before = gather_rows.launches
    out = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(out, gather_rows_reference(table, torch.from_numpy(idx).to(cuda_device)))


@pytest.mark.cuda
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,segs,d,b", [(37, 36, 72, 53), (11, 3, 40, 29), (9, 5, 7, 17),
                                        (7, 3, 16, 2100)])
def test_gather_rows_dequant_kernel_is_bit_exact(cuda_device, scale_dtype, n, segs, d, b):
    """Widths on the kernel's vector path (d = 72, 40, 16: d % 8 == 0) and
    on its one-value-per-thread path (d = 7; a row of 7 bytes is not a
    multiple of 16), repeated rows, and a batch over ROWS_PER_LAUNCH (two
    launches): bit-equal to the plain chain."""
    x = torch.randn(n, segs, d, device=cuda_device) * 3
    values, scales = (torch.from_numpy(a).to(cuda_device)
                      for a in quantize_features(x.cpu().numpy()))
    scales = scales.to(scale_dtype)
    idx = np.random.default_rng(b).integers(0, n, b)
    idx[: b // 4] = idx[0]
    before = gather_rows_dequant.launches
    out = gather_rows_dequant(values, scales, idx)
    want = gather_rows_dequant_reference(values, scales, torch.from_numpy(idx).to(cuda_device))
    torch.cuda.synchronize()
    assert gather_rows_dequant.launches == before + (2 if b > 2048 else 1)
    assert out.dtype == scale_dtype and torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
def test_gathers_on_pooled_rows_are_bit_exact(cuda_device, scale_dtype):
    """The NoAtt archs' pooled table [N, 2048]: rows of 4096 bytes (bf16),
    2048 (int8) with scales [N, 1], repeated rows; both kernels bit-equal
    to their plain versions."""
    x = torch.randn(50, 2048, device=cuda_device) * 3
    idx = np.random.default_rng(1).integers(0, 50, 1024)
    idx[:256] = idx[0]
    idx_dev = torch.from_numpy(idx).to(cuda_device)
    table = x.bfloat16()
    assert torch.equal(gather_rows(table, idx), gather_rows_reference(table, idx_dev))
    values, scales = (torch.from_numpy(a).to(cuda_device)
                      for a in quantize_features(x.cpu().numpy()))
    scales = scales.to(scale_dtype)
    out = gather_rows_dequant(values, scales, idx)
    torch.cuda.synchronize()
    assert out.shape == (1024, 2048) and out.dtype == scale_dtype
    assert torch.equal(out, gather_rows_dequant_reference(values, scales, idx_dev))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(5, 37, 40), (4, 37, 42), (7, 130, 96), (3, 256, 128),
                                   (4, 64, 1024), (3, 1100, 2400), (3, 1024, 2400),
                                   (5, 37, 41)])
def test_lstm_seq_kernel_matches_plain(cuda_device, T, B, H):
    """bf16 kernel vs the plain version in float32 on the same inputs: the
    kernel stores h and c in bf16 between steps (LSTM_ATOL, as
    chip_smoke.py). H=42 takes the padded gate strips; H=41 one zero unit
    more; B=1100, H=2400 the paired 128-row tiles with an odd last one;
    B=1024, H=2400 the tail tiles shared over K."""
    xg, mask, wh = (torch.from_numpy(a).to(cuda_device) for a in _lstm_inputs(T, T, B, H))
    before = lstm_seq.launches
    h, seq = lstm_seq(xg.bfloat16(), mask.bfloat16(), wh.bfloat16())
    ref_h, ref_seq = lstm_seq_reference(xg.bfloat16().float(), mask, wh.bfloat16().float())
    torch.cuda.synchronize()
    assert lstm_seq.launches == before + 1  # one persistent launch runs all T steps
    assert h.shape == (B, H) and seq.shape == (T, B, H)
    assert (h.float() - ref_h).abs().max().item() <= LSTM_ATOL
    assert (seq.float() - ref_seq).abs().max().item() <= LSTM_ATOL


def _relative(got, want):
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(7, 128, 2400), (26, 128, 2400), (7, 128, 1024),
                                   (9, 37, 40)])
def test_lstm_seq_train_on_the_card_matches_plain(cuda_device, T, B, H):
    """lstm_seq(train=True) on the card (the kernel's forward, the big-matmul
    backward after a plain recompute) against float32 autograd through the
    plain version on the same bf16 inputs, a row fully padded: dxg and dwh
    within 5e-2 relative (Frobenius; chip_smoke.py's TRAIN_GRAD_RTOL),
    dmask exactly 0."""
    xg, mask, wh = _lstm_inputs(T + H, T, B, H)
    mask[:, 2] = 0
    rng = np.random.default_rng(H)
    cots = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda_device,
                                                                           torch.bfloat16)
            for s in ((B, H), (T, B, H))]
    bf = [torch.from_numpy(a).to(cuda_device, torch.bfloat16) for a in (xg, mask, wh)]
    args = [a.clone().requires_grad_() for a in bf]
    got = torch.autograd.grad(lstm_seq(*args, train=True), args, cots)
    ref = [a.float().requires_grad_() for a in bf]
    want = torch.autograd.grad(lstm_seq_reference(*ref), ref, [c.float() for c in cots])
    assert _relative(got[0], want[0]) <= 5e-2 and _relative(got[2], want[2]) <= 5e-2
    assert bool((got[1] == 0).all()) and bool((got[0][:, 2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("M,G", [(510, 2), (1024, 1), (1200, 2)])
def test_glimpse_head_train_on_the_card_matches_plain(cuda_device, M, G):
    """glimpse_head's Function on the card (the kernel's forward, the plain
    version's grads recomputed) against float32 autograd through the plain
    version: djoint, dw, db and dv within 5e-2 relative."""
    gen = torch.Generator(device=cuda_device).manual_seed(M)
    shapes = ((128, 36, M), (M, G), (G,), (128, 36, 2048))
    bf = [torch.randn(s, generator=gen, device=cuda_device).to(torch.bfloat16) for s in shapes]
    bf[0], bf[1] = torch.tanh(bf[0]), (bf[1].float() / M ** 0.5).to(torch.bfloat16)
    cots = [torch.randn(s, generator=gen, device=cuda_device).to(torch.bfloat16)
            for s in ((128, G, 2048), (128, 36, G))]
    args = [a.clone().requires_grad_() for a in bf]
    got = torch.autograd.grad(glimpse_head(*args), args, cots)
    ref = [a.float().requires_grad_() for a in bf]
    want = torch.autograd.grad(glimpse_head_reference(*ref), ref, [c.float() for c in cots])
    for g, w in zip(got, want):
        assert _relative(g, w) <= 5e-2


def _grads_on_the_card(fn, reference, bf, cots):
    """The grads of ``fn`` (a Function on the card) and of float32 autograd
    through ``reference`` on the same bf16 inputs."""
    args = [a.clone().requires_grad_() for a in bf]
    got = torch.autograd.grad(fn(*args), args, cots)
    ref = [a.float().requires_grad_() for a in bf]
    want = torch.autograd.grad(reference(*ref), ref, [c.float() for c in cots])
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("T", [7, 13, 26])
def test_glimpse_attend_train_on_the_card_matches_plain(cuda_device, T):
    """glimpse_attend's Function on the card (the kernel's forward, the plain
    version's grads recomputed) at MFB's B=128, G=2, D=1024, logits masked
    at finfo(bf16).min past each row's length and one row masked whole:
    dlogits and dv within 5e-2 relative of float32 autograd, finite."""
    rng = np.random.default_rng(T)
    gen = torch.Generator(device=cuda_device).manual_seed(T)
    valid = np.arange(T)[None, :] < rng.integers(1, T + 1, 128)[:, None]
    valid[0] = False
    logits = torch.randn(128, T, 2, generator=gen, device=cuda_device).to(torch.bfloat16)
    logits = logits.masked_fill(~torch.from_numpy(valid[..., None]).to(cuda_device),
                                torch.finfo(torch.bfloat16).min)
    v = torch.randn(128, T, 1024, generator=gen, device=cuda_device).to(torch.bfloat16)
    cot = torch.randn(128, 2, 1024, generator=gen, device=cuda_device).to(torch.bfloat16)
    got, want = _grads_on_the_card(glimpse_attend, glimpse_attend_reference, [logits, v], [cot])
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all()) and _relative(g, w) <= 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128 * 36, 128])
def test_mfb_pool_train_on_the_card_matches_plain(cuda_device, n):
    """mfb_pool's Function on the card at MFB's k=5, m=1000 (the attention's
    B*36 rows and the final fusion's B): dz, recomputed in bf16, within 5e-2
    relative of float32 autograd."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    z = torch.randn(n, 5000, generator=gen, device=cuda_device).to(torch.bfloat16)
    cot = torch.randn(n, 1000, generator=gen, device=cuda_device).to(torch.bfloat16)
    got, want = _grads_on_the_card(lambda x: mfb_pool(x, 5), lambda x: mfb_pool_reference(x, 5),
                                   [z], [cot])
    assert got[0].dtype == torch.bfloat16 and _relative(got[0], want[0]) <= 5e-2


@pytest.mark.cuda
def test_relation_attend_train_on_the_card_matches_plain(cuda_device):
    """relation_attend's Function on the card at CoR's B=128, N=36, D=1024:
    dpg and dr within 5e-2 relative of float32 autograd."""
    gen = torch.Generator(device=cuda_device).manual_seed(36)
    pg, r, cot = (torch.tanh(torch.randn(128, 36, 1024, generator=gen, device=cuda_device))
                  .to(torch.bfloat16) for _ in range(3))
    got, want = _grads_on_the_card(relation_attend, relation_attend_reference, [pg, r], [cot])
    for g, w in zip(got, want):
        assert _relative(g, w) <= 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(6, 1024, 2400), (6, 64, 1024)])
def test_lstm_seq_kernel_is_bit_equal_across_runs(cuda_device, T, B, H):
    """No split-K, no atomics on the data: two calls give the same bits."""
    xg, mask, wh = (torch.from_numpy(a).to(cuda_device).bfloat16()
                    for a in _lstm_inputs(T, T, B, H))
    first, second = lstm_seq(xg, mask, wh), lstm_seq(xg, mask, wh)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,M,G,D", [(37, 36, 45, 2, 72), (5, 7, 33, 3, 75),
                                       (64, 36, 510, 2, 2048), (16, 36, 510, 8, 2048),
                                       (8, 196, 510, 2, 2048), (3, 196, 64, 16, 1024),
                                       (4, 196, 33, 5, 75), (1024, 36, 1024, 1, 2048),
                                       (64, 36, 1200, 2, 2048)])
def test_glimpse_head_kernel_matches_plain(cuda_device, B, R, M, G, D):
    """bf16 kernel vs the plain version in float32: alpha and the outputs
    are rounded to bf16 (0.05, as chip_smoke.py). G=8 and 16 run as groups
    of 4; R=196 through the ring refilled as it drains; D=75 the generic
    path."""
    joint = torch.tanh(torch.randn(B, R, M, device=cuda_device)).bfloat16()
    w = (torch.randn(M, G, device=cuda_device) / M ** 0.5).bfloat16()
    b = torch.randn(G, device=cuda_device).bfloat16()
    v = torch.randn(B, R, D, device=cuda_device).bfloat16()
    before = glimpse_head.launches
    att, logits = glimpse_head(joint, w, b, v)
    ref_att, ref_logits = glimpse_head_reference(joint.float(), w.float(), b.float(), v.float())
    torch.cuda.synchronize()
    assert glimpse_head.launches == before + 1
    assert (att.float() - ref_att).abs().max().item() <= 0.05
    assert (logits.float() - ref_logits).abs().max().item() <= 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,G,D", [(37, 26, 2, 72), (5, 7, 3, 75), (64, 13, 2, 1024),
                                     (1024, 7, 2, 1024), (16, 36, 8, 1024), (8, 196, 2, 1024),
                                     (3, 196, 16, 40)])
def test_glimpse_attend_kernel_matches_plain(cuda_device, B, R, G, D):
    """bf16 kernel vs the plain version in float32 on the same bf16 inputs,
    with masked rows (finfo(bf16).min) and a fully masked row: alpha and the
    output are rounded to bf16 (0.05, as chip_smoke.py)."""
    logits = torch.from_numpy(_masked_logits(np.random.default_rng(B), B, R, G))
    logits = logits.clamp(min=torch.finfo(torch.bfloat16).min).to(cuda_device).bfloat16()
    v = torch.randn(B, R, D, device=cuda_device).bfloat16()
    before = glimpse_attend.launches
    got = glimpse_attend(logits, v)
    want = glimpse_attend_reference(logits.float(), v.float())
    torch.cuda.synchronize()
    assert glimpse_attend.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want).abs().max().item() <= 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,M,G,D", [(1024, 36, 510, 2, 2048), (64, 36, 510, 2, 2048),
                                       (16, 36, 510, 8, 2048), (8, 196, 510, 2, 2048)])
def test_glimpse_kernels_are_bit_equal_across_runs(cuda_device, B, R, M, G, D):
    """No atomics into the outputs: two calls of each entry give the same
    bits, and a fully masked row of glimpse_attend gives uniform alpha."""
    joint = torch.tanh(torch.randn(B, R, M, device=cuda_device)).bfloat16()
    w = (torch.randn(M, G, device=cuda_device) / M ** 0.5).bfloat16()
    b = torch.randn(G, device=cuda_device).bfloat16()
    v = torch.randn(B, R, D, device=cuda_device).bfloat16()
    first, second = glimpse_head(joint, w, b, v), glimpse_head(joint, w, b, v)
    logits = first[1].clone()
    logits[0] = torch.finfo(torch.bfloat16).min
    a1, a2 = glimpse_attend(logits, v), glimpse_attend(logits, v)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(a1, a2)
    uniform = v[0].float().mean(0).expand(G, D)
    assert (a1[0].float() - uniform).abs().max().item() <= 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(131, 3, 33), (37, 5, 1000), (2304, 5, 1000), (9, 4, 6)])
def test_mfb_pool_kernel_matches_plain(cuda_device, n, k, m):
    """Row counts no multiple of 8, m % 8 != 0 (scalar loads): outputs are
    unit rows rounded to bf16 (2e-3, as chip_smoke.py)."""
    z = torch.randn(n, k * m, device=cuda_device).bfloat16()
    before = mfb_pool.launches
    got = mfb_pool(z, k)
    want = mfb_pool_reference(z.float(), k)
    torch.cuda.synchronize()
    assert mfb_pool.launches == before + 1
    assert (got.float() - want).abs().max().item() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D", [(5, 7, 33), (37, 36, 1024), (3, 36, 40), (2, 64, 24),
                                   (4, 1, 8), (3, 65, 1024), (4, 196, 1024), (2, 100, 33),
                                   (64, 36, 1024), (3, 300, 64), (2, 600, 64)])
def test_relation_attend_kernel_matches_plain(cuda_device, B, N, D):
    """fp32 scores and softmax, alpha as two bf16 halves, output rounded to
    bf16 (0.01, as chip_smoke.py's RELATION_ATOL). N = 65, 100, 196, 300
    take the tiled design (N=300: two boxes of r, two passes of the
    scores), N=600 the tc one, D=33 the plain copies, D=40 a zero-padded
    k-step."""
    pg = torch.tanh(torch.randn(B, N, D, device=cuda_device)).bfloat16()
    r = torch.tanh(torch.randn(B, N, D, device=cuda_device)).bfloat16()
    before = relation_attend.launches
    got = relation_attend(pg, r)
    want = relation_attend_reference(pg.float(), r.float())
    torch.cuda.synchronize()
    assert relation_attend.launches == before + 1
    assert (got.float() - want).abs().max().item() <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D", [(1024, 36, 1024), (64, 36, 1024), (64, 196, 1024)])
def test_relation_attend_kernel_is_bit_equal_across_runs(cuda_device, B, N, D):
    """Every sum in a fixed order (the cluster's partial scores in rank
    order): two calls give the same bits."""
    pg = torch.tanh(torch.randn(B, N, D, device=cuda_device)).bfloat16()
    r = torch.tanh(torch.randn(B, N, D, device=cuda_device)).bfloat16()
    first = relation_attend(pg, r)
    second = relation_attend(pg, r)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,vec", [(1024, 36, 1024, True), (64, 36, 1024, True),
                                       (1024, 48, 1024, True), (1024, 196, 1024, True),
                                       (64, 300, 64, True), (5, 7, 33, False),
                                       (2, 600, 64, True)])
def test_relation_plan_matches_the_card(cuda_device, B, N, D, vec):
    """relation_plan reckons the launch in Python; the kernel reckons it in
    C++: they agree on the CTAs, the cluster, the threads and the shared
    memory."""
    plan = relation_plan(B, N, D, vec=vec,
                         smem_limit=_build.smem_optin(cuda_device.index or 0))
    geometry = relation_geometry(B, N, D, plan, vec, cuda_device.index or 0)
    want = {"ctas": plan["ctas"], "cluster": plan["cluster"], "threads": plan["threads"],
            "smem_bytes": plan["smem_bytes"]}
    if plan["design"] == "tc":  # and its second launch, the weighted sum
        want["weighted"] = plan["weighted"]
    assert geometry == want


# the archs' shapes of each registered op: (inputs' shapes, non-tensor args)
FAKE_CASES = {
    "lstm_seq": [((26, 64, 4 * 2400), (26, 64, 1), (2400, 4 * 2400)),   # MutanAtt, serving
                 ((7, 1024, 4 * 1024), (7, 1024, 1), (1024, 4 * 1024)),  # MFB / CoR, eval
                 ((5, 3, 4 * 41), (5, 3, 1), (41, 4 * 41))],              # odd H
    "glimpse_head": [((64, 36, 510), (510, 2), (2,), (64, 36, 2048)),    # MutanAtt
                     ((1024, 36, 512), (512, 2), (2,), (1024, 36, 2048)),  # MFB
                     ((64, 36, 1024), (1024, 1), (1,), (64, 36, 2048)),  # ConcatAtt
                     ((64, 196, 1200), (1200, 2), (2,), (64, 196, 2048))],  # MLBAtt, grid
    "glimpse_attend": [((64, 26, 2), (64, 26, 1024)), ((1024, 7, 2), (1024, 7, 1024))],
    "mfb_pool": [((64, 36, 5000), 5), ((1024, 5000), 5), ((64, 1000), 2)],
    "relation_attend": [((64, 36, 1024), (64, 36, 1024)), ((8, 196, 1024), (8, 196, 1024))],
}
FAKE_REFERENCES = {"lstm_seq": lstm_seq_reference, "glimpse_head": glimpse_head_reference,
                   "glimpse_attend": glimpse_attend_reference, "mfb_pool": mfb_pool_reference,
                   "relation_attend": relation_attend_reference}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("op,case", [(op, i) for op, cases in FAKE_CASES.items()
                                     for i in range(len(cases))])
def test_registered_op_fake_gives_the_plain_versions_shapes(op, case, dtype):
    """Each registered op (torch.ops.vqa_tpu_torch.*) on meta tensors, which
    takes its fake implementation (what torch.export traces with), gives the
    output shapes and dtypes of its plain version on the same meta tensors,
    at the archs' shapes."""
    args = [torch.empty(a, dtype=dtype, device="meta") if isinstance(a, tuple) else a
            for a in FAKE_CASES[op][case]]
    got = getattr(torch.ops.vqa_tpu_torch, op)(*args)
    want = FAKE_REFERENCES[op](*args)
    got, want = ((x,) if isinstance(x, torch.Tensor) else tuple(x) for x in (got, want))
    assert [(t.shape, t.dtype, t.device.type) for t in got] == \
        [(t.shape, t.dtype, "meta") for t in want]


def test_registered_ops_take_the_plain_version_on_the_cpu():
    """On CPU tensors each registered op is its plain version, bit for bit."""
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    mask = torch.from_numpy((rng.random((5, 3, 1)) > 0.3).astype(np.float32))
    cases = {"lstm_seq": (t(5, 3, 4 * 6), mask, t(6, 4 * 6)),
             "glimpse_head": (t(2, 5, 7), t(7, 2), t(2), t(2, 5, 8)),
             "glimpse_attend": (t(2, 5, 3), t(2, 5, 8)),
             "mfb_pool": (t(4, 10), 2),
             "relation_attend": (t(2, 5, 8), t(2, 5, 8))}
    for op, args in cases.items():
        got = getattr(torch.ops.vqa_tpu_torch, op)(*args)
        want = FAKE_REFERENCES[op](*args)
        got, want = ((x,) if isinstance(x, torch.Tensor) else tuple(x) for x in (got, want))
        assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want)), op


@pytest.mark.cuda
def test_exported_program_launches_the_kernels(cuda_device):
    """A tiny MutanAtt exported on the card keeps lstm_seq and glimpse_head
    as registered ops, and running the loaded program launches both kernels
    (the launch counters live in the ops' CUDA implementations)."""
    import io

    from vqa_tpu_torch import flagship
    from vqa_tpu_torch.export import export_forward, model_params, program_ops
    from vqa_tpu_torch.weights import random_params

    model = flagship.build(num_words=50, num_answers=7, tiny=True, dtype=torch.bfloat16,
                           device=cuda_device, dim_v=64)
    random_params(model, 0)
    program = export_forward(model, model_params(model), batch=4, seq=6, feature_shape=(36, 64),
                             device=cuda_device)
    assert program_ops(program) == ["vqa_tpu_torch::lstm_seq", "vqa_tpu_torch::glimpse_head"]
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    loaded = torch.export.load(buf).module()
    visual = torch.randn(4, 36, 64, device=cuda_device)
    question = torch.randint(1, 50, (4, 6), device=cuda_device, dtype=torch.int32)
    lengths = torch.full((4,), 6, device=cuda_device, dtype=torch.int32)
    lstm_seq.launches = glimpse_head.launches = 0
    with torch.inference_mode():
        got = loaded(visual, question, lengths)
        want = model(visual, question, lengths)
    torch.cuda.synchronize()
    assert lstm_seq.launches == 2 and glimpse_head.launches == 2
    assert torch.equal(got, want)
