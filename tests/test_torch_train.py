"""The port's train path (vqa_tpu_torch: the autograd Functions of lstm_seq,
glimpse_head, glimpse_attend, mfb_pool, relation_attend and the GRU,
dropout, the optimizer, the train step of every arch and the epoch loop)
against the JAX package's, on the CPU.

The same numpy inputs go through both sides in float32. Where the JAX side
would reach a Pallas kernel it takes its jnp reference, as the JAX package's
own tests run it on the CPU. Dropout streams cannot equal flax's, so the
parity runs have every dropout rate at 0; dropout itself is held to its
definition. Tolerances: 1e-5 for one op's grads (float32, sums in another
order), 1e-6 for the optimizer (elementwise float32), 1e-4 for a whole
train step's metrics (float32 through several matmuls), and 1e-5 of each
leaf's scale for the parameters after the steps. The two Functions' holds
on the card are ``cuda`` tests in tests/test_torch_ops.py (this file imports
flax, which the card's machine lacks).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqa_tpu.config import OptimOptions as JaxOptimOptions
from vqa_tpu.config import load_options
from vqa_tpu.engine import engine as jax_engine
from vqa_tpu.engine import optim as jax_optim
from vqa_tpu.engine import steps as jax_steps
from vqa_tpu.engine.logger import Experiment as JaxExperiment
from vqa_tpu.importers import flatten_tree
from vqa_tpu.models import factory as jax_factory
from vqa_tpu.ops import attention as jax_attention
from vqa_tpu.ops import gru as jax_gru
from vqa_tpu.ops import lstm as jax_lstm
from vqa_tpu.ops import mfb_pool as jax_mfb_pool
from vqa_tpu.ops import relation as jax_relation
from vqa_tpu_torch import flagship
from vqa_tpu_torch.config import OptimOptions, VQAOptions
from vqa_tpu_torch.datasets.features import FeatureStore
from vqa_tpu_torch.datasets.pipeline import BatchIterator
from vqa_tpu_torch.datasets.processed import ProcessedSplit, Vocabs
from vqa_tpu_torch.datasets.vqa2 import VQA2Dataset
from vqa_tpu_torch.engine import engine as port_engine
from vqa_tpu_torch.engine import optim as port_optim
from vqa_tpu_torch.engine import steps as port_steps
from vqa_tpu_torch.engine.logger import Experiment
from vqa_tpu_torch.models import factory as port_factory
from vqa_tpu_torch.models.layers import dropout
from vqa_tpu_torch.ops.attention import glimpse_attend, glimpse_head
from vqa_tpu_torch.ops.gru import gru_seq
from vqa_tpu_torch.ops.lstm import lstm_seq
from vqa_tpu_torch.ops.mfb_pool import mfb_pool
from vqa_tpu_torch.ops.relation import relation_attend
from vqa_tpu_torch.weights import export_params, load_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = dict(rtol=1e-5, atol=1e-5)
OPTIM_ATOL = 1e-6
STEP_ATOL = 1e-4
PARAM_REL = 1e-5
# tiny widths of every arch (as tests/test_torch_models.py's)
TINY = {
    "mfb_coatt": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                  "model.attention.dim_h=6", "model.fusion.dim_mm=4",
                  "model.fusion.pool_factor=3"],
    "mfh_coatt": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                  "model.attention.dim_h=6", "model.fusion.dim_mm=4",
                  "model.fusion.pool_factor=3", "model.fusion.mfh_order=3"],
    "cor": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
            "model.fusion.dim_h=10", "model.classif.dim_h=7"],
    "mutan_att_skipthoughts": ["model.seq2vec.arch=skipthoughts", "model.seq2vec.emb_size=8",
                               "model.seq2vec.hidden_size=12", "model.attention.dim_hv=6",
                               "model.attention.dim_hq=5", "model.attention.dim_mm=7",
                               "model.attention.R=2", "model.fusion.dim_hv=6",
                               "model.fusion.dim_hq=5", "model.fusion.dim_mm=7",
                               "model.fusion.R=2"],
    "mutan_att": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                  "model.attention.dim_hv=6", "model.attention.dim_hq=5",
                  "model.attention.dim_mm=7", "model.attention.R=2", "model.fusion.dim_hv=6",
                  "model.fusion.dim_hq=5", "model.fusion.dim_mm=7", "model.fusion.R=2"],
    "concat_att": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                   "model.attention.dim_h=9", "model.classif.dim_h=7"],
    "mlb_att": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                "model.attention.dim_h=10", "model.fusion.dim_h=9"],
    "mutan_noatt": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                    "model.fusion.dim_hv=7", "model.fusion.dim_hq=6", "model.fusion.dim_mm=9",
                    "model.fusion.R=3"],
    "mlb_noatt": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                  "model.fusion.dim_h=9"],
    "concat_noatt": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                     "model.arch=ConcatNoAtt",
                     "model.fusion={arch: concat, dropout_v: 0.5, dropout_q: 0.5}"],
}
NOATT = ("mutan_noatt", "mlb_noatt", "concat_noatt")
NUM_WORDS, NUM_ANSWERS, DIM_V, N_IMAGES = 30, 11, 14, 9
# leaves whose grad is 0 in exact arithmetic, a softmax not seeing them: the
# glimpse logits' bias (over the regions), MFB's question-attention logits'
# bias (over the tokens) and CoR's pooling logit's bias (over the objects)
CANCELLING = ("glimpse_logits/bias", "q_attention/logits/bias", "chain/pool_logits/bias")
# the MFB family's train-step tolerance, relative to each metric's (at least
# 1) and each leaf's scale: the signed square root's derivative
# 0.5 / sqrt(|p|) magnifies float32 rounding of pooled values near 0 (on this
# batch the attention's smallest |p| is 3.8e-5, its median 0.028), so each
# package's float32 grads sit up to 7e-5 (the port) and 3e-4 (JAX) of a
# leaf's scale from a float64 run of the port, and three sgd steps at
# momentum 0.9 carry that into the parameters (measured: 2.4e-4)
MFB_REL = 1e-3
MFB_FAMILY = ("mfb_coatt", "mfh_coatt")


# ------------------------------------------------------------------ ops


def _lstm_inputs(seed, T, B, H):
    """Mixed lengths (1 and T included), every third row left-padded, row 2
    fully padded."""
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B)
    lengths[:2] = (1, T)
    left = np.arange(B) % 3 == 0
    t = np.arange(T)[:, None]
    valid = np.where(left[None, :], t >= T - lengths[None, :], t < lengths[None, :])
    valid[:, 2] = False
    cot_h = rng.standard_normal((B, H)).astype(np.float32)
    cot_seq = rng.standard_normal((T, B, H)).astype(np.float32)
    return xg, valid[..., None].astype(np.float32), wh, cot_h, cot_seq


@pytest.mark.parametrize("rnn_bwd", ["bigmatmul", "native"])
@pytest.mark.parametrize("T,B,H", [(6, 7, 5), (4, 5, 8), (1, 3, 4)])
def test_lstm_seq_grads_match_jax(rnn_bwd, T, B, H):
    """lstm_seq(train=True) against jax.vjp of _lstm_seq_bigmatmul (its
    hand-written backward: dmask 0) or of lstm_seq_reference (native)."""
    xg, mask, wh, cot_h, cot_seq = _lstm_inputs(T * 10 + B, T, B, H)
    args = [torch.from_numpy(a).requires_grad_() for a in (xg, mask, wh)]
    h, seq = lstm_seq(*args, train=True, rnn_bwd=rnn_bwd)
    got = torch.autograd.grad((h, seq), args, (torch.from_numpy(cot_h),
                                                torch.from_numpy(cot_seq)))
    fn = jax_lstm._lstm_seq_bigmatmul if rnn_bwd == "bigmatmul" else jax_lstm.lstm_seq_reference
    (want_h, want_seq), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (xg, mask, wh)))
    want = vjp((jnp.asarray(cot_h), jnp.asarray(cot_seq)))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), **OP_TOL)
    np.testing.assert_allclose(seq.detach().numpy(), np.asarray(want_seq), **OP_TOL)
    for name, g, w in zip(("dxg", "dmask", "dwh"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **OP_TOL)
    if rnn_bwd == "bigmatmul":
        assert bool((got[1] == 0).all())
    assert bool((got[0][:, 2] == 0).all())  # the fully padded row takes no grad


def test_lstm_seq_backward_reads_only_the_asked_inputs():
    """Grads of xg alone (wh without grad) and of h_last alone (seq unused)
    equal the corresponding parts of the full backward."""
    xg, mask, wh, cot_h, _ = _lstm_inputs(3, 5, 4, 6)
    x = torch.from_numpy(xg).requires_grad_()
    h, _ = lstm_seq(x, torch.from_numpy(mask), torch.from_numpy(wh), train=True)
    (dxg,) = torch.autograd.grad(h, x, torch.from_numpy(cot_h))
    _, vjp = jax.vjp(jax_lstm._lstm_seq_bigmatmul, *(jnp.asarray(a) for a in (xg, mask, wh)))
    want = vjp((jnp.asarray(cot_h), jnp.zeros((5, 4, 6), jnp.float32)))
    np.testing.assert_allclose(dxg.numpy(), np.asarray(want[0]), **OP_TOL)


def _glimpse_inputs(seed, B, R, M, G, D):
    rng = np.random.default_rng(seed)
    joint = np.tanh(rng.standard_normal((B, R, M))).astype(np.float32)
    w = (rng.standard_normal((M, G)) / np.sqrt(M)).astype(np.float32)
    b = (0.1 * rng.standard_normal(G)).astype(np.float32)
    v = rng.standard_normal((B, R, D)).astype(np.float32)
    cot_att = rng.standard_normal((B, G, D)).astype(np.float32)
    cot_logits = rng.standard_normal((B, R, G)).astype(np.float32)
    return (joint, w, b, v), (cot_att, cot_logits)


@pytest.mark.parametrize("cotangents", ["both", "attended", "logits"])
@pytest.mark.parametrize("B,R,M,G,D", [(3, 5, 7, 2, 6), (2, 36, 9, 1, 8)])
def test_glimpse_head_grads_match_jax(cotangents, B, R, M, G, D):
    """glimpse_head's Function against jax.vjp(glimpse_head_reference), with a
    cotangent on both outputs or on one (the other output unused)."""
    inputs, (cot_att, cot_logits) = _glimpse_inputs(B * 100 + M, B, R, M, G, D)
    if cotangents == "attended":
        cot_logits = np.zeros_like(cot_logits)
    if cotangents == "logits":
        cot_att = np.zeros_like(cot_att)
    args = [torch.from_numpy(a).requires_grad_() for a in inputs]
    att, logits = glimpse_head(*args)
    outs, cots = zip(*[(o, torch.from_numpy(c)) for o, c, use in (
        (att, cot_att, cotangents != "logits"), (logits, cot_logits, cotangents != "attended"))
        if use])
    got = torch.autograd.grad(outs, args, cots, allow_unused=True)
    _, vjp = jax.vjp(jax_attention.glimpse_head_reference, *(jnp.asarray(a) for a in inputs))
    want = vjp((jnp.asarray(cot_att), jnp.asarray(cot_logits)))
    for name, g, w in zip(("djoint", "dw", "db", "dv"), got, want):
        g = np.zeros_like(np.asarray(w)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **OP_TOL)


def _grads_match(got, want, names):
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **OP_TOL)


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("lead,m", [((6,), 7), ((2, 4), 3)])
def test_mfb_pool_grads_match_jax(lead, m, k):
    """mfb_pool's Function against jax.vjp(mfb_pool_reference), with pooled
    values exactly 0 (the signed square root's grad is 0 there in both
    packages) in one row, and a row that pools to 0 whole."""
    rng = np.random.default_rng(k * 10 + m)
    z = rng.standard_normal(lead + (k * m,)).astype(np.float32)
    flat = z.reshape(-1, k, m)
    flat[0, :, 0] = 0.0
    flat[0, :2, 1] = (0.75, -0.75)
    flat[0, 2:, 1] = 0.0
    flat[-1] = 0.0
    cot = rng.standard_normal(lead + (m,)).astype(np.float32)
    x = torch.from_numpy(z).requires_grad_()
    out = mfb_pool(x, k)
    (got,) = torch.autograd.grad(out, x, torch.from_numpy(cot))
    want_out, vjp = jax.vjp(lambda zz: jax_mfb_pool.mfb_pool_reference(zz, k), jnp.asarray(z))
    (want,) = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **OP_TOL)
    _grads_match([got], [want], ["dz"])
    assert bool(torch.isfinite(got).all())
    assert bool((got.reshape(-1, k, m)[-1] == 0).all())


@pytest.mark.parametrize("B,R,G,D", [(5, 7, 2, 6), (3, 13, 1, 9)])
def test_glimpse_attend_grads_match_jax(B, R, G, D):
    """glimpse_attend's Function against jax.vjp(glimpse_attend_reference),
    with logits masked at finfo(float32).min past each row's length (MFB's
    question self-attention) and one row masked whole: the masked logits of
    a partly masked row take a zero grad, the whole-masked row finite ones."""
    rng = np.random.default_rng(B * 10 + R)
    logits = rng.standard_normal((B, R, G)).astype(np.float32)
    lengths = rng.integers(1, R + 1, B)
    valid = np.arange(R)[None, :] < lengths[:, None]
    valid[1] = False
    logits = np.where(valid[..., None], logits, np.finfo(np.float32).min).astype(np.float32)
    v = rng.standard_normal((B, R, D)).astype(np.float32)
    cot = rng.standard_normal((B, G, D)).astype(np.float32)
    args = [torch.from_numpy(a).requires_grad_() for a in (logits, v)]
    out = glimpse_attend(*args)
    got = torch.autograd.grad(out, args, torch.from_numpy(cot))
    want_out, vjp = jax.vjp(jax_attention.glimpse_attend_reference,
                            *(jnp.asarray(a) for a in (logits, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **OP_TOL)
    _grads_match(got, vjp(jnp.asarray(cot)), ["dlogits", "dv"])
    dlogits = got[0].numpy()
    assert np.isfinite(dlogits).all() and np.isfinite(got[1].numpy()).all()
    partly = ~valid & valid.any(axis=1, keepdims=True)
    assert partly.any() and (dlogits[partly] == 0).all()


@pytest.mark.parametrize("B,N,D", [(3, 5, 8), (2, 36, 6)])
def test_relation_attend_grads_match_jax(B, N, D):
    """relation_attend's Function against jax.vjp(relation_attend_reference)."""
    rng = np.random.default_rng(B * 100 + N)
    pg, r = (np.tanh(rng.standard_normal((B, N, D))).astype(np.float32) for _ in range(2))
    cot = rng.standard_normal((B, N, D)).astype(np.float32)
    args = [torch.from_numpy(a).requires_grad_() for a in (pg, r)]
    out = relation_attend(*args)
    got = torch.autograd.grad(out, args, torch.from_numpy(cot))
    want_out, vjp = jax.vjp(jax_relation.relation_attend_reference,
                            *(jnp.asarray(a) for a in (pg, r)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **OP_TOL)
    _grads_match(got, vjp(jnp.asarray(cot)), ["dpg", "dr"])


def _gru_inputs(seed, T, B, H):
    """The LSTM's masks (row 2 fully padded), gx [T, B, 3H], wh [H, 3H], a
    non-zero bh, and cotangents of h_last and seq."""
    xg, mask, _, cot_h, cot_seq = _lstm_inputs(seed, T, B, H)
    rng = np.random.default_rng(seed + 1)
    wh = (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    bh = (0.3 * rng.standard_normal(3 * H)).astype(np.float32)
    return np.ascontiguousarray(xg[..., :3 * H]), mask, wh, bh, cot_h, cot_seq


@pytest.mark.parametrize("rnn_bwd", ["bigmatmul", "native"])
@pytest.mark.parametrize("T,B,H", [(6, 7, 5), (4, 5, 8), (1, 3, 4)])
def test_gru_seq_grads_match_jax(rnn_bwd, T, B, H):
    """gru_seq(train=True) against jax.vjp of _gru_seq_bigmatmul (its
    hand-written backward: dmask 0) or of gru_seq_reference (native)."""
    *inputs, cot_h, cot_seq = _gru_inputs(T * 10 + B, T, B, H)
    args = [torch.from_numpy(a).requires_grad_() for a in inputs]
    h, seq = gru_seq(*args, train=True, rnn_bwd=rnn_bwd)
    got = torch.autograd.grad((h, seq), args, (torch.from_numpy(cot_h),
                                                torch.from_numpy(cot_seq)))
    fn = jax_gru._gru_seq_bigmatmul if rnn_bwd == "bigmatmul" else jax_gru.gru_seq_reference
    (want_h, want_seq), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), **OP_TOL)
    np.testing.assert_allclose(seq.detach().numpy(), np.asarray(want_seq), **OP_TOL)
    _grads_match(got, vjp((jnp.asarray(cot_h), jnp.asarray(cot_seq))),
                 ["dgx", "dmask", "dwh", "dbh"])
    if rnn_bwd == "bigmatmul":
        assert bool((got[1] == 0).all())
    assert bool((got[0][:, 2] == 0).all())  # the fully padded row takes no grad


def test_gru_seq_dbh_keeps_the_float32_bias_dtype_under_bf16():
    """bf16 gx and wh with bh the raw float32 parameter (as GRULayer passes
    it): the big-matmul backward gives a float32 dbh, within bf16 rounding
    (the watch list's 0.05 of its scale) of JAX's bf16 backward and of the
    float32 one; dgx and dwh keep the compute dtype."""
    gx, mask, wh, bh, cot_h, cot_seq = _gru_inputs(7, 5, 6, 8)
    bf = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (gx, mask, wh)]
    b = torch.from_numpy(bh).requires_grad_()
    h, seq = gru_seq(bf[0], bf[1], bf[2], b, train=True)
    cots = (torch.from_numpy(cot_h).bfloat16(), torch.from_numpy(cot_seq).bfloat16())
    dgx, dwh, dbh = torch.autograd.grad((h, seq), (bf[0], bf[2], b), cots)
    assert dbh.dtype == torch.float32 and dgx.dtype == dwh.dtype == torch.bfloat16
    args = [jnp.asarray(a, jnp.bfloat16) for a in (gx, mask, wh)] + [jnp.asarray(bh)]
    _, vjp = jax.vjp(jax_gru._gru_seq_bigmatmul, *args)
    want = vjp(tuple(jnp.asarray(c.float().numpy(), jnp.bfloat16) for c in cots))[3]
    assert want.dtype == jnp.float32
    _, vjp32 = jax.vjp(jax_gru._gru_seq_bigmatmul, *(jnp.asarray(a) for a in (gx, mask, wh, bh)))
    exact = vjp32((jnp.asarray(cot_h), jnp.asarray(cot_seq)))[3]
    for w in (want, exact):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(dbh.numpy(), np.asarray(w), rtol=0, atol=0.05 * scale)


# ------------------------------------------------------------ optimizer

OPTIM_CASES = {
    "adam": dict(optimizer="adam", lr=1e-2),
    "sgd_momentum": dict(optimizer="sgd", lr=1e-2, momentum=0.9),
    "adam_clip_decay_epochs": dict(optimizer="adam", lr=1e-2, grad_clip=1.5,
                                   weight_decay=1e-2, lr_decay=0.5),
    "sgd_clip_decay_accum3": dict(optimizer="sgd", lr=5e-2, momentum=0.8, grad_clip=2.0,
                                  weight_decay=1e-3, lr_decay=0.7, grad_accum=3),
}


@pytest.mark.parametrize("case", sorted(OPTIM_CASES))
def test_optimizer_matches_optax(case):
    """The port's chain against vqa_tpu.engine.optim.factory's optax chain
    on one grad sequence: 21 micro-steps (7 applied updates under
    grad_accum=3), steps_per_epoch 3 so the staircase decay crosses epoch
    boundaries, grads whose norm crosses the clip both ways."""
    knobs = OPTIM_CASES[case]
    steps_per_epoch, n = 3, 21
    rng = np.random.default_rng(7)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 2))]
    scales = rng.uniform(0.1, 3.0, n)  # norms from ~0.3 to ~9
    grads = [[(s * rng.standard_normal(p.shape)).astype(np.float32) for p in params]
             for s in scales]

    tx = jax_optim.factory(JaxOptimOptions(**knobs), steps_per_epoch)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    port_tx = port_optim.factory(OptimOptions(**knobs), steps_per_epoch)
    tp = [torch.from_numpy(p.copy()) for p in params]
    pstate = port_tx.init(tp)
    for g in grads:
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        updates, pstate = port_tx.update([torch.from_numpy(x) for x in g], pstate, tp)
        port_optim.apply_updates(tp, updates)
        for got, want in zip(tp, jp):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=OPTIM_ATOL)
    assert not np.allclose(tp[0].numpy(), params[0])


def test_global_norm_and_clip_match_optax():
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((6, 4), (3,))]
    norm = port_optim.global_norm([torch.from_numpy(g) for g in grads])
    assert abs(float(norm) - float(optax.global_norm([jnp.asarray(g) for g in grads]))) < 1e-6
    for max_norm in (0.5 * float(norm), 2.0 * float(norm)):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads],
                                                             None)
        got, _ = port_optim.clip_by_global_norm(max_norm).update(
            [torch.from_numpy(g) for g in grads], None)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=OPTIM_ATOL)


def test_cross_entropy_matches_optax():
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((8, 13))).astype(np.float32)
    labels = rng.integers(0, 13, 8).astype(np.int32)
    got = port_optim.criterion_factory()(torch.from_numpy(logits), torch.from_numpy(labels))
    want = optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits),
                                                           jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ train step


def _no_dropout(section: dict) -> dict:
    return {k: (0.0 if k.startswith("dropout") else v) for k, v in section.items()}


def _arch_pair(name, dropout_off=True):
    """One tiny arch in flax and as the port's training build, with the same
    non-zero float32 params, and a batch over a small table."""
    yaml = flagship.VARIANTS[name][0] if name in flagship.VARIANTS else name
    opt = load_options(os.path.join(REPO, f"options/vqa2/{yaml}.yaml"), TINY[name])
    if dropout_off:
        for section in ("seq2vec", "attention", "fusion", "classif"):
            setattr(opt.model, section, _no_dropout(getattr(opt.model, section) or {}))
    rng = np.random.default_rng(5)
    shape = (N_IMAGES, DIM_V) if name in NOATT else (N_IMAGES, 5, DIM_V)
    table = rng.standard_normal(shape).astype(np.float32)
    tokens = np.zeros((6, 8), np.int32)
    for i, n in enumerate((1, 8, 3, 5, 2, 7)):
        ids = rng.integers(1, NUM_WORDS, n)
        if i % 2:
            tokens[i, 8 - n:] = ids  # left-padded
        else:
            tokens[i, :n] = ids
    batch = {"question": tokens, "length": (tokens != 0).sum(1).astype(np.int32),
             "answer": rng.integers(0, NUM_ANSWERS, 6).astype(np.int32),
             "image_index": rng.integers(0, N_IMAGES, 6).astype(np.int32)}
    jax_model = jax_factory(opt.model, NUM_WORDS, NUM_ANSWERS)
    params = jax_model.init(jax.random.key(0), jnp.asarray(table[:2]),
                            jnp.asarray(tokens[:2]))["params"]
    params = jax.tree.map(lambda p: p + 0.05, params)
    port = port_factory(dataclasses.asdict(opt.model), NUM_WORDS, NUM_ANSWERS, dim_v=DIM_V,
                        train=True)
    load_params(port, flatten_tree(params))
    return jax_model, params, port, table, batch


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items() if k != "image_index"}
    out["image_index"] = batch["image_index"]
    return out


def _run_both(name, knobs, n_steps):
    jax_model, params, port, table, batch = _arch_pair(name)
    opt = dict(knobs)
    state = jax_steps.create_state(jax_model, params, jax_optim.factory(JaxOptimOptions(**opt)))
    step = jax_steps.make_train_step(jax_optim.criterion_factory(), donate=False)
    pstate = port_steps.create_state(port, port_optim.factory(OptimOptions(**opt)))
    pstep = port_steps.make_train_step(port_optim.criterion_factory(), seed=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(n_steps):
        state, want = step(state, jbatch, jax.random.key(0), jnp.asarray(table))
        pstate, got = pstep(pstate, _torch_batch(batch), torch.from_numpy(table))
        for key in ("loss", "acc1", "acc5", "gnorm"):
            atol = (MFB_REL * max(abs(float(want[key])), 1.0) if name in MFB_FAMILY
                    else STEP_ATOL)
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=0, atol=atol,
                                       err_msg=key)
    assert pstate.step == n_steps
    got_params = export_params(port)
    start = flatten_tree(params)
    for key, want in flatten_tree(state.params).items():
        want = np.asarray(want)
        if knobs["optimizer"] == "adam" and key.endswith(CANCELLING):
            # the softmax does not see these biases: their grad is 0 but for
            # rounding, which adam scales up to +-lr on either side; both
            # sides move them by at most lr
            for moved in (got_params[key], want):
                assert np.abs(moved - np.asarray(start[key])).max() <= knobs["lr"] * 1.001
            continue
        scale = max(float(np.abs(want).max()), 1e-3)
        rel = MFB_REL if name in MFB_FAMILY else PARAM_REL
        np.testing.assert_allclose(got_params[key], want, rtol=0, atol=rel * scale, err_msg=key)


@pytest.mark.parametrize("name", sorted(TINY))
def test_train_step_matches_jax_sgd(name):
    """Three sgd-momentum steps on one batch, dropout off: each step's loss,
    acc1, acc5 and gnorm within 1e-4 of JAX make_train_step's, then every
    parameter within 1e-5 of its leaf's scale (the MFB family: 1e-3 of
    each's scale, ``MFB_REL``)."""
    _run_both(name, dict(optimizer="sgd", lr=0.1, momentum=0.9), 3)


@pytest.mark.parametrize("name", sorted(TINY))
def test_train_step_matches_jax_adam(name):
    """One adam step (the YAMLs' optimizer), as above."""
    _run_both(name, dict(optimizer="adam", lr=1e-3), 1)


@pytest.mark.parametrize("name", sorted(TINY))
def test_train_build_round_trips_a_flax_tree(name):
    """A flax tree goes into the float32 training build and comes back out of
    export_params unchanged; every parameter is float32 and takes grads."""
    _, params, port, _, _ = _arch_pair(name, dropout_off=False)
    flat = flatten_tree(params)
    out = export_params(port)
    assert set(out) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(out[key], np.asarray(value), err_msg=key)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in port.parameters())


# -------------------------------------------------------------- dropout


def test_dropout_rate_scale_and_stream():
    x = torch.ones(200_000)
    for rate in (0.1, 0.5):
        y = dropout(x, rate, port_steps.dropout_generator(1337, 4, "cpu"))
        zeroed = float((y == 0).float().mean())
        assert abs(zeroed - rate) < 0.01
        assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / (1 - rate)))
    same = [dropout(x, 0.5, port_steps.dropout_generator(1337, 4, "cpu")) for _ in range(2)]
    assert torch.equal(*same)
    other = dropout(x, 0.5, port_steps.dropout_generator(1337, 5, "cpu"))
    assert not torch.equal(same[0], other)
    assert dropout(x, 0.5, None) is x and dropout(x, 0.0, torch.Generator()) is x


def test_dropout_in_the_model_follows_seed_and_step():
    """With the YAML's dropout rates: train=False (no generator) gives the
    eval logits; one (seed, step) gives one set of logits, another step
    others."""
    _, _, port, table, batch = _arch_pair("mutan_att", dropout_off=False)
    b = _torch_batch(batch)
    visual = torch.from_numpy(table)[torch.from_numpy(batch["image_index"]).long()]

    def logits(**kw):
        with torch.no_grad():
            return port(visual, b["question"], b["length"], **kw)

    eval_logits = logits()
    torch.testing.assert_close(logits(train=True), eval_logits, rtol=0, atol=0)
    a = logits(train=True, rng=port_steps.dropout_generator(0, 3, "cpu"))
    again = logits(train=True, rng=port_steps.dropout_generator(0, 3, "cpu"))
    other = logits(train=True, rng=port_steps.dropout_generator(0, 4, "cpu"))
    assert torch.equal(a, again)
    assert not torch.equal(a, other) and not torch.equal(a, eval_logits)


NEW_ARCHS = ("mfb_coatt", "mfh_coatt", "cor", "mutan_att_skipthoughts")


def _flax_sites(jax_model, params, visual, tokens, steps):
    """flax's dropout sites of one train forward, as (rate, input shape) with
    their counts: each ``nn.Dropout`` module is one site (flax names each
    call's module apart); one inside CoR's scanned chain runs once a step."""
    import flax.linen as fnn

    seen = {}
    real = fnn.Dropout.__call__

    def recording(self, inputs, deterministic=None, rng=None):
        seen[self.scope.path] = (self.rate, tuple(inputs.shape))
        return real(self, inputs, deterministic=deterministic, rng=rng)

    fnn.Dropout.__call__ = recording
    try:
        jax_model.apply({"params": params}, jnp.asarray(visual), jnp.asarray(tokens),
                        train=True, rngs={"dropout": jax.random.key(0)})
    finally:
        fnn.Dropout.__call__ = real
    sites = []
    for path, site in seen.items():
        if site[0] > 0:
            sites += [site] * (steps if path[0] == "chain" else 1)
    return sorted(sites)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_dropout_is_drawn_at_flaxs_sites(name, monkeypatch):
    """With the YAML's rates, the port's train forward draws dropout at the
    sites flax's draws it, with flax's rates, on tensors of the same shapes
    (MFB: the encoder's embeddings, the question attention's input,
    dropout_pre on the pre-pool product of both fusions, dropout_mm, the
    classifier at 0.1; CoR: the objects twice and q once in each of the 3
    chain steps, the classifier at 0.5 twice); CoR's two draws on the
    objects are independent and every step draws anew."""
    from vqa_tpu_torch.models import att, classifier, cor, fusion, mfb, seq2vec

    jax_model, params, port, table, batch = _arch_pair(name, dropout_off=False)
    visual = table[batch["image_index"]]
    steps = getattr(port, "steps", 1)
    want = _flax_sites(jax_model, params, visual, batch["question"], steps)
    drawn = []

    def recording(x, rate, rng):
        out = dropout(x, rate, rng)
        if rng is not None and rate > 0:
            drawn.append((rate, tuple(x.shape), out == 0))
        return out

    for module in (att, classifier, cor, fusion, mfb, seq2vec):
        monkeypatch.setattr(module, "dropout", recording)
    with torch.no_grad():
        port(torch.from_numpy(visual), torch.from_numpy(batch["question"]),
             torch.from_numpy(batch["length"]), train=True,
             rng=port_steps.dropout_generator(0, 0, "cpu"))
    assert sorted((rate, shape) for rate, shape, _ in drawn) == want
    if name == "cor":
        objects = [dropped for rate, shape, dropped in drawn if len(shape) == 3]
        assert len(objects) == 2 * steps
        assert all(not torch.equal(a, b) for i, a in enumerate(objects) for b in objects[i + 1:])


def test_question_attention_pools_the_undropped_sequence():
    """MFB's question self-attention drops its logits' input only: with every
    element dropped the logits are the bias alone, and the pooled vector is
    the mean of the un-dropped sequence over each row's valid tokens."""
    from vqa_tpu_torch.models.mfb import QuestionSelfAttention

    rng = np.random.default_rng(9)
    mask = np.arange(6)[None, :] < np.array([[6], [2], [4]])
    seq = torch.from_numpy((rng.standard_normal((3, 6, 5)) * mask[..., None]).astype(np.float32))
    module = QuestionSelfAttention(5, glimpses=2, dim_h=4, dropout=1.0)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)))
        got = module(seq, torch.from_numpy(mask), rng=port_steps.dropout_generator(0, 0, "cpu"))
    mean = seq.sum(1) / torch.from_numpy(mask.sum(1, keepdims=True)).float()
    torch.testing.assert_close(got, mean.repeat(1, 2), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- epoch loop


def _tiny_dataset(n=40):
    rng = np.random.default_rng(11)
    lengths = rng.integers(1, 9, n).astype(np.int32)
    questions = rng.integers(1, NUM_WORDS, (n, 8)).astype(np.int32)
    questions *= (np.arange(8)[None, :] < lengths[:, None])
    names = [f"img{i}" for i in range(N_IMAGES)]
    split = ProcessedSplit(
        question_ids=np.arange(n, dtype=np.int64), questions=questions, lengths=lengths,
        image_names=np.array([names[i] for i in rng.integers(0, N_IMAGES, n)]),
        answers=rng.integers(0, NUM_ANSWERS, n).astype(np.int32), answer_pool=None)
    table = rng.standard_normal((N_IMAGES, 5, DIM_V)).astype(np.float32)
    vocabs = Vocabs(["<pad>", "<unk>"] + [f"w{i}" for i in range(NUM_WORDS - 2)],
                    [f"a{i}" for i in range(NUM_ANSWERS)])
    opt = VQAOptions(maxlength=8)
    return (VQA2Dataset(split, vocabs, FeatureStore.in_memory(names, table), opt, "train",
                        visual_mode="index"), table)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_engine_train_matches_jax_epoch(tmp_path, capsys):
    """engine.train over a shuffled, bucketed BatchIterator (drop_last): the
    epoch averages are the means of the step metrics, which equal JAX
    engine.train's over the same batches (dropout off), and steps.jsonl and
    metrics.jsonl carry the same keys as the JAX loop writes."""
    from vqa_tpu.datasets.pipeline import BatchIterator as JaxBatchIterator

    dataset, table = _tiny_dataset()
    loader_kw = dict(batch_size=6, shuffle=True, seed=3, drop_last=True, bucket_window=2,
                     length_buckets=(4, 8))
    jax_model, params, port, _, _ = _arch_pair("mutan_att")
    knobs = dict(optimizer="sgd", lr=0.1, momentum=0.9)
    state = jax_steps.create_state(jax_model, params, jax_optim.factory(JaxOptimOptions(**knobs)))
    jax_exp = JaxExperiment(str(tmp_path / "jax"))
    _, want = jax_engine.train(JaxBatchIterator(dataset, **loader_kw), state,
                               jax_steps.make_train_step(jax_optim.criterion_factory(),
                                                         donate=False),
                               jax.random.key(0), jax_exp, 0, print_freq=2,
                               features=jnp.asarray(table))
    jax_exp.close()

    pstate = port_steps.create_state(port, port_optim.factory(OptimOptions(**knobs)))
    step = port_steps.make_train_step(port_optim.criterion_factory(), seed=0)
    seen = []

    def recording_step(state, batch, features=None):
        state, metrics = step(state, batch, features)
        seen.append({k: float(v) for k, v in metrics.items()})
        return state, metrics

    exp = Experiment(str(tmp_path / "port"))
    loader = BatchIterator(dataset, transform=port_engine.make_device_transform("cpu"),
                           **loader_kw)
    _, got = port_engine.train(loader, pstate, recording_step, exp, 0, print_freq=2,
                               features=torch.from_numpy(table))
    exp.close()
    assert len(seen) == loader.steps_per_epoch() == 6
    for key in ("loss", "acc1", "acc5", "gnorm"):
        assert abs(got[key] - np.mean([m[key] for m in seen])) < 1e-6
        assert abs(got[key] - want[key]) < STEP_ATOL, key
    for name in ("steps.jsonl", "metrics.jsonl"):
        port_recs = _records(tmp_path / "port" / name)
        jax_recs = _records(tmp_path / "jax" / name)
        assert [sorted(r) for r in port_recs] == [sorted(r) for r in jax_recs], name
        assert [r.get("step") for r in port_recs] == [r.get("step") for r in jax_recs]
    assert "Epoch [0][5/6]" in capsys.readouterr().out


def test_train_step_runs_with_dropout_and_start_step(tmp_path):
    """With the YAML's dropout, engine.train runs an epoch from start_step 2
    (4 of 6 steps): finite metrics, the parameters moved, the state counted
    the steps executed."""
    dataset, table = _tiny_dataset()
    _, _, port, _, _ = _arch_pair("mutan_att", dropout_off=False)
    before = export_params(port)
    pstate = port_steps.create_state(port, port_optim.factory(OptimOptions(lr=1e-2)))
    loader = BatchIterator(dataset, batch_size=6, shuffle=True, seed=3, drop_last=True,
                           transform=port_engine.make_device_transform("cpu"))
    pstate, avgs = port_engine.train(loader, pstate,
                                     port_steps.make_train_step(port_optim.criterion_factory(),
                                                                seed=1),
                                     None, 0, print_freq=0, features=torch.from_numpy(table),
                                     start_step=2)
    assert pstate.step == 4
    assert all(np.isfinite(avgs[k]) for k in ("loss", "acc1", "acc5", "gnorm"))
    after = export_params(port)
    assert any(not np.array_equal(before[k], after[k]) for k in before)


def test_create_state_refuses_an_eval_build():
    port = flagship.build(40, 11, tiny=True, dim_v=24, device="cpu")
    with pytest.raises(ValueError, match="train=True"):
        port_steps.create_state(port, port_optim.factory(OptimOptions()))
