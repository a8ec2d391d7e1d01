"""The 3xTF32 numerics that the float32 ``relation_attend`` and ``lstm_seq``
kernels run on the tensor cores, held on the CPU with plain torch.

Each product of those kernels splits its float32 operands into tf32 halves
(``cvt.rna.tf32.f32``) and sums three tensor-core products in fp32
(``vqa_tpu_torch/ops/_tf32.py``). Here the same arithmetic, in plain torch,
goes through the plain LSTM recurrence and the plain relation core at small
shapes, and is held against float64 with the tolerances the card's kernels
are held to (``chip_smoke.py``'s ``F32_LSTM_REL`` and ``F32_REL``, of the
reference's max-abs); JAX's float32 references of the same functions sit
within the same tolerances of float64. One TF32 pass in the same code misses
the LSTM's tolerance: that is why the kernels take three.

These sums round to nearest, as ``relation_attend``'s and the wg=1 class of
``lstm_seq``'s do (each stage's products added into fp32 registers). The
wg=2 class of ``lstm_seq`` (``lstm_plan(..., elem=4)``: H=2400 at B >= 769)
keeps its sum in the tensor cores, whose fp32 accumulation truncates: these
tests do not bind it, and it is held only on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_tpu.ops import lstm as jax_lstm
from vqa_tpu.ops import relation as jax_relation
from vqa_tpu_torch.ops._tf32 import tf32_matmul, tf32_round, tf32_split, tf32x3_matmul

torch.set_num_threads(1)
F32_REL = 1e-5       # relation_attend's float32 hold, of the reference's max-abs
F32_LSTM_REL = 1e-4  # lstm_seq's: the sums carried through the steps


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _lstm(xg, mask, wh, matmul):
    """lstm_seq_reference with its product ``h @ wh`` taken by ``matmul``."""
    T, B, _ = xg.shape
    H = wh.shape[0]
    h = xg.new_zeros(B, H)
    c = xg.new_zeros(B, H)
    seq = []
    for t in range(T):
        gates = xg[t] + matmul(h, wh)
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        keep = mask[t] != 0
        h = torch.where(keep, new_h, h)
        c = torch.where(keep, new_c, c)
        seq.append(new_h * mask[t])
    return h, torch.stack(seq)


def _relation(pg, r, matmul):
    """relation_attend_reference with both products taken by ``matmul``."""
    s = matmul(pg, r.transpose(1, 2)) * pg.shape[-1] ** -0.5
    return matmul(torch.softmax(s, dim=-1), r)


def _lstm_inputs(T, B, H, seed):
    """chip_smoke.py's LSTM inputs: xg ~ N(0, 1), wh ~ N(0, 1/H), a mask of
    ragged lengths, a quarter of the rows left-padded."""
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) / H ** 0.5).astype(np.float32)
    lengths = rng.integers(1, T + 1, B)
    left = rng.random(B) < 0.25
    t = np.arange(T)[:, None]
    valid = np.where(left[None, :], t >= T - lengths[None, :], t < lengths[None, :])
    return xg, valid[..., None].astype(np.float32), wh


def _relation_inputs(B, N, D, seed):
    rng = np.random.default_rng(seed)
    return (np.tanh(rng.standard_normal((B, N, D))).astype(np.float32),
            np.tanh(rng.standard_normal((B, N, D))).astype(np.float32))


# ------------------------------------------------------------- the split


def test_tf32_round_is_to_nearest_ties_away():
    """10 mantissa bits kept: 1 + 2^-11 (a tie) goes up to 1 + 2^-10, as
    does -(1 + 2^-11) in magnitude; just below a tie goes down; a carry
    moves into the exponent; inf and NaN pass."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23, 2 - ulp / 2, 3.0,
                      float("inf"), -float("inf")], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 2.0, 3.0, float("inf"), -float("inf")])
    assert torch.equal(tf32_round(x), want)
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()
    with pytest.raises(TypeError, match="float32"):
        tf32_round(torch.zeros(2, dtype=torch.float64))


def test_tf32_split_keeps_float32_to_2_pow_minus_22():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100_000).astype(np.float32))
    hi, lo = tf32_split(x)
    for half in (hi, lo):
        assert not (half.view(torch.int32) & 0x1FFF).any()  # 13 low bits clear: tf32
    assert ((hi.double() + lo.double() - x.double()).abs() <= 2.0 ** -22 * x.double().abs()).all()


@pytest.mark.parametrize("K", [8, 256, 2400])
def test_tf32x3_matmul_is_float32_accurate(K):
    rng = np.random.default_rng(K)
    a = rng.standard_normal((64, K)).astype(np.float32)
    b = (rng.standard_normal((K, 96)) / K ** 0.5).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    got = tf32x3_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    one_pass = tf32_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert _rel(got, exact) <= 1e-6
    assert _rel(one_pass, exact) > 1e-4


# --------------------------------------------------------- lstm_seq

@pytest.mark.parametrize("T,B,H", [(5, 64, 256), (5, 64, 41)])
def test_lstm_recurrence_in_tf32x3_holds_to_float64(T, B, H):
    """The recurrence with its products in 3xTF32 within F32_LSTM_REL of
    float64, as is JAX's float32 reference (the TPU kernel's numerics)."""
    xg, mask, wh = _lstm_inputs(T, B, H, seed=T * B + H)
    x = [torch.from_numpy(a) for a in (xg, mask, wh)]
    want_h, want_seq = _lstm(*(a.double() for a in x), torch.matmul)
    got_h, got_seq = _lstm(*x, tf32x3_matmul)
    assert max(_rel(got_h, want_h), _rel(got_seq, want_seq)) <= F32_LSTM_REL
    jax_h, jax_seq = jax_lstm.lstm_seq_reference(jnp.asarray(xg), jnp.asarray(mask),
                                                 jnp.asarray(wh))
    assert max(_rel(jax_h, want_h), _rel(jax_seq, want_seq)) <= F32_LSTM_REL


def test_lstm_recurrence_in_one_tf32_pass_misses_the_float32_hold():
    """The same recurrence with single-pass TF32 products: past
    F32_LSTM_REL, which is why the kernel takes three."""
    xg, mask, wh = _lstm_inputs(5, 64, 256, seed=5 * 64 + 256)
    x = [torch.from_numpy(a) for a in (xg, mask, wh)]
    want_h, want_seq = _lstm(*(a.double() for a in x), torch.matmul)
    got_h, got_seq = _lstm(*x, tf32_matmul)
    assert max(_rel(got_h, want_h), _rel(got_seq, want_seq)) > F32_LSTM_REL


# --------------------------------------------------- relation_attend

@pytest.mark.parametrize("N", [36, 196])
def test_relation_core_in_tf32x3_holds_to_float64(N):
    """Both products in 3xTF32 (alpha split like any operand, not rounded to
    bf16) within F32_REL of float64, as is JAX's float32 reference."""
    pg, r = _relation_inputs(2, N, 256, seed=N)
    want = _relation(torch.from_numpy(pg).double(), torch.from_numpy(r).double(), torch.matmul)
    got = _relation(torch.from_numpy(pg), torch.from_numpy(r), tf32x3_matmul)
    assert _rel(got, want) <= F32_REL
    jax_want = jax_relation.relation_attend_reference(jnp.asarray(pg), jnp.asarray(r))
    assert jax_want.dtype == jnp.float32 and _rel(jax_want, want) <= F32_REL


def test_relation_core_in_one_tf32_pass_is_further_from_float64():
    """One TF32 pass keeps ~3 decimal digits: well past the 3xTF32 error."""
    pg, r = _relation_inputs(2, 196, 256, seed=1)
    want = _relation(torch.from_numpy(pg).double(), torch.from_numpy(r).double(), torch.matmul)
    three = _rel(_relation(torch.from_numpy(pg), torch.from_numpy(r), tf32x3_matmul), want)
    one = _rel(_relation(torch.from_numpy(pg), torch.from_numpy(r), tf32_matmul), want)
    assert one > 10 * three and one > F32_REL


def test_jax_is_on_the_cpu():
    assert jax.default_backend() == "cpu"
