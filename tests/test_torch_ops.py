"""The port's kernels (vqa_tpu_torch/ops) against the JAX package's.

On the CPU each wrapper takes its plain PyTorch version; that version is
held to 1e-5 (float32) of both the JAX jnp reference and the JAX Pallas
kernel run in TPU interpret mode, on the same numpy inputs. The CUDA kernels
themselves run only on a card: those tests carry the ``cuda`` marker and
skip here (chip_smoke.py runs the same comparisons at the flagship shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vqa_tpu.ops import attention as jax_attention
from vqa_tpu.ops import gather as jax_gather
from vqa_tpu.ops import lstm as jax_lstm
from vqa_tpu_torch.ops import _build
from vqa_tpu_torch.ops.attention import glimpse_head, glimpse_head_reference
from vqa_tpu_torch.ops.gather import gather_rows, gather_rows_reference
from vqa_tpu_torch.ops.lstm import lstm_seq, lstm_seq_reference

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)  # float32 on both sides; sums in another order


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


def test_lstm_seq_train_is_not_ported():
    xg, mask, wh = (torch.from_numpy(a) for a in _lstm_inputs(0, 2, 2, 4))
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        lstm_seq(xg, mask, wh, train=True)


@pytest.mark.parametrize("B,R,M,G,D,block_b", [(8, 36, 48, 2, 64, 8), (6, 9, 13, 3, 10, 3)])
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


@pytest.mark.parametrize("n,tail,b", [(10, (4, 16), 16), (7, (3,), 5)])
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


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """A CPU tensor never reaches the kernel library, and counts no launch."""
    def no_library():
        raise AssertionError("CPU tensors must not build or load the CUDA kernels")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(_build, "build", no_library)
    counts = (gather_rows.launches, lstm_seq.launches, glimpse_head.launches)
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
    assert (gather_rows.launches, lstm_seq.launches, glimpse_head.launches) == counts


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
@pytest.mark.parametrize("T,B,H", [(5, 37, 40), (4, 37, 42), (7, 130, 96)])
def test_lstm_seq_kernel_matches_plain(cuda_device, T, B, H):
    """bf16 kernel vs the plain version in float32 on the same inputs: the
    kernel stores h and c in bf16 between steps (0.05, as chip_smoke.py)."""
    xg, mask, wh = (torch.from_numpy(a).to(cuda_device) for a in _lstm_inputs(T, T, B, H))
    before = lstm_seq.launches
    h, seq = lstm_seq(xg.bfloat16(), mask.bfloat16(), wh.bfloat16())
    ref_h, ref_seq = lstm_seq_reference(xg.bfloat16().float(), mask, wh.bfloat16().float())
    torch.cuda.synchronize()
    assert lstm_seq.launches == before + T  # one launch per step
    assert (h.float() - ref_h).abs().max().item() <= 0.05
    assert (seq.float() - ref_seq).abs().max().item() <= 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,M,G,D", [(37, 36, 45, 2, 72), (5, 7, 33, 3, 75)])
def test_glimpse_head_kernel_matches_plain(cuda_device, B, R, M, G, D):
    """bf16 kernel vs the plain version in float32: alpha and the outputs
    are rounded to bf16 (0.05, as chip_smoke.py)."""
    joint = torch.tanh(torch.randn(B, R, M, device=cuda_device)).bfloat16()
    w = (torch.randn(M, G, device=cuda_device) / M ** 0.5).bfloat16()
    b = torch.randn(G, device=cuda_device).bfloat16()
    v = torch.randn(B, R, D, device=cuda_device).bfloat16()
    att, logits = glimpse_head(joint, w, b, v)
    ref_att, ref_logits = glimpse_head_reference(joint.float(), w.float(), b.float(), v.float())
    torch.cuda.synchronize()
    assert (att.float() - ref_att).abs().max().item() <= 0.05
    assert (logits.float() - ref_logits).abs().max().item() <= 0.05
