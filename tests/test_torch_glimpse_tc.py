"""The glimpse kernels' "tc" design (csrc/glimpse_tc.cu): past alpha [R, G]
in shared memory in bf16, the logits on mma.sync into fp32 scratch with
each region tile's (max, sum of exp), then the weighted sum on wgmma from
alpha = bf16(exp(logit - m) / l).

On the CPU: the design's arithmetic in plain PyTorch (``glimpse_tc_model``:
the logits in fp32, their statistics by region tile merged in tile order,
alpha rounded once to the input's dtype, fp32 sums over region chunks added
in order) against the JAX package's Pallas kernels (``_head_pallas``,
``_pallas_fwd``) run in TPU interpret mode, as tests/test_torch_ops.py runs
them, and against the port's plain version, on the same seeded numpy
inputs: float32 within 1e-5, bf16 within the glimpse kernels' bound (0.05,
and 1% of the plain output's max-abs), at G no multiple of 8, R no multiple
of the tile, several chunks, a row masked past its middle and a row masked
whole. The plans: "tc" wherever the split design ran in bf16 and TMA can
load v; "split" for float32, without TMA and where forced. The ``cuda``
test holds the kernels against the plain version on the card; it skips
here. JAX is imported only inside the tests that use it, so the card's
machine (no flax) runs the ``cuda`` test.
"""

import numpy as np
import pytest
import torch

from vqa_tpu_torch.ops import attention
from vqa_tpu_torch.ops.attention import (glimpse_attend, glimpse_attend_reference, glimpse_head,
                                         glimpse_head_reference, glimpse_plan,
                                         glimpse_tc_logits_model, glimpse_tc_model,
                                         glimpse_tc_stats_model, glimpse_tc_sum_model,
                                         launch_glimpse_attend, launch_glimpse_head)

torch.set_num_threads(1)
SMEM = attention.SMEM_LIMIT  # the H100's opt-in shared memory
GRID = 3136                  # the 56 x 56 grid of a 1792-pixel extract
F32_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_ops.py's: sums in another order
# chip_smoke.py's bf16 holds at these shapes: the glimpse kernels' absolute
# bound, and 1% of the plain output's max-abs (one bf16 rounding of the
# output is at most 0.4% of it)
GLIMPSE_ATOL, BF16_REL = 0.05, 0.01


def _near(got, want):
    """bf16: within GLIMPSE_ATOL and BF16_REL of ``want``'s max-abs."""
    err = (got.double() - want.double()).abs().max().item()
    assert err <= min(GLIMPSE_ATOL, BF16_REL * want.double().abs().max().item()), err


def _head_inputs(B, R, M, G, D, seed):
    rng = np.random.default_rng(seed)
    return (np.tanh(rng.standard_normal((B, R, M))).astype(np.float32),
            (rng.standard_normal((M, G)) / np.sqrt(M)).astype(np.float32),
            (0.1 * rng.standard_normal(G)).astype(np.float32),
            rng.standard_normal((B, R, D)).astype(np.float32))


def _masked(logits: torch.Tensor) -> torch.Tensor:
    """Row 1 masked past its middle and row 2 masked whole at the dtype's
    finfo.min (MFB's padding), as chip_smoke.py masks them."""
    out = logits.clone()
    out[1, logits.shape[1] // 2:] = torch.finfo(logits.dtype).min
    out[2] = torch.finfo(logits.dtype).min
    return out


def _tc_head(joint, w, b, v, rows, chunks):
    logits = glimpse_tc_logits_model(joint, w, b)
    return glimpse_tc_model(logits, v, rows, chunks), logits.to(joint.dtype)


# (B, R, M, G, D, rows, chunks): G no multiple of 8 (5, 12), R no multiple
# of the logits tile or of the 64-region stage (200, 130), several chunks,
# the three logits tiles
CASES = [(8, 200, 33, 5, 16, 64, 1), (8, 200, 32, 12, 24, 16, 3), (4, 130, 20, 24, 8, 32, 2),
         (8, 70, 17, 3, 8, 64, 2)]


@pytest.mark.parametrize("B,R,M,G,D,rows,chunks", CASES)
def test_glimpse_tc_model_matches_the_pallas_head_in_float32(B, R, M, G, D, rows, chunks):
    """float32 operands (alpha not rounded): the model's attended output and
    logits within 1e-5 of the interpret-mode Pallas kernel's, of the jnp
    reference's and of the port's plain version."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vqa_tpu.ops import attention as jax_attention

    arrays = _head_inputs(B, R, M, G, D, seed=R + G)
    att, logits = _tc_head(*(torch.from_numpy(a) for a in arrays), rows, chunks)
    args = tuple(jnp.asarray(a) for a in arrays)
    with pltpu.force_tpu_interpret_mode():
        pallas = jax_attention._head_pallas(*args, block_b=B)
    for want_att, want_logits in (pallas, jax_attention.glimpse_head_reference(*args),
                                  glimpse_head_reference(*(torch.from_numpy(a) for a in arrays))):
        np.testing.assert_allclose(att.numpy(), np.asarray(want_att), **F32_TOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **F32_TOL)


@pytest.mark.parametrize("B,R,M,G,D,rows,chunks", CASES)
def test_glimpse_tc_model_matches_the_pallas_head_in_bf16(B, R, M, G, D, rows, chunks):
    """bf16 operands: alpha rounded once to bf16 as the Pallas kernel rounds
    it (``alpha.astype(v_ref.dtype)``), the output and logits rounded once;
    within the glimpse bound of the interpret-mode Pallas kernel's outputs
    and of the port's plain version in float32."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vqa_tpu.ops import attention as jax_attention

    arrays = _head_inputs(B, R, M, G, D, seed=R * G)
    tensors = [torch.from_numpy(a).bfloat16() for a in arrays]
    att, logits = _tc_head(*tensors, rows, chunks)
    assert att.dtype == logits.dtype == torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        p_att, p_logits = jax_attention._head_pallas(
            *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tensors), block_b=B)
    p_att = torch.from_numpy(np.array(p_att.astype(jnp.float32)))
    p_logits = torch.from_numpy(np.array(p_logits.astype(jnp.float32)))
    ref_att, ref_logits = glimpse_head_reference(*(t.float() for t in tensors))
    for got, want in ((att, p_att), (logits, p_logits), (att, ref_att), (logits, ref_logits)):
        _near(got.float(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,G,rows,chunks", [(200, 5, 64, 1), (200, 12, 16, 3), (130, 24, 32, 2)])
def test_glimpse_tc_model_matches_the_pallas_attend_with_masked_rows(R, G, rows, chunks, dtype):
    """glimpse_attend's tc arithmetic on given logits, a row masked past its
    middle and one masked whole (uniform weights, as the softmax gives):
    float32 within 1e-5, bf16 within the glimpse bound of the
    interpret-mode Pallas kernel's and of the port's plain version."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vqa_tpu.ops import attention as jax_attention

    B, D = 8, 16
    rng = np.random.default_rng(R + 7 * G)
    logits = (2 * rng.standard_normal((B, R, G))).astype(np.float32)
    v = rng.standard_normal((B, R, D)).astype(np.float32)
    lt, vt = _masked(torch.from_numpy(logits).to(dtype)), torch.from_numpy(v).to(dtype)
    got = glimpse_tc_model(lt, vt, rows, chunks)
    jl, jv = jnp.asarray(lt.float().numpy()), jnp.asarray(vt.float().numpy())
    if dtype == torch.bfloat16:
        jl, jv = jl.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        pallas = torch.from_numpy(np.array(jax_attention._pallas_fwd(jl, jv).astype(jnp.float32)))
    plain = glimpse_attend_reference(lt.float(), vt.float())
    uniform = vt[2].float().mean(0).expand(G, D)
    if dtype == torch.float32:
        for want in (pallas, plain):
            torch.testing.assert_close(got, want, **F32_TOL)
        torch.testing.assert_close(got[2], uniform, **F32_TOL)
    else:
        for want in (pallas, plain):
            _near(got.float(), want)
        _near(got[2].float(), uniform)
    assert bool(torch.isfinite(got).all())


def test_glimpse_tc_stats_merge_in_tile_order_to_the_softmax():
    """The logits kernel's tile statistics (max, sum of exp over each tile
    of rows) merged as the weighted sum merges them give the softmax's
    normaliser; a tile of masked regions keeps l at its length."""
    rng = np.random.default_rng(3)
    logits = _masked(torch.from_numpy(rng.standard_normal((3, 70, 4))))
    stats = glimpse_tc_stats_model(logits, 16)
    assert stats.shape == (3, 4, 5, 2)
    m, l = stats.unbind(-1)
    big = m.amax(-1, keepdim=True)
    merged = (l * torch.exp(m - big)).sum(-1)
    want = torch.exp(logits - logits.amax(1, keepdim=True)).sum(1)
    torch.testing.assert_close(merged, want)
    assert torch.equal(l[2], torch.tensor([16.0, 16, 16, 16, 6]).expand(4, 5).double())
    v = torch.from_numpy(rng.standard_normal((3, 70, 6)))
    torch.testing.assert_close(glimpse_tc_sum_model(logits, stats, v, 2),
                               glimpse_attend_reference(logits, v))


# ----------------------------------------------------------------- plans


@pytest.mark.parametrize("M", [510, 0])
@pytest.mark.parametrize("B,R,G,n,chunks", [
    (8, 196, 512, 128, 1),     # four groups of 128 glimpses
    (1024, 196, 512, 128, 1),
    (2, 196, 512, 128, 2),     # 128 CTAs: the four stages in two chunks
    (2, 16_384, 4, 8, 9),      # 32 CTAs: the regions in chunks to fill two CTAs an SM
    (1024, 16_384, 4, 8, 1),
    (64, GRID, 24, 24, 1),     # MutanAtt with 24 glimpses over the 1792-pixel grid
])
def test_glimpse_plan_takes_tc_past_shared_memory(B, R, G, n, chunks, M):
    """bf16 past alpha [R, G] in shared memory, v loadable by TMA: the tc
    design, G rounded up to a wgmma width (groups of 128 past it), both
    kernels within the shared memory a block may opt into, the regions in
    chunks of whole 64-region stages only where the CTAs leave SMs idle,
    the scratch the kernels' layout needs."""
    D = 2048
    plan = glimpse_plan(B, R, M, G, D)
    assert (plan["copy"], plan["groups"], plan["chunks"]) == ("tc", n, chunks)
    assert plan["smem_bytes"] <= SMEM and plan["logits"]["smem_bytes"] <= SMEM
    assert plan["rows"] == 64 and plan["ln"] == min(n, 64) and 2 <= plan["stages"] <= 4
    n_groups, n_rt = -(-G // n), -(-R // 64)
    assert plan["chunk"] % 64 == 0 and -(-n_rt * 64 // plan["chunk"]) == chunks
    assert plan["ctas"] == B * n_groups * (D // 128) * chunks
    assert plan["scratch_bytes"] == (B * n_groups * n_rt * 64 * n * 4
                                     + B * n_groups * n * -(-R // 64) * 8
                                     + (chunks * B * G * D * 4 if chunks > 1 else 0))
    assert attention._tc_plan(B, R, M, G, D, SMEM, attention.SMS) == plan


@pytest.mark.parametrize("M", [510, 0])
def test_glimpse_plan_keeps_split_without_tma_in_float32_and_where_forced(M):
    """The split design stays: float32 (no tc entry), vec=False (v or the
    output off 16 bytes, D % 8 != 0: no TMA) and copy="split" (at any
    shape), where the tc plan would fit."""
    B, R, G, D = 64, GRID, 24, 2048
    assert glimpse_plan(B, R, M, G, D, elem=4)["copy"] == "split"
    assert glimpse_plan(B, R, M, G, D, vec=False)["copy"] == "split"
    assert glimpse_plan(B, R, M, G, D, copy="split")["copy"] == "split"
    assert glimpse_plan(8, 36, M, 2, D, copy="split")["copy"] == "split"
    assert glimpse_plan(B, R, M, G, D, copy="split") == attention._split_plan(B, R, G, D, SMEM)
    assert attention._tc_plan(B, R, M, G, D, SMEM, attention.SMS) is not None


def test_glimpse_plan_tc_narrows_its_logits_tiles_for_wide_joint_rows():
    """A joint 4096 wide: the logits kernel's tiles shrink (8 glimpses, 16
    regions) until w^T and the joint tile fit; past what any tile fits
    (M=8000) the split design runs."""
    plan = glimpse_plan(2, GRID, 4096, 24, 2048)
    assert (plan["copy"], plan["ln"], plan["rows"]) == ("tc", 8, 16)
    assert plan["logits"]["smem_bytes"] <= SMEM
    assert glimpse_plan(2, GRID, 8000, 24, 2048)["copy"] == "split"


@pytest.mark.parametrize("B,R,G,chunks", [(2, 196, 512, 2), (2, 16_384, 4, 9), (64, GRID, 24, 1)])
def test_tc_scratch_is_one_allocation_the_plan_sizes(B, R, G, chunks):
    """The scratch: one allocation of the plan's ``scratch_bytes``, holding
    the logits, the tile statistics and (with chunks) the partials one
    after another, each of the size the kernels index and starting on 16
    bytes."""
    D = 2048
    plan = glimpse_plan(B, R, 510, G, D)
    assert (plan["copy"], plan["chunks"]) == ("tc", chunks)
    n_lg, n_stats, n_part = attention._tc_scratch_sizes(B, R, G, D, plan)
    n = plan["groups"]
    assert n_lg == B * -(-G // n) * -(-R // 64) * 64 * n
    assert n_stats == B * -(-G // n) * n * -(-R // plan["rows"]) * 2
    assert n_part == (chunks * B * G * D if chunks > 1 else 0)
    assert n_lg % 4 == 0 and n_stats % 4 == 0  # 16-byte starts for the next array
    scratch = attention.tc_scratch(B, R, G, D, "cpu", plan)
    assert scratch.dtype == torch.float32 and scratch.numel() * 4 == plan["scratch_bytes"]


# ------------------------------------------------------ on the card only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,M,G,D", [(64, GRID, 510, 24, 2048), (2, 196, 510, 512, 2048),
                                       (2, 16_384, 510, 4, 2048), (3, 1000, 77, 5, 200),
                                       (3, 130, 510, 24, 136)])
def test_glimpse_tc_on_the_card_matches_plain(cuda_device, B, R, M, G, D):
    """The tc design (the wrappers' at the large shapes, its plan taken
    directly at the odd ones: M odd, D past the last 128-column block by 72
    and by 8 columns)
    against the plain version in float32, glimpse_attend with a row masked
    past its middle and one whole; finite and bit-equal across two calls."""
    joint = torch.tanh(torch.randn(B, R, M, device=cuda_device)).bfloat16()
    w = (torch.randn(M, G, device=cuda_device) / M ** 0.5).bfloat16()
    b = (0.1 * torch.randn(G, device=cuda_device)).bfloat16()
    v = torch.randn(B, R, D, device=cuda_device).bfloat16()
    smem = attention._build.smem_optin(cuda_device.index or 0)
    head = attention._tc_plan(B, R, M, G, D, smem, attention.SMS)
    attend = attention._tc_plan(B, R, 0, G, D, smem, attention.SMS)
    assert head is not None and attend is not None
    outs = []
    for _ in range(2):
        att = torch.empty(B, G, D, dtype=torch.bfloat16, device=cuda_device)
        logits = torch.empty(B, R, G, dtype=torch.bfloat16, device=cuda_device)
        launch_glimpse_head(joint, w, b, v, att, logits, head)
        outs.append((att, logits))
    masked = outs[0][1].clone()
    masked[0, R // 2:] = torch.finfo(torch.bfloat16).min
    masked[1] = torch.finfo(torch.bfloat16).min
    got = [torch.empty(B, G, D, dtype=torch.bfloat16, device=cuda_device) for _ in range(2)]
    for g_ in got:
        launch_glimpse_attend(masked, v, g_, attend)
    if glimpse_plan(B, R, M, G, D)["copy"] == "tc":  # the wrappers' own dispatch
        before = glimpse_head.design_launches["tc"], glimpse_attend.design_launches["tc"]
        assert torch.equal(glimpse_head(joint, w, b, v)[0], outs[0][0])
        assert torch.equal(glimpse_attend(masked, v), got[0])
        assert (glimpse_head.design_launches["tc"], glimpse_attend.design_launches["tc"]) == \
            (before[0] + 1, before[1] + 1)
    ref_att, ref_logits = glimpse_head_reference(*(x.float() for x in (joint, w, b, v)))
    want = glimpse_attend_reference(masked.float(), v.float())
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(got[0], got[1]) and bool(torch.isfinite(got[0]).all())
    for g_, w_ in ((outs[0][0], ref_att), (outs[0][1], ref_logits), (got[0], want)):
        _near(g_.float(), w_)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,M,G,D", [(64, GRID, 510, 24, 2048), (2, 196, 510, 512, 2048),
                                       (2, 16_384, 510, 4, 2048), (2, GRID, 4096, 24, 2048),
                                       (3, 1000, 77, 5, 200)])
def test_glimpse_tc_geometry_matches_the_plan(cuda_device, B, R, M, G, D):
    """The plan's copy of csrc/glimpse_tc.cu's layout (``_tc_logits_smem``,
    ``_tc_sum_smem``) against the entry's own reckoning: both launches'
    CTAs, threads and shared memory, glimpse_head and glimpse_attend."""
    smem = attention._build.smem_optin(cuda_device.index or 0)
    for m in (M, 0):
        plan = attention._tc_plan(B, R, m, G, D, smem, attention.SMS)
        geo = attention.tc_launch_geometry(B, R, m, G, D, plan, cuda_device.index or 0)
        keys = ("ctas", "threads", "smem_bytes")
        assert {k: geo[k] for k in keys} == {k: plan["logits"][k] for k in keys}
        assert geo["weighted"] == {k: plan[k] for k in keys}
