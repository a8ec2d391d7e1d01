"""``relation_attend``'s "tc" design (csrc/relation_tc.cu): every N past
the tiled design's shared memory, both products on the tensor cores, as two
wgmma kernels (the scores with each row's tile statistics into fp32
scratch, then the weighted sum from alpha = exp(s - m) / l).

On the CPU: the design's arithmetic in plain PyTorch
(``relation_attend_tc_model``: the scores, each column tile's (max, sum of
exp), their merge in tile order, the normalised weighted sum) against the
port's and the JAX package's plain versions at odd N, N no multiple of the
tile, and one tile; the plans (which design each N takes in each dtype,
the kernels' shared memory, the slices of the batch under the scratch
budget, the designs that stay where "tc" cannot run); the slice loop of
the launch over a stand-in library. The dispatch of a CUDA-shaped call is
in tests/test_torch_large_shapes.py (its stand-in library). The ``cuda``
tests hold the kernels against the plain version on the card (bf16 within
min(0.01, 1% of the plain output's max-abs), float32 within 1e-5 of it),
bit-equal across two calls, and the plan's two launches against the
kernels' own reckoning; they skip here. JAX is imported only inside the
test that needs it, so the card's machine (no flax) runs the ``cuda``
tests.
"""

import ctypes

import numpy as np
import pytest
import torch

from vqa_tpu_torch.ops import _build, relation
from vqa_tpu_torch.ops.relation import (TC_SCRATCH_BUDGET, launch_relation_attend,
                                        relation_attend, relation_attend_reference,
                                        relation_attend_tc_model, relation_plan,
                                        tc_scores_model, tc_sum_model)

torch.set_num_threads(1)
SMEM = relation.SMEM_LIMIT  # the H100's opt-in shared memory
GRID = 3136                 # the 56 x 56 grid of a 1792-pixel extract
# the model against the plain versions in float32: the same products and
# exponentials, the softmax's sums taken by tile and merged (another order),
# which moves an output of magnitude <= 1 by a few float32 ulps
MODEL_TOL = 1e-5
RELATION_ATOL, BF16_REL, F32_REL = 0.01, 0.01, 1e-5  # chip_smoke.py's holds
BF16_TILED_MAX_N = 560       # the tiled design's largest bf16 N at D=1024


def _inputs(B, N, D, seed=0):
    rng = np.random.default_rng(seed)
    return (np.tanh(rng.standard_normal((B, N, D))).astype(np.float32),
            np.tanh(rng.standard_normal((B, N, D))).astype(np.float32))


@pytest.mark.parametrize("N,tile", [(37, 8), (50, 16), (64, 64), (33, 64), (300, 128),
                                    (257, 256)])
def test_relation_tc_model_matches_the_references(N, tile):
    """Odd N (37, 33, 257), N no multiple of the tile (37 in tiles of 8,
    50 of 16, 300 of 128), one tile (64 of 64, 33 of 64): the model within
    1e-5 of the port's plain version and of the JAX package's jnp
    reference on the same numpy inputs."""
    import jax.numpy as jnp

    from vqa_tpu.ops import relation as jax_relation

    pg, r = _inputs(2, N, 24)
    got = relation_attend_tc_model(torch.from_numpy(pg), torch.from_numpy(r), tile).numpy()
    want = relation_attend_reference(torch.from_numpy(pg), torch.from_numpy(r)).numpy()
    jax_want = np.asarray(jax_relation.relation_attend_reference(jnp.asarray(pg),
                                                                 jnp.asarray(r)))
    assert np.abs(got - want).max() <= MODEL_TOL
    assert np.abs(got - jax_want).max() <= MODEL_TOL


def test_relation_tc_model_keeps_uniform_and_peaked_rows():
    """Rows whose scores are all equal give the mean of r; a row with one
    score far above the rest (in another tile than the first) gives that
    row of r: the merge carries each tile's max."""
    N, D = 40, 8
    pg = torch.zeros(1, N, D, dtype=torch.float64)
    r = torch.from_numpy(np.random.default_rng(3).standard_normal((1, N, D)))
    got = relation_attend_tc_model(pg, r, 16)
    assert torch.allclose(got[0], r[0].mean(0).expand(N, D), atol=1e-12)
    pg[0, 0] = 40.0 * r[0, 35] / r[0, 35].norm()  # s[0, 35] ~ 40 sqrt(D) above the rest
    got = relation_attend_tc_model(pg, r, 16)
    assert torch.allclose(got[0, 0], relation_attend_reference(pg, r)[0, 0], atol=1e-12)


# ----------------------------------------------------------------- plans


@pytest.mark.parametrize("elem,N", [(2, 561), (2, 600), (2, 784), (2, 2048), (2, GRID),
                                    (2, 4096), (2, 8192), (4, 257), (4, 300), (4, 784),
                                    (4, 2048), (4, GRID), (4, 4096), (4, 8192)])
def test_relation_plan_takes_tc_past_the_tiled_design(elem, N):
    """D=1024, B=64: every N past the tiled design (bf16 past 560, float32
    past 256) takes "tc": two launches of 288 threads, the scores a CTA a
    128 x tile block of s (tile 256 in bf16, 128 in float32), the
    weighted sum a CTA 128 rows x tile columns of d; both kernels' shared
    memory within the opt-in limit; the batch in the fewest slices whose
    scratch (s [slice, N, ld] fp32, ld = N rounded up to 4, and the tile
    statistics [slice, N, tiles, 2]) fits 4 GiB."""
    plan = relation_plan(64, N, 1024, elem=elem)
    tile = 256 if elem == 2 else 128
    assert plan["design"] == "tc" and plan["tile"] == tile
    assert (plan["threads"], plan["cluster"], plan["rows"]) == (288, 1, 128)
    ld, tiles = -(-N // 4) * 4, -(-N // tile)
    per_element = N * (ld + 2 * tiles) * 4
    slices = -(-64 // (TC_SCRATCH_BUDGET // per_element))
    bs = -(-64 // slices)
    assert (plan["slice"], plan["slices"], plan["ld"], plan["tiles"]) == (bs, slices, ld, tiles)
    assert plan["scratch_bytes"] == bs * per_element <= TC_SCRATCH_BUDGET
    assert plan["ctas"] == bs * -(-N // 128) * tiles
    weighted = plan["weighted"]
    assert weighted["ctas"] == bs * -(-N // 128) * (1024 // tile)
    assert (weighted["threads"], weighted["cluster"]) == (288, 1)
    assert max(plan["smem_bytes"], weighted["smem_bytes"]) <= SMEM
    # a stage: pg's 128-row box and r's tile-row box (float32: and its lo
    # half), 128-byte rows; the weighted sum's r tile and the scratch tile
    # (float32: and alpha's lo half), 1 KB of alignment, 16 bytes of
    # barriers a stage, (m, 1 / l) of 128 rows
    score_stage = 128 * 128 + tile * 128 * (2 if elem == 4 else 1)
    k = 128 // elem
    sum_stage = k * tile * elem + 128 * k * 4 * (2 if elem == 4 else 1)
    stages = (4, 3) if elem == 2 else (4, 4)
    assert plan["smem_bytes"] == 1024 + stages[0] * (score_stage + 16)
    assert weighted["smem_bytes"] == 1024 + stages[1] * (sum_stage + 16) + 1024


@pytest.mark.parametrize("elem,N,design", [(2, BF16_TILED_MAX_N, "tiled"), (2, 561, "tc"),
                                           (4, 256, "tiled"), (4, 257, "tc")])
def test_relation_plan_tc_starts_where_the_tiled_design_ends(elem, N, design):
    assert relation_plan(8, N, 1024, elem=elem)["design"] == design


@pytest.mark.parametrize("elem", [2, 4])
def test_relation_plan_keeps_wide_and_split_where_tc_cannot_run(elem):
    """No TMA (D % 8 != 0, or a pointer off 16 bytes), a card whose shared
    memory holds neither tc kernel, or one element's scratch past the
    budget: the wide design while its scores fit, else the split one. Both
    stay forceable where "tc" would run; a forced tc that cannot run is
    refused."""
    assert relation_plan(8, 2048, 1024, vec=False, elem=elem)["design"] == "wide"
    assert relation_plan(8, GRID, 1024, vec=False, elem=elem)["design"] == "split"
    assert relation_plan(8, 1000, 1024, smem_limit=150_000, elem=elem)["design"] == "wide"
    assert relation_plan(1, 40_000, 1024, elem=elem)["design"] == "split"  # 6.4 GB an element
    assert relation_plan(8, GRID, 1024, elem=elem, design="split")["design"] == "split"
    assert relation_plan(8, 2048, 1024, elem=elem, design="wide")["design"] == "wide"
    assert relation_plan(8, 2048, 1024, elem=elem, design="tc")["design"] == "tc"
    with pytest.raises(ValueError, match="tc design needs"):
        relation_plan(8, 2048, 1024, vec=False, elem=elem, design="tc")


def test_relation_tc_slices_stay_under_the_budget():
    """CoR's eval batch over the grid runs as one slice of 64 (2.54 GB of
    scratch in bf16); a batch of 1024 as ten slices of at most 103, each
    within 4 GiB; a smaller budget cuts the batch finer, one element at the
    least."""
    assert relation_plan(64, GRID, 1024)["slices"] == 1
    big = relation_plan(1024, GRID, 1024)
    assert (big["slices"], big["slice"]) == (10, 103)
    assert big["scratch_bytes"] <= TC_SCRATCH_BUDGET
    per_element = GRID * (GRID + 2 * 13) * 4
    small = relation._tc_plan(64, GRID, 1024, True, SMEM, 2, budget=3 * per_element)
    assert (small["slice"], small["slices"]) == (3, 22)
    assert relation._tc_plan(64, GRID, 1024, True, SMEM, 2, budget=per_element - 1) is None


# ------------------------------------------------ the slices, off the card


def _view(ptr: int, shape, dtype) -> torch.Tensor:
    n = int(np.prod(shape))
    raw = (ctypes.c_uint16 if dtype == torch.bfloat16 else ctypes.c_float) * n
    t = torch.from_numpy(np.ctypeslib.as_array(raw.from_address(ptr)))
    return (t.view(torch.bfloat16) if dtype == torch.bfloat16 else t).view(*shape)


class _TcLibrary:
    """The tc entry, computing each launch's model in the memory it is
    handed (float32; bf16 operands widened, the output rounded once): the
    scores and their tile statistics into the scratch, then the weighted
    sum from the scratch."""

    def __init__(self):
        self.calls = []

    def vqa_relation_attend_tc(self, pg, r, out, s, stats, B, N, D, elem, which, stream):
        dt = torch.bfloat16 if elem == 2 else torch.float32
        tile = relation._TC[elem]["tile"]
        self.calls.append((pg, out, B, which))
        s_view = _view(s, (B, N, -(-N // 4) * 4), torch.float32)[..., :N]  # a slice's scratch
        stats_view = _view(stats, (B, N, -(-N // tile), 2), torch.float32)
        rr = _view(r, (B, N, D), dt).float()
        if which == 0:
            got_s, got_stats = tc_scores_model(_view(pg, (B, N, D), dt).float(), rr, tile)
            s_view.copy_(got_s)
            stats_view.copy_(got_stats)
        else:
            _view(out, (B, N, D), dt).copy_(tc_sum_model(s_view, stats_view, rr))
        return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relation_tc_launch_runs_the_batch_in_slices(monkeypatch, dtype):
    """A budget of two elements' scratch over a batch of 5: the entry's two
    launches for each slice (2, 2 and 1 elements) at the slices' offsets,
    one scratch for all, the output the plain version's."""
    lib = _TcLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "current_stream", lambda device: 0)
    B, N, D = 5, 40, 16
    g = torch.Generator().manual_seed(4)
    pg, r = (torch.tanh(torch.randn(B, N, D, generator=g)).to(dtype) for _ in range(2))
    per_element = N * (40 + 2 * 1) * 4
    plan = relation._tc_plan(B, N, D, True, SMEM, dtype.itemsize, budget=2 * per_element + 3)
    assert (plan["slice"], plan["slices"]) == (2, 3)
    out = torch.empty_like(pg)
    launch_relation_attend(pg, r, out, plan)
    step = N * D * dtype.itemsize
    assert lib.calls == [(pg.data_ptr() + b0 * step, out.data_ptr() + b0 * step, n, which)
                         for b0, n in ((0, 2), (2, 2), (4, 1)) for which in (0, 1)]
    want = relation_attend_reference(pg.float(), r.float())
    tol = 1e-6 if dtype == torch.float32 else RELATION_ATOL
    assert (out.float() - want).abs().max().item() <= tol


# ------------------------------------------------------ on the card only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _hold(got, want):
    """bf16 within min(0.01, 1% of the plain output's max-abs); float32
    within 1e-5 of it."""
    err = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    if got.dtype == torch.bfloat16:
        assert err <= min(RELATION_ATOL, BF16_REL * scale), (err, scale)
    else:
        assert err <= F32_REL * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D", [(2, GRID, 1024), (3, 600, 64), (2, 1001, 1024),
                                   (1, 4097, 200), (3, 257, 1024), (2, 300, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_relation_tc_on_the_card_matches_plain(cuda_device, B, N, D, dtype):
    """B=2, N=3136 (the grid), odd N (1001, 4097, 257), D no multiple of
    the weighted sum's columns (64, 200): the tc design wherever it takes
    the shape, against the plain version; two calls bit-equal."""
    pg = torch.tanh(torch.randn(B, N, D, device=cuda_device)).to(dtype)
    r = torch.tanh(torch.randn(B, N, D, device=cuda_device)).to(dtype)
    plan = relation_plan(B, N, D, elem=dtype.itemsize, design="tc",
                         smem_limit=_build.smem_optin(cuda_device.index or 0))
    got, again = torch.empty_like(pg), torch.empty_like(pg)
    launch_relation_attend(pg, r, got, plan)
    launch_relation_attend(pg, r, again, plan)
    want = relation_attend_reference(pg.float(), r.float())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _hold(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_relation_tc_is_the_default_on_the_card(cuda_device, dtype):
    """The wrapper takes "tc" at N=3136 and counts the call under it."""
    pg = torch.tanh(torch.randn(2, GRID, 1024, device=cuda_device)).to(dtype)
    r = torch.tanh(torch.randn(2, GRID, 1024, device=cuda_device)).to(dtype)
    before = relation_attend.design_launches["tc"]
    got = relation_attend(pg, r)
    want = relation_attend_reference(pg.float(), r.float())
    torch.cuda.synchronize()
    assert relation_attend.design_launches["tc"] == before + 1
    _hold(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,elem", [(64, GRID, 1024, 2), (16, GRID, 1024, 4),
                                        (1024, GRID, 1024, 2), (3, 600, 64, 2),
                                        (3, 257, 1024, 4)])
def test_relation_tc_plan_matches_the_card(cuda_device, B, N, D, elem):
    """relation_plan reckons both launches in Python; csrc/relation_tc.cu
    reckons them in C++: they agree on the CTAs, the cluster, the threads
    and the shared memory of each."""
    plan = relation_plan(B, N, D, elem=elem, smem_limit=_build.smem_optin(cuda_device.index or 0))
    assert plan["design"] == "tc"
    geometry = relation.launch_geometry(B, N, D, plan, True, cuda_device.index or 0, elem=elem)
    keys = ("ctas", "cluster", "threads", "smem_bytes")
    assert geometry == {**{k: plan[k] for k in keys}, "weighted": plan["weighted"]}
