"""Every shape the JAX package computes, on the port's kernels: the designs
for the shapes past the others' shared memory.

- ``relation_attend``'s tc design (two wgmma kernels: the scores into
  fp32 scratch, then the weighted sum) at every N past the tiled design,
  N=3136 (the grid of a 1792-pixel extract) among them, and its split
  design (r's rows in chunks, merged by their log-sum-exp) where the tc
  design cannot run (no TMA) or where forced;
- the glimpse kernels past alpha [R, G] in shared memory: in bf16 the tc
  design (csrc/glimpse_tc.cu, tests/test_torch_glimpse_tc.py), and the
  split design in float32, without TMA and where forced: glimpse groups
  (R=196 with G=512), and region chunks merged by their log-sum-exp
  (R=16,384 with G=4);
- ``mfb_pool``'s shared memory opted in past 48 KB, and its global design
  (the roots in the output row) past what a block may opt into;
- ``lstm_seq`` on an ``xg`` whose storage is off 16 bytes (an aligned copy).

On the CPU: the plans at those shapes in both dtypes, within the shared
memory a block may opt into; the plain models of each split-and-merge
against the plain versions (1e-5, float64 sums in another order), for 1, 2
and 7 chunks; each CUDA implementation, over a stand-in library whose new
entries compute those models in the memory handed to them, calling the
new entry with its plan's arguments; and the port's CoR and MutanAtt
forwards over 3136 regions (narrow widths, the flax weights carried
across) against the JAX package's, within 1e-4, the relation core once
more through the split design's dispatch. The ``cuda`` tests hold each new
design against its plain version on the card, at the tolerances of
tests/test_torch_ops.py (bf16) and tests/test_torch_float32.py (float32);
they skip here.
"""

import ctypes
import dataclasses
import os

import numpy as np
import pytest
import torch

from vqa_tpu_torch.ops import _build, attention, lse_merge, lstm, mfb_pool, relation
from vqa_tpu_torch.ops.attention import (glimpse_attend, glimpse_attend_reference,
                                         glimpse_attend_split_model, glimpse_head,
                                         glimpse_head_reference, glimpse_plan,
                                         glimpse_tc_logits_model, glimpse_tc_stats_model,
                                         glimpse_tc_sum_model)
from vqa_tpu_torch.ops.lstm import lstm_seq_reference
from vqa_tpu_torch.ops.mfb_pool import mfb_plan, mfb_pool_reference
from vqa_tpu_torch.ops.relation import (relation_attend, relation_attend_reference,
                                        relation_attend_split_model, relation_plan,
                                        tc_scores_model, tc_sum_model)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMEM = relation.SMEM_LIMIT  # the H100's opt-in shared memory
MODEL_TOL = 1e-5            # a split model against its plain version, float64
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_models.py's
GRID = 3136                 # the 56 x 56 grid of a 1792-pixel extract
# tests/test_torch_ops.py's and chip_smoke.py's bounds against the plain
# version in float32: bf16 relation_attend 0.01, the glimpse kernels 0.05,
# mfb_pool 2e-3 (unit rows), and at these shapes, where an output is a mean
# over thousands of rows, also 1% of the plain output's max-abs (one bf16
# rounding of the output is at most 0.4% of it, mfb_pool's global design's
# two 0.8%); float32 1e-5 of the plain
# output's max-abs, and mfb_pool against float64 within twice the plain
# float32 version's error
RELATION_ATOL, GLIMPSE_ATOL, MFB_ATOL, F32_REL = 0.01, 0.05, 2e-3, 1e-5
BF16_REL = 0.01




def _assert_near(got, want, atol):
    """bf16: the max-abs error within ``atol`` and within BF16_REL of the
    plain output's max-abs; float32: within F32_REL of it."""
    err = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    if got.dtype == torch.bfloat16:
        assert err <= min(atol, BF16_REL * scale), (err, atol, scale)
    else:
        assert err <= F32_REL * scale, (err, scale)


# ----------------------------------------------------------------- plans


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("N,design,chunks", [(2048, "wide", None), (GRID, "split", 2),
                                             (4096, "split", 2), (8192, "split", None),
                                             (2048, "tc", None), (GRID, "tc", None),
                                             (4096, "tc", None), (8192, "tc", None)])
def test_relation_plan_takes_every_n(N, design, chunks, elem):
    """D=1024: by default the tc design at every N (both kernels' shared
    memory independent of N, the scratch in slices of the batch under its
    budget). Forced: the wide design while its scores fit (N=2048), the
    split design past it, with the fewest chunks whose 16 x chunk scores
    fit beside pg's 16 rows (N=8192: 3 in bf16, 4 in float32)."""
    plan = relation_plan(64, N, 1024, elem=elem, design=None if design == "tc" else design)
    assert plan["design"] == design
    assert plan["smem_bytes"] <= SMEM
    if design == "tc":
        assert plan["weighted"]["smem_bytes"] <= SMEM
        assert plan["scratch_bytes"] <= relation.TC_SCRATCH_BUDGET
        assert plan["slice"] * plan["slices"] >= 64 > plan["slice"] * (plan["slices"] - 1)
    if design == "split":
        want = chunks or (3 if elem == 2 else 4)
        chunk = -(-N // want)
        assert (plan["chunks"], plan["chunk"]) == (want, chunk)
        assert plan["smem_bytes"] == 16 * 1024 * elem + chunk * 16 * 4
        assert plan["ctas"] == 64 * -(-N // 16) * want and plan["threads"] == 256
        assert plan["scratch_bytes"] == 64 * N * want * (1024 + 2) * 4
        fewer = 16 * 1024 * elem + -(-N // (want - 1)) * 16 * 4 if want > 1 else 0
        assert fewer > SMEM  # one chunk fewer would not fit


def test_relation_plan_refuses_only_past_one_chunk():
    """A forced split design runs at any N; only a limit below pg's 16 rows
    and one row's scores refuses, or chunks that do not split N evenly."""
    forced = relation_plan(8, 2048, 1024, design="split", split=2)
    assert (forced["design"], forced["chunks"], forced["chunk"]) == ("split", 2, 1024)
    assert relation_plan(8, 100, 1024, elem=4, design="split", split=7)["chunk"] == 15
    with pytest.raises(ValueError, match="shared memory"):
        relation_plan(8, GRID, 1024, smem_limit=16 * 1024 * 2 + 63)
    assert relation_plan(8, GRID, 1024, smem_limit=16 * 1024 * 2 + 64)["chunks"] == GRID
    with pytest.raises(ValueError, match="evenly"):
        relation_plan(8, 10, 64, design="split", split=6)  # chunks of 2 give 5


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("M", [510, 0])
@pytest.mark.parametrize("B,R,G,groups,chunks", [
    (8, 196, 512, 16, 1),      # groups of 16: 256 blocks
    (1024, 196, 512, 256, 1),  # the largest groups that fit: two
    (2, 16_384, 4, 4, 64),     # chunks of 256 regions: 128 blocks
    (1024, 16_384, 4, 4, 2),   # the fewest chunks that fit
    (64, GRID, 24, 8, 1),      # MutanAtt with 24 glimpses over the 1792-pixel grid
    (64, GRID, 2, None, None),  # MutanAtt as its YAML has it: the designs it had
])
def test_glimpse_plan_takes_every_region_and_glimpse_count(B, R, G, groups, chunks, M, elem):
    """glimpse_head (M=510) and glimpse_attend (M=0): past alpha [R, G] in
    shared memory the split design (in bf16 the tc design, the split one
    where forced), every region in one block while alpha [R, 4] fits
    (R=196 with G=512: the glimpses in groups of a multiple of 4, as small
    as fill twice the 132 SMs, as large as fit); past that (R=16,384 with
    G=4: alpha [R, 4] is 256 KB) the regions in chunks, at least the two
    that fit, as many as fill the SMs twice down to 256 regions a chunk."""
    plan = glimpse_plan(B, R, M, G, 2048, elem=elem)
    assert plan["smem_bytes"] <= SMEM
    if groups is None:
        assert plan["copy"] == ("f32" if elem == 4 else "bulk")
        return
    if elem == 2:  # bf16 takes the tc design (tests/test_torch_glimpse_tc.py)
        assert plan["copy"] == "tc"
        plan = glimpse_plan(B, R, M, G, 2048, elem=elem, copy="split")
    assert (plan["copy"], plan["groups"], plan["chunks"]) == ("split", groups, chunks)
    assert plan["chunk"] == -(-R // chunks)
    assert plan["smem_bytes"] == plan["chunk"] * groups * 4
    assert plan["ctas"] == B * -(-G // groups) * chunks
    assert plan["scratch_bytes"] == (B * G * chunks * (2048 + 2) * 4 if chunks > 1 else 0)


@pytest.mark.parametrize("m,design", [(1000, "shared"), (12_288, "shared"), (12_289, "shared"),
                                      (20_000, "shared"), (58_112, "shared"),
                                      (58_113, "global"), (70_000, "global")])
def test_mfb_plan_takes_every_m(m, design):
    """The roots in shared memory, opted in past 48 KB, up to the 232,448
    bytes a block may opt into (m = 58,112); past it in the output row."""
    plan = mfb_plan(m)
    assert plan["design"] == design and plan["smem_bytes"] <= SMEM
    assert plan["smem_bytes"] == (m * 4 if design == "shared" else 0)
    with pytest.raises(ValueError, match="m >= 1"):
        mfb_plan(0)


# ------------------------------------------------- the split-and-merge


def _f64(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape))


@pytest.mark.parametrize("chunks", [1, 2, 7])
def test_relation_split_model_matches_the_reference(chunks):
    """N=50 in chunks of 50, 25 and 8 (the last of 2): r's rows merged by
    their log-sum-exp give the plain version's output."""
    pg, r = torch.tanh(_f64(3, 50, 24)), torch.tanh(_f64(3, 50, 24, seed=1))
    got = relation_attend_split_model(pg, r, chunks)
    assert (got - relation_attend_reference(pg, r)).abs().max().item() <= MODEL_TOL


@pytest.mark.parametrize("chunks", [1, 2, 7])
def test_glimpse_split_model_matches_the_reference(chunks):
    """R=45 regions, G=6, with MFB's masked logits (finfo.min) past a row's
    length and a row masked whole (uniform weights, as the plain softmax)."""
    logits, v = _f64(4, 45, 6) * 3, _f64(4, 45, 10, seed=1)
    logits[1, 30:] = torch.finfo(torch.float64).min
    logits[2] = torch.finfo(torch.float64).min
    got = glimpse_attend_split_model(logits, v, chunks)
    want = glimpse_attend_reference(logits, v)
    assert (got - want).abs().max().item() <= MODEL_TOL
    assert (got[2] - v[2].mean(0)).abs().max().item() <= MODEL_TOL


def test_lse_merge_of_one_chunk_is_the_normalised_sum():
    part, m, l = _f64(5, 1, 8), _f64(5, 1), _f64(5, 1).abs() + 1
    assert torch.allclose(lse_merge(part, m, l), part[:, 0] / l)


# -------------------------------------------- the dispatch, off the card


def _view(ptr: int, shape, dtype=torch.float32) -> torch.Tensor:
    """The CPU memory at ``ptr`` as a tensor of ``shape`` and ``dtype``."""
    n = int(np.prod(shape))
    raw = (ctypes.c_uint16 if dtype == torch.bfloat16 else ctypes.c_float) * n
    t = torch.from_numpy(np.ctypeslib.as_array(raw.from_address(ptr)))
    return (t.view(torch.bfloat16) if dtype == torch.bfloat16 else t).view(*shape)


class _SplitLibrary:
    """The new entries (and the float32 ones a forward reaches), each
    computing its plain model in the memory the wrapper hands it, in
    float32 (bf16 operands widened, the outputs rounded once)."""

    def __init__(self):
        self.calls = []

    def vqa_relation_attend_split(self, pg, r, out, part, stats, B, N, D, chunks, elem, stream):
        dt = torch.bfloat16 if elem == 2 else torch.float32
        self.calls.append(("relation_split", chunks))
        got = relation_attend_split_model(_view(pg, (B, N, D), dt).float(),
                                          _view(r, (B, N, D), dt).float(), chunks)
        _view(out, (B, N, D), dt).copy_(got)
        _view(part, (B * N * chunks * D,)).zero_()   # the scratch is the wrapper's, whole
        _view(stats, (B * N * chunks * 2,)).zero_()
        return 0

    def vqa_relation_attend_tc(self, pg, r, out, s, stats, B, N, D, elem, which, stream):
        dt = torch.bfloat16 if elem == 2 else torch.float32
        tile = relation._TC[elem]["tile"]
        self.calls.append(("relation_tc", B, which))
        # launch 0 leaves the scores and their tile statistics in the
        # wrapper's scratch; launch 1 reads them from there
        s_view = _view(s, (B, N, -(-N // 4) * 4))[..., :N]
        stats_view = _view(stats, (B, N, -(-N // tile), 2))
        rr = _view(r, (B, N, D), dt).float()
        if which == 0:
            got_s, got_stats = tc_scores_model(_view(pg, (B, N, D), dt).float(), rr, tile)
            s_view.copy_(got_s)
            stats_view.copy_(got_stats)
        else:
            _view(out, (B, N, D), dt).copy_(tc_sum_model(s_view, stats_view, rr))
        return 0

    def vqa_relation_attend_f32(self, pg, r, out, B, N, D, design, stages, stream):
        self.calls.append(("relation_f32", design))
        _view(out, (B, N, D)).copy_(relation_attend_reference(_view(pg, (B, N, D)),
                                                              _view(r, (B, N, D))))
        return 0

    def vqa_glimpse_split(self, joint, w, bias, logits_in, v, out, logits_out, part, stats, B,
                          R, M, G, D, gc, chunks, elem, stream):
        dt = torch.bfloat16 if elem == 2 else torch.float32
        self.calls.append(("glimpse_split", "attend" if logits_in else "head", gc, chunks))
        assert (part is None) == (chunks == 1) and (stats is None) == (chunks == 1)
        if part is not None:
            _view(part, (B * G * chunks * D,)).zero_()
            _view(stats, (B * G * chunks * 2,)).zero_()
        vv = _view(v, (B, R, D), dt).float()
        if logits_in:
            logits = _view(logits_in, (B, R, G), dt).float()
        else:
            logits = (_view(joint, (B, R, M), dt).float() @ _view(w, (M, G), dt).float()
                      + _view(bias, (G,), dt).float())
            _view(logits_out, (B, R, G), dt).copy_(logits)
        _view(out, (B, G, D), dt).copy_(glimpse_attend_split_model(logits, vv, chunks))
        return 0

    def vqa_glimpse_tc(self, joint, w, bias, logits_in, v, out, logits_out, lg, stats, part, B,
                       R, M, G, D, n, rows, ln, stages, chunks, slots, launches, stream):
        dt = torch.bfloat16
        groups, rpad, rtiles = -(-G // n), -(-R // 64) * 64, -(-R // rows)
        assert (part is None) == (chunks == 1) and n % ln == 0 and launches in (1, 2, 3)
        # launch 0 leaves the fp32 logits [B, groups, rpad, n] and their tile
        # statistics [B, groups n, rtiles, 2] in the wrapper's scratch (the
        # columns past G zero); launch 1 reads them from there
        lg_view = _view(lg, (B, groups, rpad, n))
        stats_view = _view(stats, (B, groups * n, rtiles, 2))
        for which in (0, 1):
            if not launches >> which & 1:
                continue
            self.calls.append(("glimpse_tc", "attend" if logits_in else "head", which, n, chunks))
            if which == 0:
                if logits_in:
                    logits = _view(logits_in, (B, R, G), dt).float()
                else:
                    logits = glimpse_tc_logits_model(_view(joint, (B, R, M), dt),
                                                     _view(w, (M, G), dt), _view(bias, (G,), dt))
                    _view(logits_out, (B, R, G), dt).copy_(logits)
                padded = torch.nn.functional.pad(logits, (0, groups * n - G))
                lg_view[:, :, :R].copy_(padded.view(B, R, groups, n).transpose(1, 2))
                stats_view.copy_(glimpse_tc_stats_model(padded, rows))
            else:
                logits = lg_view[:, :, :R].transpose(1, 2).reshape(B, R, groups * n)[..., :G]
                got = glimpse_tc_sum_model(logits, stats_view[:, :G], _view(v, (B, R, D), dt),
                                           chunks)
                _view(out, (B, G, D), dt).copy_(got)
                if part is not None:
                    _view(part, (chunks * B * G * D,)).zero_()  # the scratch is the wrapper's
        return 0

    def vqa_glimpse_head_f32(self, joint, w, bias, v, out, logits, B, R, M, G, D, staged,
                             stream):
        self.calls.append(("glimpse_f32", "head"))
        att, lg = glimpse_head_reference(_view(joint, (B, R, M)), _view(w, (M, G)),
                                         _view(bias, (G,)), _view(v, (B, R, D)))
        _view(out, (B, G, D)).copy_(att)
        _view(logits, (B, R, G)).copy_(lg)
        return 0

    def vqa_mfb_pool_global(self, z, out, n, k, m, elem, stream):
        dt = torch.bfloat16 if elem == 2 else torch.float32
        self.calls.append(("mfb_global", m))
        _view(out, (n, m), dt).copy_(mfb_pool_reference(_view(z, (n, k * m), dt).float(), k))
        return 0

    def vqa_lstm_seq_f32(self, xg, mask, wh, h_last, seq, scratch, c, count, T, B, H, gs,
                         stream):
        self.calls.append(("lstm_f32", xg % 16))
        w = _view(wh, (H, 4, gs))[..., :H].reshape(H, 4 * H)
        h, s = lstm_seq_reference(_view(xg, (T, B, 4 * H)), _view(mask, (T, B, 1)), w)
        _view(h_last, (B, H)).copy_(h)
        _view(seq, (T, B, H)).copy_(s)
        return 0


@pytest.fixture
def split_dispatch(monkeypatch):
    """Every registered op's call routed to its CUDA implementation (as a
    CUDA tensor is dispatched), over the stand-in library, on a card with
    the H100's shared memory."""
    lib = _SplitLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "smem_optin", lambda index: SMEM)
    monkeypatch.setattr(_build, "current_stream", lambda device: 0)
    monkeypatch.setattr(lstm, "launch_geometry_f32",
                        lambda B, H, index: dict.fromkeys(lstm._F32_GEOMETRY, 0))
    for module, handle, impl in ((lstm, "_LSTM_SEQ_OP", lstm._lstm_seq_cuda),
                                 (attention, "_GLIMPSE_HEAD_OP", attention._glimpse_head_cuda),
                                 (attention, "_GLIMPSE_ATTEND_OP",
                                  attention._glimpse_attend_cuda),
                                 (mfb_pool, "_MFB_POOL_OP", mfb_pool._mfb_pool_cuda),
                                 (relation, "_RELATION_ATTEND_OP",
                                  relation._relation_attend_cuda)):
        monkeypatch.setattr(module, handle, impl)
    return lib


def _off_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose storage starts one element past 16
    bytes (no TMA: the wrapper plans with vec=False)."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
    off = base.view(t.shape).copy_(t)
    assert off.data_ptr() % 16 and off.is_contiguous()
    return off


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-6), (torch.bfloat16, RELATION_ATOL)])
def test_relation_attend_dispatches_the_split_design(split_dispatch, dtype, atol):
    """N=3136 at D=1024 with r off 16 bytes (no TMA, so not the tc design)
    takes the split entry with its plan's two chunks; the launch is counted
    under the design."""
    g = torch.Generator().manual_seed(0)
    pg, r = (torch.tanh(torch.randn(1, GRID, 1024, generator=g)).to(dtype) for _ in range(2))
    r = _off_16_bytes(r)
    before = relation_attend.design_launches["split"]
    got = relation_attend(pg, r)
    assert split_dispatch.calls == [("relation_split", 2)]
    assert relation_attend.design_launches["split"] == before + 1
    want = relation_attend_reference(pg.float(), r.float())
    assert (got.float() - want).abs().max().item() <= atol
    _assert_near(got, want, atol)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-6), (torch.bfloat16, RELATION_ATOL)])
def test_relation_attend_dispatches_the_tc_design(split_dispatch, dtype, atol):
    """N=3136 at D=1024, operands on 16 bytes: the wrapper takes the tc
    entry, its two launches for the batch (one slice, the scores' scratch
    handed from the first to the second), and counts the call under the
    design; the output is the plain version's."""
    g = torch.Generator().manual_seed(5)
    pg, r = (torch.tanh(torch.randn(1, GRID, 1024, generator=g)).to(dtype) for _ in range(2))
    before = relation_attend.design_launches["tc"]
    got = relation_attend(pg, r)
    assert split_dispatch.calls == [("relation_tc", 1, 0), ("relation_tc", 1, 1)]
    assert relation_attend.design_launches["tc"] == before + 1
    want = relation_attend_reference(pg.float(), r.float())
    assert (got.float() - want).abs().max().item() <= atol
    _assert_near(got, want, atol)


def _glimpse_inputs(dtype, R, G, seed=1):
    g = torch.Generator().manual_seed(seed)
    B, M, D = 1, 24, 16
    joint = torch.tanh(torch.randn(B, R, M, generator=g)).to(dtype)
    w = (torch.randn(M, G, generator=g) / M ** 0.5).to(dtype)
    b = torch.randn(G, generator=g).to(dtype)
    v = torch.randn(B, R, D, generator=g).to(dtype)
    return joint, w, b, v


def _assert_glimpse_outputs(dtype, joint, w, b, v, att, logits, got):
    ref_att, ref_logits = glimpse_head_reference(*(x.float() for x in (joint, w, b, v)))
    tol = 1e-5 if dtype == torch.float32 else GLIMPSE_ATOL
    assert (logits.float() - ref_logits).abs().max().item() <= tol
    assert (att.float() - ref_att).abs().max().item() <= tol
    assert (got.float() - glimpse_attend_reference(logits.float(), v.float())).abs().max() <= tol
    for out, want in ((logits, ref_logits), (att, ref_att),
                      (got, glimpse_attend_reference(logits.float(), v.float()))):
        _assert_near(out, want, GLIMPSE_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,G,groups,chunks,tc_n,tc_chunks", [(196, 512, 4, 1, 128, 4),
                                                              (16_384, 4, 4, 64, 8, 256)])
def test_glimpse_kernels_dispatch_the_split_design(split_dispatch, dtype, R, G, groups, chunks,
                                                   tc_n, tc_chunks):
    """glimpse_head and glimpse_attend past alpha [R, G] in shared memory
    at B=1: float32 takes the split entry with the plan's groups and chunks
    (scratch only where the regions are split); bf16 the tc entry, its two
    launches a call (the logits' scratch handed from the first to the
    second; glimpses in groups of the plan's wgmma width, the regions in
    chunks of 64, one a CTA at B=1), each call counted under its design;
    the outputs are the plain version's."""
    joint, w, b, v = _glimpse_inputs(dtype, R, G)
    design = "split" if dtype == torch.float32 else "tc"
    before = glimpse_head.design_launches[design], glimpse_attend.design_launches[design]
    att, logits = glimpse_head(joint, w, b, v)
    got = glimpse_attend(logits, v)
    if dtype == torch.float32:
        assert split_dispatch.calls == [("glimpse_split", "head", groups, chunks),
                                        ("glimpse_split", "attend", groups, chunks)]
    else:
        assert split_dispatch.calls == [("glimpse_tc", entry, which, tc_n, tc_chunks)
                                        for entry in ("head", "attend") for which in (0, 1)]
    assert (glimpse_head.design_launches[design], glimpse_attend.design_launches[design]) == \
        (before[0] + 1, before[1] + 1)
    _assert_glimpse_outputs(dtype, joint, w, b, v, att, logits, got)


@pytest.mark.parametrize("R,G,groups,chunks", [(196, 512, 4, 1), (16_384, 4, 4, 64)])
def test_glimpse_kernels_dispatch_the_split_design_in_bf16_without_tma(split_dispatch, R, G,
                                                                       groups, chunks):
    """bf16 with v off 16 bytes (no TMA, so not the tc design) takes the
    split entry with the plan's groups and chunks, counted under it; the
    outputs are the plain version's."""
    joint, w, b, v = _glimpse_inputs(torch.bfloat16, R, G)
    v = _off_16_bytes(v)
    before = glimpse_head.design_launches["split"], glimpse_attend.design_launches["split"]
    att, logits = glimpse_head(joint, w, b, v)
    got = glimpse_attend(logits, v)
    assert split_dispatch.calls == [("glimpse_split", "head", groups, chunks),
                                    ("glimpse_split", "attend", groups, chunks)]
    assert (glimpse_head.design_launches["split"], glimpse_attend.design_launches["split"]) == \
        (before[0] + 1, before[1] + 1)
    _assert_glimpse_outputs(torch.bfloat16, joint, w, b, v, att, logits, got)


@pytest.mark.parametrize("R,G,groups,chunks", [(196, 512, 4, 1), (16_384, 4, 4, 64)])
def test_glimpse_kernels_run_the_forced_split_design_in_bf16(split_dispatch, R, G, groups,
                                                             chunks):
    """bf16 on 16 bytes with the split design forced (copy="split", as
    chip_smoke.py times it beside tc): the launch functions take the split
    entry with its plan's groups and chunks."""
    joint, w, b, v = _glimpse_inputs(torch.bfloat16, R, G)
    B, _, M = joint.shape
    D = v.shape[2]
    att = torch.empty(B, G, D, dtype=torch.bfloat16)
    logits = torch.empty(B, R, G, dtype=torch.bfloat16)
    attention.launch_glimpse_head(joint, w, b, v, att, logits,
                                  glimpse_plan(B, R, M, G, D, copy="split"))
    got = torch.empty_like(att)
    attention.launch_glimpse_attend(logits, v, got, glimpse_plan(B, R, 0, G, D, copy="split"))
    assert split_dispatch.calls == [("glimpse_split", "head", groups, chunks),
                                    ("glimpse_split", "attend", groups, chunks)]
    _assert_glimpse_outputs(torch.bfloat16, joint, w, b, v, att, logits, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mfb_pool_dispatches_the_global_design(split_dispatch, dtype):
    """m=70,000 (past the opt-in shared memory) takes the global entry."""
    z = torch.randn(2, 2 * 70_000, generator=torch.Generator().manual_seed(2)).to(dtype)
    before = mfb_pool.mfb_pool.design_launches["global"]
    got = mfb_pool.mfb_pool(z, 2)
    assert split_dispatch.calls == [("mfb_global", 70_000)]
    assert mfb_pool.mfb_pool.design_launches["global"] == before + 1
    want = mfb_pool_reference(z.float(), 2)
    assert (got.float() - want).abs().max().item() <= (1e-6 if dtype == torch.float32
                                                       else MFB_ATOL)
    _assert_near(got, want, MFB_ATOL)


def test_lstm_seq_copies_an_xg_off_16_bytes(split_dispatch):
    """An xg view whose storage starts 4 bytes past 16 reaches the kernel
    as an aligned copy, with the same values."""
    g = torch.Generator().manual_seed(3)
    T, B, H = 3, 4, 8
    base = torch.randn(T * B * 4 * H + 1, generator=g)
    xg = base[1:].view(T, B, 4 * H)
    assert xg.data_ptr() % 16
    mask = torch.ones(T, B, 1)
    wh = torch.randn(H, 4 * H, generator=g) / H ** 0.5
    h, seq = lstm._lstm_seq_cuda(xg, mask, wh)
    assert split_dispatch.calls == [("lstm_f32", 0)]
    want_h, want_seq = lstm_seq_reference(xg, mask, wh)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)
    torch.testing.assert_close(seq, want_seq, rtol=0, atol=0)


# ----------------------------------------- the models over the 3136 grid

# tiny widths of cor.yaml and mutan_att.yaml (tests/test_torch_models.py's)
_TINY = {
    "cor": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
            "model.fusion.dim_h=10", "model.classif.dim_h=7"],
    "mutan_att": ["model.seq2vec.emb_size=16", "model.seq2vec.hidden_size=32",
                  "model.attention.dim_hv=12", "model.attention.dim_hq=12",
                  "model.attention.dim_mm=16", "model.attention.R=2",
                  "model.fusion.dim_hv=12", "model.fusion.dim_hq=12",
                  "model.fusion.dim_mm=16", "model.fusion.R=2"],
}


def _grid_models(name, num_words=30, num_answers=11, dim_v=14, B=3, extra=()):
    """A tiny model of ``name``.yaml (``extra`` overrides after the tiny
    widths) in flax and in the port with the same non-zero params, and its
    inputs over 3136 regions."""
    import jax
    import jax.numpy as jnp

    from vqa_tpu.config import load_options
    from vqa_tpu.importers import flatten_tree
    from vqa_tpu.models import factory as jax_factory
    from vqa_tpu_torch.models import factory as port_factory
    from vqa_tpu_torch.weights import load_params

    opt = load_options(os.path.join(REPO, "options", "vqa2", f"{name}.yaml"),
                       _TINY[name] + list(extra))
    jax_model = jax_factory(opt.model, num_words, num_answers)
    rng = np.random.default_rng(7)
    visual = rng.standard_normal((B, GRID, dim_v)).astype(np.float32)
    tokens = np.zeros((B, 8), np.int32)
    for i, n in enumerate((8, 3, 1)[:B]):
        tokens[i, :n] = rng.integers(1, num_words, n)
    params = jax_model.init(jax.random.key(0), jnp.asarray(visual[:1]),
                            jnp.asarray(tokens[:1]))["params"]
    params = jax.tree.map(lambda p: p + 0.05, params)
    port = port_factory(dataclasses.asdict(opt.model), num_words, num_answers, dim_v=dim_v)
    load_params(port, flatten_tree(params))
    want = jax_model.apply({"params": params}, jnp.asarray(visual), jnp.asarray(tokens))
    return port.eval(), visual, tokens, np.asarray(want)


@pytest.mark.parametrize("name", ["cor", "mutan_att"])
def test_models_over_the_1792_pixel_grid_match_jax(name):
    """CoR (its relation core at N=3136, three chain steps) and MutanAtt
    (its glimpse head at R=3136) over a 3136-region table: the port's
    logits within 1e-4 of the JAX package's."""
    port, visual, tokens, want = _grid_models(name)
    with torch.inference_mode():
        got = port(torch.from_numpy(visual), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)


def test_cor_over_the_grid_through_the_split_dispatch_matches_jax(split_dispatch, monkeypatch):
    """The same CoR with every kernel call through its CUDA implementation,
    on a card whose shared memory leaves the wide design no room at the
    model's narrow D (10): each relation core call takes the split entry,
    and the logits stay within 1e-4 of JAX's."""
    monkeypatch.setattr(_build, "smem_optin", lambda index: 100_000)
    port, visual, tokens, want = _grid_models("cor")
    with torch.inference_mode():
        got = port(torch.from_numpy(visual), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)
    splits = [c for c in split_dispatch.calls if c[0] == "relation_split"]
    assert len(splits) == 3 and all(chunks == 3 for _, chunks in splits)


def test_cor_over_the_grid_through_the_tc_dispatch_matches_jax(split_dispatch):
    """CoR with its fusion 16 wide (D % 8 == 0: TMA can load it) over the
    grid, every kernel call through its CUDA implementation: each of the
    three relation core calls takes the tc entry, the batch in one slice,
    and the logits stay within 1e-4 of JAX's."""
    port, visual, tokens, want = _grid_models("cor", extra=["model.fusion.dim_h=16"])
    before = relation_attend.design_launches["tc"]
    with torch.inference_mode():
        got = port(torch.from_numpy(visual), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)
    assert [c for c in split_dispatch.calls if c[0].startswith("relation")] == \
        [("relation_tc", 3, 0), ("relation_tc", 3, 1)] * 3
    assert relation_attend.design_launches["tc"] == before + 3


# ------------------------------------------------------ on the card only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(2, GRID), (2, 4096), (64, GRID)])  # (64, GRID): CoR's eval
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_relation_split_on_the_card_matches_plain(cuda_device, B, N, dtype):
    """r off 16 bytes: the wrapper takes the split design (the tc design
    needs TMA), counted under it."""
    pg = torch.tanh(torch.randn(B, N, 1024, device=cuda_device)).to(dtype)
    r = torch.empty(B * N * 1024 + 1, device=cuda_device, dtype=dtype)[1:].view(B, N, 1024)
    r.copy_(torch.tanh(torch.randn(B, N, 1024, device=cuda_device)))
    before = relation_attend.design_launches["split"]
    got = relation_attend(pg, r)
    want = relation_attend_reference(pg.float(), r.float())
    torch.cuda.synchronize()
    assert relation_attend.design_launches["split"] == before + 1
    _assert_near(got, want, RELATION_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,G", [(2, 196, 512), (2, 16_384, 4),
                                   (64, GRID, 24)])  # MutanAtt's eval with 24 glimpses
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_glimpse_split_on_the_card_matches_plain(cuda_device, B, R, G, dtype):
    """glimpse_head, then glimpse_attend on its logits with a row masked
    past its 100th region and one masked whole."""
    M, D = 510, 2048
    joint = torch.tanh(torch.randn(B, R, M, device=cuda_device)).to(dtype)
    w = (torch.randn(M, G, device=cuda_device) / M ** 0.5).to(dtype)
    b = torch.randn(G, device=cuda_device).to(dtype)
    v = torch.randn(B, R, D, device=cuda_device).to(dtype)
    att, logits = glimpse_head(joint, w, b, v)
    masked = logits.clone()
    masked[0, 100:] = torch.finfo(dtype).min
    masked[1] = torch.finfo(dtype).min
    got = glimpse_attend(masked, v)
    ref_att, ref_logits = glimpse_head_reference(*(x.float() for x in (joint, w, b, v)))
    want = glimpse_attend_reference(masked.float(), v.float())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    for g_, w_ in ((att, ref_att), (logits, ref_logits), (got, want)):
        _assert_near(g_, w_, GLIMPSE_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [20_000, 70_000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mfb_pool_large_m_on_the_card_matches_plain(cuda_device, m, dtype):
    z = torch.randn(37, 5 * m, device=cuda_device).to(dtype)
    got = mfb_pool.mfb_pool(z, 5)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        _assert_near(got, mfb_pool_reference(z.float(), 5), MFB_ATOL)
    else:
        want = mfb_pool_reference(z.double(), 5)
        plain = mfb_pool_reference(z, 5)
        assert _rel(got, want) <= max(1e-5, 2 * _rel(plain, want))


@pytest.mark.cuda
def test_lstm_seq_on_an_unaligned_xg_on_the_card(cuda_device):
    base = torch.randn(7 * 64 * 4 * 1024 + 1, device=cuda_device).bfloat16()
    xg = base[1:].view(7, 64, 4 * 1024)
    mask = torch.ones(7, 64, 1, device=cuda_device).bfloat16()
    wh = (torch.randn(1024, 4 * 1024, device=cuda_device) / 32).bfloat16()
    h, seq = lstm.lstm_seq(xg, mask, wh)
    h2, seq2 = lstm.lstm_seq(xg.contiguous().clone(), mask, wh)
    torch.cuda.synchronize()
    assert torch.equal(h, h2) and torch.equal(seq, seq2)
