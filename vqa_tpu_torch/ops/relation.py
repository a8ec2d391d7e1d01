"""CoR relation core, the port of ``vqa_tpu/ops/relation.py``.

relation_attend(pg [B, N, D], r [B, N, D]) -> absorbed [B, N, D]

    s_ij  = <pg_i, r_j> / sqrt(D)
    alpha = softmax_j(s)
    out_i = sum_j alpha_ij r_j

The forward is the registered op ``torch.ops.vqa_tpu_torch.relation_attend``:
on CUDA tensors it launches the hand-written kernel in
``csrc/relation.cu`` (past the tiled design's shared memory, the two
kernels of ``csrc/relation_tc.cu``) with the schedule ``relation_plan``
gives: bf16 in and
out (fp32 scores and softmax; alpha kept to ~2^-16 through the second
product as two bf16 halves), or float32 in and out through its float32
entry (the tiled design with both products in 3xTF32 on the tensor cores,
everything else in fp32, nothing rounded); on CPU tensors it takes the
plain version.

Where an input asks for grads, the call is a ``torch.autograd.Function``:
the same forward, and a backward by autograd through
``relation_attend_reference`` on the saved ``(pg, r)`` (a recompute), as
``vqa_tpu/ops/relation.py::_bwd`` takes the vjp of its jnp reference.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vqa_tpu_torch.ops import (KERNEL_DTYPES, MAX_MERGE_CHUNKS, SMEM_LIMIT, _build, lse_merge,
                               recompute_grads, register)

MAX_N = 64              # the element design: s at most 4 x 16 rows, 8 x 8 columns
MAX_F32_TILED_N = 256   # float32's tiled design: its softmax keeps a row in registers
_ELEMENT_N = 48         # its N by default: at N=64 the tiled design measured faster
# csrc/relation.cu's constants, and the plan's targets
_MAX_SPLIT = 8          # the portable cluster size
_MIN_COLS = 64          # columns a split CTA keeps
_PAIR_BYTES = 115_712   # two CTAs of this (and 1 KB reserved each) fill an SM's 228 KB
_TILE_ROWS = 64         # rows of i a CTA of the tiled design owns
_ROW_BYTES = 128        # a tiled stage's rows: one 128-byte swizzled row (64 bf16, 32 float32)
_BOX_ROWS = 256         # rows one TMA box may hold
_MAX_STAGES = 4
_WIDE_ROWS = 16         # rows of i a block of the wide (and split) design owns
_DESIGNS = {"element": 0, "tiled": 1, "wide": 2, "split": 3}  # csrc/relation.cu's kDesign*
_GEOMETRY = ("ctas", "cluster", "threads", "smem_bytes")
# csrc/relation_tc.cu's constants: rows of i a CTA of either kernel, its
# threads (two consumer warpgroups and a producer warp); by element size the
# scores' column tile (the tile statistics'), the weighted sum's columns of
# d a CTA, the elements of a stage's 128-byte rows, the two rings' stages
_TC_ROWS = 128
_TC_THREADS = 288
_TC = {2: dict(tile=256, cols=256, k=64, score_stages=4, sum_stages=3),
       4: dict(tile=128, cols=128, k=32, score_stages=4, sum_stages=4)}
TC_SCRATCH_BUDGET = 4 << 30  # bytes of s and its tile statistics a call of "tc" may hold


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _ceil(x, m) * m


def _element_smem(N: int, D: int, split: int) -> int:
    """csrc/relation.cu's Shape: three barriers; this CTA's columns of pg
    and r, rows padded by 16 bytes; its partial scores [N, N4] and the
    peers' partials of the ceil(N / split) rows it owns [split - 1, ., N4]
    (fp32, N4 = N rounded up to 4); alpha [Np, Np] as packed words (bf16 hi
    | lo), rows of 4 Np + 32 bytes (Np = N rounded up to 16)."""
    dcp = _round_up(_ceil(D, split), 16)
    np_, np4 = _round_up(N, 16), _round_up(N, 4)
    part = (N + (split - 1) * _ceil(N, split)) * np4 * 4
    return 32 + 2 * _round_up(N * (dcp + 8) * 2, 16) + part + np_ * (4 * np_ + 32)


def _tiled_smem(N: int, stages: int, elem: int = 2) -> int:
    """csrc/relation.cu's tiled_smem: 1 KB to align the ring; the ring (each
    stage pg's 64-row box and N rows of r in boxes of up to 256 rows, rows
    of 128 bytes: 64 bf16 or 32 float32 columns, 128-byte swizzled); the
    region: bf16 s / alpha [64, 4 Np + 32 bytes] (packed words read 8 bytes
    at a time); float32 two buffers of the lo half of a stage's pg box and
    s [64, 4 Np + 16 bytes] during the scores, then alpha's tf32 halves (K
    blocks of 32 columns, 8 KB each, hi and lo); the barriers."""
    nbox = _ceil(N, _BOX_ROWS)
    r_rows = nbox * _round_up(_ceil(N, nbox), 8)
    stage = _TILE_ROWS * _ROW_BYTES + r_rows * _ROW_BYTES
    row = 4 * _round_up(N, 16) + (32 if elem == 2 else 16)
    region = _TILE_ROWS * row
    if elem == 4:
        lo = 2 * _TILE_ROWS * _ROW_BYTES
        region = max(lo + region, 2 * _ceil(_round_up(N, 16), 32) * _TILE_ROWS * _ROW_BYTES)
    return 1024 + stages * stage + region + 16 * stages


def _wide_smem(N: int, D: int, elem: int = 2) -> int:
    """csrc/relation.cu's wide_smem: 16 rows of pg (``elem``-byte
    elements), s^T [N, 16] (fp32); the split design's with N its chunk."""
    return _round_up(_WIDE_ROWS * D * elem, 16) + N * _WIDE_ROWS * 4


def _wide_plan(B: int, N: int, D: int, smem_limit: int, elem: int = 2) -> dict:
    """The wide design where its s^T [N, 16] fits, else the split one."""
    smem = _wide_smem(N, D, elem)
    if smem > smem_limit:
        return _split_plan(B, N, D, smem_limit, elem)
    return {"design": "wide", "split": 1, "stages": 1, "rows": _WIDE_ROWS,
            "smem_bytes": smem, "ctas": B * _ceil(N, _WIDE_ROWS), "cluster": 1,
            "threads": 256}


def _split_plan(B: int, N: int, D: int, smem_limit: int, elem: int = 2,
                chunks: int | None = None) -> dict:
    """The split design: the wide design over ``chunks`` chunks of r's rows
    (the fewest whose s^T [chunk, 16] fits beside pg's 16 rows, or as
    forced), merged by their log-sum-exp; fp32 scratch of the chunks'
    partial outputs [B N, chunks, D] and their (max, sum) [B N, chunks, 2].
    Raises ValueError where even a chunk of one row does not fit."""
    room = (smem_limit - _wide_smem(0, D, elem)) // (_WIDE_ROWS * 4)  # rows a chunk may hold
    if room < 1:
        raise ValueError(f"relation_attend: D={D} needs {_wide_smem(1, D, elem)} bytes of "
                         f"shared memory (16 rows of pg and the scores of one row of r), over "
                         f"the {smem_limit} a block may opt into")
    if chunks is None:
        chunks = _ceil(N, room)
    if not 1 <= chunks <= min(N, MAX_MERGE_CHUNKS):
        raise ValueError(f"relation_attend: the split design takes 1 to min(N, {MAX_MERGE_CHUNKS}) "
                         f"chunks, got {chunks} at N={N}")
    chunk = _ceil(N, chunks)
    if _ceil(N, chunk) != chunks or chunk > room:
        raise ValueError(f"relation_attend: {chunks} chunks of N={N} rows do not split evenly "
                         f"or exceed the {room} rows a chunk's scores may hold")
    return {"design": "split", "split": 1, "stages": 1, "rows": _WIDE_ROWS,
            "chunks": chunks, "chunk": chunk, "smem_bytes": _wide_smem(chunk, D, elem),
            "ctas": B * _ceil(N, _WIDE_ROWS) * chunks, "cluster": 1, "threads": 256,
            "scratch_bytes": B * N * chunks * (D + 2) * 4}


def _tc_smem(elem: int) -> tuple:
    """csrc/relation_tc.cu's Layout: the scores' and the weighted sum's
    shared memory. Each: 1 KB to align the ring, the ring (scores: pg's
    128-row box and r's tile-row box of 128-byte rows, float32 also r's lo
    half; weighted sum: r's k x cols tile and the scratch's 128 x k fp32
    tile, float32 also alpha's lo half) with 16 bytes of barriers a stage;
    the weighted sum also (m, 1 / l) of its 128 rows."""
    t = _TC[elem]
    score = _TC_ROWS * _ROW_BYTES + t["tile"] * _ROW_BYTES * (2 if elem == 4 else 1)
    s_tile = _TC_ROWS * t["k"] * 4
    weighted = t["k"] * t["cols"] * elem + s_tile * (2 if elem == 4 else 1)
    return (1024 + t["score_stages"] * (score + 16),
            1024 + t["sum_stages"] * (weighted + 16) + 2 * _TC_ROWS * 4)


def _tc_plan(B: int, N: int, D: int, vec: bool, smem_limit: int, elem: int,
             budget: int = TC_SCRATCH_BUDGET):
    """The "tc" design, or None where it cannot run: D % 8 != 0 or a
    pointer off 16 bytes (no TMA), either kernel's shared memory past
    ``smem_limit``, or one element's scratch past ``budget``. Two launches
    a slice of ``slice`` elements: the scores ([slice, N, ld] fp32, ld = N
    rounded up to 4, and the tile statistics [slice, N, tiles, 2]), then the
    weighted sum; the slices as even as the budget lets them be."""
    t = _TC[elem]
    score_smem, sum_smem = _tc_smem(elem)
    if not vec or max(score_smem, sum_smem) > smem_limit:
        return None
    ld, tiles = _round_up(N, 4), _ceil(N, t["tile"])
    per_element = N * (ld + 2 * tiles) * 4
    most = budget // per_element
    if most < 1:
        return None
    slices = _ceil(B, most)
    bs = _ceil(B, slices)
    row_tiles = _ceil(N, _TC_ROWS)
    return {"design": "tc", "split": 1, "stages": t["score_stages"], "rows": _TC_ROWS,
            "tile": t["tile"], "smem_bytes": score_smem, "ctas": bs * row_tiles * tiles,
            "cluster": 1, "threads": _TC_THREADS,
            "weighted": {"ctas": bs * row_tiles * _ceil(D, t["cols"]), "cluster": 1,
                         "threads": _TC_THREADS, "smem_bytes": sum_smem},
            "slice": bs, "slices": slices, "ld": ld, "tiles": tiles,
            "scratch_bytes": bs * per_element}


def _forced_tc(B: int, N: int, D: int, vec: bool, smem_limit: int, elem: int) -> dict:
    plan = _tc_plan(B, N, D, vec, smem_limit, elem)
    if plan is None:
        raise ValueError(f"relation_attend: the tc design needs D % 8 == 0, operands on 16 "
                         f"bytes, {max(_tc_smem(elem))} bytes of shared memory (a block may opt "
                         f"into {smem_limit}) and one element's scratch within "
                         f"{TC_SCRATCH_BUDGET} bytes (N={N}, D={D})")
    return plan


def _tiled_plan(B: int, N: int, smem_limit: int, elem: int = 2) -> dict:
    stages = _MAX_STAGES
    while _tiled_smem(N, stages, elem) > smem_limit:
        stages -= 1
    return {"design": "tiled", "split": 1, "stages": stages, "rows": _TILE_ROWS,
            "smem_bytes": _tiled_smem(N, stages, elem), "ctas": B * _ceil(N, _TILE_ROWS),
            "cluster": 1, "threads": 544}


def _f32_plan(B: int, N: int, D: int, vec: bool, smem_limit: int, design: str | None,
              split: int | None) -> dict:
    """float32's plan: "tiled" up to N = 256 (its softmax keeps a row in
    registers) where a stage fits, both products in 3xTF32 on the tensor
    cores; "tc" past that (both products in 3xTF32 on wgmma, two kernels);
    "wide" (FP32 FMA on the CUDA cores) where "tc" cannot run (vec=False),
    or where forced; "split" past the wide design's shared memory, or where
    forced."""
    fits = N <= MAX_F32_TILED_N and _tiled_smem(N, 1, elem=4) <= smem_limit
    if design is None:
        if fits:
            design = "tiled"
        else:
            tc = _tc_plan(B, N, D, vec, smem_limit, 4)
            if tc is not None:
                return tc
            design = "wide"
    if design == "tc":
        return _forced_tc(B, N, D, vec, smem_limit, 4)
    if design == "wide":
        return _wide_plan(B, N, D, smem_limit, elem=4)
    if design == "split":
        return _split_plan(B, N, D, smem_limit, 4, split)
    if design != "tiled":
        raise ValueError(f"relation_attend (float32) has no {design!r} design: it runs the "
                         f"tiled one, the tc one, the wide one or the split one")
    if not fits:
        raise ValueError(f"relation_attend (float32): the tiled design takes N <= "
                         f"{MAX_F32_TILED_N} and a stage in shared memory: N={N} needs "
                         f"{_tiled_smem(N, 1, elem=4)} bytes, {smem_limit} a block may opt into")
    return _tiled_plan(B, N, smem_limit, elem=4)


@functools.lru_cache(maxsize=1024)
def relation_plan(B: int, N: int, D: int, vec: bool = True, smem_limit: int = SMEM_LIMIT,
                  design: str | None = None, split: int | None = None,
                  elem: int = 2) -> dict:
    """The schedule ``csrc/relation.cu`` runs for B elements of N objects and
    D features, in elements of ``elem`` bytes. float32 (``elem=4``): "tiled"
    below with both products in 3xTF32 (each operand split into two tf32
    halves, three tensor-core products summed in fp32, on ``wgmma``), up to
    N = 256; "wide", with both products as FP32 FMA, past that. bf16
    (``elem=2``):

    - "element" (N <= 48; forced, up to 64): a cluster of ``split`` CTAs
      of 512 threads an element, each holding its D / split columns of pg
      and r (bulk copies on an mbarrier), computing its partial scores on
      the tensor cores and sending each peer the rows it owns, taking the
      softmax of its own rows (the cluster's partials summed in rank order)
      and sending each peer those rows of alpha (bulk copies between the
      CTAs' shared memory), then computing its columns of the output.
      ``split`` is 2 where two such CTAs fit on an SM (N=36, D=1024: ~91
      KB; on the card the pair beat 1, 4 and 8), else the fewest that fit
      (N=48: 1, where the pair would hold an SM alone and lost to it); each
      split CTA keeps >= 64 columns on a multiple of 16;
    - "tiled" (N > 48: at N=64 it beat every split): one CTA an
      element and 64 rows of i, fed by TMA through a ring of ``stages``
      stages of 128-byte rows (pg's tile and all of r for the scores, then
      r again for the weighted sum), s [64, N] kept in shared memory;
    - "tc" (the tiled design's s and one stage over ``smem_limit``: N
      past ~570 at D=1024; in float32 past N = 256): two kernels of
      csrc/relation_tc.cu, the scores on wgmma into fp32 scratch with each
      row's (max, sum of exp) a column tile, then the weighted sum on
      wgmma from alpha = exp(s - m) / l; the batch in slices whose scratch
      fits ``TC_SCRATCH_BUDGET`` (one slice at CoR's [64, 3136, 1024]);
    - "wide" (where "tc" cannot run: ``vec=False``, or one element's
      scratch past the budget; or forced): the parent's N > 64 kernel,
      one block an element and 16 rows, the scores on the CUDA cores;
    - "split" (the wide design's s^T [N, 16] over ``smem_limit``: N past
      ~3100 at D=1024, ~2600 in float32): the wide design over ``chunks``
      chunks of r's rows, each block's shared memory independent of N, the
      chunks' fp32 partials merged by their log-sum-exp (a second kernel).

    ``vec=False`` (D % 8 != 0, or a pointer off 16 bytes) takes the same
    designs with plain copies (the element design one CTA an element),
    and "wide" / "split" where "tc" would run (TMA needs both).
    ``design`` (either type) and ``split`` (bf16's element design; the
    split design's chunks, in either type) may be forced, to probe other
    schedules.
    Raises ValueError, naming the limit, where even one chunk of the split
    design exceeds ``smem_limit`` (the shared memory a block may opt into).
    Cached: the wrapper asks at every call; the dict is shared, not to be
    changed."""
    if min(B, N, D) < 1:
        raise ValueError(f"relation_attend needs B, N, D >= 1, got B={B}, N={N}, D={D}")
    if elem == 4:
        return _f32_plan(B, N, D, vec, smem_limit, design, split)
    if elem != 2:
        raise ValueError(f"relation_attend takes 2-byte (bf16) or 4-byte (float32) elements, "
                         f"got {elem}")

    def can_split(s: int) -> bool:
        return vec and s <= _MAX_SPLIT and D % (16 * s) == 0 and D // s >= _MIN_COLS

    def min_split() -> int:  # the fewest CTAs an element whose columns fit
        s = 1
        while _element_smem(N, D, s) > smem_limit and can_split(2 * s):
            s *= 2
        return s

    if design is None:
        fits = _element_smem(N, D, min_split()) <= smem_limit
        design = "element" if N <= _ELEMENT_N and fits else "tiled"
    if design == "element":
        if N > MAX_N:
            raise ValueError(f"relation_attend: the element design takes N <= {MAX_N}, got {N}")
        if split is None:  # a CTA pair where two fit on an SM, else the fewest that fit
            pair = can_split(2) and _element_smem(N, D, 2) <= min(_PAIR_BYTES, smem_limit)
            split = 2 if pair else min_split()
        elif split != 1 and not can_split(split):
            raise ValueError(f"relation_attend: split={split} needs D % {16 * split} == 0 and "
                             f">= {_MIN_COLS} columns a CTA, got D={D}")
        smem = _element_smem(N, D, split)
        if smem > smem_limit:
            raise ValueError(f"relation_attend: N={N}, D={D} need {smem} bytes of shared memory "
                             f"an element CTA, over the {smem_limit} a block may opt into")
        return {"design": design, "split": split, "stages": 1, "rows": N, "smem_bytes": smem,
                "ctas": B * split, "cluster": split, "threads": 512}
    if design == "tiled" and _tiled_smem(N, 1) > smem_limit:
        tc = _tc_plan(B, N, D, vec, smem_limit, 2)
        if tc is not None:
            return tc
        design = "wide"
    if design == "tc":
        return _forced_tc(B, N, D, vec, smem_limit, 2)
    if design == "wide":
        return _wide_plan(B, N, D, smem_limit)
    if design == "split":
        return _split_plan(B, N, D, smem_limit, 2, split)
    if design != "tiled":
        raise ValueError(f"relation_attend: no design {design!r}")
    return _tiled_plan(B, N, smem_limit)


def _vec(D: int, *tensors) -> bool:
    return D % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def relation_attend_reference(pg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    s = torch.einsum("bnd,bmd->bnm", pg, r) * pg.shape[-1] ** -0.5
    return torch.einsum("bnm,bmd->bnd", torch.softmax(s, dim=-1), r)


def relation_attend_split_model(pg: torch.Tensor, r: torch.Tensor, chunks: int) -> torch.Tensor:
    """The split design's arithmetic in plain PyTorch, to hold the
    split-and-merge against the reference: ``chunks`` chunks of r's rows
    (ceil(N / chunks) each), each chunk's unnormalised weighted sum with its
    max and sum of exp, merged by ``lse_merge``."""
    N = pg.shape[1]
    chunk = _ceil(N, chunks)
    s = torch.einsum("bnd,bmd->bnm", pg, r) * pg.shape[-1] ** -0.5
    parts, ms, ls = [], [], []
    for j0 in range(0, N, chunk):
        sc = s[..., j0:j0 + chunk]
        m = sc.amax(-1)
        p = torch.exp(sc - m.unsqueeze(-1))
        parts.append(torch.einsum("bnm,bmd->bnd", p, r[:, j0:j0 + chunk]))
        ms.append(m)
        ls.append(p.sum(-1))
    return lse_merge(torch.stack(parts, -2), torch.stack(ms, -1), torch.stack(ls, -1))


def tc_scores_model(pg: torch.Tensor, r: torch.Tensor, tile: int) -> tuple:
    """The tc design's first launch in plain PyTorch: the scores
    s = pg r^T / sqrt(D) [B, N, N] and each row's (max, sum of exp) over
    each ``tile`` columns of s, stats [B, N, tiles, 2]."""
    s = torch.einsum("bnd,bmd->bnm", pg, r) * pg.shape[-1] ** -0.5
    tiles = s.split(tile, dim=-1)
    m = torch.stack([sc.amax(-1) for sc in tiles], -1)
    l = torch.stack([torch.exp(sc - mc.unsqueeze(-1)).sum(-1)
                     for sc, mc in zip(tiles, m.unbind(-1))], -1)
    return s, torch.stack([m, l], -1)


def tc_sum_model(s: torch.Tensor, stats: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The tc design's second launch in plain PyTorch: each row's tile
    statistics merged, m = max_c m_c and l = sum_c l_c e^(m_c - m), then
    out = (exp(s - m) / l) r."""
    mc, lc = stats.unbind(-1)
    m = mc.amax(-1, keepdim=True)
    l = (lc * torch.exp(mc - m)).sum(-1, keepdim=True)
    return torch.einsum("bnm,bmd->bnd", torch.exp(s - m) / l, r)


def relation_attend_tc_model(pg: torch.Tensor, r: torch.Tensor, tile: int) -> torch.Tensor:
    """The tc design's arithmetic in plain PyTorch, to hold it against the
    reference: its two launches' models, column tiles of ``tile``."""
    return tc_sum_model(*tc_scores_model(pg, r, tile), r)


def tc_scratch(pg: torch.Tensor, plan: dict) -> tuple:
    """The tc design's scratch for a slice of ``plan["slice"]`` elements on
    ``pg``'s device: s [slice, N, ld] and the tile statistics
    [slice, N, tiles, 2], fp32, flat."""
    N = pg.shape[1]
    return (torch.empty(plan["slice"] * N * plan["ld"], dtype=torch.float32, device=pg.device),
            torch.empty(plan["slice"] * N * plan["tiles"] * 2, dtype=torch.float32,
                        device=pg.device))


def _launch_tc(pg: torch.Tensor, r: torch.Tensor, out: torch.Tensor, plan: dict,
               launches: tuple = (0, 1), scratch: tuple | None = None) -> None:
    """The tc design's ``launches`` (0 the scores, 1 the weighted sum) a
    slice of ``plan["slice"]`` elements at a time, over ``scratch`` (one
    allocated here if None)."""
    B, N, D = pg.shape
    s, stats = tc_scratch(pg, plan) if scratch is None else scratch
    step = N * D * pg.dtype.itemsize
    lib, stream = _build.library(), _build.current_stream(pg.device)
    for b0 in range(0, B, plan["slice"]):
        n = min(plan["slice"], B - b0)
        for which in launches:
            err = lib.vqa_relation_attend_tc(
                pg.data_ptr() + b0 * step, r.data_ptr() + b0 * step, out.data_ptr() + b0 * step,
                s.data_ptr(), stats.data_ptr(), n, N, D, pg.dtype.itemsize, which, stream)
            _build.check(err, "relation_attend")


def launch_relation_attend(pg: torch.Tensor, r: torch.Tensor, out: torch.Tensor,
                           plan: dict) -> None:
    """One launch with ``plan``'s schedule (float32 operands through the
    float32 entry; the split design, in either type, through its own entry,
    with its scratch allocated here; the tc design through its own, a call
    a slice)."""
    B, N, D = pg.shape
    if plan["design"] == "tc":
        _launch_tc(pg, r, out, plan)
        return
    if plan["design"] == "split":
        chunks = plan["chunks"]
        part = torch.empty(B * N * chunks * D, dtype=torch.float32, device=pg.device)
        stats = torch.empty(B * N * chunks * 2, dtype=torch.float32, device=pg.device)
        err = _build.library().vqa_relation_attend_split(
            pg.data_ptr(), r.data_ptr(), out.data_ptr(), part.data_ptr(), stats.data_ptr(),
            B, N, D, chunks, pg.dtype.itemsize, _build.current_stream(pg.device))
        _build.check(err, "relation_attend")
        return
    if pg.dtype == torch.float32:
        err = _build.library().vqa_relation_attend_f32(
            pg.data_ptr(), r.data_ptr(), out.data_ptr(), B, N, D, _DESIGNS[plan["design"]],
            plan["stages"], _build.current_stream(pg.device))
        _build.check(err, "relation_attend")
        return
    err = _build.library().vqa_relation_attend(
        pg.data_ptr(), r.data_ptr(), out.data_ptr(), B, N, D, _DESIGNS[plan["design"]],
        plan["split"], plan["stages"], _build.current_stream(pg.device))
    _build.check(err, "relation_attend")


def launch_geometry(B: int, N: int, D: int, plan: dict, vec: bool, device_index: int,
                    elem: int = 2) -> dict:
    """What csrc/relation.cu launches for ``plan`` at this shape in
    ``elem``-byte elements (its own reckoning): the CTAs, the cluster size,
    the threads and the shared memory of a CTA (the split design's first
    kernel: its merge runs one 256-thread block a row; the tc design's
    scores kernel, and its weighted sum's under "weighted", a slice of
    ``plan["slice"]`` elements)."""
    geometry = (ctypes.c_longlong * len(_GEOMETRY))()
    if plan["design"] == "tc":
        launches = []
        with torch.cuda.device(device_index):
            for launch in (0, 1):
                _build.check(_build.library().vqa_relation_tc_geometry(
                    plan["slice"], N, D, launch, elem, geometry), "relation_attend geometry")
                launches.append(dict(zip(_GEOMETRY, geometry)))
        return {**launches[0], "weighted": launches[1]}
    split = plan["chunks"] if plan["design"] == "split" else plan["split"]
    with torch.cuda.device(device_index):
        _build.check(_build.library().vqa_relation_geometry(
            B, N, D, _DESIGNS[plan["design"]], split, plan["stages"], int(vec), elem,
            geometry), "relation_attend geometry")
    return dict(zip(_GEOMETRY, geometry))


class _RelationAttend(torch.autograd.Function):
    """The registered op ``relation_attend`` (the kernel on the card), and
    the grads of ``relation_attend_reference`` recomputed from the saved
    inputs."""

    @staticmethod
    def forward(ctx, pg, r):
        ctx.save_for_backward(pg, r)
        return _RELATION_ATTEND_OP(pg, r)

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(ctx, relation_attend_reference, (g,))


def relation_attend(pg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and (pg.requires_grad or r.requires_grad):
        return _RelationAttend.apply(pg, r)
    return _RELATION_ATTEND_OP(pg, r)


def _relation_attend_cuda(pg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: check the operands, plan, launch, count."""
    if pg.ndim != 3:
        raise ValueError(f"expected pg and r [B, N, D], got {tuple(pg.shape)}")
    B, N, D = pg.shape
    dev, dt = pg.device, pg.dtype
    _build.require("pg", pg, dev, KERNEL_DTYPES, (B, N, D))
    _build.require("r", r, dev, dt, (B, N, D))
    out = torch.empty(B, N, D, dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    plan = relation_plan(B, N, D, vec=_vec(D, pg, r, out),
                         smem_limit=_build.smem_optin(dev.index or 0), elem=dt.itemsize)
    launch_relation_attend(pg, r, out, plan)
    relation_attend.launches += 1
    relation_attend.design_launches[plan["design"]] += 1
    return out


def _relation_attend_fake(pg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return pg.new_empty(pg.shape)


relation_attend.launches = 0
relation_attend.design_launches = dict.fromkeys([*_DESIGNS, "tc"], 0)  # the launches by design
_RELATION_ATTEND_OP = register("relation_attend(Tensor pg, Tensor r) -> Tensor",
                               relation_attend_reference, _relation_attend_cuda,
                               _relation_attend_fake)
