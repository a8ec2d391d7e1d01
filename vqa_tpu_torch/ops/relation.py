"""CoR relation core, the port of ``vqa_tpu/ops/relation.py``.

relation_attend(pg [B, N, D], r [B, N, D]) -> absorbed [B, N, D]

    s_ij  = <pg_i, r_j> / sqrt(D)
    alpha = softmax_j(s)
    out_i = sum_j alpha_ij r_j

The forward is the registered op ``torch.ops.vqa_tpu_torch.relation_attend``:
on CUDA tensors it launches the hand-written kernel in
``csrc/relation.cu`` (bf16 in and out; fp32 scores and softmax; alpha kept
to ~2^-16 through the second product as two bf16 halves) with the schedule
``relation_plan`` gives; on CPU tensors it takes the plain version.

Where an input asks for grads, the call is a ``torch.autograd.Function``:
the same forward, and a backward by autograd through
``relation_attend_reference`` on the saved ``(pg, r)`` (a recompute), as
``vqa_tpu/ops/relation.py::_bwd`` takes the vjp of its jnp reference.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vqa_tpu_torch.ops import _build, recompute_grads, register

SMEM_LIMIT = 232_448    # shared memory a Hopper block may opt into
MAX_N = 64              # the element design: s at most 4 x 16 rows, 8 x 8 columns
_ELEMENT_N = 48         # its N by default: at N=64 the tiled design measured faster
# csrc/relation.cu's constants, and the plan's targets
_MAX_SPLIT = 8          # the portable cluster size
_MIN_COLS = 64          # columns a split CTA keeps
_PAIR_BYTES = 115_712   # two CTAs of this (and 1 KB reserved each) fill an SM's 228 KB
_TILE_ROWS = 64         # rows of i a CTA of the tiled design owns
_CHUNK = 64             # columns of a tiled stage: one 128-byte swizzled row
_BOX_ROWS = 256         # rows one TMA box may hold
_MAX_STAGES = 4
_WIDE_ROWS = 16         # rows of i a block of the wide design owns
_DESIGNS = {"element": 0, "tiled": 1, "wide": 2}  # csrc/relation.cu's kDesign*
_GEOMETRY = ("ctas", "cluster", "threads", "smem_bytes")


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


def _tiled_smem(N: int, stages: int) -> int:
    """csrc/relation.cu's tiled_smem: 1 KB to align the ring; the ring (each
    stage one 64 x 64 box of pg and N rows of r in boxes of up to 256 rows,
    128-byte swizzled); s / alpha [64, 4 Np + 32 bytes]; the barriers."""
    nbox = _ceil(N, _BOX_ROWS)
    stage = _TILE_ROWS * _CHUNK * 2 + nbox * _round_up(_ceil(N, nbox), 8) * _CHUNK * 2
    return 1024 + stages * stage + _TILE_ROWS * (4 * _round_up(N, 16) + 32) + 16 * stages


def _wide_smem(N: int, D: int) -> int:
    """csrc/relation.cu's wide_smem: 16 rows of pg, s^T [N, 16] (fp32)."""
    return _round_up(_WIDE_ROWS * D * 2, 16) + N * _WIDE_ROWS * 4


@functools.lru_cache(maxsize=1024)
def relation_plan(B: int, N: int, D: int, vec: bool = True, smem_limit: int = SMEM_LIMIT,
                  design: str | None = None, split: int | None = None) -> dict:
    """The schedule ``csrc/relation.cu`` runs for B elements of N objects and
    D features:

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
      stages of 64 columns (pg's tile and all of r for the scores, then r
      again for the weighted sum), s [64, N] kept in shared memory;
    - "wide" (the tiled design's s and one stage over ``smem_limit``: N
      past ~570 at D=1024): the parent's N > 64 kernel, one block an
      element and 16 rows, the scores on the CUDA cores (slow; for shapes
      nothing else takes).

    ``vec=False`` (D % 8 != 0, or a pointer off 16 bytes) takes the same
    designs with plain copies (the element design one CTA an element).
    ``design`` and ``split`` may be forced, to probe other schedules.
    Raises ValueError, naming the limit, where even the wide design exceeds
    ``smem_limit`` (the shared memory a block may opt into). Cached: the
    wrapper asks at every call; the dict is shared, not to be changed."""
    if min(B, N, D) < 1:
        raise ValueError(f"relation_attend needs B, N, D >= 1, got B={B}, N={N}, D={D}")

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
        design = "wide"
    if design == "wide":
        smem = _wide_smem(N, D)
        if smem > smem_limit:
            raise ValueError(f"relation_attend: N={N}, D={D} need {smem} bytes of shared "
                             f"memory (16 rows of pg and 16 x N scores), over the {smem_limit} "
                             f"a block may opt into")
        return {"design": design, "split": 1, "stages": 1, "rows": _WIDE_ROWS,
                "smem_bytes": smem, "ctas": B * _ceil(N, _WIDE_ROWS), "cluster": 1,
                "threads": 256}
    if design != "tiled":
        raise ValueError(f"relation_attend: no design {design!r}")
    stages = _MAX_STAGES
    while _tiled_smem(N, stages) > smem_limit:
        stages -= 1
    return {"design": design, "split": 1, "stages": stages, "rows": _TILE_ROWS,
            "smem_bytes": _tiled_smem(N, stages), "ctas": B * _ceil(N, _TILE_ROWS),
            "cluster": 1, "threads": 544}


def _vec(D: int, *tensors) -> bool:
    return D % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def relation_attend_reference(pg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    s = torch.einsum("bnd,bmd->bnm", pg, r) * pg.shape[-1] ** -0.5
    return torch.einsum("bnm,bmd->bnd", torch.softmax(s, dim=-1), r)


def launch_relation_attend(pg: torch.Tensor, r: torch.Tensor, out: torch.Tensor,
                           plan: dict) -> None:
    """One launch with ``plan``'s schedule."""
    B, N, D = pg.shape
    err = _build.library().vqa_relation_attend(
        pg.data_ptr(), r.data_ptr(), out.data_ptr(), B, N, D, _DESIGNS[plan["design"]],
        plan["split"], plan["stages"], _build.current_stream(pg.device))
    _build.check(err, "relation_attend")


def launch_geometry(B: int, N: int, D: int, plan: dict, vec: bool, device_index: int) -> dict:
    """What csrc/relation.cu launches for ``plan`` at this shape (its own
    reckoning): the CTAs, the cluster size, the threads and the shared
    memory of a CTA."""
    geometry = (ctypes.c_longlong * len(_GEOMETRY))()
    with torch.cuda.device(device_index):
        _build.check(_build.library().vqa_relation_geometry(
            B, N, D, _DESIGNS[plan["design"]], plan["split"], plan["stages"], int(vec), geometry),
            "relation_attend geometry")
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
    dev, dt = pg.device, torch.bfloat16
    _build.require("pg", pg, dev, dt, (B, N, D))
    _build.require("r", r, dev, dt, (B, N, D))
    out = torch.empty(B, N, D, dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    plan = relation_plan(B, N, D, vec=_vec(D, pg, r, out),
                         smem_limit=_build.smem_optin(dev.index or 0))
    launch_relation_attend(pg, r, out, plan)
    relation_attend.launches += 1
    return out


def _relation_attend_fake(pg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return pg.new_empty(pg.shape)


relation_attend.launches = 0
_RELATION_ATTEND_OP = register("relation_attend(Tensor pg, Tensor r) -> Tensor",
                               relation_attend_reference, _relation_attend_cuda,
                               _relation_attend_fake)
