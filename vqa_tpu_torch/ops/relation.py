"""CoR relation core, the port of ``vqa_tpu/ops/relation.py`` (forward).

relation_attend(pg [B, N, D], r [B, N, D]) -> absorbed [B, N, D]

    s_ij  = <pg_i, r_j> / sqrt(D)
    alpha = softmax_j(s)
    out_i = sum_j alpha_ij r_j

On CUDA tensors this launches a hand-written kernel in
``csrc/relation.cu`` (bf16, fp32 math, alpha not rounded before the second
product): one block per batch element for N <= 64 where r fits in shared
memory, else the tiled entry (one block per element and 16 rows of i, N
bounded only by shared memory: 32 D + 64 N bytes). On CPU tensors it takes
the plain version.
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops import _build

MAX_N = 64          # the one-block-an-element kernel pads N to at most eight 8-column tiles
_TILE_ROWS = 16     # rows of i a block of the tiled entry owns


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _smem_bytes(N: int, D: int) -> int:
    """csrc/relation.cu's smem_bytes: r with rows padded by 8, s, alpha^T."""
    return _round_up(N * (D + 8) * 2, 16) + (_round_up(N * N, 4) + N * _round_up(N, 6)) * 4


def _tiled_smem_bytes(N: int, D: int) -> int:
    """csrc/relation.cu's tiled_smem_bytes: a tile's pg rows, s^T [N, 16]."""
    return _round_up(_TILE_ROWS * D * 2, 16) + N * _TILE_ROWS * 4


def relation_entry(N: int, D: int, smem_limit: int) -> str:
    """Which entry of csrc/relation.cu runs at N objects of D features:
    "element" (one block a batch element, N <= 64) where r fits, else
    "tiled"; ValueError, naming the limit, past the shared memory a block
    may opt into."""
    if N <= MAX_N and _smem_bytes(N, D) <= smem_limit:
        return "element"
    if _tiled_smem_bytes(N, D) <= smem_limit:
        return "tiled"
    raise ValueError(f"relation_attend: N={N}, D={D} need {_tiled_smem_bytes(N, D)} bytes of "
                     f"shared memory (16 rows of pg and 16 x N scores), over the {smem_limit} a "
                     f"block may opt into")


def relation_attend_reference(pg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    s = torch.einsum("bnd,bmd->bnm", pg, r) * pg.shape[-1] ** -0.5
    return torch.einsum("bnm,bmd->bnd", torch.softmax(s, dim=-1), r)


def relation_attend(pg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    if pg.device.type == "cpu":
        return relation_attend_reference(pg, r)
    if pg.ndim != 3:
        raise ValueError(f"expected pg and r [B, N, D], got {tuple(pg.shape)}")
    B, N, D = pg.shape
    dev, dt = pg.device, torch.bfloat16
    _build.require("pg", pg, dev, dt, (B, N, D))
    _build.require("r", r, dev, dt, (B, N, D))
    out = torch.empty(B, N, D, dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    entry = relation_entry(N, D, _build.smem_optin(dev.index or 0))
    launch = (_build.library().vqa_relation_attend if entry == "element"
              else _build.library().vqa_relation_attend_tiled)
    err = launch(pg.data_ptr(), r.data_ptr(), out.data_ptr(), B, N, D, _build.current_stream(dev))
    _build.check(err, "relation_attend")
    relation_attend.launches += 1  # either entry
    return out


relation_attend.launches = 0
