"""CoR relation core, the port of ``vqa_tpu/ops/relation.py`` (forward).

relation_attend(pg [B, N, D], r [B, N, D]) -> absorbed [B, N, D]

    s_ij  = <pg_i, r_j> / sqrt(D)
    alpha = softmax_j(s)
    out_i = sum_j alpha_ij r_j

On CUDA tensors this launches the hand-written kernel in
``csrc/relation.cu`` (bf16, one block per batch element, N <= 64, fp32
math, alpha not rounded before the second product); on CPU tensors it
takes the plain version.
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops import _build

_SMEM_LIMIT = 232_448  # the most dynamic shared memory a Hopper block can opt into
MAX_N = 64             # the kernel pads N to at most eight 8-column tiles


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _smem_bytes(N: int, D: int) -> int:
    """csrc/relation.cu's smem_bytes: r with rows padded by 8, s, alpha^T."""
    return _round_up(N * (D + 8) * 2, 16) + (_round_up(N * N, 4) + N * _round_up(N, 6)) * 4


def relation_attend_reference(pg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    s = torch.einsum("bnd,bmd->bnm", pg, r) * pg.shape[-1] ** -0.5
    return torch.einsum("bnm,bmd->bnd", torch.softmax(s, dim=-1), r)


def relation_attend(pg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    if pg.device.type == "cpu":
        return relation_attend_reference(pg, r)
    if pg.ndim != 3:
        raise ValueError(f"expected pg and r [B, N, D], got {tuple(pg.shape)}")
    B, N, D = pg.shape
    if N > MAX_N:
        raise ValueError(f"the kernel takes N <= {MAX_N} objects, got {N}")
    if _smem_bytes(N, D) > _SMEM_LIMIT:
        raise ValueError(f"N={N}, D={D} exceed the kernel's shared memory")
    dev, dt = pg.device, torch.bfloat16
    _build.require("pg", pg, dev, dt, (B, N, D))
    _build.require("r", r, dev, dt, (B, N, D))
    out = torch.empty(B, N, D, dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    err = _build.library().vqa_relation_attend(
        pg.data_ptr(), r.data_ptr(), out.data_ptr(), B, N, D,
        _build.current_stream(dev),
    )
    _build.check(err, "relation_attend")
    relation_attend.launches += 1
    return out


relation_attend.launches = 0
