"""Feature-table row gather, the port of ``vqa_tpu/ops/gather.py``.

gather_rows(table [N, ...], idx [B]) -> out [B, ...], out[b] = table[idx[b]]

On a CUDA table this launches the hand-written kernel in
``csrc/gather.cu``; on a CPU table it takes the plain version. The indices
stay on the host until they are checked to lie in ``[0, N)`` (an
out-of-range row would read outside the table on the card), then are
uploaded.
"""

from __future__ import annotations

import numpy as np
import torch

from vqa_tpu_torch.ops import _build


def gather_rows_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, idx)


def _host_indices(idx, n_rows: int) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        if idx.device.type != "cpu":
            raise ValueError(
                "gather_rows takes its indices on the host, so their range is "
                "checked before they are uploaded"
            )
        idx = idx.numpy()
    idx = np.asarray(idx)
    if idx.ndim != 1 or idx.dtype.kind not in "iu":
        raise TypeError(f"indices must be a 1-D integer array, got {idx.dtype} {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= n_rows):
        raise IndexError(
            f"row index out of range [0, {n_rows}): min {idx.min()}, max {idx.max()}"
        )
    return torch.from_numpy(idx.astype(np.int64))


def gather_rows(table: torch.Tensor, idx) -> torch.Tensor:
    """Rows of ``table`` at host indices ``idx`` (numpy or a CPU tensor)."""
    if table.ndim < 1:
        raise ValueError("table must have a row axis")
    idx = _host_indices(idx, table.shape[0])
    if table.device.type == "cpu":
        return gather_rows_reference(table, idx)
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    out = torch.empty((idx.shape[0],) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    idx_dev = idx.to(table.device)
    row_bytes = table[0].numel() * table.element_size()
    err = _build.library().vqa_gather_rows(
        table.data_ptr(), idx_dev.data_ptr(), out.data_ptr(), idx.shape[0], row_bytes,
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    _build.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
