"""Feature-table row gather, the port of ``vqa_tpu/ops/gather.py``.

gather_rows(table [N, ...], idx [B]) -> out [B, ...], out[b] = table[idx[b]]
gather_rows_dequant(values int8 [N, ..., D], scales [N, ..., 1], idx [B])
    -> out [B, ..., D] = values[idx].to(scales.dtype) * scales[idx]

The second is the int8 feature table's path (``engine.features_dtype=int8``
in the JAX package, ``vqa_tpu/engine/steps.py:69-73``): the JAX step runs the
gather kernel on the int8 rows and dequantizes after it; here one kernel
does both, so only int8 bytes are read.

On CUDA tensors these launch the hand-written kernels in ``csrc/gather.cu``;
on CPU tensors they take the plain versions. The indices stay on the host:
they are checked to lie in ``[0, N)`` there (an out-of-range row would read
outside the table on the card), then ride to the card inside the kernel's
launch parameters, up to ``ROWS_PER_LAUNCH`` of them per launch, so no
upload is issued.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vqa_tpu_torch.ops import _build

# rows per launch: csrc/gather.cu's kMaxRows (8 KB of int32 indices in the
# kernel's parameters); the kernel refuses more
ROWS_PER_LAUNCH = 2048
_INT32_MAX = 2**31 - 1


def gather_rows_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, idx)


def gather_rows_dequant_reference(values: torch.Tensor, scales: torch.Tensor,
                                  idx: torch.Tensor) -> torch.Tensor:
    return values.index_select(0, idx).to(scales.dtype) * scales.index_select(0, idx)


def _host_indices(idx, n_rows: int) -> np.ndarray:
    """``idx`` as contiguous int32 numpy, as the kernels take it, checked to
    be 1-D, integer and in ``[0, n_rows)``."""
    if isinstance(idx, torch.Tensor):
        if idx.device.type != "cpu":
            raise ValueError(
                "gather_rows takes its indices on the host, so their range is "
                "checked before they reach the card"
            )
        idx = idx.numpy()
    idx = np.asarray(idx)
    if idx.ndim != 1 or idx.dtype.kind not in "iu":
        raise TypeError(f"indices must be a 1-D integer array, got {idx.dtype} {idx.shape}")
    if n_rows > _INT32_MAX:
        raise ValueError(f"the kernels index at most 2**31 - 1 rows, the table has {n_rows}")
    # one pass for both bounds: read as unsigned, a negative index is a huge one
    unsigned = idx.view(f"u{idx.dtype.itemsize}") if idx.dtype.kind == "i" else idx
    if idx.size and unsigned.max() >= n_rows:
        raise IndexError(
            f"row index out of range [0, {n_rows}): min {idx.min()}, max {idx.max()}"
        )
    return np.ascontiguousarray(idx, dtype=np.int32)


def gather_rows(table: torch.Tensor, idx) -> torch.Tensor:
    """Rows of ``table`` at host indices ``idx`` (numpy or a CPU tensor)."""
    if table.ndim < 1:
        raise ValueError("table must have a row axis")
    idx = _host_indices(idx, table.shape[0])
    if table.device.type == "cpu":
        return gather_rows_reference(table, torch.from_numpy(idx))
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    out = torch.empty((idx.shape[0],) + table.shape[1:], dtype=table.dtype, device=table.device)
    if out.numel():
        launch_gather_rows(table, idx, out)
    return out


def launch_gather_rows(table: torch.Tensor, idx: np.ndarray, out: torch.Tensor) -> None:
    """The kernel launches alone: ``out[b] = table[idx[b]]`` for host int32
    indices already checked (``gather_rows`` checks them)."""
    row_bytes = math.prod(table.shape[1:]) * table.element_size()
    lib, stream = _build.library(), _build.current_stream(table.device)
    for start in range(0, idx.shape[0], ROWS_PER_LAUNCH):
        n = min(ROWS_PER_LAUNCH, idx.shape[0] - start)
        err = lib.vqa_gather_rows(table.data_ptr(), idx[start:].ctypes.data,
                                  out.data_ptr() + start * row_bytes, n, row_bytes, stream)
        _build.check(err, "gather_rows")
        gather_rows.launches += 1


gather_rows.launches = 0


def _check_dequant_table(values: torch.Tensor, scales: torch.Tensor) -> None:
    if values.ndim < 2 or values.dtype != torch.int8:
        raise TypeError(f"values must be an int8 table [N, ..., D], got {values.dtype} "
                        f"{tuple(values.shape)}")
    if scales.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"scales must be bfloat16 or float32, got {scales.dtype}")
    if tuple(scales.shape) != tuple(values.shape[:-1]) + (1,):
        raise ValueError(f"scales have shape {tuple(scales.shape)}, expected "
                         f"{tuple(values.shape[:-1]) + (1,)} (one per row segment)")
    if scales.device != values.device:
        raise ValueError(f"scales are on {scales.device}, values on {values.device}")


def gather_rows_dequant(values: torch.Tensor, scales: torch.Tensor, idx) -> torch.Tensor:
    """Rows of the int8 table ``values`` at host indices ``idx``, times their
    per-segment ``scales``, in the scales' dtype."""
    _check_dequant_table(values, scales)
    idx = _host_indices(idx, values.shape[0])
    if values.device.type == "cpu":
        return gather_rows_dequant_reference(values, scales, torch.from_numpy(idx))
    if not (values.is_contiguous() and scales.is_contiguous()):
        raise ValueError("values and scales must be contiguous")
    out = torch.empty((idx.shape[0],) + values.shape[1:], dtype=scales.dtype,
                      device=values.device)
    if out.numel():
        launch_gather_rows_dequant(values, scales, idx, out)
    return out


def launch_gather_rows_dequant(values: torch.Tensor, scales: torch.Tensor, idx: np.ndarray,
                               out: torch.Tensor) -> None:
    """The kernel launches alone, for host int32 indices already checked
    (``gather_rows_dequant`` checks them and the table)."""
    segs, d = scales.numel() // values.shape[0], values.shape[-1]
    out_row_bytes = segs * d * out.element_size()
    lib, stream = _build.library(), _build.current_stream(values.device)
    for start in range(0, idx.shape[0], ROWS_PER_LAUNCH):
        n = min(ROWS_PER_LAUNCH, idx.shape[0] - start)
        err = lib.vqa_gather_rows_dequant(
            values.data_ptr(), scales.data_ptr(), idx[start:].ctypes.data,
            out.data_ptr() + start * out_row_bytes, n, segs, d,
            int(scales.dtype == torch.bfloat16), stream)
        _build.check(err, "gather_rows_dequant")
        gather_rows_dequant.launches += 1


gather_rows_dequant.launches = 0
