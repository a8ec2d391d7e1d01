"""The data-parallel mesh and the row-sharded feature table, the port of
``vqa_tpu/parallel/mesh.py``'s ``make_mesh``, ``check_batch_divisible`` and
``shard_feature_table``.

The JAX mesh is a 2-D grid ('data', 'model') whose collectives XLA inserts.
Here the data axis is the process group (one process per card, see
``parallel/distributed.py``) and the collectives are written out: the train
step's one ``all_reduce`` of the grads, the eval loop's gather of its
outputs, and the sharded table's gather. The model axis stays 1: tensor
parallelism (``vqa_tpu/parallel/partition.py``) is ROADMAP.md item 12b.

Not ported, being the TPU's layout only: ``table_format``, ``put_table`` and
``_streamed_put`` (a PyTorch tensor on the card is row-major as created).

The sharded table (``engine.features_sharded``). Each rank holds
``ceil(N / ranks)`` rows (the last rank's padded) and one SINK row after
them, filled with -0.0 (int8 values: 0 with a -0.0 scale). A gather of a
global batch's rows:
  1. the ranks exchange their batches' indices over the host group;
  2. each rank gathers, with the hand-written ``gather_rows`` (or
     ``gather_rows_dequant`` over the int8 pair), every row of the global
     batch from its shard: the rows it owns, and the sink row for the rest;
  3. ``reduce_scatter`` sums the ranks' buffers and hands each rank its
     batch's slice. Exactly one rank contributed each row; the others added
     -0.0, the additive identity of IEEE arithmetic in every dtype (+0.0
     would turn a -0.0 feature into +0.0), so the result is bit-equal to
     the replicated gather's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from vqa_tpu_torch.ops.gather import gather_rows, gather_rows_dequant
from vqa_tpu_torch.parallel import distributed

TP_REFUSAL = ("engine.model_parallel > 1: tensor parallelism is not ported yet "
              "(ROADMAP.md queue 1, item 12b)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: its size (the world), this rank's index on it, the
    process group of its card collectives, the group of its host ones and
    the backend. ``group`` is None in a process that joined no group. The
    model axis is 1 (``make_mesh`` refuses more)."""

    data: int = 1
    index: int = 0
    group: Any = None
    host_group: Any = None
    backend: Optional[str] = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def all_reduce_mean(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` summed over the data ranks, in place, then divided by
        their count (gloo, like NCCL, reduces card tensors)."""
        dist.all_reduce(flat, group=self.group)
        return flat.div_(self.data)

    def all_gather_host(self, array: np.ndarray) -> np.ndarray:
        """Every rank's ``array`` (same shape and dtype on each), stacked in
        rank order: ``[data, *array.shape]``, over the host group."""
        local = torch.from_numpy(np.ascontiguousarray(array)).reshape(-1)
        out = torch.empty(self.data * local.numel(), dtype=local.dtype)
        dist.all_gather_into_tensor(out, local, group=self.host_group)
        return out.numpy().reshape((self.data,) + np.shape(array))

    def reduce_scatter_sum(self, out: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """``out`` = this rank's ``1 / data`` slice of the ranks' ``rows``
        summed."""
        if self.backend == "gloo" and rows.device.type == "cuda":
            # gloo reduces card tensors in all_reduce and broadcast only:
            # its reduce_scatter is staged through host memory
            host = torch.empty(out.shape, dtype=out.dtype)
            dist.reduce_scatter_tensor(host, rows.cpu(), group=self.group)
            return out.copy_(host)
        dist.reduce_scatter_tensor(out, rows, group=self.group)
        return out


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The mesh of this process: every rank of the process group on the data
    axis (one rank, no group, when ``parallel.initialize`` was not called)."""
    if model_parallel > 1:
        raise NotImplementedError(TP_REFUSAL)
    if not dist.is_initialized():
        return Mesh()
    return Mesh(data=dist.get_world_size(), index=dist.get_rank(), group=dist.group.WORLD,
                host_group=distributed.host_group(), backend=dist.get_backend())


def check_batch_divisible(batch_size: int, mesh: Mesh) -> None:
    if batch_size % mesh.data:
        raise ValueError(
            f"batch_size={batch_size} must be divisible by data-parallel size {mesh.data}")


Table = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def shard_rows(table: torch.Tensor, mesh: Mesh, sink=-0.0) -> torch.Tensor:
    """This rank's ``ceil(N / mesh.data)`` rows of ``table``, padded with
    ``sink`` rows to that count, then one ``sink`` row more (the sink the
    sharded gather reads for the rows other ranks own)."""
    n = table.shape[0]
    per = -(-n // mesh.data)
    lo = min(n, mesh.index * per)
    hi = min(n, lo + per)
    pad = torch.full((per + 1 - (hi - lo),) + tuple(table.shape[1:]), sink, dtype=table.dtype,
                     device=table.device)
    return torch.cat([table[lo:hi], pad])


class ShardedTable:
    """A feature table row-sharded over the mesh's data ranks: ``local`` is
    this rank's shard (``shard_rows``), a tensor or the int8 ``(values,
    scales)`` pair sharded by the same rows; ``n_rows`` the table's rows.
    ``gather(idx)`` returns the rows of the global table at this rank's
    batch's host indices, as the step's gather of a replicated table does;
    every rank of the mesh must call it at once, with batches of one size."""

    def __init__(self, local: Table, n_rows: int, mesh: Mesh):
        self.local = local
        self.n_rows = n_rows
        self.mesh = mesh
        self.rows_per_rank = -(-n_rows // mesh.data)

    @property
    def int8(self) -> bool:
        return isinstance(self.local, tuple)

    @property
    def nbytes(self) -> int:
        parts = self.local if self.int8 else (self.local,)
        return sum(t.nbytes for t in parts)

    def gather(self, idx) -> torch.Tensor:
        idx = np.asarray(idx)
        if idx.ndim != 1 or idx.dtype.kind not in "iu":
            raise TypeError(f"indices must be a 1-D integer array, got {idx.dtype} {idx.shape}")
        mesh = self.mesh
        every = (mesh.all_gather_host(idx.astype(np.int64)).reshape(-1) if mesh.distributed
                 else idx.astype(np.int64))
        # checked after the exchange, so every rank raises together
        if every.size and (every.min() < 0 or every.max() >= self.n_rows):
            raise IndexError(f"row index out of range [0, {self.n_rows}): "
                             f"min {every.min()}, max {every.max()}")
        first = mesh.index * self.rows_per_rank
        owned = (every >= first) & (every < first + self.rows_per_rank)
        local = np.where(owned, every - first, self.rows_per_rank).astype(np.int32)
        rows = (gather_rows_dequant(*self.local, local) if self.int8
                else gather_rows(self.local, local))
        if not mesh.distributed:
            return rows
        out = torch.empty((idx.shape[0],) + tuple(rows.shape[1:]), dtype=rows.dtype,
                          device=rows.device)
        return mesh.reduce_scatter_sum(out, rows)


def shard_feature_table(table: Table, mesh: Mesh, device=None) -> ShardedTable:
    """Row-shard a feature table over the mesh's data ranks
    (``engine.features_sharded``, for tables bigger than one card's memory):
    this rank keeps its rows (``shard_rows``), moved to ``device``. ``table``
    is a tensor or the int8 ``(values, scales)`` pair, sharded by the same
    rows (values' sink 0, scales' -0.0: a dequantized sink row is -0.0)."""
    def place(t):
        return t if device is None else t.to(device)

    if isinstance(table, (tuple, list)):
        values, scales = table
        local: Table = (place(shard_rows(values, mesh, sink=0)), place(shard_rows(scales, mesh)))
        return ShardedTable(local, values.shape[0], mesh)
    return ShardedTable(place(shard_rows(table, mesh)), table.shape[0], mesh)


def local_rows(n: int, mesh: Mesh) -> Tuple[int, int]:
    """The rows ``[start, stop)`` of a global batch of ``n`` that this rank
    runs (replica-fed evaluation and the sharded step's own slice)."""
    check_batch_divisible(n, mesh)
    per = n // mesh.data
    return mesh.index * per, (mesh.index + 1) * per
