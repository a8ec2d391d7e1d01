"""The 2-D process mesh and the row-sharded feature table, the port of
``vqa_tpu/parallel/mesh.py``'s ``make_mesh``, ``check_batch_divisible`` and
``shard_feature_table``.

The JAX mesh is a grid ('data', 'model') of devices whose collectives XLA
inserts. Here it is a grid of processes (one a card, see
``parallel/distributed.py``), laid out as the JAX grid
``devices.reshape(n // model, model)``: global rank ``r`` sits at data index
``r // model`` and model index ``r % model``. A rank's COLUMN (the ranks of
its model index, one a data index) averages the grads of the data shards in
the train step's one ``all_reduce``; its ROW (the ranks of its data index,
which see the same batch shard) shares a leaf's optimizer state, each rank
holding its slice and all-gathering the updated parameter
(``parallel/partition.py``); the whole world row-shards the feature table
(the JAX ``P(('data', 'model'))``). The collectives are written out.

Not ported, being the TPU's layout only: ``table_format``, ``put_table`` and
``_streamed_put`` (a PyTorch tensor on the card is row-major as created).

The sharded table (``engine.features_sharded``). Each rank of the world
holds ``ceil(N / ranks)`` rows (the last rank's padded) and one SINK row
after them, filled with -0.0 (int8 values: 0 with a -0.0 scale). A gather of
a global batch's rows:
  1. the ranks exchange their batches' indices over the host group (the
     ranks of one row send the same batch shard);
  2. each rank gathers, with the hand-written ``gather_rows`` (or
     ``gather_rows_dequant`` over the int8 pair), every row of every rank's
     batch from its shard: the rows it owns, and the sink row for the rest;
  3. ``reduce_scatter`` over the world sums the ranks' buffers and hands
     each rank its batch's slice. Exactly one rank contributed each row; the
     others added -0.0, the additive identity of IEEE arithmetic in every
     dtype (+0.0 would turn a -0.0 feature into +0.0), so the result is
     bit-equal to the replicated gather's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from vqa_tpu_torch.ops.gather import gather_rows, gather_rows_dequant
from vqa_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the 2-D mesh: the sizes of the data and model
    axes and its index on each; the process groups of the world (``group``
    for card tensors, ``host_group`` for host ones), of its column
    (``data_group``: the ranks of its model index) and of its row
    (``model_group``: the ranks of its data index); and the backend. The
    groups are None in a process that joined no group, and an axis' group
    is None where that axis is one rank of a larger world: its collectives
    then raise rather than run over the world (``group=None`` is the
    world in ``torch.distributed``)."""

    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    group: Any = None
    host_group: Any = None
    data_group: Any = None
    model_group: Any = None
    backend: Optional[str] = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def size(self) -> int:
        """The world's size: every rank of the mesh."""
        return self.data * self.model

    @property
    def rank(self) -> int:
        """This rank's global rank."""
        return self.data_index * self.model + self.model_index

    def _staged(self, t: torch.Tensor) -> bool:
        # gloo reduces card tensors in all_reduce and broadcast only: its
        # other collectives are staged through host memory
        return self.backend == "gloo" and t.device.type == "cuda"

    def _axis_group(self, name: str):
        group = getattr(self, f"{name}_group")
        if group is None:
            raise RuntimeError(f"mesh {self.data} x {self.model}: no {name} group to run a "
                               f"collective over")
        return group

    def all_reduce_mean(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` summed over this rank's column (the data axis), in place,
        then divided by its size (gloo, like NCCL, reduces card tensors)."""
        dist.all_reduce(flat, group=self._axis_group("data"))
        return flat.div_(self.data)

    def all_reduce_model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over this rank's row (the model axis), in place."""
        dist.all_reduce(t, group=self._axis_group("model"))
        return t

    def all_gather_model(self, flat: torch.Tensor) -> torch.Tensor:
        """The row's ``flat`` tensors (one size on each rank), concatenated in
        model-index order: ``[model * flat.numel()]`` on ``flat``'s device."""
        group = self._axis_group("model")
        if self._staged(flat):
            host = torch.empty(self.model * flat.numel(), dtype=flat.dtype)
            dist.all_gather_into_tensor(host, flat.cpu(), group=group)
            return host.to(flat.device)
        out = torch.empty(self.model * flat.numel(), dtype=flat.dtype, device=flat.device)
        dist.all_gather_into_tensor(out, flat, group=group)
        return out

    def all_gather_host(self, array: np.ndarray) -> np.ndarray:
        """Every rank's ``array`` (same shape and dtype on each), stacked in
        global-rank order: ``[size, *array.shape]``, over the host group."""
        local = torch.from_numpy(np.ascontiguousarray(array)).reshape(-1)
        out = torch.empty(self.size * local.numel(), dtype=local.dtype)
        dist.all_gather_into_tensor(out, local, group=self.host_group)
        return out.numpy().reshape((self.size,) + np.shape(array))

    def reduce_scatter_sum(self, out: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """``out`` = this rank's ``1 / size`` slice of the world's ``rows``
        summed."""
        if self._staged(rows):
            host = torch.empty(out.shape, dtype=out.dtype)
            dist.reduce_scatter_tensor(host, rows.cpu(), group=self.group)
            return out.copy_(host)
        dist.reduce_scatter_tensor(out, rows, group=self.group)
        return out


def _own_group(grid: np.ndarray, rank: int, backend: str):
    """One process group for each row of ``grid`` (global ranks), made in
    order on every rank, as ``dist.new_group`` requires; returns the group
    of the row that holds ``rank``. A row that is the whole world (a world
    of one included) is the default group; rows of one rank in a larger
    world get none (no collective runs over them)."""
    if grid.shape[1] == dist.get_world_size():
        return dist.group.WORLD
    if grid.shape[1] == 1:
        return None
    own = None
    for ranks in grid.tolist():
        group = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            own = group
    return own


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The mesh of this process: the world laid out ``[world / model_parallel,
    model_parallel]`` (one rank, no group, when ``parallel.initialize`` was
    not called). Every rank calls it at once, as it makes the column and
    row groups. A world that ``model_parallel`` does not divide raises
    ``ValueError``, as ``vqa_tpu/parallel/mesh.py:30-31`` does."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} process(es) not divisible by model_parallel={model_parallel}")
    if not dist.is_initialized():
        return Mesh()
    rank, backend = dist.get_rank(), dist.get_backend()
    grid = np.arange(world).reshape(world // model_parallel, model_parallel)
    return Mesh(data=grid.shape[0], model=model_parallel, data_index=rank // model_parallel,
                model_index=rank % model_parallel, group=dist.group.WORLD,
                host_group=distributed.host_group(),
                data_group=_own_group(grid.T, rank, backend),
                model_group=_own_group(grid, rank, backend), backend=backend)


def check_batch_divisible(batch_size: int, mesh: Mesh) -> None:
    if batch_size % mesh.data:
        raise ValueError(
            f"batch_size={batch_size} must be divisible by data-parallel size {mesh.data}")


Table = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def shard_rows(table: torch.Tensor, mesh: Mesh, sink=-0.0) -> torch.Tensor:
    """This rank's ``ceil(N / mesh.size)`` rows of ``table`` (by global
    rank), padded with ``sink`` rows to that count, then one ``sink`` row
    more (the sink the sharded gather reads for the rows other ranks own)."""
    n = table.shape[0]
    per = -(-n // mesh.size)
    lo = min(n, mesh.rank * per)
    hi = min(n, lo + per)
    pad = torch.full((per + 1 - (hi - lo),) + tuple(table.shape[1:]), sink, dtype=table.dtype,
                     device=table.device)
    return torch.cat([table[lo:hi], pad])


class ShardedTable:
    """A feature table row-sharded over every rank of the mesh: ``local`` is
    this rank's shard (``shard_rows``), a tensor or the int8 ``(values,
    scales)`` pair sharded by the same rows; ``n_rows`` the table's rows.
    ``gather(idx)`` returns the rows of the global table at this rank's
    batch's host indices, as the step's gather of a replicated table does;
    every rank of the mesh must call it at once, with batches of one size."""

    def __init__(self, local: Table, n_rows: int, mesh: Mesh):
        self.local = local
        self.n_rows = n_rows
        self.mesh = mesh
        self.rows_per_rank = -(-n_rows // mesh.size)

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
        first = mesh.rank * self.rows_per_rank
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
    """Row-shard a feature table over every rank of the mesh, as the JAX
    package's ``P(('data', 'model'))`` does (``engine.features_sharded``, for tables bigger than one card's memory):
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
    runs (replica-fed evaluation and the step's own slice): its data index's
    share, the same in every rank of its row."""
    check_batch_divisible(n, mesh)
    per = n // mesh.data
    return mesh.data_index * per, (mesh.data_index + 1) * per
