"""Multi-process runtime entry, the port of ``vqa_tpu/parallel/distributed.py``.

One process per card, PyTorch's idiom: ``torchrun --nproc_per_node N -m
vqa_tpu_torch.cli.train --distributed ...`` (or the JAX CLI's flags,
``--coordinator_address host:port --num_processes N --process_id i``, one
command per process). What runs across processes:

  * ``initialize()`` below: ``torch.distributed.init_process_group`` over
    NCCL when the process runs on the card, gloo on the host
    (``--platform cpu``), and each rank's card;
  * per-process INPUT sharding for training: each process feeds only its
    ``BatchIterator(shard_index=rank, shard_count=world, shard_even=True)``
    slice at ``batch_size / world`` a process, and the train step averages
    the grads (and the metrics) over the ranks in one ``all_reduce``
    (``engine/steps.py``);
  * replica-fed evaluation: every process iterates the FULL eval split and
    runs its slice of each global batch; the eval loop gathers the packed
    outputs once, after the epoch's dispatch, so every process holds the
    same metrics and results (``engine/engine.py``);
  * the row-sharded feature table (``engine.features_sharded``,
    ``parallel/mesh.py``).

Host-side data (the gather's indices, the eval loop's packed outputs) moves
over a gloo group: NCCL moves only card tensors. Under gloo that group is the
default one; under NCCL ``initialize`` makes a gloo side group. No collective
runs in the loader's producer thread (its transform only copies).

Process-0-only duties in the CLI: ``options.yaml``, the JSONL logs, the
results and the checkpoints, each save followed by a barrier so every rank
may read what was written.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

# the gloo group that carries host tensors; None before initialize() and
# under gloo, where the default group does
_HOST_GROUP = None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> torch.device:
    """Join the process group and return this rank's device.

    With no address the cluster comes from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``). An
    address is ``host:port`` (``tcp://`` is prepended, as the JAX flags
    read) or a URL with its own scheme (``file:///path`` for a shared-file
    store), with ``num_processes`` and ``process_id`` beside it.

    ``device`` says where the process runs: the card (``"cuda"``: rank r
    takes ``cuda:<LOCAL_RANK>``, else ``cuda:<r % device_count>``; ``"cuda:i"``
    card i) or the host (``"cpu"``). The card is made current before the
    process group exists, so nothing of this process touches another card.
    The backend is NCCL on the card and gloo on the host;
    ``backend="gloo"`` on the card puts several ranks on one card (each
    passing the same ``"cuda:i"``), which NCCL refuses. A card without NCCL
    fails here, with no other route."""
    global _HOST_GROUP
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in this process")
    device = torch.device(device)
    on_card = device.type == "cuda"
    backend = backend or ("nccl" if on_card else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl (the card) or gloo")
    if backend == "nccl" and not (on_card and dist.is_nccl_available()):
        raise RuntimeError(
            "--distributed on the card runs over NCCL, and this torch build has no NCCL"
            if on_card else "NCCL moves card tensors only: run the host over gloo")
    if coordinator_address is None:
        init_method, kwargs = "env://", {}
        rank, local = int(os.environ.get("RANK", "0")), os.environ.get("LOCAL_RANK")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs num_processes and "
                             "process_id beside it")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        kwargs = dict(world_size=num_processes, rank=process_id)
        rank, local = process_id, None
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: torch.cuda.is_available() is false")
        if device.index is None:
            index = int(local) if local is not None else rank % torch.cuda.device_count()
            device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    # NCCL cannot move host tensors: the gather's indices and the eval
    # loop's outputs ride a gloo side group
    _HOST_GROUP = dist.new_group(backend="gloo") if backend == "nccl" else None
    return device


def host_group():
    """The group that moves host tensors: the gloo side group under NCCL,
    else the default group."""
    return _HOST_GROUP if _HOST_GROUP is not None else dist.group.WORLD


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank (over the host group; a no-op in one process)."""
    if dist.is_initialized():
        dist.barrier(group=host_group())


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None
