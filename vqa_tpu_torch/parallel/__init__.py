"""Data and tensor parallelism across processes, the port of
``vqa_tpu/parallel/``.

One process per card: ``distributed.initialize`` joins the process group
(NCCL on the card, gloo on the host), ``mesh.make_mesh(model_parallel)``
lays the world out as the JAX grid ('data', 'model') and makes the groups of
this rank's column and row, ``partition.shard_state_tp`` shards the
optimizer state over the model axis, and ``mesh.shard_feature_table``
row-shards the feature table over every rank. The collectives live where
the JAX package lets XLA insert them: the train step's grad reduction over
the data axis (``engine/steps.py``), the sharded update's all-gather over
the model axis (``partition.Layout.apply``), the eval loop's output gather
(``engine/engine.py``), the checkpoint's state gather
(``partition.gather_state``) and the sharded gather (``mesh.ShardedTable``).
"""

from vqa_tpu_torch.parallel.distributed import (  # noqa: F401
    barrier,
    initialize,
    is_primary,
    process_count,
    process_index,
    shutdown,
)
from vqa_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    ShardedTable,
    check_batch_divisible,
    make_mesh,
    shard_feature_table,
)
from vqa_tpu_torch.parallel.partition import (  # noqa: F401
    Layout,
    gather_state,
    shard_state_tp,
    state_bytes,
    tp_shardings,
)
