"""Data parallelism across processes, the port of ``vqa_tpu/parallel/``
(less ``partition.py``, tensor parallelism: ROADMAP.md item 12b).

One process per card: ``distributed.initialize`` joins the process group
(NCCL on the card, gloo on the host), ``mesh.make_mesh`` names this rank's
place on the data axis, and ``mesh.shard_feature_table`` row-shards the
feature table over it. The collectives live where the JAX package lets XLA
insert them: the train step's grad reduction (``engine/steps.py``), the eval
loop's output gather (``engine/engine.py``) and the sharded gather
(``mesh.ShardedTable``).
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
