"""The feature table as dense rows of the traffic file's ``table.dtype``
(``traffic.image_rows``: each image's rows a pure function of the seed
and the image), whole on the card, or row-sharded over a mesh's ranks
where ``table.sharded`` is set (``parallel.mesh.shard_rows``'s layout: a
rank's rows, -0.0 rows to the shard's size and one -0.0 sink row)."""

import numpy as np
import torch

from portbench import traffic as traffic_lib


def make(traffic: dict, seed: int, device, mesh=None):
    """What the program takes as its features: the table, or this rank's
    ``ShardedTable``."""
    if not traffic["table"].get("sharded"):
        return traffic_lib.make_table(traffic, seed, device)
    from vqa_tpu_torch.parallel.mesh import ShardedTable

    t, images = traffic["table"], traffic["split"]["images"]
    per = -(-images // mesh.size)
    lo, hi = min(images, mesh.rank * per), min(images, (mesh.rank + 1) * per)
    local = torch.full((per + 1, t["regions"], t["dim"]), -0.0,
                       dtype=traffic_lib.table_dtype(traffic), device=device)
    traffic_lib.image_rows(traffic, seed, np.arange(lo, hi), device, out=local[:hi - lo])
    return ShardedTable(local, images, mesh)


def rows(traffic: dict, seed: int, images: np.ndarray, device, table=None) -> torch.Tensor:
    """The rows of ``images`` as the reference reads them: indexed from the
    table where it is whole here, else rebuilt from the seed."""
    if isinstance(table, torch.Tensor):
        return table[torch.from_numpy(images).to(device).long()]
    return traffic_lib.image_rows(traffic, seed, images, device)
