"""The data-parallel group and batch sharding, as the JAX package's
``parallel/mesh.py``.

JAX places one global array on a mesh of devices; here each rank is a
process with its own device, and the batch a rank computes on is simply
its row-block of the global batch. So ``make_mesh`` gives the ``data``
process group and ``shard_batch`` this rank's rows. The JAX package's
``batch_sharding`` and ``replicate_sharding`` have no counterpart:
placement is per process (a rank's tensors live on its device), and
replication is a broadcast of rank 0's weights
(``multihost.replicate_global``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch.distributed as dist


def make_mesh() -> Optional["dist.ProcessGroup"]:
    """The ``data`` group: every rank of the process group, or None in a
    single process (the train step's plain path)."""
    if not dist.is_initialized():
        return None
    return dist.group.WORLD


def group_rank_size(group) -> tuple:
    """(this rank's index in ``group``, its size); (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def shard_batch(group, batch: Dict) -> Dict:
    """This rank's contiguous row-block of every array of ``batch`` (numpy
    arrays or tensors); 0-d leaves stay whole. A leading dimension that the
    group's size does not divide raises. The JAX package replicates such a
    leaf over its devices instead; across processes that would make every
    rank train on the whole batch, and the summed gradient would count it
    once a rank: a wrong result, not a slow one."""
    rank, size = group_rank_size(group)
    out = {}
    for k, v in batch.items():
        if np.ndim(v) == 0:
            out[k] = v
            continue
        n = v.shape[0]
        if n % size:
            raise ValueError(f"shard_batch: leaf {k!r} has {n} rows, which {size} ranks "
                             f"do not divide; use a batch size the ranks divide")
        per = n // size
        out[k] = v[rank * per:(rank + 1) * per]
    return out

