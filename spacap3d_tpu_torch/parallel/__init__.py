"""Parallel runtimes of the port over ``torch.distributed``: data
parallelism (``mesh``, ``multihost``) and tensor parallelism of the
captioner (``tp``)."""
from spacap3d_tpu_torch.parallel.mesh import make_mesh, shard_batch  # noqa: F401
from spacap3d_tpu_torch.parallel.tp import (  # noqa: F401
    count_sharded,
    make_tp_mesh,
    shard_model,
    tp_degree,
    tp_param_specs,
)
