"""Sharding of the PSGD training step over `torch.distributed` ranks.

Counterpart of `psgd_tf_tpu/parallel/`: a (data, shard) mesh of ranks
(`make_mesh`), placement policies per preconditioner family, and
`build_sharded_step`. Batches shard over `data` (the loss, gradients and
Hvps all-reduce there); the flat families' states shard their lanes over
`shard`, where only rank-space quantities cross ranks (the Grams and
max-abs normalizers of K14 and the sharded K16); dense and Kronecker
states replicate. `overlap` holds the ring reductions and the model of the
bytes a sharded step exchanges.
"""
from psgd_tf_tpu_torch.parallel.mesh import Mesh, make_mesh
from psgd_tf_tpu_torch.parallel.policies import (
    batch_sharding,
    gather_state,
    precond_sharding,
    replicated,
    shard_state,
    state_sharding,
)
from psgd_tf_tpu_torch.parallel.step import build_sharded_step

__all__ = [
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "precond_sharding",
    "replicated",
    "state_sharding",
    "shard_state",
    "gather_state",
    "build_sharded_step",
]
