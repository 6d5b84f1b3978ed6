"""The (data, shard) mesh over the ranks of a `torch.distributed` job.

Counterpart of `psgd_tf_tpu/parallel/mesh.py:19-46`. Axes:
  data  - batch parallelism: the loss, gradients and Hvps all-reduce here;
  shard - preconditioner-state partitioning: the lanes of the flat
          families' states; the rank-space Grams and max-abs step
          normalizers all-reduce here.
Tensor-parallel parameters split and gather over either axis or both.

Ranks lie on the mesh as JAX lays devices: rank i is at data coordinate
i // shard and shard coordinate i % shard. `make_mesh` runs inside an
initialised default process group (`dist.init_process_group`, with its
address, world size and rank given by the caller) and builds its own
subgroups with `dist.new_group`; every rank of the job must call it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from psgd_tf_tpu_torch.parallel import _collectives


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int             # ranks on the data axis
    shard: int            # ranks on the shard axis
    data_rank: int        # this rank's data coordinate
    shard_rank: int       # this rank's shard coordinate
    data_group: object    # the ranks that share this rank's shard coordinate
    shard_group: object   # the ranks that share this rank's data coordinate
    backend: str          # the subgroups' backend, e.g. 'nccl' or 'gloo'
    device: torch.device  # where this rank's tensors live

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "shard": self.shard}

    # the reductions over the shard axis that the sharded families call
    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return _collectives.psum(x, self.shard_group, self.shard)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return _collectives.pmax(x, self.shard_group, self.shard)

    def all_gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        return _collectives.all_gather_lanes(x, self.shard_group, self.shard, self.shard_rank)

    def all_gather_dims(self, xs: list[torch.Tensor], dims: list[int],
                        axis: str = "shard") -> list[torch.Tensor]:
        """Every rank's xs[i] of this rank's group over `axis`, concatenated
        along dims[i] in the order of the ranks' coordinates, in one gather."""
        if axis == "shard":
            return _collectives.all_gather_dims(xs, dims, self.shard_group, self.shard,
                                                self.shard_rank)
        return _collectives.all_gather_dims(xs, dims, self.data_group, self.data,
                                            self.data_rank)


def make_mesh(data: int | None = None, shard: int = 1, backend: str | None = None,
              device: torch.device | str | None = None) -> Mesh:
    """A (data, shard) mesh over the job's ranks; `data=None` takes all the
    ranks that remain. Raises as the JAX package does when the ranks do not
    divide or do not suffice. `device` defaults to this rank's card,
    cuda:(rank mod cards). `backend` defaults to the default group's, the
    one the caller chose in `init_process_group`: 'nccl' when every rank
    has a card of its own, 'gloo' on the CPU or for ranks that share a
    card (NCCL refuses two ranks on one device)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs inside dist.init_process_group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        if world % shard:
            raise ValueError(f"{world} ranks not divisible by shard={shard}")
        data = world // shard
    if data * shard > world:
        raise ValueError(f"mesh {data}x{shard} needs {data * shard} ranks, have {world}")
    backend = backend or dist.get_backend()
    data_groups = [dist.new_group([d * shard + s for d in range(data)], backend=backend)
                   for s in range(shard)]
    shard_groups = [dist.new_group([d * shard + s for s in range(shard)], backend=backend)
                    for d in range(data)]
    if rank >= data * shard:
        raise ValueError(f"rank {rank} lies outside the {data}x{shard} mesh")
    if device is None:
        device = torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    d, s = divmod(rank, shard)
    return Mesh(data=data, shard=shard, data_rank=d, shard_rank=s, data_group=data_groups[s],
                shard_group=shard_groups[d], backend=backend, device=torch.device(device))
