"""The one place of the port that calls `torch.distributed`.

Every collective of the sharded step goes through a function here, on a
group of a `parallel.Mesh`:

  psum, pmax         all-reduce (sum, max) of a tensor, in place on a copy
  all_gather_lanes   the ranks' equal-length slices, concatenated in rank order
  ring_hop           one hop of a ring: send to the next rank, receive from
                     the previous one
  data_mean          one all-reduce of the loss, gradients and Hvps over `data`

A group of one rank returns its input and calls nothing. Under gloo a CUDA
tensor goes to `all_reduce` as it is (gloo takes CUDA tensors there), and
`all_gather_lanes` is an all-reduce of a zero-filled full vector, so it
needs nothing else. gloo has no send/recv for CUDA tensors: `ring_hop`
stages that hop's payload alone through host memory (a rank-space Gram,
a few KB). A kernel's input or output never moves to the host.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX


def stages_on_host(group, x: torch.Tensor) -> bool:
    """Whether a send/recv of `x` over `group` goes through host memory
    (gloo with a CUDA tensor)."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def psum(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The sum of `x` over the `size` ranks of `group`."""
    if size == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def pmax(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The elementwise max of `x` over the `size` ranks of `group`."""
    if size == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def psum_async(x: torch.Tensor, group, size: int, op=SUM):
    """(out, work): the all-reduce of a copy of `x`, started without waiting;
    `work.wait()` (None for one rank) before reading `out`."""
    if size == 1:
        return x, None
    out = x.clone()
    return out, dist.all_reduce(out, op=op, group=group, async_op=True)


def all_gather_lanes(x: torch.Tensor, group, size: int, rank: int) -> torch.Tensor:
    """(size * len(x),): every rank's 1-D `x`, in rank order."""
    if size == 1:
        return x
    k = x.shape[0]
    if dist.get_backend(group) == "nccl":
        out = x.new_empty(size * k)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    out = x.new_zeros(size * k)
    out[rank * k:(rank + 1) * k] = x
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def ring_hop(x: torch.Tensor, group, size: int, rank: int) -> torch.Tensor:
    """Send `x` to the next rank of the ring (rank + 1 mod size) and return
    what the previous one sent. Under gloo a CUDA payload goes through host
    memory, there and back."""
    nxt = dist.get_global_rank(group, (rank + 1) % size)
    prv = dist.get_global_rank(group, (rank - 1) % size)
    host = stages_on_host(group, x)
    send = x.detach().cpu() if host else x.contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt, group=group),
                                   dist.P2POp(dist.irecv, recv, prv, group=group)])
    for req in reqs:
        req.wait()
    return recv.to(x.device) if host else recv


def data_mean(mesh, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each tensor averaged over the mesh's `data` ranks, in one all-reduce."""
    if mesh is None or mesh.data == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = psum(flat, mesh.data_group, mesh.data) / mesh.data
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out
