"""Diagonal (Jacobi) preconditioner: Q = diag(q).

Counterpart of `psgd_tf_tpu/groups/diag.py`. The Lie-group step is the
diagonal specialisation of the dense rule:

  a = q * h,  b = v / q,  grad = a*a - b*b
  q <- q - (step / (max|grad| + tiny)) * grad * q

`closed_form_update` moves q multiplicatively toward the elementwise
minimiser q* = (v^2 / h^2)^(1/4). Every op is elementwise: the JAX package
has no kernel for this family, and neither has the port.
"""
from __future__ import annotations

import dataclasses

import torch

from psgd_tf_tpu_torch.ops import hopper, linalg


@dataclasses.dataclass(frozen=True)
class DiagState:
    q: torch.Tensor  # (n,) positive


def init(n: int, init_scale: float = 1.0, dtype=torch.float32,
         device: torch.device | str = "cuda") -> DiagState:
    return DiagState(q=torch.full((n,), init_scale, dtype=dtype, device=device))


def update(state: DiagState, v: torch.Tensor, h: torch.Tensor, step=0.01) -> DiagState:
    """One step. Under the sharding context, q, v and h are this rank's
    lanes and the step normalizer's max is taken over the shard ranks."""
    q = state.q
    a = q * h
    b = v / q
    grad = a * a - b * b
    max_g = linalg.max_abs(grad)
    mesh = hopper.shard_ctx()
    if mesh is not None:
        max_g = mesh.pmax(max_g)
    step0 = linalg.step_scale(step, max_g, q.dtype)
    return DiagState(q=q - step0 * grad * q)


def closed_form_update(state: DiagState, v: torch.Tensor, h: torch.Tensor,
                       step=0.01) -> DiagState:
    """Multiplicative interpolation toward the exact minimiser q*."""
    q = state.q
    t = linalg.tiny(q.dtype)
    q_star = torch.sqrt((v.abs() + t) / (h.abs() + t))
    return DiagState(q=q * (q_star / q) ** step)


def apply(state: DiagState, g: torch.Tensor) -> torch.Tensor:
    return state.q * state.q * g


def materialize(state: DiagState) -> torch.Tensor:
    return torch.diag(state.q * state.q)
