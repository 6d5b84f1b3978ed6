"""Dense (full triangular) preconditioner: P = Q^T Q, Q upper triangular.

Counterpart of `psgd_tf_tpu/groups/dense.py`:

  a = Q h,  b = Q^{-T} v,  grad = triu(a a^T - b b^T)
  Q <- Q - (step / (max|grad| + tiny)) grad Q,   P g = Q^T (Q g)

With vector probes the gradient is rank 2, so `grad Q` is computed in
O(n^2) by reverse cumulative sums. Routing follows the JAX package: fp32
on CUDA with n <= `dense_upd.MAX_N` takes K11, n <= `dense_big.MAX_N` K12,
and anything larger runs the plain rank-2 form on the device (route
'xla', where the JAX package has no kernel either). Other dtypes and the
CPU take the plain form.
"""
from __future__ import annotations

import dataclasses

import torch

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import dense_big, dense_upd


@dataclasses.dataclass(frozen=True)
class DenseState:
    Q: torch.Tensor  # (n, n) upper triangular


def init(n: int, init_scale: float = 1.0, dtype=torch.float32,
         device: torch.device | str = "cuda") -> DenseState:
    """Identity-scaled init (`hello_psgd` uses 0.1 I)."""
    return DenseState(Q=init_scale * torch.eye(n, dtype=dtype, device=device))


def route(n: int, device: torch.device | str, dtype=torch.float32) -> str:
    """Which path serves the update of an (n, n) Q on `device`: 'plain' on
    the CPU, inside `hopper.disabled()` or for a dtype other than fp32;
    on a CUDA device 'dense_upd' (K11), 'dense_big' (K12) or 'xla' (the
    plain form on the device), as the JAX package routes."""
    if dtype != torch.float32 or not hopper.use_kernel(device):
        return "plain"
    if n <= dense_upd.MAX_N:
        return "dense_upd"
    if n <= dense_big.MAX_N:
        return "dense_big"
    return "xla"


_KERNELS = {"dense_upd": dense_upd, "dense_big": dense_big}


def update(state: DenseState, v: torch.Tensor, h: torch.Tensor, step=0.01) -> DenseState:
    """One Lie-group step fitting Q to the curvature pair (v, h)."""
    q = state.Q
    mod = _KERNELS.get(route(q.shape[0], q.device, q.dtype))
    if mod is None:
        return DenseState(Q=dense_upd.update_plain(q, v, h, step))
    return DenseState(Q=mod.fused_update(q, v, h, step))


def update_apply(state: DenseState, v: torch.Tensor, h: torch.Tensor, g: torch.Tensor,
                 step=0.01) -> tuple[DenseState, torch.Tensor]:
    """update() followed by apply() of the UPDATED Q, fused in the kernels."""
    q = state.Q
    mod = _KERNELS.get(route(q.shape[0], q.device, q.dtype))
    if mod is None:
        new_q, pre = dense_upd.update_apply_plain(q, v, h, g, step)
    else:
        new_q, pre = mod.fused_update_apply(q, v, h, g, step)
    return DenseState(Q=new_q), pre


def apply(state: DenseState, g: torch.Tensor) -> torch.Tensor:
    """P g = Q^T (Q g): two triangular matvecs."""
    q = state.Q
    return q.T @ (q @ g)


def materialize(state: DenseState) -> torch.Tensor:
    """Dense P = Q^T Q, for tests."""
    return state.Q.T @ state.Q
