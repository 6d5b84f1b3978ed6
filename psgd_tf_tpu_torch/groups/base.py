"""Uniform interface contract for preconditioner families.

Counterpart of `psgd_tf_tpu/groups/base.py`. Every family is a functional
module over a state object, with three entry points:

    init(n_or_shape, ...)          -> state
    update(state, v, h, step)      -> state      # one Lie-group step
    apply(state, g)                -> pre_grad   # P @ g with P = Q^T Q

`v` is the random probe and `h` the Hessian-vector product H v. The kron
family consumes per-tensor matrices; the flat families (dense, diag, xmat,
shift, splu, lra) consume the raveled parameter vector, and dense, splu
and lra add `update_apply(state, v, h, g, step) -> (state, P' g)`. lra's `update`
takes its two coins as `coins=(balance, update_u)` where the JAX package
takes a key.
"""
from __future__ import annotations

from typing import Any, Protocol

import torch

PreconditionerState = Any


class Family(Protocol):
    """Structural protocol each family module satisfies."""

    def init(self, *args, **kwargs) -> PreconditionerState: ...

    def update(
        self,
        state: PreconditionerState,
        v: torch.Tensor,
        h: torch.Tensor,
        step: float,
    ) -> PreconditionerState: ...

    def apply(self, state: PreconditionerState, g: torch.Tensor) -> torch.Tensor: ...

