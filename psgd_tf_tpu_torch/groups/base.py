"""Uniform interface contract for preconditioner families.

Counterpart of `psgd_tf_tpu/groups/base.py`. Every family is a functional
module over a state object, with three entry points:

    init(n_or_shape, ...)          -> state
    update(state, v, h, step)      -> state      # one Lie-group step
    apply(state, g)                -> pre_grad   # P @ g with P = Q^T Q

`v` is the random probe and `h` the Hessian-vector product H v. The kron
family consumes per-tensor matrices; the whole-model (flat-vector)
families are not ported yet (ROADMAP queue 1, slice 3).
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

