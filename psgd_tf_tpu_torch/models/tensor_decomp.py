"""Rank-R CP tensor decomposition with an L1 sparsity penalty.

Counterpart of `psgd_tf_tpu/models/tensor_decomp.py`: fit a uniform [0, 1)
(I, J, K) tensor T with sum_r x_r ⊗ y_r ⊗ z_r; loss = sum((T - fit)^2) +
1e-3 · sum|factors|; factors drawn from N(0, 1). The parameters are the
list [x, y, z] (the JAX package's {"x", "y", "z"} dict in its leaf order).
"""
from __future__ import annotations

import torch


def make_target(generator: torch.Generator, shape=(10, 20, 50),
                dtype=torch.float32) -> torch.Tensor:
    """Uniform [0, 1) target, on the generator's device."""
    return torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)


def init(generator: torch.Generator, shape=(10, 20, 50), rank: int = 5,
         dtype=torch.float32) -> list[torch.Tensor]:
    """The factors x (rank, I), y (rank, J), z (rank, K) ~ N(0, 1), on the
    generator's device."""
    return [torch.randn(rank, d, generator=generator, dtype=dtype, device=generator.device)
            for d in shape]


def loss(params, target: torch.Tensor, l1: float = 1e-3) -> torch.Tensor:
    x, y, z = params
    fit = torch.einsum("ri,rj,rk->ijk", x, y, z)
    return torch.sum((target - fit) ** 2) + l1 * sum(torch.sum(torch.abs(p)) for p in params)
