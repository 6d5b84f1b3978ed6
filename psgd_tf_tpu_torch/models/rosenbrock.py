"""Rosenbrock's banana function: the hello-world workload.

Counterpart of `psgd_tf_tpu/models/rosenbrock.py`. The parameters are the
list [x, y] of 0-d tensors (the JAX package's {"x", "y"} dict in its leaf
order).
"""
from __future__ import annotations

import torch


def init(dtype=torch.float32, device: torch.device | str = "cuda") -> list[torch.Tensor]:
    """The reference's starting point (-1, 1)."""
    return [torch.tensor(-1.0, dtype=dtype, device=device),
            torch.tensor(1.0, dtype=dtype, device=device)]


def loss(params) -> torch.Tensor:
    x, y = params
    return 100.0 * (y - x**2) ** 2 + (1.0 - x) ** 2
