"""Core structured linear-algebra ops shared by the preconditioner families.

Counterpart of `psgd_tf_tpu/ops/linalg.py`: the numerical constants the
Lie-group updates depend on, triangular masking and solves, and the
max-abs step normalizer.
"""
from __future__ import annotations

import functools
import math

import torch

__all__ = [
    "tiny",
    "delta_scale",
    "max_abs",
    "triu",
    "solve_ut_t",
    "step_scale",
    "norm_clip_scale",
]


@functools.lru_cache(maxsize=None)
def tiny(dtype: torch.dtype) -> float:
    """Smallest positive *subnormal* of `dtype` (not `finfo.tiny`, the
    smallest normal): ~1.4e-45 for fp32. Guards `step / max|grad|`
    against division by zero."""
    fi = torch.finfo(dtype)
    return float(fi.tiny * fi.eps)


@functools.lru_cache(maxsize=None)
def delta_scale(dtype: torch.dtype) -> float:
    """sqrt(machine eps): the finite-difference perturbation scale."""
    return math.sqrt(float(torch.finfo(dtype).eps))


def max_abs(x: torch.Tensor) -> torch.Tensor:
    """max |x| over all entries — the Lie-group step normalizer."""
    return x.abs().amax()


def triu(x: torch.Tensor) -> torch.Tensor:
    """Upper-triangular part (`band_part(x, 0, -1)` in the TF reference)."""
    return torch.triu(x)


def solve_ut_t(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve U^T x = b with U upper triangular, in fp32 (or wider) even for
    half-precision states: substitution amplifies rounding."""
    out_dtype = torch.promote_types(u.dtype, b.dtype)
    compute = torch.promote_types(out_dtype, torch.float32)
    b2 = b[:, None] if b.ndim == 1 else b
    out = torch.linalg.solve_triangular(
        u.to(compute).mT, b2.to(compute), upper=False
    ).to(out_dtype)
    return out[:, 0] if b.ndim == 1 else out


def step_scale(step, max_grad: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`step / (max|grad| + tiny)` in fp32, saturated at the state dtype's
    finite max, so a group gradient of exactly 0 gives a zero update and
    not `inf * 0 = NaN`."""
    s = step / (max_grad.to(torch.float32) + tiny(dtype))
    return torch.clamp(s, max=torch.finfo(dtype).max).to(dtype)


def norm_clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The lr multiplier `min(max_norm / norm, 1)`; `max_norm = inf` (no
    clipping) yields exactly 1."""
    return torch.clamp(max_norm / norm, max=1.0)
