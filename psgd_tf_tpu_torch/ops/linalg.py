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
    "tril",
    "solve_ut",
    "solve_ut_t",
    "solve_lt",
    "solve_lt_t",
    "solve_small",
    "step_scale",
    "triu_outer_diff_matmul",
    "triu_outer_diff_maxabs",
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
    """max |x| over all entries — the Lie-group step normalizer; 0 for an
    empty x (an splu tail when rank >= n, xmat's pairs when n = 1)."""
    return x.abs().amax() if x.numel() else x.new_zeros(())


def triu(x: torch.Tensor) -> torch.Tensor:
    """Upper-triangular part (`band_part(x, 0, -1)` in the TF reference)."""
    return torch.triu(x)


def tril(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular part (`band_part(x, -1, 0)` in the TF reference)."""
    return torch.tril(x)


def _solve_tri(a: torch.Tensor, b: torch.Tensor, *, upper: bool) -> torch.Tensor:
    """Solve a x = b with `a` triangular (`upper` says which), in fp32 (or
    wider) even for half-precision states: substitution amplifies rounding."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    compute = torch.promote_types(out_dtype, torch.float32)
    b2 = b[:, None] if b.ndim == 1 else b
    out = torch.linalg.solve_triangular(a.to(compute), b2.to(compute), upper=upper).to(out_dtype)
    return out[:, 0] if b.ndim == 1 else out


def solve_ut(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve U x = b with U upper triangular."""
    return _solve_tri(u, b, upper=True)


def solve_ut_t(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve U^T x = b with U upper triangular."""
    return _solve_tri(u.mT, b, upper=False)


def solve_lt(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b with L lower triangular."""
    return _solve_tri(l, b, upper=False)


def solve_lt_t(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b with L lower triangular."""
    return _solve_tri(l.mT, b, upper=True)


def solve_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense solve of a small (r, r) system in fp32 (or wider) even for
    half-precision operands: the Woodbury cores of the lra family.
    `solve_ex` skips the singularity check, so a solve on the device never
    waits for the host."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    compute = torch.promote_types(out_dtype, torch.float32)
    return torch.linalg.solve_ex(a.to(compute), b.to(compute))[0].to(out_dtype)


def step_scale(step, max_grad: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`step / (max|grad| + tiny)` in fp32, saturated at the state dtype's
    finite max, so a group gradient of exactly 0 gives a zero update and
    not `inf * 0 = NaN`."""
    s = step / (max_grad.to(torch.float32) + tiny(dtype))
    return torch.clamp(s, max=torch.finfo(dtype).max).to(dtype)


def triu_outer_diff_matmul(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """`triu(a a^T - b b^T) @ q` in O(n^2): row i of `triu(a a^T) @ q` is
    `a_i * sum_{j >= i} a_j q[j, :]`, a reverse cumulative sum."""
    sa = torch.flip(torch.cumsum(torch.flip(a[:, None] * q, (0,)), 0), (0,))
    sb = torch.flip(torch.cumsum(torch.flip(b[:, None] * q, (0,)), 0), (0,))
    return a[:, None] * sa - b[:, None] * sb


def triu_outer_diff_maxabs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max over the upper triangle of |a a^T - b b^T|."""
    m = torch.triu(a[:, None] * a[None, :] - b[:, None] * b[None, :])
    return m.abs().amax()


def norm_clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The lr multiplier `min(max_norm / norm, 1)`; `max_norm = inf` (no
    clipping) yields exactly 1."""
    return torch.clamp(max_norm / norm, max=1.0)
