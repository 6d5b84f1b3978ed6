"""K3: exact inverse of upper-triangular factors (`csrc/tri.cu`).

Replaces `psgd_tf_tpu/ops/pallas/tri.py` `_newton_inv_batched` (:94). The
Pallas routine inverts 128x128 diagonal blocks by a Newton chain because
the TPU has no trsm; the CUDA kernel inverts each whole factor by blocked
fp32 back-substitution, exact to fp32 rounding. One call inverts a whole
list of factors in two launches.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import _build

MAX_FACTORS = 32  # PSGD_MAX_TRI in csrc/psgd.cuh


def inverse_upper_plain(us: list[torch.Tensor]) -> list[torch.Tensor]:
    """Plain PyTorch version: U^{-1} by a triangular solve against I."""
    return [
        torch.linalg.solve_triangular(
            u, torch.eye(u.shape[0], dtype=u.dtype, device=u.device), upper=True
        )
        for u in us
    ]


def inverse_upper(us: list[torch.Tensor]) -> list[torch.Tensor]:
    """Inverses of a list of (n_i, n_i) upper-triangular factors: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if not hopper.use_kernel(us[0]):
        return inverse_upper_plain(us)
    for u in us:
        if u.ndim != 2 or u.shape[0] != u.shape[1]:
            raise ValueError(f"tri: square factors only, got {tuple(u.shape)}")
    hopper.check_operands("tri", *us)
    lib = _build.lib()
    stream = torch.cuda.current_stream(us[0].device).cuda_stream
    out: list[torch.Tensor] = []
    for i in range(0, len(us), MAX_FACTORS):
        chunk = us[i:i + MAX_FACTORS]
        xs = [torch.empty_like(u) for u in chunk]
        rc = lib.psgd_tri_inv_upper(
            len(chunk), _build.ptr_array(chunk), _build.ptr_array(xs),
            _build.int_array([u.shape[0] for u in chunk]), stream,
        )
        _build.check(rc, "tri kernel")
        hopper.counts["tri"] += 1
        out += xs
    return out
