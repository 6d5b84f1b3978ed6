"""K3: exact inverse of upper-triangular factors, and K19: the blocked
triangular solve (`csrc/tri.cu`).

K3 replaces `psgd_tf_tpu/ops/pallas/tri.py` `_newton_inv_batched` (:94). The
Pallas routine inverts 128x128 diagonal blocks by a Newton chain because
the TPU has no trsm; the CUDA kernel inverts each whole factor by blocked
fp32 back-substitution, exact to fp32 rounding. One call inverts a whole
list of factors in two launches.

K19 replaces the same file's `solve_triangular` (:161 → `pallas_call` :185,
`_solve_kernel` :123), which only the JAX package's tests call: K3's tile
routine inverts the 32x32 diagonal tiles (read through an index map for
the lower and transposed systems), then one block per 16-column panel of B
substitutes block row by block row, in fp32. The JAX kernel's cap
(n <= 768) is a VMEM limit and is not carried over: any n is taken.

The same JAX file's `dot_bf16x3` (:45) has no counterpart here. It is a
three-pass bf16 product standing in for Precision.HIGH, which Mosaic
lacks, inside K9/K10's substitutions (`kron_sparse_big.py:120-140`). The
port computes those products in fp32 FMA in `csrc/kron_dd.cu`'s grouped
GEMM (K9 and K10 in `csrc/kron_sparse_big.cu` launch it), which is at
least as accurate (`tests/test_torch_splu_apply.py`).
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


def solve_triangular_plain(q: torch.Tensor, b: torch.Tensor, *, lower: bool = False,
                           trans: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K19: X with (Q^T if trans else Q) X = B."""
    m = q.T if trans else q
    x = torch.linalg.solve_triangular(m, b[:, None] if b.ndim == 1 else b, upper=lower == trans)
    return x[:, 0] if b.ndim == 1 else x


def solve_triangular(q: torch.Tensor, b: torch.Tensor, *, lower: bool = False,
                     trans: bool = False) -> torch.Tensor:
    """K19: solves (Q^T if trans else Q) X = B for a triangular Q (n, n),
    upper or lower, and B (n, nrhs) or (n,); returns X of B's rank. The
    plain version for CPU tensors, the CUDA kernels for CUDA tensors."""
    if not hopper.use_kernel(q):
        return solve_triangular_plain(q, b, lower=lower, trans=trans)
    if q.ndim != 2 or q.shape[0] != q.shape[1] or b.ndim not in (1, 2) or len(b) != len(q):
        raise ValueError(f"tri_solve: shapes Q {tuple(q.shape)}, B {tuple(b.shape)} do not agree")
    n = q.shape[0]
    b2 = (b[:, None] if b.ndim == 1 else b).contiguous()
    hopper.check_operands("tri_solve", q, b2)
    lib = _build.lib()
    x = torch.empty_like(b2)
    scratch = torch.empty(lib.psgd_tri_solve_scratch_floats(n), dtype=torch.float32,
                          device=q.device)
    rc = lib.psgd_tri_solve(n, b2.shape[1], int(lower), int(trans), q.data_ptr(), b2.data_ptr(),
                            x.data_ptr(), scratch.data_ptr(),
                            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "tri_solve kernels")
    hopper.counts["tri_solve"] += 1
    return x[:, 0] if b.ndim == 1 else x
