"""K3: exact inverse of upper-triangular factors, and K19: the blocked
triangular solve (`csrc/tri.cu`).

K3 replaces `psgd_tf_tpu/ops/pallas/tri.py` `_newton_inv_batched` (:94). The
Pallas routine inverts 128x128 diagonal blocks by a Newton chain because
the TPU has no trsm; the CUDA kernel inverts each whole factor in fp32,
exact to fp32 rounding, by the recursive block form (`inverse_schedule`):
32-row leaves by substitution, then levels that join pairs of diagonal
blocks, X12 = -X11 (U12 X22). One call inverts a whole list of factors in
one cooperative launch, every pair of a level of every factor in one
phase, a grid barrier between phases. `inverse_upper_blocked_plain`
executes the same schedule in torch, so the CPU tests reach its index
maps.

K19 replaces the same file's `solve_triangular` (:161 → `pallas_call` :185,
`_solve_kernel` :123), which only the JAX package's tests call. `schedule`
lists its work as records of six ints: the inverses of every NB x NB
diagonal block (K3's tile routine and walk, reading Q through an index map
for the lower and transposed systems), then block by block in
substitution order one leaf GEMM (X_i = M_ii^{-1} C_i) and one update GEMM
of every row still unsolved (C_rest -= M_rest,i X_i, M read through the
transposed index, no copy). One C call launches the whole schedule, with
no host sync. Up to SUBST_MAX_N rows the schedule is one record: the
substitution kernel over the whole system (two launches).
`solve_triangular_blocked_plain` executes the same schedule in torch, so
the CPU tests reach its index maps. NB and SUBST_MAX_N, and the
right-looking order (each update K = NB deep over all the rows left,
rather than a recursive split whose deep updates leave most of the card
idle), were chosen on the card (`tools/tri_lra_ab.py --sweep`). The JAX
kernel's cap (n <= 768) is a VMEM limit and is not carried over: any n is
taken.

The same JAX file's `dot_bf16x3` (:45) has no counterpart here. It is a
three-pass bf16 product standing in for Precision.HIGH, which Mosaic
lacks, inside K9/K10's substitutions (`kron_sparse_big.py:120-140`). The
port computes those products in fp32 FMA in `csrc/kron_dd.cu`'s grouped
GEMM (K9 and K10 in `csrc/kron_sparse_big.cu` launch it), which is at
least as accurate (`tests/test_torch_splu_apply.py`).
"""
from __future__ import annotations

import functools

import torch

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import _build

MAX_FACTORS = 32  # PSGD_MAX_TRI in csrc/psgd.cuh
NB = 256           # K19's leaf rows (a multiple of 32)
SUBST_MAX_N = 384  # K19 systems up to this n: the substitution kernel alone
# K19's schedule records (TRI_OP_* in csrc/tri.cu)
OP_SUBST, OP_INV, OP_LEAF, OP_UPDATE = range(4)


def inverse_upper_plain(us: list[torch.Tensor]) -> list[torch.Tensor]:
    """Plain PyTorch version: U^{-1} by a triangular solve against I."""
    return [
        torch.linalg.solve_triangular(
            u, torch.eye(u.shape[0], dtype=u.dtype, device=u.device), upper=True
        )
        for u in us
    ]


LEAF = 32  # TRI_LEAF in csrc/tri_inv.cuh


def inverse_schedule(n: int) -> list[list[tuple[int, int, int]]]:
    """K3's levels for a factor of side n: level l's pairs (r0, s, e) of
    diagonal blocks, rows [r0, s) and [s, e) joined, b = LEAF << l rows in
    the first block (s = r0 + b, e = min(r0 + 2 b, n)); a pair exists where
    s < n (`tri_pairs` in csrc/tri_inv.cuh)."""
    levels = []
    while True:
        b = LEAF << len(levels)
        pairs = [(r0, r0 + b, min(r0 + 2 * b, n)) for r0 in range(0, n, 2 * b) if r0 + b < n]
        if not pairs:
            return levels
        levels.append(pairs)


def inverse_upper_blocked_plain(us: list[torch.Tensor]) -> list[torch.Tensor]:
    """K3's schedule executed in torch: each 32-row leaf of each factor
    inverted by a triangular solve against I (the last one of the
    identity-extended factor, cut back to n), then level by level
    T = U12 X22 and X12 = -X11 T on every pair (`inverse_schedule`), the
    strictly lower part zero."""
    out = []
    for u in us:
        n = u.shape[0]
        x = torch.zeros_like(u)
        for r0 in range(0, n, LEAF):
            leaf = torch.eye(LEAF, dtype=u.dtype, device=u.device)
            k = min(LEAF, n - r0)
            leaf[:k, :k] = torch.triu(u[r0:r0 + k, r0:r0 + k])
            inv = torch.linalg.solve_triangular(leaf, torch.eye(LEAF, dtype=u.dtype,
                                                                device=u.device), upper=True)
            x[r0:r0 + k, r0:r0 + k] = inv[:k, :k]
        for pairs in inverse_schedule(n):
            for r0, s, e in pairs:
                t = u[r0:s, s:e] @ x[s:e, s:e]
                x[r0:s, s:e] = -(x[r0:s, r0:s] @ t)
        out.append(x)
    return out


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


def schedule(n: int, lower: bool, trans: bool, nb: int | None = None,
             subst_max: int | None = None) -> list[tuple[int, ...]]:
    """K19's work for an (n, n) system as records (kind, r0, rows, k0, k,
    src): INV the diagonal blocks' inverses; then, block by block in
    substitution order, LEAF X[r0:r0+rows] = M_ii^{-1} S[r0:r0+rows] and
    UPDATE C[r0:r0+rows] = S[r0:r0+rows] - M[r0:r0+rows, k0:k0+k] X[k0:k0+k]
    for every row still unsolved; or SUBST, the whole system by
    substitution. S is B (src 0) until the first update has written C
    (src 1). nb and subst_max default to NB and SUBST_MAX_N."""
    nb = NB if nb is None else nb
    if n <= (SUBST_MAX_N if subst_max is None else subst_max):
        return [(OP_SUBST, 0, n, 0, 0, 0)]
    forward = lower != trans
    blocks = range(0, n, nb)
    ops = [(OP_INV, 0, n, 0, 0, 0)]
    for i, r0 in enumerate(blocks if forward else reversed(blocks)):
        m = min(nb, n - r0)
        ops.append((OP_LEAF, r0, m, 0, 0, int(i > 0)))
        rest = (r0 + m, n - r0 - m) if forward else (0, r0)
        if rest[1]:
            ops.append((OP_UPDATE, *rest, r0, m, int(i > 0)))
    return ops


def solve_triangular_blocked_plain(q: torch.Tensor, b: torch.Tensor, *, lower: bool = False,
                                   trans: bool = False, nb: int | None = None,
                                   subst_max: int | None = None) -> torch.Tensor:
    """K19's schedule executed in torch, through the kernels' index maps:
    each diagonal block's U (M or M^T, whichever is upper; Q read
    transposed when lower) inverted by a triangular solve against I, the
    forward systems' leaves multiplying by its transpose, the updates
    reading M's blocks as Q's (transposed when trans)."""
    n = q.shape[0]
    nb = NB if nb is None else nb
    b2 = b[:, None] if b.ndim == 1 else b
    forward = lower != trans
    x, c = torch.empty_like(b2), torch.empty_like(b2)
    inv = {}

    def leaf_inverse(r0, m):
        blk = q[r0:r0 + m, r0:r0 + m]
        u = blk.T if lower else blk
        w = torch.linalg.solve_triangular(u, torch.eye(m, dtype=q.dtype, device=q.device),
                                          upper=True)
        return w.T if forward else w

    for kind, r0, m, k0, k, src in schedule(n, lower, trans, nb, subst_max):
        s = c if src else b2
        if kind == OP_SUBST:
            x = leaf_inverse(0, n) @ b2
        elif kind == OP_INV:
            inv = {a: leaf_inverse(a, min(nb, n - a)) for a in range(0, n, nb)}
        elif kind == OP_LEAF:
            x[r0:r0 + m] = inv[r0] @ s[r0:r0 + m]
        else:
            a = q[k0:k0 + k, r0:r0 + m].T if trans else q[r0:r0 + m, k0:k0 + k]
            c[r0:r0 + m] = s[r0:r0 + m] - a @ x[k0:k0 + k]
    return x[:, 0] if b.ndim == 1 else x


@functools.lru_cache(maxsize=256)
def _schedule_args(n, nrhs, lower, trans, nb, subst_max):
    """The schedule as psgd_tri_solve takes it, and its scratch in floats,
    built once a shape: (int array, records, scratch floats)."""
    ops = schedule(n, lower, trans, nb, subst_max)
    subst = int(ops[0][0] == OP_SUBST)
    return (_build.int_array([v for op in ops for v in op]), len(ops),
            _build.lib().psgd_tri_solve_scratch_floats(n, nrhs, nb, subst))


def solve_triangular(q: torch.Tensor, b: torch.Tensor, *, lower: bool = False,
                     trans: bool = False) -> torch.Tensor:
    """K19: solves (Q^T if trans else Q) X = B for a triangular Q (n, n),
    upper or lower, and B (n, nrhs) or (n,); returns X of B's rank. The
    plain version for CPU tensors, the schedule's kernels for CUDA tensors."""
    if not hopper.use_kernel(q):
        return solve_triangular_plain(q, b, lower=lower, trans=trans)
    if q.ndim != 2 or q.shape[0] != q.shape[1] or b.ndim not in (1, 2) or len(b) != len(q):
        raise ValueError(f"tri_solve: shapes Q {tuple(q.shape)}, B {tuple(b.shape)} do not agree")
    n = q.shape[0]
    b2 = (b[:, None] if b.ndim == 1 else b).contiguous()
    hopper.check_operands("tri_solve", q, b2)
    nrhs = b2.shape[1]
    nb = NB
    ops, count, floats = _schedule_args(n, nrhs, bool(lower), bool(trans), nb, SUBST_MAX_N)
    x = torch.empty_like(b2)
    scratch = torch.empty(floats, dtype=torch.float32, device=q.device)
    rc = _build.lib().psgd_tri_solve(n, nrhs, int(lower), int(trans), nb, ops, count,
                                     q.data_ptr(), b2.data_ptr(), x.data_ptr(),
                                     scratch.data_ptr(),
                                     torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "tri_solve kernels")
    hopper.counts["tri_solve"] += 1
    return x[:, 0] if b.ndim == 1 else x
