"""K5: one sparse-format Kronecker layer, (norm, scale), (dense, scale) or
(norm, dense), in one fixed chain of launches.

Replaces `psgd_tf_tpu/ops/pallas/kron_sparse.py` `fused_update_ns` /
`fused_update_ds` / `fused_update_nd` (:311/:329/:345 → `_call` :293 →
`pallas_call` :297). On Hopper K5 is the one-layer case of K1's chain in
`csrc/kron_dd.cu` (as K2 is for (dense, dense)): balance, K3 on the dense
factor if any, the arrow pre-pass, the grouped GEMMs, the row/column
reductions and the factor rewrites.

The plain versions (`update_plain_*`) follow the JAX package's XLA path
(`psgd_tf_tpu/groups/kron.py:135-241`); they are the CPU path and the
oracle the chain is checked against on the card. Layouts: an arrow
("norm") factor is (2, m) (diag; last column, whose last entry is 0), a
scale factor (n,), a dense factor (d, d) upper-triangular.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.ops import hopper, linalg
from psgd_tf_tpu_torch.ops.hopper import kron_dd

# the JAX package's routing cap (kron_sparse.py MAX_ELEMS and :288-290):
# sides padded to 128, each <= 512, product <= 512^2
_BS = 128
MAX_SIDE = 512
MAX_ELEMS = 512 * 512


def fits(m: int, n: int) -> bool:
    """Probe shapes the JAX package serves with its single-launch kernel."""
    mp, np_ = -(-m // _BS) * _BS, -(-n // _BS) * _BS
    return mp * np_ <= MAX_ELEMS and max(mp, np_) <= MAX_SIDE


# ------------------------------------------------------------- plain versions

def norm_matmul(ql, X):
    """Ql @ X for the arrow factor: diag mult + rank-1 last-row pull."""
    return ql[0][:, None] * X + torch.outer(ql[1], X[-1])


def norm_t_matmul(ql, X):
    """Ql^T @ X for the arrow factor: diag mult + correction added to the
    last row."""
    out = ql[0][:, None] * X
    out[-1] += ql[1] @ X
    return out


def norm_inv_t_matmul(ql, X):
    """Ql^{-T} @ X by the closed-form arrow inverse: rows / diag, and the
    last row corrected by corr = sum_i w_i X_i, w_i = ql1_i / (ql0_i ql0_last)."""
    Bt = X / ql[0][:, None]
    Bt[-1] = Bt[-1] - (ql[1] / (ql[0] * ql[0][-1])) @ X
    return Bt


def _arrow_step(ql, A, Bt, step):
    """The arrow factor's rewrite from its (diag, bias) gradient."""
    diag = torch.sum(A * A, dim=1) - torch.sum(Bt * Bt, dim=1)
    bias = torch.cat([A[:-1] @ A[-1] - Bt[:-1] @ Bt[-1], A.new_zeros(1)])
    step1 = linalg.step_scale(
        step, torch.maximum(linalg.max_abs(diag), linalg.max_abs(bias)), ql.dtype
    )
    new0 = ql[0] - step1 * diag * ql[0]
    new1 = ql[1] - step1 * (diag * ql[1] + ql[0, -1] * bias)
    return torch.stack([new0, new1])


def _scale_step(qr, A, Bt, step):
    grad2 = torch.sum(A * A, dim=0) - torch.sum(Bt * Bt, dim=0)
    return qr - linalg.step_scale(step, linalg.max_abs(grad2), qr.dtype) * grad2 * qr


def update_plain_ns(ql, qr, dX, dG, step):
    """(norm, scale): ql (2, m), qr (n,)."""
    rho = torch.sqrt(ql[0].amax() / qr.amax())
    ql, qr = ql / rho, rho * qr
    A = norm_matmul(ql, dG) * qr[None, :]
    Bt = norm_inv_t_matmul(ql, dX) / qr[None, :]
    return _arrow_step(ql, A, Bt, step), _scale_step(qr, A, Bt, step)


def update_plain_ds(Ql, qr, dX, dG, step):
    """(dense, scale): Ql (m, m) upper-triangular, qr (n,)."""
    rho = torch.sqrt(torch.diagonal(Ql).amax() / qr.amax())
    Ql, qr = Ql / rho, rho * qr
    A = (Ql @ dG) * qr[None, :]
    Bt = linalg.solve_ut_t(Ql, dX) / qr[None, :]
    grad1 = linalg.triu(A @ A.T - Bt @ Bt.T)
    step1 = linalg.step_scale(step, linalg.max_abs(grad1), Ql.dtype)
    return Ql - step1 * (grad1 @ Ql), _scale_step(qr, A, Bt, step)


def update_plain_nd(ql, Qr, dX, dG, step):
    """(norm, dense): ql (2, m), Qr (n, n) upper-triangular."""
    rho = torch.sqrt(ql[0].amax() / torch.diagonal(Qr).amax())
    ql, Qr = ql / rho, rho * Qr
    A = norm_matmul(ql, dG) @ Qr.T
    Bt = linalg.solve_ut_t(Qr, norm_inv_t_matmul(ql, dX).T).T  # Ql^{-T} dX Qr^{-1}
    grad2 = linalg.triu(A.T @ A - Bt.T @ Bt)
    step2 = linalg.step_scale(step, linalg.max_abs(grad2), Qr.dtype)
    return _arrow_step(ql, A, Bt, step), Qr - step2 * (grad2 @ Qr)


PLAIN = {"ns": update_plain_ns, "ds": update_plain_ds, "nd": update_plain_nd}


# ------------------------------------------------------------------ wrappers

def _fused(kind, a, b, dx, dg, step):
    if not hopper.use_kernel(a):
        return PLAIN[kind](a, b, dx, dg, step)
    (na,), (nb,) = kron_dd.launch(
        [kind], [a], [b], [dx.contiguous()], [dg.contiguous()], step, "kron_sparse"
    )
    return na, nb


def fused_update_ns(ql, qr, dx, dg, step):
    """K5, (norm, scale): ql (2, m), qr (n,); returns (ql', qr')."""
    return _fused("ns", ql, qr, dx, dg, step)


def fused_update_ds(Ql, qr, dx, dg, step):
    """K5, (dense, scale): Ql (m, m), qr (n,); returns (Ql', qr')."""
    return _fused("ds", Ql, qr, dx, dg, step)


def fused_update_nd(ql, Qr, dx, dg, step):
    """K5, (norm, dense): ql (2, m), Qr (n, n); returns (ql', Qr')."""
    return _fused("nd", ql, Qr, dx, dg, step)


FUSED_UPDATE = {"ns": fused_update_ns, "ds": fused_update_ds, "nd": fused_update_nd}
