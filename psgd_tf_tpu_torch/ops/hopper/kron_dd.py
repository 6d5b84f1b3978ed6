"""K1/K2/K5 device chain: the Kronecker factor update of a layer list.

Replaces `psgd_tf_tpu/ops/pallas/kron_dd.py` `fused_update` (:181). The
CUDA chain in `csrc/kron_dd.cu` updates a whole list of layers of kinds
dd/ds/nd/ns in a fixed chain of grouped launches (balance, K3, arrow
pre-pass, grouped GEMMs, reductions, factor rewrites); `fused_update` here
is its single (dense, dense) layer entry point (K2),
`kron_sparse.fused_update_*` its single sparse layer entry points (K5), and
`kron_multi.fused_update_multi` its list entry point (K1).

The plain version follows `psgd_tf_tpu/groups/kron.py` `_update_dd`
(:107-119): triangular solves and plain matmuls. It is the CPU path and
the oracle the kernel is checked against on the card.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.ops import hopper, linalg
from psgd_tf_tpu_torch.ops.hopper import _build

MAX_LAYERS = 16  # PSGD_MAX_LAYERS in csrc/psgd.cuh


def update_plain(ql, qr, dx, dg, step):
    """One (dense, dense) Lie-group step on one layer; returns the balanced,
    updated (Ql', Qr')."""
    rho = torch.sqrt(torch.diagonal(ql).amax() / torch.diagonal(qr).amax())
    ql, qr = ql / rho, rho * qr
    a = ql @ (dg @ qr.T)
    bt = linalg.solve_ut_t(ql, linalg.solve_ut_t(qr, dx.T).T)
    grad1 = linalg.triu(a @ a.T - bt @ bt.T)
    grad2 = linalg.triu(a.T @ a - bt.T @ bt)
    step1 = linalg.step_scale(step, linalg.max_abs(grad1), ql.dtype)
    step2 = linalg.step_scale(step, linalg.max_abs(grad2), qr.dtype)
    return ql - step1 * (grad1 @ ql), qr - step2 * (grad2 @ qr)


# kind codes of csrc/kron_dd.cu; the left factor is an arrow for nd/ns, the
# right factor a scale vector for ds/ns
KIND_CODE = {"dd": 0, "ds": 1, "nd": 2, "ns": 3}


def _factor_shapes(kind: str, m: int, n: int):
    left = (2, m) if kind in ("nd", "ns") else (m, m)
    right = (n,) if kind in ("ds", "ns") else (n, n)
    return left, right


def launch(kinds, qls, qrs, dxs, dgs, step: float, counter: str):
    """Run the CUDA chain on up to MAX_LAYERS layers of the given kinds;
    returns the lists of new factors. `counter` names the entry point whose
    launch this is (K1, K2 or K5)."""
    L = len(qls)
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"kron_dd chain takes 1..{MAX_LAYERS} layers, got {L}")
    for kind, ql, qr, dx, dg in zip(kinds, qls, qrs, dxs, dgs, strict=True):
        m, n = dx.shape
        left, right = _factor_shapes(kind, m, n)
        if tuple(ql.shape) != left or tuple(qr.shape) != right or dg.shape != (m, n):
            raise ValueError(
                f"{counter}: {kind} shapes Ql {tuple(ql.shape)}, Qr {tuple(qr.shape)}, "
                f"dX {tuple(dx.shape)}, dG {tuple(dg.shape)} do not agree"
            )
    hopper.check_operands(counter, *qls, *qrs, *dxs, *dgs)
    lib = _build.lib()
    codes = _build.int_array([KIND_CODE[k] for k in kinds])
    ms = _build.int_array([x.shape[0] for x in dxs])
    ns = _build.int_array([x.shape[1] for x in dxs])
    dev = qls[0].device
    scratch = torch.empty(
        lib.psgd_kron_multi_scratch_floats(L, codes, ms, ns), dtype=torch.float32, device=dev
    )
    new_qls = [torch.empty_like(q) for q in qls]
    new_qrs = [torch.empty_like(q) for q in qrs]
    p = _build.ptr_array
    rc = lib.psgd_kron_multi_update(
        L, codes, p(qls), p(qrs), p(dxs), p(dgs), p(new_qls), p(new_qrs), ms, ns,
        float(step), scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, f"{counter} kernel chain")
    hopper.counts[counter] += 1
    if any(k != "ns" for k in kinds):
        hopper.counts["tri"] += 1  # the chain's step (b) is K3
    return new_qls, new_qrs


def fused_update(ql, qr, dx, dg, step):
    """K2: one (dense, dense) layer update. The plain version for CPU
    tensors, the CUDA chain for CUDA tensors. `step` is a Python number."""
    if not hopper.use_kernel(ql):
        return update_plain(ql, qr, dx, dg, step)
    (new_ql,), (new_qr,) = launch(["dd"], [ql], [qr], [dx], [dg], step, "kron_dd")
    return new_ql, new_qr
