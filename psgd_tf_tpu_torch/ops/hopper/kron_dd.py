"""K1/K2 device chain: the (dense, dense) Kronecker factor update.

Replaces `psgd_tf_tpu/ops/pallas/kron_dd.py` `fused_update` (:181). The
CUDA chain in `csrc/kron_dd.cu` updates a whole list of layers in seven
grouped launches (balance, K3's two, four grouped GEMMs); `fused_update`
here is its single-layer entry point (K2), and
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


def launch(qls, qrs, dxs, dgs, step: float, counter: str):
    """Run the CUDA chain on up to MAX_LAYERS layers; returns the lists of
    new factors. `counter` names the entry point whose launch this is."""
    L = len(qls)
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"kron_dd chain takes 1..{MAX_LAYERS} layers, got {L}")
    for ql, qr, dx, dg in zip(qls, qrs, dxs, dgs, strict=True):
        m, n = dx.shape
        if ql.shape != (m, m) or qr.shape != (n, n) or dg.shape != (m, n):
            raise ValueError(
                f"kron_dd: shapes Ql {tuple(ql.shape)}, Qr {tuple(qr.shape)}, "
                f"dX {tuple(dx.shape)}, dG {tuple(dg.shape)} do not agree"
            )
    hopper.check_operands(counter, *qls, *qrs, *dxs, *dgs)
    lib = _build.lib()
    ms = _build.int_array([x.shape[0] for x in dxs])
    ns = _build.int_array([x.shape[1] for x in dxs])
    dev = qls[0].device
    scratch = torch.empty(
        lib.psgd_kron_dd_scratch_floats(L, ms, ns), dtype=torch.float32, device=dev
    )
    new_qls = [torch.empty_like(q) for q in qls]
    new_qrs = [torch.empty_like(q) for q in qrs]
    p = _build.ptr_array
    rc = lib.psgd_kron_dd_update(
        L, p(qls), p(qrs), p(dxs), p(dgs), p(new_qls), p(new_qrs), ms, ns,
        float(step), scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, f"{counter} kernel chain")
    hopper.counts[counter] += 1
    hopper.counts["tri"] += 1  # the chain's step (b) is K3
    return new_qls, new_qrs


def fused_update(ql, qr, dx, dg, step):
    """K2: one (dense, dense) layer update. The plain version for CPU
    tensors, the CUDA chain for CUDA tensors. `step` is a Python number."""
    if not hopper.use_kernel(ql):
        return update_plain(ql, qr, dx, dg, step)
    (new_ql,), (new_qr,) = launch([ql], [qr], [dx], [dg], step, "kron_dd")
    return new_ql, new_qr
