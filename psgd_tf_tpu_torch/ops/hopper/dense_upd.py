"""K11: the dense-family rank-2 update, n <= MAX_N (`csrc/dense.cu`).

Replaces `psgd_tf_tpu/ops/pallas/dense_upd.py` `fused_update` (:136) and
`fused_update_apply` (:149) → `_call` (:90) → `pallas_call` (:116,
`_kernel` :39). For Q (n, n) upper triangular:

  a = Q h,  b = Q^{-T} v,  G = triu(a a^T - b b^T)
  Q' = Q - step / (max|G| + tiny) * G Q,  and optionally P' g = Q'^T Q' g

The TPU kernel holds Q resident in VMEM up to MAX_N = 1536 (9.4 MB), far
past a Hopper block's 227 KB of shared memory, so on the card K11 and K12
(`dense_big`) run the same streaming chain of `csrc/dense.cu`. The two
entry points and the JAX caps stay, so routes and launch counts read as
in the JAX package. No padding: the chain masks the ragged edge, which
gives what the TPU kernel's identity extension gives. One difference from
the Pallas kernel: the step scale saturates at the fp32 max
(`linalg.step_scale`), so a zero gradient gives a zero update, not NaN.

The plain versions here are the JAX package's XLA path (the rank-2 reverse
cumsum form); the wrappers take them for CPU tensors, and on a CUDA tensor
launch the kernel or raise.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.ops import hopper, linalg
from psgd_tf_tpu_torch.ops.hopper import _build, tri

# psgd_tf_tpu/ops/pallas/dense_upd.py MAX_N: the JAX package's VMEM cap,
# kept as the routing cap between K11 and K12
MAX_N = 1536
PANEL = 128  # DP in csrc/dense.cu: rows of a panel, the side of a diagonal block


def update_plain(q, v, h, step):
    """Q' by the rank-2 form: O(n^2), no n x n gradient."""
    a = q @ h
    b = linalg.solve_ut_t(q, v)
    step0 = linalg.step_scale(step, linalg.triu_outer_diff_maxabs(a, b), q.dtype)
    return q - step0 * linalg.triu_outer_diff_matmul(a, b, q)


def update_apply_plain(q, v, h, g, step):
    """(Q', P' g) with P' g = Q'^T (Q' g) of the updated Q."""
    new_q = update_plain(q, v, h, step)
    return new_q, new_q.T @ (new_q @ g)


def launch(name: str, cap: int, q, v, h, g, step):
    """The chain of `csrc/dense.cu` on CUDA tensors: (Q', P' g or None).
    Counts one launch of `name` and one of K3 for every MAX_FACTORS of the
    chain's diagonal blocks (it inverts them in batches of that many)."""
    n = q.shape[0]
    if n > cap:
        raise ValueError(f"{name}: n = {n} exceeds its cap {cap}")
    vecs = [v, h] + ([g] if g is not None else [])
    if q.shape != (n, n) or any(x.shape != (n,) for x in vecs):
        raise ValueError(f"{name}: operand shapes do not agree")
    hopper.check_operands(name, q, *vecs)
    lib = _build.lib()
    new_q = torch.empty_like(q)
    pre = torch.empty_like(v) if g is not None else None
    scratch = torch.empty(lib.psgd_dense_scratch_floats(n), dtype=torch.float32, device=q.device)
    rc = lib.psgd_dense_update(
        n, q.data_ptr(), v.data_ptr(), h.data_ptr(), g.data_ptr() if g is not None else None,
        float(step), new_q.data_ptr(), pre.data_ptr() if pre is not None else None,
        scratch.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, f"{name} kernel chain")
    hopper.counts[name] += 1
    panels = (n + PANEL - 1) // PANEL
    hopper.counts["tri"] += (panels + tri.MAX_FACTORS - 1) // tri.MAX_FACTORS
    return new_q, pre


def fused_update(q, v, h, step):
    """Q' for n <= MAX_N: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if not hopper.use_kernel(q):
        return update_plain(q, v, h, step)
    return launch("dense_upd", MAX_N, q, v, h, None, step)[0]


def fused_update_apply(q, v, h, g, step):
    """(Q', P' g) for n <= MAX_N, P' g of the UPDATED Q."""
    if not hopper.use_kernel(q):
        return update_apply_plain(q, v, h, g, step)
    return launch("dense_upd", MAX_N, q, v, h, g, step)
