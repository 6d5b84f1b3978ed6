"""K12: the dense-family rank-2 update streamed, dense_upd.MAX_N < n <= MAX_N.

Replaces `psgd_tf_tpu/ops/pallas/dense_big.py` `fused_update` (:351) and
`fused_update_apply` (:364) → `_stages` (:230) → its `pallas_call`s at
:272 (`_probe_kernel` :107, a = Q h and b = Q^{-T} v in one row-panel
pass), :290 (`_maxabs_kernel` :152), :317 (`_update_kernel` :169, the
reverse running sums) and :332 (`_update_apply_kernel` :204, plus P' g).

The function is K11's (`dense_upd`), and so are the phases on the card
(`csrc/dense.cu`): K12 launches them as four kernels whatever n (K3's
phases, pass 1, the normalizer, pass 2), K11 as one. This module keeps the
JAX entry points and cap, so the route `dense_big` and its launch count
read as in the JAX package. The plain versions are K11's.
"""
from __future__ import annotations

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper.dense_upd import launch, update_apply_plain, update_plain

# psgd_tf_tpu/ops/pallas/dense_big.py MAX_N: above it the JAX package runs
# the XLA path, and the port the plain version on the device (route 'xla')
MAX_N = 16384

__all__ = ["MAX_N", "fused_update", "fused_update_apply", "update_plain", "update_apply_plain"]


def fused_update(q, v, h, step):
    """Q' for n <= MAX_N: the plain version for CPU tensors, the kernel
    chain for CUDA tensors."""
    if not hopper.use_kernel(q):
        return update_plain(q, v, h, step)
    return launch("dense_big", MAX_N, q, v, h, None, step)[0]


def fused_update_apply(q, v, h, g, step):
    """(Q', P' g) for n <= MAX_N, P' g of the UPDATED Q."""
    if not hopper.use_kernel(q):
        return update_apply_plain(q, v, h, g, step)
    return launch("dense_big", MAX_N, q, v, h, g, step)
