"""K1: every (dense, dense) layer of a list in one fixed chain of launches.

Replaces `psgd_tf_tpu/ops/pallas/kron_multi.py` `fused_update_multi`
(:222), dd kind. The Pallas kernel runs a whole layer list in one launch
with one batched Newton chain; on Hopper the factors do not fit one
block's shared memory, so the same list goes through the fixed chain of
grouped launches of `csrc/kron_dd.cu`, each launch covering every layer.
The other kinds of the Pallas kernel (ds, nd, ns) come with slice 2.
"""
from __future__ import annotations

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import kron_dd


def fused_update_multi(qls, qrs, dxs, dgs, step):
    """(dense, dense) updates for a list of layers of any sizes; returns
    (new_qls, new_qrs). Per layer identical to `kron_dd.fused_update`. The
    plain version for CPU tensors, the CUDA chain for CUDA tensors, split
    into launches of at most `kron_dd.MAX_LAYERS` layers."""
    if not hopper.use_kernel(qls[0]):
        res = [kron_dd.update_plain(*a, step) for a in zip(qls, qrs, dxs, dgs, strict=True)]
        return [r[0] for r in res], [r[1] for r in res]
    new_qls, new_qrs = [], []
    for i in range(0, len(qls), kron_dd.MAX_LAYERS):
        sl = slice(i, i + kron_dd.MAX_LAYERS)
        nql, nqr = kron_dd.launch(qls[sl], qrs[sl], dxs[sl], dgs[sl], step, "kron_multi")
        new_qls += nql
        new_qrs += nqr
    return new_qls, new_qrs
