"""K1: every eligible Kronecker layer of a list, of any kind, in one fixed
chain of launches.

Replaces `psgd_tf_tpu/ops/pallas/kron_multi.py` `fused_update_multi`
(:222), kinds dd, ds, nd and ns. The Pallas kernel runs a whole layer list
in one launch with one batched Newton chain; on Hopper the factors do not
fit one block's shared memory, so the same list goes through the chain of
`csrc/kron_dd.cu`: each stage covers every layer of the list, and K3
inverts every dense factor of every layer. For a list with a
sparse side (`kron_dd.route`) the stages run in one cooperative launch
with grid barriers between them, else as a fixed chain of grouped
launches; the two give the same bits. Mirrors arrive transposed from
`groups/kron.py`, as in the JAX package.
"""
from __future__ import annotations

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import kron_dd, kron_sparse

KINDS = ("dd", "ds", "nd", "ns")
# the plain update of each kind: the CPU path and the oracle of the chain
PLAIN = {"dd": kron_dd.update_plain, **kron_sparse.PLAIN}


def fused_update_multi(kinds, qls, qrs, dxs, dgs, step):
    """Updates for a list of layers; kinds[i] in {dd, ds, nd, ns} with
    (qls[i], qrs[i]) in that kind's layout. Returns a list of (ql', qr').
    Per layer identical to the plain update of its kind. The plain versions
    for CPU tensors, the CUDA chain for CUDA tensors, split into launches
    of at most `kron_dd.MAX_LAYERS` layers. `step` is a Python number."""
    for k in kinds:
        if k not in KINDS:
            raise ValueError(f"kron_multi: unknown kind {k!r}")
    if not hopper.use_kernel(qls[0]):
        return [PLAIN[k](*a, step) for k, *a in zip(kinds, qls, qrs, dxs, dgs, strict=True)]
    nql, nqr = kron_dd.launch_chains(kinds, qls, qrs, [x.contiguous() for x in dxs],
                                     [g.contiguous() for g in dgs], step, "kron_multi")
    return list(zip(nql, nqr))
