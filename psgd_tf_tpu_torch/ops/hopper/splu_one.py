"""K15: the sparse-LU family's update with the fused apply, resident regime.

Replaces `psgd_tf_tpu/ops/pallas/splu_one.py` `fused_update` (:309) →
`_call` (:223) → `pallas_call` (:286, `_kernel` :77), which holds the
whole state in VMEM and in one launch computes the balance, the packed
tail Gram, the four r x r corner solves, the rank-space vectors, the tail
images, both exact max|grad| normalizers, the factor rewrites and, with
`g`, P' g of the updated state through a second Gram.

Here it is one launch too (`splu_upd.launch_mono`, `csrc/splu.cu`'s
one-launch kernels), with or without g, at every rank: the sparse-LU
chain's stage and corner bodies between barriers, its partials in a
scratch that the 50 MB L2 holds at these sizes (the state is ~5.2 MB at
the JAX bench's n = 65,536, r = 10, and at most ~14 MB where `fits`
holds), its result equal to the chain's (`splu_upd.launch`) bit for bit.
The barrier is the host's pick by the work's size: a thread-block
cluster (one CTA at one block of work), or a cooperative grid
(`splu_upd.launch_mono(..., schedule=...)` forces one).
The corner algebra runs on the device, not as torch ops on the host. The
TPU-only mechanics (Newton-inverted blocks, 128-lane padding,
identity-padded corners, the VMEM budget) are not copied; `fits` keeps
the VMEM cap only as the route between K15 and K16, so routes read as in
the JAX package. One difference from the Pallas kernel: its step scale
`step / (max + tiny)` saturates here at the fp32 max
(`linalg.step_scale`), as the JAX package's XLA path does.
"""
from __future__ import annotations

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import splu_upd

# psgd_tf_tpu/ops/pallas/splu_one.py: its VMEM cap, kept as the route
SUB = 8                    # fp32 sublane quantum
LANE = 128
VMEM_BUDGET = 72 * 2**20


def fits(r: int, n: int) -> bool:
    """The JAX package's cap (`splu_one.fits`): True when the resident
    kernel's working set fits its VMEM budget (n up to ~92k at r = 10)."""
    rp = max(SUB, -(-r // SUB) * SUB)
    ntp = -(-max(n - r, 1) // LANE) * LANE
    return (11 * rp + 28) * ntp * 4 <= VMEM_BUDGET


def fused_update(Lt, l3, U12, u3, v, h, step):
    """One update: (Lt', l3', U12', u3'). The plain chain for CPU tensors
    and inside `hopper.disabled()`, one launch for CUDA tensors."""
    if not hopper.use_kernel(Lt):
        return splu_upd.chain_plain(Lt, l3, U12, u3, v, h, step)[:4]
    return splu_upd.launch_mono("splu_one", Lt, l3, U12, u3, v, h, step)[:4]


def fused_update_apply(Lt, l3, U12, u3, v, h, g, step):
    """One update and P' g of the UPDATED state: (Lt', l3', U12', u3', P' g)."""
    if not hopper.use_kernel(Lt):
        return splu_upd.chain_plain(Lt, l3, U12, u3, v, h, step, g)
    return splu_upd.launch_mono("splu_one", Lt, l3, U12, u3, v, h, step, g)
