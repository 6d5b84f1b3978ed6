"""K15: the sparse-LU family's update with the fused apply, resident regime.

Replaces `psgd_tf_tpu/ops/pallas/splu_one.py` `fused_update` (:309) →
`_call` (:223) → `pallas_call` (:286, `_kernel` :77), which holds the
whole state in VMEM and in one launch computes the balance, the packed
tail Gram, the four r x r corner solves, the rank-space vectors, the tail
images, both exact max|grad| normalizers, the factor rewrites and, with
`g`, P' g of the updated state through a second Gram.

The state at the JAX bench's n = 65,536 (r = 10) is ~5.2 MB, far past a
Hopper block's 227 KB of shared memory, so the counterpart is K16's fixed
chain of launches (`splu_upd`, `csrc/splu.cu`) with the apply's corner
kernel and tail pass after it, and no host sync: the corner algebra runs
in single-warp kernels on the device, not as torch ops on the host. The
TPU-only mechanics (Newton-inverted blocks, 128-lane padding,
identity-padded corners, the VMEM budget) are not copied; `fits` keeps
the VMEM cap only as the route between K15 and K16, so routes and launch
counts read as in the JAX package. One difference from the Pallas kernel:
its step scale `step / (max + tiny)` saturates here at the fp32 max
(`linalg.step_scale`), as the JAX package's XLA path does.
"""
from __future__ import annotations

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
    """One update: (Lt', l3', U12', u3'). The plain chain for CPU tensors,
    the kernels for CUDA tensors (`splu_upd.run`)."""
    return splu_upd.run("splu_one", Lt, l3, U12, u3, v, h, step)[:4]


def fused_update_apply(Lt, l3, U12, u3, v, h, g, step):
    """One update and P' g of the UPDATED state: (Lt', l3', U12', u3', P' g)."""
    return splu_upd.run("splu_one", Lt, l3, U12, u3, v, h, step, g)
