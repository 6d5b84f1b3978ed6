"""Whether the model runs under a `torch.func` transform.

The models' hand-written autograd Functions (the NMT's attention, the
Granite scan) serve plain reverse mode, as `hvp.finite_diff` and
`hvp.grad_only` differentiate. Under a transform (`hvp.exact`'s
`torch.func.jvp` over `grad`, or a caller's own `torch.func.grad`) they
would need a forward-mode rule, and the kernels raw storage, which the
transforms' wrapped tensors lack: there the models take their plain ops.
"""
from __future__ import annotations

import torch


def active() -> bool:
    """True inside any `torch.func` transform."""
    return torch._C._are_functorch_transforms_active()
