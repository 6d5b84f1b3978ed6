"""psgd_tf_tpu_torch — the PyTorch/CUDA port of psgd_tf_tpu.

It sits beside the JAX package, which stays the reference, and imports
neither JAX nor `psgd_tf_tpu`. This first slice carries the main path:
LeNet5 with (dense, dense) Kronecker preconditioners and exact Hvp, with
the Kronecker factor update as hand-written CUDA kernels for Hopper
(`ops/hopper`, sources in `csrc/`).

Public surface:
  - PSGD: the optimizer (Kronecker branch).
  - hvp: exact (forward-over-reverse) and finite-difference Hvp.
  - kron: the Kronecker family, (dense, dense) pair.
"""
from psgd_tf_tpu_torch import hvp
from psgd_tf_tpu_torch.groups import kron
from psgd_tf_tpu_torch.optim.psgd import PSGD, Hyper, PSGDState

__all__ = ["PSGD", "PSGDState", "Hyper", "hvp", "kron"]
