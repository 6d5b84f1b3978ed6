"""psgd_tf_tpu_torch — the PyTorch/CUDA port of psgd_tf_tpu.

It sits beside the JAX package, which stays the reference, and imports
neither JAX nor `psgd_tf_tpu`. It carries the Kronecker family with all
seven format pairs, exact and finite-difference Hvp, and two workloads:
LeNet5 with (dense, dense) factors, and the seq2seq + attention NMT model
with its per-layer mixed formats. The Kronecker factor updates run as
hand-written CUDA kernels for Hopper (`ops/hopper`, sources in `csrc/`).

Public surface:
  - PSGD: the optimizer (Kronecker branch).
  - hvp: exact (forward-over-reverse) and finite-difference Hvp.
  - kron: the Kronecker family, all seven format pairs.
"""
from psgd_tf_tpu_torch import hvp
from psgd_tf_tpu_torch.groups import kron
from psgd_tf_tpu_torch.optim.psgd import PSGD, Hyper, PSGDState

__all__ = ["PSGD", "PSGDState", "Hyper", "hvp", "kron"]
