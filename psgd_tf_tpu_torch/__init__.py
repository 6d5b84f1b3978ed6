"""psgd_tf_tpu_torch — the PyTorch/CUDA port of psgd_tf_tpu.

It sits beside the JAX package, which stays the reference, and imports
neither JAX nor `psgd_tf_tpu`. It carries the Kronecker family with all
seven format pairs (and its stacked (dense, dense) buckets), the dense,
diag, X-shape (xmat), butterfly (shift), sparse-LU (splu) and low-rank
(lra, UVd) families, exact and finite-difference Hvp, and the six
reference workloads: LeNet5 with (dense, dense) factors, the seq2seq +
attention NMT model with its per-layer mixed formats, Rosenbrock with dense
(hello_psgd), the delayed-XOR RNN with lra, the delayed-XOR LSTM with
(dense, dense) factors (lstm_xor), and the tensor decomposition under
every family (all_preconditioners). The preconditioner updates run as
hand-written CUDA kernels for Hopper (`ops/hopper`, sources in `csrc/`).

Public surface:
  - PSGD: the optimizer (kron, dense, diag, xmat, shift, splu, lra).
  - UVd: the reference's closure-style class API.
  - hvp: exact (forward-over-reverse) and finite-difference Hvp.
  - kron, dense, diag, xmat, shift, splu, lra: the families.
"""
from psgd_tf_tpu_torch import hvp
from psgd_tf_tpu_torch.groups import dense, diag, kron, lra, shift, splu, xmat
from psgd_tf_tpu_torch.optim.psgd import PSGD, Hyper, PSGDState
from psgd_tf_tpu_torch.optim.uvd import UVd

__all__ = ["PSGD", "PSGDState", "Hyper", "UVd", "hvp", "kron", "dense", "diag", "xmat",
           "shift", "splu", "lra"]
