"""Simple RNN for the delayed-XOR task.

Counterpart of `psgd_tf_tpu/models/rnn.py`, in PSGD matrix form: W_rnn is
(dim_in + hidden + 1, hidden) with tanh, W_fc is (hidden + 1, dim_out), the
bias as the last row of each. The JAX model's `lax.scan` over time is a
Python loop over T here.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.data.xor import logistic_loss


def init(generator: torch.Generator, dim_in: int = 2, hidden: int = 30, dim_out: int = 1,
         dtype=torch.float32) -> list[torch.Tensor]:
    """On the generator's device: the input kernel glorot-uniform / 3, the
    recurrent kernel orthogonal (QR of a square normal, signs fixed by the
    diagonal of R), the fc kernel glorot-uniform / 3, biases 0."""
    f = dict(generator=generator, dtype=dtype, device=generator.device)

    def uniform(shape, lim):
        return (2.0 * torch.rand(shape, **f) - 1.0) * lim

    w_in = uniform((dim_in, hidden), (6.0 / (dim_in + hidden)) ** 0.5 / 3.0)
    q, r = torch.linalg.qr(torch.randn(hidden, hidden, **f))
    w_rec = q * torch.sign(torch.diagonal(r))[None, :]
    w_rnn = torch.cat([w_in, w_rec, torch.zeros(1, hidden, dtype=dtype, device=generator.device)])
    w_fc = torch.cat([uniform((hidden, dim_out), (6.0 / (hidden + dim_out)) ** 0.5 / 3.0),
                      torch.zeros(1, dim_out, dtype=dtype, device=generator.device)])
    return [w_rnn, w_fc]


def apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: (batch, T, dim_in) -> logits (batch, dim_out)."""
    w_rnn, w_fc = params
    h = x.new_zeros(x.shape[0], w_fc.shape[0] - 1)
    for t in range(x.shape[1]):
        h = torch.tanh(torch.cat([x[:, t], h], dim=1) @ w_rnn[:-1] + w_rnn[-1])
    return h @ w_fc[:-1] + w_fc[-1]


def loss(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Logistic loss, y in {-1, +1}."""
    return logistic_loss(apply(params, x), y)
