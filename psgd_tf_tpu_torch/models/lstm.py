"""Hand-rolled LSTM for the delayed-XOR task.

Counterpart of `psgd_tf_tpu/models/lstm.py`, in PSGD matrix form: the cell
state joins the input features (`[x, h, c] @ W1[:-1] + W1[-1]`), the forget
gate gets a bias of +1.0, and the readout is one (hidden + 1, out) matrix
on the final hidden state, the bias as the last row of each. Two PSGD
matrices: (in + 2*hidden + 1, 4*hidden) and (hidden + 1, out). The JAX
model's `lax.scan` over time is a Python loop over T here.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.data.xor import logistic_loss


def layer_shapes(dim_in: int = 2, dim_hidden: int = 30, dim_out: int = 1):
    return [
        (dim_in + 2 * dim_hidden + 1, 4 * dim_hidden),
        (dim_hidden + 1, dim_out),
    ]


def init(generator: torch.Generator, dim_in: int = 2, dim_hidden: int = 30, dim_out: int = 1,
         dtype=torch.float32) -> list[torch.Tensor]:
    """W ~ 0.1 * N(0, 1), on the generator's device."""
    return [0.1 * torch.randn(s, generator=generator, dtype=dtype, device=generator.device)
            for s in layer_shapes(dim_in, dim_hidden, dim_out)]


def apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: (batch, T, dim_in) -> logits (batch, dim_out)."""
    w1, w2 = params
    hidden = w2.shape[0] - 1
    h = x.new_zeros(x.shape[0], hidden)
    c = x.new_zeros(x.shape[0], hidden)
    for t in range(x.shape[1]):
        ifgo = torch.cat([x[:, t], h, c], dim=1) @ w1[:-1] + w1[-1]
        i = torch.sigmoid(ifgo[:, :hidden])
        f = torch.sigmoid(ifgo[:, hidden:2 * hidden] + 1.0)
        g = torch.tanh(ifgo[:, 2 * hidden:3 * hidden])
        o = torch.sigmoid(ifgo[:, 3 * hidden:])
        c = f * c + i * g
        h = o * torch.tanh(c)
    return h @ w2[:-1] + w2[-1]


def loss(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Logistic loss -mean log sigmoid(y * logit), y in {-1, +1}."""
    return logistic_loss(apply(params, x), y)
