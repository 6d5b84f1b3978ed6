"""LeNet5 CNN in PSGD matrix layout.

Counterpart of `psgd_tf_tpu/models/lenet5.py`: five weight matrices of
shape (fan_in + 1, fan_out) with the bias as the last row, in the JAX
layout. Architecture: conv5x5(6) -> maxpool2 -> relu -> conv5x5(16) ->
maxpool2 -> relu -> fc120 -> fc84 -> fc10, all VALID padding.

Layout at the public functions is the JAX package's: images NHWC
(batch, 28, 28, 1), conv rows in (h, w, cin) order, and the flatten before
fc1 in (h, w, c) order. Inside, the convolutions run NCHW with OIHW
kernels, and the activations are permuted back to NHWC before the flatten.

Max-pooling is two `amax` reductions over a reshape, w-pair first and then
h-pair, as the JAX model takes two `jnp.max`: both split the derivative
evenly among ties, level by level. `F.max_pool2d` would route the whole
gradient to one index, and after the ReLU of layer 1 ties are common.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LAYER_SHAPES = [
    (5 * 5 * 1 + 1, 6),
    (5 * 5 * 6 + 1, 16),
    (4 * 4 * 16 + 1, 120),
    (120 + 1, 84),
    (84 + 1, 10),
]


def init(generator: torch.Generator, dtype=torch.float32) -> list[torch.Tensor]:
    """W ~ 0.1 * N(0, 1), on the generator's device."""
    return [
        0.1 * torch.randn(s, generator=generator, dtype=dtype, device=generator.device)
        for s in LAYER_SHAPES
    ]


def _conv(x: torch.Tensor, w: torch.Tensor, hw: int, cin: int, cout: int) -> torch.Tensor:
    kernel = w[:-1].reshape(hw, hw, cin, cout).permute(3, 2, 0, 1)  # HWIO -> OIHW
    return F.conv2d(x, kernel) + w[-1][None, :, None, None]


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.amax(dim=5).amax(dim=3)


def apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: (batch, 28, 28, 1) NHWC -> logits (batch, 10)."""
    w1, w2, w3, w4, w5 = params
    x = x.permute(0, 3, 1, 2)
    x = torch.relu(_maxpool2(_conv(x, w1, 5, 1, 6)))
    x = torch.relu(_maxpool2(_conv(x, w2, 5, 6, 16)))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], 4 * 4 * 16)  # (h, w, c) order
    x = torch.relu(x @ w3[:-1] + w3[-1])
    x = torch.relu(x @ w4[:-1] + w4[-1])
    return x @ w5[:-1] + w5[-1]


def loss(params, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy."""
    logp = torch.log_softmax(apply(params, x), dim=1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None]))


def error_rate(params, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Classification error fraction."""
    return torch.mean((torch.argmax(apply(params, x), dim=1) != labels).float())


class LeNet5(nn.Module):
    """The five (fan_in + 1, fan_out) matrices as parameters; `forward` is
    `apply` on them. The optimizer works on `list(model.weights)`."""

    def __init__(self, generator: torch.Generator, dtype=torch.float32):
        super().__init__()
        self.weights = nn.ParameterList(init(generator, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply(list(self.weights), x)
