"""The delayed-XOR sequence task.

Counterpart of `psgd_tf_tpu/data/xor.py`. Each sequence of length T has two
input channels: channel 0 a random ±1 stream, channel 1 zero except at two
marker positions (the first in [0, T/10), the second in [T/10, T/2)). The
label is -1 when the two marked values agree and +1 when they differ.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def batch(generator: torch.Generator, batch_size: int = 128, seq_len: int = 100,
          dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, y) on the generator's device: x (batch, T, 2), y (batch, 1) in
    {-1, +1}. An empty marker window (T < 10) gives position 0, as
    `jax.random.randint` does."""
    dev = generator.device
    bits = torch.where(torch.rand(batch_size, seq_len, generator=generator, device=dev) < 0.5,
                       1.0, -1.0).to(dtype)
    lo, mid, hi = 0, seq_len // 10, seq_len // 2
    i = torch.randint(lo, max(mid, lo + 1), (batch_size,), generator=generator, device=dev)
    j = torch.randint(mid, max(hi, mid + 1), (batch_size,), generator=generator, device=dev)
    pos = torch.arange(seq_len, device=dev)[None, :]
    marks = (pos == i[:, None]).to(dtype) + (pos == j[:, None]).to(dtype)
    x = torch.stack([bits, marks], dim=-1)
    bit_i = torch.gather(bits, 1, i[:, None])[:, 0]
    bit_j = torch.gather(bits, 1, j[:, None])[:, 0]
    y = torch.where(bit_i == bit_j, -1.0, 1.0).to(dtype)[:, None]
    return x, y


def logistic_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """-mean log sigmoid(y * logit), y in {-1, +1}, in the softplus form
    (`log1p(exp(z))` overflows fp32 past z ~ 88)."""
    return torch.mean(F.softplus(-y * logits))
