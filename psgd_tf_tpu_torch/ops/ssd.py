"""Mamba-2's state-space scan in its chunked form (SSD, the state-space
duality of Dao and Gu, 2024), in plain torch.

Per head, with the state h_t (P, N), the step's decay a_t = exp(dt_t A)
and one group of B and C shared by every head (as Granite-4.0-H has it):

  h_t = a_t h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t

so that  y_t = sum_{s <= t} exp(sum_{s < k <= t} dt_k A) (C_t . B_s) dt_s x_s.

The chunked form cuts the sequence into chunks of Q positions (zero-padded
at the end; a padded position has dt = 0, so it neither decays nor feeds
the state). Inside a chunk the sum is a masked (Q, Q) product, the
quadratic dual form; each chunk's end state is formed from its positions,
and the states are passed from chunk to chunk by their summed decays.
Every exponent is a sum formed over its own positions (`segsum`, the
cumulative sums from a chunk's start, and `_suffix`), never a difference
of two long prefix sums, which would cancel in float32 when dt A is large.

Shapes: x (b, L, H, P), dt (b, L, H) (after the softplus), A (H,)
(negative), B and C (b, L, N); y (b, L, H, P).

`scan` is what the model calls. In plain reverse mode it is an autograd
Function that keeps only its inputs: its backward recomputes the chunked
forward under `torch.func.vjp`, so the (Q, Q) decays and products (two of
268 MB a layer at 2 x 2,048 tokens, 64 heads) are not held between the
passes. Under a `torch.func` transform (`hvp.exact`'s jvp, which the
Function has no rule for; `utils.transforms`) the plain function runs.
Either way the scan runs inside a `model_ssd` span, and its backward too
while a profiler records (`utils.profiling.region`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from psgd_tf_tpu_torch.utils import transforms
from psgd_tf_tpu_torch.utils.profiling import region


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): entry [i, j] = sum_{j < k <= i} a_k for
    j <= i (0 on the diagonal), -inf above it. Each entry is summed over
    its own positions."""
    t = a.shape[-1]
    strict = torch.ones(t, t, dtype=torch.bool, device=a.device).tril(-1)
    s = a[..., None].expand(*a.shape, t).masked_fill(~strict, 0.0).cumsum(dim=-2)
    return s.masked_fill(~torch.ones(t, t, dtype=torch.bool, device=a.device).tril(), -torch.inf)


def _suffix(a: torch.Tensor) -> torch.Tensor:
    """(..., Q): entry t = sum_{k > t} a_k, summed from the chunk's end."""
    tail = a[..., 1:].flip(-1).cumsum(-1).flip(-1)
    return F.pad(tail, (0, 1))


def chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, chunk: int) -> torch.Tensor:
    """y of the scan by the chunked algorithm (shapes in the module's
    docstring)."""
    b, length, h, p = x.shape
    n = B.shape[-1]
    pad = -length % chunk
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, B, C))
    c = x.shape[1] // chunk
    xd = (x * dt[..., None]).reshape(b, c, chunk, h, p)         # dt_s x_s
    da = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (b, h, c, Q): dt A
    Bc, Cc = B.reshape(b, c, chunk, n), C.reshape(b, c, chunk, n)

    # inside each chunk: (L o C B^T) dt x
    cb = Cc @ Bc.transpose(-1, -2)                              # (b, c, Q, Q)
    m = torch.exp(segsum(da)) * cb[:, None]                     # (b, h, c, Q, Q)
    y = torch.einsum("bhcij,bcjhp->bcihp", m, xd)

    # each chunk's end state from its own positions: (b, c, N, H P)
    w = torch.exp(_suffix(da)).permute(0, 2, 3, 1)[..., None]   # (b, c, Q, h, 1)
    states = Bc.transpose(-1, -2) @ (xd * w).reshape(b, c, chunk, h * p)

    # the state entering each chunk, passed by the chunks' summed decays
    total = da.sum(-1)                                          # (b, h, c)
    decay = torch.exp(segsum(F.pad(total, (1, 0))))             # (b, h, c + 1, c + 1)
    states = torch.cat([states.new_zeros(b, 1, n, h * p), states], dim=1)
    states = states.reshape(b, c + 1, n, h, p)
    entering = torch.einsum("bhzc,bcnhp->bznhp", decay[:, :, :-1], states)

    # the entering state's part of each position's output
    start = torch.exp(da.cumsum(-1)).permute(0, 2, 3, 1)[..., None]  # (b, c, Q, h, 1)
    y_off = (Cc @ entering.reshape(b, c, n, h * p)).reshape(b, c, chunk, h, p)
    y = (y + y_off * start).reshape(b, c * chunk, h, p)
    return y[:, :length] if pad else y


class _Scan(torch.autograd.Function):
    """`chunked` with a backward that recomputes it from the inputs."""

    @staticmethod
    def forward(x, dt, A, B, C, chunk):
        return chunked(x, dt, A, B, C, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:5])
        ctx.chunk = inputs[5]

    @staticmethod
    def backward(ctx, dy):
        _, vjp = torch.func.vjp(lambda *a: chunked(*a, ctx.chunk), *ctx.saved_tensors)
        return (*vjp(dy), None)


def scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
         C: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """y (b, L, H, P) of the scan (the module's docstring), chunk by chunk."""
    fn = chunked if transforms.active() else _Scan.apply
    return region("model_ssd", fn, x, dt, A, B, C, chunk)
