"""The NMT decoder's additive attention over the encoder states
(`csrc/attention.cu`): a forward and a backward launch a decoder position,
and the encoder states' gradient formed once a backward pass.

Replaces no kernel of `psgd_tf_tpu/ops/pallas/`: the JAX package leaves the
model's attention to XLA, which fuses it inside the decoder's `lax.scan`.
Run eagerly by PyTorch, the same ops read the encoder states `enc`
(B, S, U) twice a position in the forward, and autograd writes two
enc-sized gradients a position in the backward and sums them, for under 2%
of the model's FLOPs (PERF.md, section 6). These kernels read `enc`
once a position in each direction and write its gradient once a pass.

For one position, with hw = h W_h (B, A) and the hoisted ow = enc W_o
(B, S, A), both plain products:

  score = tanh(hw + ow) v, masked to -inf;  w = softmax_S(score)
  ctx   = sum_s w_s enc[:, s, :]

and in the backward, from d ctx:

  dw = enc . d ctx;  ds = w (dw - sum_s w dw), zero where masked
  g  = ds v (1 - tanh^2):  d ow = g,  d hw = sum_s g,  d v = sum_{b,s} ds tanh

`enc`'s gradient is not formed a position. The backward stores d ctx in
the pass's `Stash` beside the weights its forward stored, and once every
position has run, `enc_grad` writes

  d enc[b, s, :] = sum_t w_t[b, s] d ctx_t[b, :] + d ow[b, s, :] W_o^T

in one launch, d ow summed over the positions by autograd.

What bounds each launch on the card: bytes. The forward reads `enc` once
(302 MB at the benchmark's 4,096 x 18 x 1,024: 0.090 ms at 3.35 TB/s), the
backward reads it once more, and `enc_grad` reads the stashed d ctx
(B, T, U) and writes d enc (B, S, U) once. A block takes one batch row:
the row's scores and softmax in its threads, then the row's S x U slab
streamed once, in 16-byte loads where U and the strides allow. Every sum
runs in a fixed order, d v's over the rows in a second launch, so reruns
are bit-equal. The kernels take any B, S >= 1 and U, and A <= A_MAX (one
warp lane an attention unit); past it the wrappers raise.

`project` and `step` are the autograd Functions the model calls.
`_Project`'s backward runs after every position's, since each position
consumes its output `ow`, so the stash is full by then. Both serve plain
reverse mode: under a `torch.func` transform the model takes the plain
ops (`models/nmt.py`, `utils.transforms`). On CPU tensors the wrappers
run their plain versions inside the same Functions, so the CPU tests hold
the structure to the plain ops; on a CUDA tensor they launch the kernels
or raise.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import _build

A_MAX = 32  # ATTN_A_MAX in csrc/attention.cu: attention units, one warp lane each


# ---------------------------------------------------------------- plain versions


def attend_plain(hw, ow, v, mask, enc):
    """(ctx (B, U), softmax weights (B, S)): the model's plain attention ops."""
    score = torch.tanh(hw[:, None, :] + ow) @ v
    weights = torch.softmax(torch.where(mask, score, -torch.inf), dim=1)
    return torch.einsum("bs,bsu->bu", weights, enc), weights


def attend_backward_plain(dctx, enc, weights, hw, ow, v, mask):
    """(d hw (B, A), d ow (B, S, A), d v (A,)) of one position, no d enc."""
    dw = torch.einsum("bsu,bu->bs", enc, dctx)
    ds = torch.where(mask, weights * (dw - (weights * dw).sum(dim=1, keepdim=True)), 0.0)
    th = torch.tanh(hw[:, None, :] + ow)
    g = ds[..., None] * v * (1.0 - th * th)
    return g.sum(dim=1), g, torch.einsum("bs,bsa->a", ds, th)


def enc_grad_plain(weights, dctx, d_ow, w_enc):
    """d enc (B, S, U) from every position's weights (B, T, S) and d ctx
    (B, T, U), and the summed d ow (B, S, A) through W_o (U, A)."""
    return torch.einsum("bts,btu->bsu", weights, dctx) + d_ow @ w_enc.T


# ---------------------------------------------------------------- kernels


def _check_attn(name: str, hw, ow, v, mask, enc) -> tuple[int, int, int, int]:
    b, s, u = enc.shape
    a = hw.shape[1]
    if a > A_MAX:
        raise ValueError(f"{name}: {a} attention units exceed the kernels' limit A_MAX = {A_MAX}")
    if s < 1 or hw.shape != (b, a) or ow.shape != (b, s, a) or v.shape != (a,) \
            or mask.shape != (b, s):
        raise ValueError(f"{name}: operand shapes do not agree")
    if mask.dtype != torch.bool or not mask.is_contiguous() or mask.device != enc.device:
        raise ValueError(f"{name}: the mask must be a contiguous bool tensor on enc's device")
    hopper.check_operands(name, hw, ow, v, enc)
    return b, s, u, a


def _check_rows(name: str, x: torch.Tensor, shape: tuple, like: torch.Tensor) -> None:
    """A (rows, n) fp32 view with unit column stride on `like`'s device."""
    if x.shape != shape or x.stride(1) != 1 or x.dtype != torch.float32 or x.device != like.device:
        raise ValueError(f"{name}: expected a float32 {shape} view with unit column stride on "
                         f"{like.device}, got {x.dtype} {tuple(x.shape)} strides {x.stride()}")


def _vec4(u: int, *tensors: torch.Tensor) -> int:
    """1 when rows of U floats move as float4: U, the row strides and the
    addresses of every (rows, U) operand multiples of 4 floats."""
    ok = u % 4 == 0
    for x in tensors:
        ok = ok and x.data_ptr() % 16 == 0 and all(st % 4 == 0 for st in x.stride()[:-1])
    return int(ok)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def attend(hw, ow, v, mask, enc, weights_out):
    """ctx (B, U) of one position; its softmax weights go into `weights_out`
    (B, S), a view with unit column stride (a slot of the stash)."""
    if not hopper.use_kernel(enc):
        ctx, weights = attend_plain(hw, ow, v, mask, enc)
        weights_out.copy_(weights)
        return ctx
    b, s, u, a = _check_attn("attn_fwd", hw, ow, v, mask, enc)
    _check_rows("attn_fwd", weights_out, (b, s), enc)
    ctx = torch.empty((b, u), dtype=enc.dtype, device=enc.device)
    rc = _build.lib().psgd_attn_forward(
        b, s, u, a, hw.data_ptr(), ow.data_ptr(), v.data_ptr(), mask.data_ptr(), enc.data_ptr(),
        weights_out.data_ptr(), weights_out.stride(0), ctx.data_ptr(), _vec4(u, enc, ctx),
        _stream(enc))
    _build.check(rc, "attn_fwd kernel")
    hopper.counts["attn_fwd"] += 1
    return ctx


def attend_backward(dctx, enc, weights, hw, ow, v, mask, dctx_out):
    """(d hw, d ow, d v) of one position from d ctx (B, U), which is copied
    into `dctx_out` (B, U), a slot of the stash; `weights` (B, S) is the
    slot its forward filled. Both slots are views with unit column stride."""
    if not hopper.use_kernel(enc):
        dctx_out.copy_(dctx)
        return attend_backward_plain(dctx, enc, weights, hw, ow, v, mask)
    b, s, u, a = _check_attn("attn_bwd", hw, ow, v, mask, enc)
    if dctx.stride(1) != 1:
        dctx = dctx.contiguous()
    _check_rows("attn_bwd", dctx, (b, u), enc)
    _check_rows("attn_bwd", weights, (b, s), enc)
    _check_rows("attn_bwd", dctx_out, (b, u), enc)
    new = lambda *shape: torch.empty(shape, dtype=enc.dtype, device=enc.device)
    d_hw, d_ow, d_v, dw, part = new(b, a), new(b, s, a), new(a), new(b, s), new(b, a)
    rc = _build.lib().psgd_attn_backward(
        b, s, u, a, dctx.data_ptr(), dctx.stride(0), enc.data_ptr(), weights.data_ptr(),
        weights.stride(0), hw.data_ptr(), ow.data_ptr(), v.data_ptr(), mask.data_ptr(),
        dctx_out.data_ptr(), dctx_out.stride(0), dw.data_ptr(), d_hw.data_ptr(), d_ow.data_ptr(),
        part.data_ptr(), d_v.data_ptr(), _vec4(u, enc, dctx, dctx_out), _stream(enc))
    _build.check(rc, "attn_bwd kernels")
    hopper.counts["attn_bwd"] += 1
    return d_hw, d_ow, d_v


def enc_grad(weights, dctx, d_ow, w_enc):
    """d enc (B, S, U) in one launch (see the module's docstring)."""
    if not hopper.use_kernel(d_ow):
        return enc_grad_plain(weights, dctx, d_ow, w_enc)
    d_ow, w_enc = d_ow.contiguous(), w_enc.contiguous()
    b, t, s = weights.shape
    u, a = w_enc.shape
    if a > A_MAX:
        raise ValueError(f"attn_enc_grad: {a} attention units exceed the kernels' limit "
                         f"A_MAX = {A_MAX}")
    if dctx.shape != (b, t, u) or d_ow.shape != (b, s, a):
        raise ValueError("attn_enc_grad: operand shapes do not agree")
    hopper.check_operands("attn_enc_grad", weights, dctx, d_ow, w_enc)
    w_t = w_enc.T.contiguous()  # (A, U): W_o^T's rows stream in like d ctx's
    d_enc = torch.empty((b, s, u), dtype=dctx.dtype, device=dctx.device)
    rc = _build.lib().psgd_attn_enc_grad(
        b, t, s, u, a, weights.data_ptr(), dctx.data_ptr(), d_ow.data_ptr(), w_t.data_ptr(),
        d_enc.data_ptr(), _vec4(u, dctx, w_t, d_enc), _stream(dctx))
    _build.check(rc, "attn_enc_grad kernel")
    hopper.counts["attn_enc_grad"] += 1
    return d_enc


# ---------------------------------------------------------------- autograd


class Stash:
    """One forward pass's record for `enc`'s deferred gradient: every
    position's softmax weights (B, T, S), filled by its forward, and its
    d ctx (B, T, U), filled by its backward."""

    def __init__(self, positions: int):
        self.positions = positions
        self.weights: torch.Tensor | None = None
        self.dctx: torch.Tensor | None = None
        self.done: set[int] = set()


def _project_backward(stash, needs, d_ow, enc, w_enc):
    d_enc = d_w = None
    if needs[0]:
        if len(stash.done) != stash.positions:
            raise RuntimeError(
                f"attention: enc's gradient needs all {stash.positions} positions' backward "
                f"first, {len(stash.done)} ran")
        d_enc = enc_grad(stash.weights, stash.dctx, d_ow, w_enc)
        # the stashed d ctx (B, T, U) is spent: free it now, not with the
        # graph; a second backward (retain_graph) fills a new one
        stash.dctx, stash.done = None, set()
    if needs[1]:
        d_w = enc.reshape(-1, enc.shape[-1]).T @ d_ow.reshape(-1, d_ow.shape[-1])
    return d_enc, d_w


def _step_backward(stash, t, dctx, hw, ow, v, mask, enc):
    if stash.dctx is None:
        stash.dctx = dctx.new_empty((enc.shape[0], stash.positions, enc.shape[2]))
    out = attend_backward(dctx, enc, stash.weights[:, t], hw, ow, v, mask, stash.dctx[:, t])
    stash.done.add(t)
    return out


class _Project(torch.autograd.Function):
    """ow = enc W_o, formed once a pass; its backward also forms d enc."""

    @staticmethod
    def forward(enc, w_enc, stash):
        return enc @ w_enc

    @staticmethod
    def setup_context(ctx, inputs, output):
        enc, w_enc, stash = inputs
        ctx.save_for_backward(enc, w_enc)
        ctx.stash = stash

    @staticmethod
    def backward(ctx, d_ow):
        enc, w_enc = ctx.saved_tensors
        needs = ctx.needs_input_grad[:2]
        return (*_project_backward(ctx.stash, needs, d_ow, enc, w_enc), None)


class _Step(torch.autograd.Function):
    """ctx of position t; its backward returns no gradient for enc."""

    @staticmethod
    def forward(hw, ow, v, mask, enc, stash, t):
        if stash.weights is None:
            stash.weights = enc.new_empty((enc.shape[0], stash.positions, enc.shape[1]))
        return attend(hw, ow, v, mask, enc, stash.weights[:, t])

    @staticmethod
    def setup_context(ctx, inputs, output):
        hw, ow, v, mask, enc, stash, t = inputs
        ctx.save_for_backward(hw, ow, v, mask, enc)
        ctx.stash, ctx.t = stash, t

    @staticmethod
    def backward(ctx, dctx):
        d_hw, d_ow, d_v = _step_backward(ctx.stash, ctx.t, dctx, *ctx.saved_tensors)
        return d_hw, d_ow, d_v, None, None, None, None


def project(enc: torch.Tensor, w_enc: torch.Tensor, stash: Stash) -> torch.Tensor:
    """ow = enc @ w_enc (B, S, A), once a forward pass."""
    return _Project.apply(enc, w_enc, stash)


def step(hw, ow, v, mask, enc, stash: Stash, t: int) -> torch.Tensor:
    """Position t's context (B, U) from hw (B, A), ow (B, S, A), v (A,), the
    bool mask (B, S) and enc (B, S, U)."""
    return _Step.apply(hw, ow, v, mask, enc, stash, t)
