"""The NMT decoder's attention route (`ops/hopper/attention.py`): the hoisted
projection, the per-position Functions and the deferred gradient of the
encoder states, held on the CPU in float64 to the model's plain
formulation (the route before it: the projection recomputed and the
context formed by plain ops at every position), and on a CUDA card the
kernels against their plain versions (those tests skip without one; the
card runs them with `python -m pytest tests/test_torch_attention.py`).

This file imports no JAX: the JAX parity of the model is
`tests/test_torch_nmt.py`'s."""
from unittest import mock

import pytest
import torch

from psgd_tf_tpu_torch import hvp
from psgd_tf_tpu_torch.data.translation import PAD
from psgd_tf_tpu_torch.models import nmt
from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import attention
from psgd_tf_tpu_torch.utils import transforms

torch.set_num_threads(1)

CFG = nmt.Config(vocab_src=16, vocab_tgt=16, embed=8, units=16, attn=4)
CFG_A10 = nmt.Config(vocab_src=20, vocab_tgt=18, embed=8, units=12, attn=10)


def _plain_logits(params, src, tgt, mask_attention=True):
    """The model's logits as it formed them before the attention route: the
    projection of the encoder states and the context by plain ops, at every
    decoder position."""
    src_mask = (src != PAD) if mask_attention else torch.ones_like(src, dtype=torch.bool)
    enc = nmt.encode(params, src)
    h = enc[:, -1, :]
    w, v = params[2], params[3]
    units = h.shape[1]
    logits = []
    for t in range(tgt.shape[1] - 1):
        score = torch.tanh((h @ w[:units])[:, None, :] + enc @ w[units:]) @ v[0]
        weights = torch.softmax(torch.where(src_mask, score, -torch.inf), dim=1)
        ctx = torch.einsum("bs,bsu->bu", weights, enc)
        step_logits, h = nmt.decode_step(params, tgt[:, t], h, ctx)
        logits.append(step_logits)
    return torch.stack(logits, dim=1)


def _plain_loss(params, src, tgt):
    logits = _plain_logits(params, src, tgt)
    real = tgt[:, 1:]
    nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, real[..., None])[..., 0]
    return torch.mean(nll * (real != PAD).to(nll.dtype))


def _inputs(seed, cfg=CFG, batch=6, src_len=7, tgt_len=6, dtype=torch.float64):
    """Weights, probes and tokens with PAD tails of several lengths (no row
    all PAD)."""
    g = torch.Generator().manual_seed(seed)
    params = nmt.init(g, cfg, dtype=dtype)
    probes = [torch.randn(p.shape, generator=g, dtype=dtype) for p in params]
    src = torch.randint(3, cfg.vocab_src, (batch, src_len), generator=g)
    tgt = torch.randint(3, cfg.vocab_tgt, (batch, tgt_len), generator=g)
    for r in range(batch):
        src[r, src_len - r % 4:] = PAD
        tgt[r, tgt_len - r % 3:] = PAD
    assert (src == PAD).any() and (src != PAD).any(dim=1).all()
    return params, probes, src, tgt


def _close(a, b, tol):
    for x, y in zip(a, b, strict=True):
        assert x.shape == y.shape
        scale = max(y.abs().max().item(), 1e-30)
        assert (x - y).abs().max().item() <= tol * scale, ((x - y).abs().max().item(), scale)


def _grad_and_value(f, params, *args):
    """(grads, value) of f by plain reverse mode, as `hvp.finite_diff` and
    `hvp.grad_only` take them: the route the attention's Functions serve
    (under a `torch.func` transform the model takes the plain ops)."""
    leaves = [p.detach().requires_grad_() for p in params]
    value = f(leaves, *args)
    return list(torch.autograd.grad(value, leaves)), value.detach()


def _logit_loss(mask_attention, weights):
    """A scalar of the logits with either masking, for gradients of the
    unmasked route too (`nmt.loss` masks)."""
    def f(params, src, tgt, route):
        return (route(params, src, tgt, mask_attention=mask_attention) * weights).sum()
    return f


# --------------------------------------------------------------- on the CPU

# float64 at toy widths: the route and the plain formulation run the same
# products, their sums in another order (the deferred gradient, the
# softmax's backward by hand): differences of a few float64 ulps, 1e-12
# relative to the largest entry with room.
TOL = 1e-12


@pytest.mark.parametrize("cfg", [CFG, CFG_A10], ids=["attn4", "attn10"])
@pytest.mark.parametrize("mask_attention", [True, False])
def test_grad_and_value_matches_plain(cfg, mask_attention):
    params, _, src, tgt = _inputs(0, cfg)
    weights = torch.randn((src.shape[0], tgt.shape[1] - 1, cfg.vocab_tgt),
                          generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    f = _logit_loss(mask_attention, weights)
    g1, v1 = _grad_and_value(f, params, src, tgt, nmt._teacher_forced_logits)
    g0, v0 = _grad_and_value(f, params, src, tgt, _plain_logits)
    _close([v1], [v0], TOL)
    _close(g1, g0, TOL)


@pytest.mark.parametrize("mask_attention", [True, False])
def test_logits_match_plain_bitwise_on_cpu(mask_attention):
    # the forward runs the same ops in the same order on the CPU
    params, _, src, tgt = _inputs(2)
    assert torch.equal(nmt._teacher_forced_logits(params, src, tgt, mask_attention),
                       _plain_logits(params, src, tgt, mask_attention))


def test_loss_gradient_matches_plain():
    params, _, src, tgt = _inputs(3)
    g1, l1 = _grad_and_value(nmt.loss, params, src, tgt)
    g0, l0 = _grad_and_value(_plain_loss, params, src, tgt)
    _close([l1], [l0], TOL)
    _close(g1, g0, TOL)


@pytest.mark.parametrize("mask_attention", [True, False])
def test_backward_matches_plain(mask_attention):
    params, _, src, tgt = _inputs(4)
    weights = torch.randn((src.shape[0], tgt.shape[1] - 1, CFG.vocab_tgt),
                          generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    f = _logit_loss(mask_attention, weights)
    grads = []
    for route in (nmt._teacher_forced_logits, _plain_logits):
        leaves = [p.clone().requires_grad_() for p in params]
        f(leaves, src, tgt, route).backward()
        grads.append([p.grad for p in leaves])
    _close(grads[0], grads[1], TOL)


def test_finite_diff_and_grad_only_match_plain():
    params, probes, src, tgt = _inputs(6)
    l1, g1, h1 = hvp.finite_diff(nmt.loss, params, probes, src, tgt)
    l0, g0, h0 = hvp.finite_diff(_plain_loss, params, probes, src, tgt)
    _close([l1], [l0], TOL)
    _close(g1, g0, TOL)
    # the FD quotient divides the gradients' float64 rounding (~1e-16) by
    # delta = sqrt(eps) ~ 1.5e-8: ~1e-8 relative, with room
    _close(h1, h0, 1e-7)
    l1, g1 = hvp.grad_only(nmt.loss, params, src, tgt)
    l0, g0 = hvp.grad_only(_plain_loss, params, src, tgt)
    _close([l1], [l0], TOL)
    _close(g1, g0, TOL)


def test_token_accuracy_matches_plain_under_no_grad():
    params, _, src, tgt = _inputs(7)
    with torch.no_grad():
        logits = _plain_logits(params, src, tgt)
        real = tgt[:, 1:]
        hit = ((torch.argmax(logits, dim=-1) == real) & (real != PAD)).sum()
        expected = hit / (real != PAD).sum()
        assert nmt.token_accuracy(params, src, tgt).item() == pytest.approx(expected.item(),
                                                                           abs=1e-15)


def test_all_pad_source_row_gives_nan_as_plain():
    params, _, src, tgt = _inputs(8)
    src[2] = PAD
    a = nmt._teacher_forced_logits(params, src, tgt)
    b = _plain_logits(params, src, tgt)
    assert torch.equal(a.isnan(), b.isnan()) and a[2].isnan().all()
    assert torch.equal(a[~a.isnan()], b[~b.isnan()])


def test_routes_by_forward_mode():
    """`hvp.exact` (jvp over grad) takes the plain ops; the gradient paths
    take the Functions, one `step` a decoder position and one `project` a
    pass."""
    params, probes, src, tgt = _inputs(9)
    with mock.patch.object(attention, "step", side_effect=AssertionError("fused under jvp")), \
            mock.patch.object(attention, "project", side_effect=AssertionError("fused under jvp")):
        l1, g1, h1 = hvp.exact(nmt.loss, params, probes, src, tgt)
    l0, g0, h0 = hvp.exact(_plain_loss, params, probes, src, tgt)
    assert l1.item() == l0.item()
    _close(g1, g0, TOL)
    _close(h1, h0, TOL)
    with mock.patch.object(attention, "step", wraps=attention.step) as step, \
            mock.patch.object(attention, "project", wraps=attention.project) as project:
        hvp.finite_diff(nmt.loss, params, probes, src, tgt)
    assert step.call_count == 2 * (tgt.shape[1] - 1) and project.call_count == 2
    assert not transforms.active()


def test_routes_to_plain_ops_under_func_grad():
    """A caller's own `torch.func.grad` gets the plain ops too: the
    Functions' kernels read raw storage, which its wrapped tensors lack."""
    params, _, src, tgt = _inputs(11)
    with mock.patch.object(attention, "step", side_effect=AssertionError("fused under grad")), \
            mock.patch.object(attention, "project", side_effect=AssertionError("fused under grad")):
        g1, l1 = torch.func.grad_and_value(nmt.loss)(params, src, tgt)
    g0, l0 = _grad_and_value(nmt.loss, params, src, tgt)
    _close([l1], [l0], TOL)
    _close(g1, g0, TOL)


def test_second_backward_through_a_retained_graph():
    """The stash's d ctx is freed once `enc`'s gradient is formed; a second
    backward through a retained graph fills a new one and gives the same
    gradients."""
    params, _, src, tgt = _inputs(12)
    leaves = [p.clone().requires_grad_() for p in params]
    loss = nmt.loss(leaves, src, tgt)
    first = torch.autograd.grad(loss, leaves, retain_graph=True)
    second = torch.autograd.grad(loss, leaves)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _close(first, torch.func.grad(_plain_loss)(params, src, tgt), TOL)


def test_plain_kernel_versions_agree_with_autograd():
    """The hand-written backward and deferred gradient against autograd of
    the forward's plain ops, position by position."""
    g = torch.Generator().manual_seed(10)
    b, s, u, a, t = 5, 7, 6, 3, 4
    enc = torch.randn(b, s, u, generator=g, dtype=torch.float64, requires_grad=True)
    w_o = torch.randn(u, a, generator=g, dtype=torch.float64, requires_grad=True)
    v = torch.randn(a, generator=g, dtype=torch.float64, requires_grad=True)
    hws = torch.randn(t, b, a, generator=g, dtype=torch.float64, requires_grad=True)
    mask = torch.rand(b, s, generator=g) > 0.3
    mask[:, 0] = True
    dctx = torch.randn(t, b, u, generator=g, dtype=torch.float64)
    ow = enc @ w_o
    out = torch.stack([attention.attend_plain(hws[i], ow, v, mask, enc)[0] for i in range(t)])
    ref = torch.autograd.grad(out, [enc, w_o, v, hws], dctx)
    with torch.no_grad():
        ow = enc @ w_o
        weights = torch.stack([attention.attend_plain(hws[i], ow, v, mask, enc)[1]
                               for i in range(t)], dim=1)
        parts = [attention.attend_backward_plain(dctx[i], enc, weights[:, i], hws[i], ow, v, mask)
                 for i in range(t)]
        d_ow = sum(p[1] for p in parts)
        d_enc = attention.enc_grad_plain(weights, dctx.transpose(0, 1), d_ow, w_o)
        d_w = enc.reshape(-1, u).T @ d_ow.reshape(-1, a)
    _close([d_enc, d_w, sum(p[2] for p in parts), torch.stack([p[0] for p in parts])], ref, TOL)


# --------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, b, s, u, a, t, seed):
    """One position's operands (fp32, on `dev`), PAD-like masked tails on
    some rows, d ctx as the slice of a wider gradient (as `torch.cat`'s
    backward gives it), and T positions' weights and d ctx for the
    deferred gradient."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape, scale=1.0: scale * torch.randn(shape, generator=g, device=dev)
    enc, hw, ow, v = r(b, s, u), r(b, a), r(b, s, a), r(a)
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    for row in range(0, b, 3):
        mask[row, s - 1 - row % max(s - 1, 1):] = False
    mask[:, 0] = True
    wide = r(b, 2 * u + 8)
    weights = torch.softmax(r(b, t, s), dim=2)
    return dict(enc=enc, hw=hw, ow=ow, v=v, mask=mask, dctx=wide[:, :u], weights=weights,
                dctxs=r(b, t, u), d_ow=r(b, s, a), w_enc=r(u, a, scale=u ** -0.5))


# (B, S, U, A, T): toy widths (float4 rows), a ragged U (float rows) at the
# A limit, the benchmark cells' shapes
CARD_SHAPES = [(6, 7, 16, 4, 5), (5, 9, 13, 32, 3), (4096, 18, 1024, 10, 12)]

# fp32 against the plain versions' fp32 with sums in other orders: ctx and
# the weights are sums of S terms (a few ulps); d ow, d hw and d enc come
# through dw = enc . d ctx, a sum of U terms, and the softmax's difference
# dw - w . dw, which cancels: 1e-5 of the largest entry covers U = 1024's
# ~sqrt(U) ulps with room; d v sums B x S terms more
TOL_FWD, TOL_BWD, TOL_DV = 1e-5, 1e-5, 1e-4


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("shape", CARD_SHAPES, ids=["toy", "ragged_a32", "cells"])
def test_kernels_match_plain(cuda, shape):
    b, s, u, a, t = shape
    c = _case(cuda, b, s, u, a, t, sum(shape))
    slot = torch.empty(b, t, s, device=cuda)[:, 1]
    before = dict(hopper.counts)
    ctx = attention.attend(c["hw"], c["ow"], c["v"], c["mask"], c["enc"], slot)
    ref_ctx, ref_w = attention.attend_plain(c["hw"], c["ow"], c["v"], c["mask"], c["enc"])
    assert _rel(ctx, ref_ctx) < TOL_FWD and _rel(slot, ref_w) < TOL_FWD
    out = torch.empty(b, t, u, device=cuda)[:, 2]
    got = attention.attend_backward(c["dctx"], c["enc"], slot, c["hw"], c["ow"], c["v"],
                                    c["mask"], out)
    ref = attention.attend_backward_plain(c["dctx"], c["enc"], slot, c["hw"], c["ow"], c["v"],
                                          c["mask"])
    assert torch.equal(out, c["dctx"])
    assert _rel(got[0], ref[0]) < TOL_BWD and _rel(got[1], ref[1]) < TOL_BWD
    assert _rel(got[2], ref[2]) < TOL_DV
    assert torch.equal(got[1][~c["mask"]], torch.zeros_like(got[1][~c["mask"]]))
    d_enc = attention.enc_grad(c["weights"], c["dctxs"], c["d_ow"], c["w_enc"])
    ref_enc = attention.enc_grad_plain(c["weights"], c["dctxs"], c["d_ow"], c["w_enc"])
    assert _rel(d_enc, ref_enc) < TOL_BWD
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in hopper.counts.items() if n != before[k]}
    assert moved == {"attn_fwd": 1, "attn_bwd": 1, "attn_enc_grad": 1}
    # no float atomics: reruns are bit-equal
    again = attention.attend_backward(c["dctx"], c["enc"], slot, c["hw"], c["ow"], c["v"],
                                      c["mask"], out)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert torch.equal(attention.enc_grad(c["weights"], c["dctxs"], c["d_ow"], c["w_enc"]), d_enc)


def test_all_masked_row_gives_nan_as_plain(cuda):
    c = _case(cuda, 4, 6, 8, 3, 2, 1)
    c["mask"][1] = False
    slot = torch.empty(4, 6, device=cuda)
    ctx = attention.attend(c["hw"], c["ow"], c["v"], c["mask"], c["enc"], slot)
    ref_ctx, _ = attention.attend_plain(c["hw"], c["ow"], c["v"], c["mask"], c["enc"])
    assert torch.equal(ctx.isnan(), ref_ctx.isnan()) and ctx[1].isnan().all()


def test_fd_step_at_reference_widths_matches_plain_route(cuda):
    """`hvp.finite_diff` of the reference-width model (batch 256, lengths
    18 / 13) through the kernels against the model's plain formulation."""
    cfg = nmt.ref_config()
    g = torch.Generator(device=cuda).manual_seed(3)
    params = nmt.init(g, cfg)
    probes = hvp.random_like(g, params)
    src = torch.randint(3, cfg.vocab_src, (256, 18), generator=g, device=cuda)
    tgt = torch.randint(3, cfg.vocab_tgt, (256, 13), generator=g, device=cuda)
    l1, g1, h1 = hvp.finite_diff(nmt.loss, params, probes, src, tgt)
    l0, g0, h0 = hvp.finite_diff(_plain_loss, params, probes, src, tgt)
    # fp32 sums in other orders: the loss to a few ulps, each gradient leaf
    # to 1e-5 of its norm; the FD quotient multiplies the gradients'
    # rounding by 1/delta ~ 2.9e3 (tests/test_torch_nmt.py's 2e-3)
    assert abs(l1.item() - l0.item()) <= 1e-6 * abs(l0.item())
    for x, y in zip(g1, g0, strict=True):
        assert ((x - y).norm() / y.norm()).item() < 1e-5
    for x, y in zip(h1, h0, strict=True):
        assert ((x - y).norm() / y.norm()).item() < 2e-3


def test_launch_counts_and_exact_route(cuda):
    """One gradient of the loss at tgt_len 13 (`hvp.grad_only`): 12
    forward, 12 backward and 1 deferred-gradient launch; `hvp.exact` and
    `torch.func.grad` launch none."""
    g = torch.Generator(device=cuda).manual_seed(4)
    params = nmt.init(g, CFG_A10)
    src = torch.randint(3, CFG_A10.vocab_src, (64, 18), generator=g, device=cuda)
    tgt = torch.randint(3, CFG_A10.vocab_tgt, (64, 13), generator=g, device=cuda)
    before = dict(hopper.counts)
    hvp.grad_only(nmt.loss, params, src, tgt)
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in hopper.counts.items() if n != before[k]}
    assert moved == {"attn_fwd": 12, "attn_bwd": 12, "attn_enc_grad": 1}
    before = dict(hopper.counts)
    hvp.exact(nmt.loss, params, hvp.random_like(g, params), src, tgt)
    torch.func.grad_and_value(nmt.loss)(params, src, tgt)
    torch.cuda.synchronize()
    assert dict(hopper.counts) == before


def test_attention_units_over_the_limit_raise(cuda):
    cfg = CFG._replace(attn=attention.A_MAX + 1)
    g = torch.Generator(device=cuda).manual_seed(5)
    params = nmt.init(g, cfg)
    src = torch.randint(3, cfg.vocab_src, (4, 6), generator=g, device=cuda)
    tgt = torch.randint(3, cfg.vocab_tgt, (4, 5), generator=g, device=cuda)
    with pytest.raises(ValueError, match="A_MAX"):
        nmt.loss(params, src, tgt)
