"""The port's Granite-4.0-H model (`psgd_tf_tpu_torch/models/granite_hybrid.py`)
and its chunked scan (`ops/ssd.py`) at tiny widths on the CPU: against the
benchmark's plain reference (`benchmark/reference/granite_hybrid.py`,
whose scan is the whole-sequence quadratic form), a step-by-step
recurrence, `hvp.exact`, PSGD's Kronecker bucketing, and Hugging Face
transformers' `GraniteMoeHybridForCausalLM` at the same settings."""
import math

import pytest
import torch

from benchmark.reference import granite_hybrid as ref
from psgd_tf_tpu_torch import PSGD, hvp
from psgd_tf_tpu_torch.models import granite_hybrid as g
from psgd_tf_tpu_torch.ops import ssd
from psgd_tf_tpu_torch.optim.psgd import KronPrecond
from psgd_tf_tpu_torch.utils import transforms

CFG = g.Config()  # hidden 64, 4 SSM heads of 32, state 16, chunk 8, 4 / 2 attention heads


def _settings(cfg: g.Config) -> dict:
    """The reference's settings, under the published config.json's names."""
    return {"hidden_size": cfg.hidden, "vocab_size": cfg.vocab,
            "layer_types": list(cfg.layer_types), "num_hidden_layers": len(cfg.layer_types),
            "mamba_n_heads": cfg.ssm_heads, "mamba_d_head": cfg.ssm_head_dim,
            "mamba_d_state": cfg.d_state, "mamba_d_conv": cfg.d_conv, "mamba_n_groups": 1,
            "mamba_expand": cfg.ssm_heads * cfg.ssm_head_dim // cfg.hidden,
            "mamba_chunk_size": cfg.chunk, "num_attention_heads": cfg.attn_heads,
            "num_key_value_heads": cfg.kv_heads, "shared_intermediate_size": cfg.mlp,
            "rms_norm_eps": cfg.eps, "embedding_multiplier": cfg.embedding_multiplier,
            "residual_multiplier": cfg.residual_multiplier, "logits_scaling": cfg.logits_scaling,
            "attention_multiplier": cfg.attention_multiplier}


def _params(dtype, seed=1, jitter=0.1):
    """Seeded weights, every leaf moved off its initial value (norm weights
    1, D 1 and a zero conv bias would hide a transposed or dropped term)."""
    gen = torch.Generator().manual_seed(seed)
    return [p.to(dtype) + jitter * torch.randn(p.shape, generator=gen, dtype=dtype)
            for p in g.init(torch.Generator().manual_seed(seed), CFG)]


def _tokens(length, seed=3):
    return torch.randint(0, CFG.vocab, (2, length), generator=torch.Generator().manual_seed(seed))


def _recurrence(x, dt, A, B, C):
    """The scan one position at a time: h = exp(dt A) h + dt x B^T, y = h C."""
    b, length, h, p = x.shape
    state = x.new_zeros(b, h, p, B.shape[-1])
    ys = []
    for t in range(length):
        state = (torch.exp(dt[:, t] * A)[..., None, None] * state
                 + (dt[:, t, :, None] * x[:, t])[..., None] * B[:, t, None, None, :])
        ys.append((state @ C[:, t, None, :, None])[..., 0])
    return torch.stack(ys, dim=1)


def _scan_inputs(length, dtype=torch.float64, heads=3, p=4, n=5, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, length, heads, p, generator=gen, dtype=dtype)
    dt = torch.nn.functional.softplus(torch.randn(2, length, heads, generator=gen, dtype=dtype) + 1)
    A = -torch.arange(1, heads + 1, dtype=dtype)
    B = torch.randn(2, length, n, generator=gen, dtype=dtype)
    C = torch.randn(2, length, n, generator=gen, dtype=dtype)
    return x, dt, A, B, C


# float64 round-off of the same sums taken in another order (chunk by chunk
# against the whole sequence): ~1e-15 relative; 1e-12 leaves that room
F64_TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("length", [1, 5, 8, 19, 40])
def test_chunked_scan_against_quadratic_form_and_recurrence(length):
    x, dt, A, B, C = _scan_inputs(length)
    y = ssd.chunked(x, dt, A, B, C, chunk=8)
    torch.testing.assert_close(y, ref.ssd(x, dt, A, B, C), **F64_TOL)
    torch.testing.assert_close(y, _recurrence(x, dt, A, B, C), **F64_TOL)


@pytest.mark.parametrize("length", [8, 19])
def test_scan_backward_against_recurrence(length):
    xs = [t.requires_grad_() for t in _scan_inputs(length)]
    dy = torch.randn(xs[0].shape, dtype=torch.float64, generator=torch.Generator().manual_seed(9))
    got = torch.autograd.grad(ssd.scan(*xs, chunk=8), xs, dy)
    want = torch.autograd.grad(_recurrence(*xs), xs, dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **F64_TOL)
    # the same gradient under torch.func, which takes the plain chunked form
    f = lambda *a: (ssd.scan(*a, chunk=8) * dy).sum()
    for a, b in zip(torch.func.grad(f, argnums=(0, 1, 2, 3, 4))(*[t.detach() for t in xs]),
                    want):
        torch.testing.assert_close(a, b, **F64_TOL)


def test_scan_keeps_fast_decays_finite():
    """dt A of -80 a position (the published A_log's largest head) over a
    256-position chunk: every exponent is summed over its own positions,
    so nothing overflows or cancels."""
    x, dt, A, B, C = _scan_inputs(300, heads=2, seed=4)
    A = torch.tensor([-1.0, -64.0], dtype=torch.float64)
    y = ssd.chunked(x.float(), dt.float(), A.float(), B.float(), C.float(), chunk=256)
    want = _recurrence(x, dt, A, B, C)
    assert torch.isfinite(y).all()
    # float32 against float64: a few float32 spacings of the output's size
    assert (y.double() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("length", [16, 19])  # a multiple of the chunk (8), and not
def test_loss_and_gradients_match_the_reference(length):
    ps = _params(torch.float64)
    tokens = _tokens(length)
    xs = [p.clone().requires_grad_() for p in ps]
    loss = g.loss(xs, tokens, CFG)
    grads = torch.autograd.grad(loss, xs)
    rs = [p.clone().requires_grad_() for p in ps]
    rloss = ref.loss(rs, tokens, _settings(CFG))
    rgrads = torch.autograd.grad(rloss, rs)
    torch.testing.assert_close(loss, rloss, **F64_TOL)
    for a, b in zip(grads, rgrads):
        torch.testing.assert_close(a, b, **F64_TOL)
    # PSGD differentiates with torch.func
    for a, b in zip(torch.func.grad(lambda p: g.loss(p, tokens, CFG))(ps), rgrads):
        torch.testing.assert_close(a, b, **F64_TOL)


def test_float32_loss_and_gradients_match_the_reference():
    """The benchmark's precision: float32 round-off of two orderings,
    relative to each leaf's largest entry."""
    ps = _params(torch.float32)
    tokens = _tokens(19)
    f = lambda p: g.loss(p, tokens, CFG)
    grads, loss = torch.func.grad_and_value(f)(ps)
    rs = [p.clone().requires_grad_() for p in ps]
    rloss = ref.loss(rs, tokens, _settings(CFG))
    rgrads = torch.autograd.grad(rloss, rs)
    assert abs(float(loss) - float(rloss.detach())) <= 1e-6 * abs(float(rloss.detach()))
    for a, b in zip(grads, rgrads):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_fd_hvp_against_exact():
    """FD's error is O(delta) (the third derivative along v); at delta 1e-8
    in float64 it reads ~2e-6 of a leaf's Hvp, its round-off ~1e-8."""
    ps = _params(torch.float64, jitter=0.0)
    tokens = _tokens(19)
    v = [torch.randn(p.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(i))
         for i, p in enumerate(ps)]
    f = lambda p, t: g.loss(p, t, CFG)
    loss, grads, exact = hvp.exact(f, ps, v, tokens)
    loss_fd, grads_fd, fd = hvp.finite_diff(f, ps, v, tokens, delta=1e-8)
    torch.testing.assert_close(loss, loss_fd, **F64_TOL)
    for a, b in zip(grads_fd, grads):
        torch.testing.assert_close(a, b, **F64_TOL)
    for a, b in zip(fd, exact):
        assert torch.linalg.vector_norm(a - b) <= 1e-5 * torch.linalg.vector_norm(b)


def test_spans_cover_forward_and_backward():
    """`model_mamba` a mixer and `model_ssd` a scan, in each forward and
    each backward (the FD: two of each), only while a profiler records."""
    from torch.profiler import ProfilerActivity, profile

    ps = _params(torch.float32)
    tokens = _tokens(19)
    v = [torch.randn_like(p) for p in ps]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hvp.finite_diff(lambda p, t: g.loss(p, t, CFG), ps, v, tokens)
    counts = {}
    for e in prof.events():
        if e.name in ("model_mamba", "model_ssd"):
            counts[e.name] = counts.get(e.name, 0) + 1
    mixers = CFG.layer_types.count("mamba")
    assert counts == {"model_mamba": 4 * mixers, "model_ssd": 4 * mixers}


def test_scan_span_nests_in_the_mixer_span_each_way():
    """One gradient (`hvp.grad_only`): a `model_mamba` and a `model_ssd`
    range a mixer in the forward and in the backward, each scan's inside
    its mixer's on the same thread (`utils.profiling.region`'s edges open
    and close each backward range)."""
    from torch.profiler import ProfilerActivity, profile

    ps = _params(torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hvp.grad_only(lambda p, t: g.loss(p, t, CFG), ps, _tokens(19))
    spans = [e for e in prof.events() if e.name in ("model_mamba", "model_ssd")]
    mixers = CFG.layer_types.count("mamba")
    assert sum(e.name == "model_mamba" for e in spans) == 2 * mixers
    assert sum(e.name == "model_ssd" for e in spans) == 2 * mixers
    for e in spans:
        if e.name == "model_ssd":
            assert any(m.name == "model_mamba" and m.thread == e.thread
                       and m.time_range.start <= e.time_range.start
                       and e.time_range.end <= m.time_range.end for m in spans)


def test_scan_routes_by_transform():
    """Plain reverse mode takes the recomputing Function; under
    `torch.func.jvp` (`hvp.exact`) and `torch.func.grad` the plain chunked
    form runs, with the same values."""
    xs = _scan_inputs(19)
    seen = []

    def f(*a):
        seen.append(transforms.active())
        return ssd.scan(*a, chunk=8)

    want = f(*xs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ssd._Scan, "apply", staticmethod(lambda *a: pytest.fail("Function under jvp")))
        y, _ = torch.func.jvp(f, tuple(xs), tuple(torch.ones_like(x) for x in xs))
        torch.func.grad(lambda *a: f(*a).sum())(*xs)
    torch.testing.assert_close(y, want, **F64_TOL)
    assert seen == [False, True, True]


def test_micro_sizes_and_formats():
    cfg = g.micro_config(10)
    shapes = g.layer_shapes(cfg)
    assert len(shapes) == 118 and sum(math.prod(s) for s in shapes) == 951_991_232
    assert cfg.layer_types.count("attention") == 1 and cfg.layer_types[5] == "attention"
    fmts = g.kron_formats(cfg)
    dd = [i for i, f in enumerate(fmts) if f == ("dense", "dense")]
    assert [shapes[i] for i in dd] == [(64, 1)] * 27
    assert fmts[0] == ("norm", "scale") and fmts[1] == ("scale", "dense")  # embed, a norm


def test_psgd_buckets_the_per_head_vectors():
    """PSGD's init with the model's formats stacks the 27 (64, 1) vectors
    (dt_bias, A_log, D of 9 Mamba layers) into one (128, 128) bucket; the
    weights on the meta device, so no memory is taken."""
    cfg = g.micro_config(10)
    params = [torch.empty(s, device="meta") for s in g.layer_shapes(cfg)]
    state = PSGD(preconditioner="kron", kron_formats=g.kron_formats(cfg)).init(params)
    pc = state.precond
    assert isinstance(pc, KronPrecond) and len(pc.batches) == 1
    names = g.leaf_names(cfg)
    assert sorted(names[i].rsplit(".", 1)[1] for i in pc.batched_idx[0]) == (
        ["A_log"] * 9 + ["D"] * 9 + ["dt_bias"] * 9)
    assert tuple(pc.batches[0].ql.shape) == (27, 128, 128)
    assert len(pc.singles) == 118 - 27


def test_psgd_steps_lower_the_loss():
    ps = _params(torch.float32)
    tokens = _tokens(19)
    opt = PSGD(preconditioner="kron", kron_formats=g.kron_formats(CFG), lr_params=0.02,
               lr_preconditioner=0.02, grad_clip_max_norm=1.0, exact_hessian_vector_product=False)
    state = opt.init(ps)
    gen = torch.Generator().manual_seed(0)
    f = lambda p, t: g.loss(p, t, CFG)
    losses = []
    for _ in range(5):
        ps, state, aux = opt.step(f, ps, state, gen, tokens)
        losses.append(float(aux["loss"]))
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


def test_reference_against_transformers():
    """The repo's reference against Hugging Face's GraniteMoeHybridForCausalLM
    (its torch path) at the same tiny settings and weights. The model runs
    in float64, but its path casts the scan's inputs and the norms to
    float32 (`.float()`, meant for bf16 weights), so the two agree to
    float32 round-off: 1e-6 relative leaves room over the ~1e-8 read."""
    transformers = pytest.importorskip("transformers")
    c = _settings(CFG)
    hc = transformers.GraniteMoeHybridConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"], intermediate_size=c[
            "shared_intermediate_size"], num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=c["num_attention_heads"], num_key_value_heads=c["num_key_value_heads"],
        rms_norm_eps=c["rms_norm_eps"], tie_word_embeddings=True,
        embedding_multiplier=c["embedding_multiplier"], logits_scaling=c["logits_scaling"],
        residual_multiplier=c["residual_multiplier"],
        attention_multiplier=c["attention_multiplier"], num_local_experts=0,
        num_experts_per_tok=0, shared_intermediate_size=c["shared_intermediate_size"],
        position_embedding_type="nope", layer_types=c["layer_types"],
        mamba_n_heads=c["mamba_n_heads"], mamba_n_groups=1, mamba_d_state=c["mamba_d_state"],
        mamba_d_head=c["mamba_d_head"], mamba_d_conv=c["mamba_d_conv"],
        mamba_expand=c["mamba_expand"], mamba_chunk_size=c["mamba_chunk_size"],
        mamba_conv_bias=True, mamba_proj_bias=False)
    hc._attn_implementation = "eager"
    model = transformers.GraniteMoeHybridForCausalLM(hc).double().eval()
    ps = _params(torch.float64)
    w = dict(zip(g.leaf_names(CFG), ps))
    col = lambda name: w[name][:, 0]
    with torch.no_grad():
        m = model.model
        m.embed_tokens.weight.copy_(w["embed"])
        m.norm.weight.copy_(col("final_norm"))
        for i, kind in enumerate(CFG.layer_types):
            layer, pre = m.layers[i], f"{i}.{kind}."
            layer.input_layernorm.weight.copy_(col(pre + "input_norm"))
            layer.post_attention_layernorm.weight.copy_(col(pre + "post_norm"))
            layer.shared_mlp.input_linear.weight.copy_(w[pre + "mlp_in"].T)
            layer.shared_mlp.output_linear.weight.copy_(w[pre + "mlp_out"].T)
            if kind == "mamba":
                mx = layer.mamba
                mx.in_proj.weight.copy_(w[pre + "in_proj"].T)
                mx.conv1d.weight.copy_(w[pre + "conv_w"][:, None, :])
                mx.conv1d.bias.copy_(col(pre + "conv_b"))
                for name in ("dt_bias", "A_log", "D"):
                    getattr(mx, name).copy_(col(pre + name))
                mx.norm.weight.copy_(col(pre + "gate_norm"))
                mx.out_proj.weight.copy_(w[pre + "out_proj"].T)
            else:
                for name in "qkvo":
                    getattr(layer.self_attn, f"{name}_proj").weight.copy_(w[pre + name].T)
        tokens = _tokens(19)  # not a multiple of the chunk
        logits = model(input_ids=tokens).logits
    theirs = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, CFG.vocab),
                                               tokens[:, 1:].reshape(-1))
    hf_tol = dict(rtol=1e-6, atol=1e-6 * float(logits.abs().max()))
    torch.testing.assert_close(ref.loss(ps, tokens, c), theirs, **hf_tol)
    torch.testing.assert_close(g.hidden_states(ps, tokens, CFG) @ ps[0].T / CFG.logits_scaling,
                               logits, **hf_tol)
