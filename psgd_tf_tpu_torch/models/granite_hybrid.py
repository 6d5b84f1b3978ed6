"""IBM Granite-4.0-H: Mamba-2 mixers and grouped-query attention in one
stack, with a SwiGLU MLP in every layer and a tied vocabulary.

The layer equations are those of Hugging Face transformers'
`GraniteMoeHybridDecoderLayer` (with no experts, no cache and no padding
mask):

  h  = x + r * mixer(rmsnorm(x))          r = residual_multiplier
  x' = h + r * mlp(rmsnorm(h))

The input is embed[tokens] * embedding_multiplier; the output the final
RMSNorm, then the tied embedding's transpose, divided by logits_scaling.
`loss` is the mean next-token cross-entropy of those logits.

A Mamba-2 mixer (`torch_forward` of `GraniteMoeHybridMambaLayer`):
in_proj splits into z, xBC and dt; xBC runs through a causal depthwise
convolution (kernel d_conv, with bias) and SiLU, and splits into x, B and
C (one group); dt = softplus(dt + dt_bias), clamped to [0, inf);
A = -exp(A_log); y = SSD(x, dt, A, B, C) + D x (`ops/ssd.py`); then
rmsnorm(y * silu(z)) * w (the gate before the norm, as
`GraniteMoeHybridRMSNormGated`) and out_proj. An attention layer: causal
grouped-query attention with no positional encoding, scaled by
attention_multiplier, then o_proj. The MLP: output(silu(a) * b) with
(a, b) = input(h).chunk(2).

Parameters are a flat list of 2-D leaves in one fixed order (`leaf_names`):
the embedding (vocab, hidden); per Mamba layer 12 leaves (input norm,
in_proj, conv weight (channels, d_conv), conv bias, dt_bias, A_log, D,
the gated norm's weight, out_proj, post norm, MLP input, MLP output), per
attention layer 8 (input norm, q, k, v, o, post norm, MLP input, MLP
output); the final norm last. A matrix is (fan_in, fan_out) and x @ W
applies it; a per-head vector or a norm's weight is an (n, 1) leaf.

Spans (`utils.profiling.region`): `model_mamba` around each mixer,
`model_ssd` around each scan (`ops/ssd.py`), their backward too while a
profiler records. Under a `torch.func` transform (`utils.transforms`:
`hvp.exact` runs the model under `torch.func.jvp`) the attention takes the
plain math: the fused attention backends have no forward-mode rule.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from psgd_tf_tpu_torch.ops import ssd
from psgd_tf_tpu_torch.utils import transforms
from psgd_tf_tpu_torch.utils.profiling import region

# the published layer pattern of granite-4.0-h-micro's 40 layers
MICRO_PATTERN = (("mamba",) * 5 + ("attention",) + ("mamba",) * 4) * 4


class Config(NamedTuple):
    vocab: int = 256
    hidden: int = 64
    layer_types: tuple = ("mamba", "attention")
    ssm_heads: int = 4
    ssm_head_dim: int = 32    # expand * hidden / ssm_heads
    d_state: int = 16
    d_conv: int = 4
    chunk: int = 8
    attn_heads: int = 4
    kv_heads: int = 2
    mlp: int = 128            # shared_intermediate_size
    eps: float = 1e-5
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    logits_scaling: float = 8.0
    attention_multiplier: float = 1.0 / 16


def micro_config(layers: int = 40) -> Config:
    """granite-4.0-h-micro at its published widths, its first `layers`
    layers (10: one whole period of the pattern, 9 Mamba-2 and 1 attention)."""
    return Config(vocab=100352, hidden=2048, layer_types=MICRO_PATTERN[:layers], ssm_heads=64,
                  ssm_head_dim=64, d_state=128, d_conv=4, chunk=256, attn_heads=32, kv_heads=8,
                  mlp=8192, eps=1e-5, embedding_multiplier=12.0, residual_multiplier=0.22,
                  logits_scaling=8.0, attention_multiplier=0.015625)


def _inner(cfg: Config) -> int:
    return cfg.ssm_heads * cfg.ssm_head_dim


def _layer_leaves(cfg: Config, kind: str):
    """(name, shape) of one layer's leaves."""
    d, di, n, h = cfg.hidden, _inner(cfg), cfg.d_state, cfg.ssm_heads
    hd = d // cfg.attn_heads
    mlp = [("post_norm", (d, 1)), ("mlp_in", (d, 2 * cfg.mlp)), ("mlp_out", (cfg.mlp, d))]
    if kind == "mamba":
        conv = di + 2 * n
        return [("input_norm", (d, 1)), ("in_proj", (d, di + conv + h)), ("conv_w", (conv, cfg.d_conv)),
                ("conv_b", (conv, 1)), ("dt_bias", (h, 1)), ("A_log", (h, 1)), ("D", (h, 1)),
                ("gate_norm", (di, 1)), ("out_proj", (di, d))] + mlp
    if kind == "attention":
        return [("input_norm", (d, 1)), ("q", (d, cfg.attn_heads * hd)),
                ("k", (d, cfg.kv_heads * hd)), ("v", (d, cfg.kv_heads * hd)),
                ("o", (cfg.attn_heads * hd, d))] + mlp
    raise ValueError(f"unknown layer type {kind!r}")


def leaf_names(cfg: Config) -> list[str]:
    return (["embed"] + [f"{i}.{kind}.{name}" for i, kind in enumerate(cfg.layer_types)
                         for name, _ in _layer_leaves(cfg, kind)] + ["final_norm"])


def layer_shapes(cfg: Config) -> list[tuple[int, int]]:
    return ([(cfg.vocab, cfg.hidden)]
            + [s for kind in cfg.layer_types for _, s in _layer_leaves(cfg, kind)]
            + [(cfg.hidden, 1)])


def kron_formats(cfg: Config):
    """A Kronecker format pair a leaf: both sides <= 1,024 (dense, dense);
    one side above, a scale factor on that side and a dense one on the
    other; both above (norm, scale)."""
    def pair(shape):
        big = [s > 1024 for s in shape]
        if all(big):
            return ("norm", "scale")
        if big[0]:
            return ("scale", "dense")
        if big[1]:
            return ("dense", "scale")
        return ("dense", "dense")
    return [pair(s) for s in layer_shapes(cfg)]


def init(generator: torch.Generator, cfg: Config = Config(), dtype=torch.float32):
    """N(0, 1) embedding; matrices N(0, 1 / fan_in), the convolution's
    fan-in d_conv; norm weights, dt_bias and D 1; A_log = log(1..heads);
    the convolution's bias 0. On the generator's device."""
    dev = generator.device
    out = [torch.randn((cfg.vocab, cfg.hidden), generator=generator, dtype=dtype, device=dev)]
    for kind in cfg.layer_types:
        for name, shape in _layer_leaves(cfg, kind):
            if name.endswith("norm") or name in ("dt_bias", "D"):
                w = torch.ones(shape, dtype=dtype, device=dev)
            elif name == "A_log":
                w = torch.log(torch.arange(1, shape[0] + 1, dtype=dtype, device=dev))[:, None]
            elif name == "conv_b":
                w = torch.zeros(shape, dtype=dtype, device=dev)
            else:
                w = torch.randn(shape, generator=generator, dtype=dtype, device=dev)
                w = w * (cfg.d_conv if name == "conv_w" else shape[0]) ** -0.5
            out.append(w)
    out.append(torch.ones((cfg.hidden, 1), dtype=dtype, device=dev))
    return out


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w[:, 0]


def _mamba(x, in_w, conv_w, conv_b, dt_bias, a_log, d_skip, norm_w, out_w, cfg: Config):
    b, length, _ = x.shape
    h, p, n, di = cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_state, _inner(cfg)
    z, xbc, dt = (x @ in_w).split([di, di + 2 * n, h], dim=-1)
    xbc = F.conv1d(xbc.transpose(1, 2), conv_w[:, None, :], conv_b[:, 0],
                   padding=cfg.d_conv - 1, groups=di + 2 * n)[..., :length]
    xs, B, C = F.silu(xbc.transpose(1, 2)).split([di, n, n], dim=-1)
    dt = torch.clamp(F.softplus(dt + dt_bias[:, 0]), 0.0, math.inf)
    xs = xs.reshape(b, length, h, p)
    y = ssd.scan(xs, dt, -torch.exp(a_log[:, 0]), B, C, cfg.chunk) + d_skip[:, 0, None] * xs
    y = rmsnorm(y.reshape(b, length, di) * F.silu(z), norm_w, cfg.eps)
    return y @ out_w


def _attention(x, q_w, k_w, v_w, o_w, cfg: Config):
    b, length, _ = x.shape
    hd = q_w.shape[1] // cfg.attn_heads
    q = (x @ q_w).view(b, length, cfg.attn_heads, hd).transpose(1, 2)
    rep = cfg.attn_heads // cfg.kv_heads
    k, v = ((x @ w).view(b, length, cfg.kv_heads, hd).transpose(1, 2).repeat_interleave(rep, dim=1)
            for w in (k_w, v_w))
    if transforms.active():
        s = (q @ k.transpose(-1, -2)) * cfg.attention_multiplier
        causal = torch.ones(length, length, dtype=torch.bool, device=x.device).tril()
        out = torch.softmax(s.masked_fill(~causal, -torch.inf), dim=-1) @ v
    else:
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             scale=cfg.attention_multiplier)
    return out.transpose(1, 2).reshape(b, length, -1) @ o_w


def _mlp(x, w_in, w_out):
    a, g = (x @ w_in).chunk(2, dim=-1)
    return (F.silu(a) * g) @ w_out


def hidden_states(params, tokens: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(b, L, hidden): the final norm's output over token ids (b, L)."""
    r = cfg.residual_multiplier
    x = params[0][tokens] * cfg.embedding_multiplier
    i = 1
    for kind in cfg.layer_types:
        k = len(_layer_leaves(cfg, kind))
        w = params[i:i + k]
        i += k
        y = rmsnorm(x, w[0], cfg.eps)
        if kind == "mamba":
            y = region("model_mamba", _mamba, y, *w[1:9], cfg)
        else:
            y = _attention(y, *w[1:5], cfg)
        h = x + r * y
        x = h + r * _mlp(rmsnorm(h, w[-3], cfg.eps), w[-2], w[-1])
    return rmsnorm(x, params[i], cfg.eps)


def loss(params, tokens: torch.Tensor, cfg: Config = Config()) -> torch.Tensor:
    """Mean cross-entropy of each position's logits against the next token."""
    h = hidden_states(params, tokens, cfg)[:, :-1]
    logits = (h @ params[0].T) / cfg.logits_scaling
    return F.cross_entropy(logits.reshape(-1, cfg.vocab), tokens[:, 1:].reshape(-1))
