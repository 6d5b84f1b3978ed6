"""Granite-4.0-H (Mamba-2 + grouped-query attention) in plain PyTorch: a
frozen copy of the layer equations of Hugging Face transformers'
`GraniteMoeHybridDecoderLayer` (`torch_forward` of the Mamba layer,
`GraniteMoeHybridRMSNormGated`, `GraniteMoeHybridMLP`, the attention with
no positional encoding), with no experts, cache or padding mask. Nothing
here imports the program.

`cfg` holds the model's settings under the names of its published
`config.json` (hidden_size, mamba_n_heads, ...); the first
`num_hidden_layers` entries of `layer_types` are run. The leaves come in
the benchmark's order (`models/granite_hybrid.py`): the embedding; per
Mamba layer input norm, in_proj, conv weight (channels, d_conv), conv
bias, dt_bias, A_log, D, the gated norm's weight, out_proj, post norm, MLP
input, MLP output; per attention layer input norm, q, k, v, o, post norm,
MLP input, MLP output; the final norm. A matrix is (fan_in, fan_out).

The scan is written in its quadratic dual form, whole-sequence and not
chunked: per head y = (L o C B^T)(dt x) with L[i, j] = exp(sum_{j < k <= i}
dt_k A) for j <= i, each entry summed over its own positions. It is
formed over blocks of `HEAD_BLOCK` heads, and each layer, and inside it
each block of heads, is recomputed in its backward (`torch.utils.checkpoint`,
which changes no arithmetic), so that the reference's steps fit on one
card beside what the check keeps.
The convolution is a sum of shifted slices; the attention the plain
softmax over a causal mask.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

HEAD_BLOCK = 8
MAMBA_LEAVES, ATTENTION_LEAVES = 12, 8


def _norm(x, w, eps):
    return w[:, 0] * (x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps))


def _segsum(a):
    """(..., T) -> (..., T, T): sum_{j < k <= i} a_k at [i, j], j <= i; -inf above."""
    t = a.shape[-1]
    below = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device), diagonal=-1)
    s = torch.cumsum(torch.where(below, a[..., :, None], 0.0), dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return torch.where(keep, s, -torch.inf)


def _heads(cb, xd, dt, A):
    """One block of heads: (L o C B^T)(dt x), (b, h, L, P)."""
    decay = torch.exp(_segsum((dt * A).transpose(1, 2)))  # (b, h, L, L)
    return (decay * cb[:, None]) @ xd


def ssd(x, dt, A, B, C):
    """x (b, L, H, P), dt (b, L, H), A (H,), B and C (b, L, N) -> y (b, L, H, P)."""
    cb = C @ B.transpose(1, 2)                        # (b, L, L), one group
    xd = (x * dt[..., None]).transpose(1, 2)          # (b, H, L, P)
    out = []
    for h0 in range(0, x.shape[2], HEAD_BLOCK):
        hs = slice(h0, h0 + HEAD_BLOCK)
        out.append(checkpoint(_heads, cb, xd[:, hs], dt[:, :, hs], A[hs], use_reentrant=False))
    return torch.cat(out, dim=1).transpose(1, 2)


def _mamba(x, w, cfg):
    (in_w, conv_w, conv_b, dt_bias, a_log, d_skip, norm_w, out_w) = w
    b, length, _ = x.shape
    heads, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    n, k = cfg["mamba_d_state"], cfg["mamba_d_conv"]
    di = heads * p
    proj = x @ in_w
    gate, xbc, dt = proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]
    padded = torch.cat([xbc.new_zeros(b, k - 1, xbc.shape[2]), xbc], dim=1)
    conv = conv_b[:, 0] + sum(conv_w[:, j] * padded[:, j:j + length] for j in range(k))
    conv = conv * torch.sigmoid(conv)
    xs = conv[..., :di].reshape(b, length, heads, p)
    B, C = conv[..., di:di + n], conv[..., di + n:]
    dt = torch.nn.functional.softplus(dt + dt_bias[:, 0]).clamp(min=0.0)
    y = ssd(xs, dt, -torch.exp(a_log[:, 0]), B, C) + xs * d_skip[:, 0, None]
    y = y.reshape(b, length, di) * (gate * torch.sigmoid(gate))
    return _norm(y, norm_w, cfg["rms_norm_eps"]) @ out_w


def _attention(x, w, cfg):
    q_w, k_w, v_w, o_w = w
    b, length, _ = x.shape
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // heads
    q = (x @ q_w).reshape(b, length, heads, hd).permute(0, 2, 1, 3)
    k = (x @ k_w).reshape(b, length, kv, 1, hd).expand(b, length, kv, heads // kv, hd)
    v = (x @ v_w).reshape(b, length, kv, 1, hd).expand(b, length, kv, heads // kv, hd)
    k = k.reshape(b, length, heads, hd).permute(0, 2, 1, 3)
    v = v.reshape(b, length, heads, hd).permute(0, 2, 1, 3)
    s = cfg["attention_multiplier"] * (q @ k.transpose(2, 3))
    causal = torch.tril(torch.ones(length, length, dtype=torch.bool, device=x.device))
    a = torch.softmax(torch.where(causal, s, -torch.inf), dim=-1) @ v
    return a.permute(0, 2, 1, 3).reshape(b, length, heads * hd) @ o_w


def _layer(kind, cfg, x, *w):
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    mix = _mamba if kind == "mamba" else _attention
    h = x + r * mix(_norm(x, w[0], eps), w[1:-3], cfg)
    a, g = torch.chunk(_norm(h, w[-3], eps) @ w[-2], 2, dim=-1)
    return h + r * ((a * torch.sigmoid(a) * g) @ w[-1])


def loss(params, tokens, cfg):
    """Mean next-token cross-entropy of the logits / logits_scaling."""
    embed = params[0]
    x = embed[tokens] * cfg["embedding_multiplier"]
    i = 1
    for kind in cfg["layer_types"][:cfg["num_hidden_layers"]]:
        n = MAMBA_LEAVES if kind == "mamba" else ATTENTION_LEAVES
        x = checkpoint(_layer, kind, cfg, x, *params[i:i + n], use_reentrant=False)
        i += n
    x = _norm(x, params[i], cfg["rms_norm_eps"])
    logits = (x[:, :-1] @ embed.T) / cfg["logits_scaling"]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, tokens[:, 1:, None]))
