"""Granite-4.0-H (Mamba-2 + grouped-query attention hybrid) for the
benchmark.

The configuration file holds the model's settings under the names of its
published `config.json`; the first `num_hidden_layers` entries of
`layer_types` are run. The weights are the benchmark's: an N(0, 1)
embedding, matrices N(0, 1 / fan_in) (the depthwise convolution's fan-in
d_conv), norm weights, dt_bias and D 1, A_log = log(1..heads) (as
`_init_weights` sets them), the convolution's bias 0; drawn on the card
from the seed, one call a tensor, and handed alike to the program and to
the reference. A step's input is a batch of token ids, uniform over the
vocabulary, at the traffic's `batch` and `seq_len`; the loss is the mean
next-token cross-entropy over each sequence's first seq_len - 1 positions.

The loss entries take the model's settings from the configuration whose
shapes, weights or batch this module made last (`current`), and the scan's
roofline reader takes the traffic of the last batch: the harness hands a
loss entry only the parameters and the batch, and a reader only the trace.
"""
from __future__ import annotations

import math

import torch

from benchmark import work

_CURRENT: dict = {}


def _seen(cfg: dict) -> dict:
    _CURRENT["cfg"] = cfg
    return cfg


def current() -> dict | None:
    """The configuration this module last made shapes, weights or a batch for."""
    return _CURRENT.get("cfg")


def _settings() -> dict:
    """`current()`, for a loss entry; raises before any has been made."""
    cfg = current()
    if cfg is None:
        raise RuntimeError("the Granite loss entries need the configuration: make its shapes, "
                           "weights or a batch through this module first")
    return cfg


def current_traffic() -> dict | None:
    """The traffic of the last batch this module made."""
    return _CURRENT.get("traffic")


def layer_types(cfg: dict) -> list[str]:
    return list(cfg["layer_types"][:cfg["num_hidden_layers"]])


def _layer(cfg: dict, kind: str):
    """(name, shape) of one layer's leaves, in order."""
    d, h, n = cfg["hidden_size"], cfg["mamba_n_heads"], cfg["mamba_d_state"]
    di = h * cfg["mamba_d_head"]
    f = cfg["shared_intermediate_size"]
    hd = d // cfg["num_attention_heads"]
    mlp = [("post_norm", (d, 1)), ("mlp_in", (d, 2 * f)), ("mlp_out", (f, d))]
    if kind == "mamba":
        conv = di + 2 * cfg["mamba_n_groups"] * n
        return [("input_norm", (d, 1)), ("in_proj", (d, di + conv + h)),
                ("conv_w", (conv, cfg["mamba_d_conv"])), ("conv_b", (conv, 1)),
                ("dt_bias", (h, 1)), ("A_log", (h, 1)), ("D", (h, 1)), ("gate_norm", (di, 1)),
                ("out_proj", (di, d))] + mlp
    kv = cfg["num_key_value_heads"] * hd
    return [("input_norm", (d, 1)), ("q", (d, cfg["num_attention_heads"] * hd)), ("k", (d, kv)),
            ("v", (d, kv)), ("o", (cfg["num_attention_heads"] * hd, d))] + mlp


def _leaves(cfg: dict):
    return ([("embed", (cfg["vocab_size"], cfg["hidden_size"]))]
            + [x for kind in layer_types(cfg) for x in _layer(cfg, kind)]
            + [("final_norm", (cfg["hidden_size"], 1))])


def shapes(cfg: dict):
    return [s for _, s in _leaves(_seen(cfg))]


def weights(generator: torch.Generator, cfg: dict):
    dev = generator.device
    out = []
    for name, shape in _leaves(_seen(cfg)):
        if name.endswith("norm") or name in ("dt_bias", "D"):
            w = torch.ones(shape, device=dev)
        elif name == "A_log":
            w = torch.log(torch.arange(1, shape[0] + 1, dtype=torch.float32, device=dev))[:, None]
        elif name == "conv_b":
            w = torch.zeros(shape, device=dev)
        else:
            fan_in = cfg["mamba_d_conv"] if name == "conv_w" else shape[0]
            w = torch.randn(shape, generator=generator, device=dev)
            if name != "embed":
                w = w * fan_in ** -0.5
        out.append(w)
    return out


def _pair(shape):
    big = [s > 1024 for s in shape]
    if all(big):
        return ("norm", "scale")
    if big[0]:
        return ("scale", "dense")
    if big[1]:
        return ("dense", "scale")
    return ("dense", "dense")


def formats(cfg: dict):
    """The NMT's hand rule on each leaf: both sides <= 1,024 (dense, dense);
    one above, a scale on that side and a dense factor on the other; both
    above (norm, scale)."""
    name = cfg["optimizer"].get("formats", "side_rule")
    if name != "side_rule":
        raise ValueError(f"the Granite model has no format set {name!r}")
    return [_pair(s) for s in shapes(cfg)]


def inputs(traffic: dict, cfg: dict, generator: torch.Generator):
    """One step's (tokens,): (batch, seq_len) ids uniform over the vocabulary."""
    _seen(cfg)
    _CURRENT["traffic"] = traffic
    return (torch.randint(0, cfg["vocab_size"], (int(traffic["batch"]), int(traffic["seq_len"])),
                          generator=generator, device=generator.device),)


def tokens_per_step(traffic: dict) -> int:
    return int(traffic["batch"]) * int(traffic["seq_len"])


def program_config(cfg: dict):
    """The program's `Config` for these settings."""
    from psgd_tf_tpu_torch.models import granite_hybrid as g

    if cfg["mamba_n_groups"] != 1 or cfg["hidden_size"] * cfg["mamba_expand"] != (
            cfg["mamba_n_heads"] * cfg["mamba_d_head"]):
        raise ValueError("the program's Granite model takes one group and expand * hidden = "
                         "mamba_n_heads * mamba_d_head")
    return g.Config(vocab=cfg["vocab_size"], hidden=cfg["hidden_size"],
                    layer_types=tuple(layer_types(cfg)), ssm_heads=cfg["mamba_n_heads"],
                    ssm_head_dim=cfg["mamba_d_head"], d_state=cfg["mamba_d_state"],
                    d_conv=cfg["mamba_d_conv"], chunk=cfg["mamba_chunk_size"],
                    attn_heads=cfg["num_attention_heads"], kv_heads=cfg["num_key_value_heads"],
                    mlp=cfg["shared_intermediate_size"], eps=cfg["rms_norm_eps"],
                    embedding_multiplier=float(cfg["embedding_multiplier"]),
                    residual_multiplier=float(cfg["residual_multiplier"]),
                    logits_scaling=float(cfg["logits_scaling"]),
                    attention_multiplier=float(cfg["attention_multiplier"]))


def program_loss():
    """The program's loss entry, which the timed step differentiates."""
    from psgd_tf_tpu_torch.models import granite_hybrid as g

    return lambda params, tokens: g.loss(params, tokens, program_config(_settings()))


def reference_loss():
    from benchmark.reference import granite_hybrid as ref

    return lambda params, tokens: ref.loss(params, tokens, _settings())


# ------------------------------------------------------------------ work

def _layer_flops(cfg: dict, kind: str, seq_len: int) -> float:
    """Minimal matmul FLOPs of one layer's forward pass a token: the
    projections, the MLP, and the mixer's own work: the scan's recurrence
    (4 P N a head: the state's decay and input, and its read-out) or
    causal attention at (seq_len + 1) / 2 keys a query."""
    d, f = cfg["hidden_size"], cfg["shared_intermediate_size"]
    mlp = 2 * d * 2 * f + 2 * f * d
    if kind == "mamba":
        h, p, n = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
        width = 2 * h * p + 2 * cfg["mamba_n_groups"] * n + h
        return 2 * d * width + 2 * h * p * d + 4 * p * n * h + mlp
    hd = d // cfg["num_attention_heads"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    attend = 2 * 2 * q * (seq_len + 1) / 2
    return 2 * d * (q + 2 * kv) + 2 * q * d + attend + mlp


def forward_flops(cfg: dict, traffic: dict) -> float:
    """Minimal matmul FLOPs of one step's forward pass over the batch: the
    layers at every position, the tied head at the seq_len - 1 positions
    that predict a token. Not counted: what the chunked scan adds over the
    recurrence, norms, the convolution and the elementwise work."""
    b, s = int(traffic["batch"]), int(traffic["seq_len"])
    body = sum(_layer_flops(cfg, kind, s) for kind in layer_types(cfg))
    return float(b * (s * body + (s - 1) * 2 * cfg["hidden_size"] * cfg["vocab_size"]))


def ssd_work(cfg: dict, traffic: dict) -> tuple[tuple[float, float], tuple[float, float]]:
    """((bytes, FLOPs) forward, (bytes, FLOPs) backward) of one scan call,
    one layer over the step's batch: x, B, C, dt and A read once and y
    written once, the same bytes each way; the recurrence's 4 P N FLOPs a
    head and token forward, twice that backward. Neither depends on how
    the scan is computed."""
    tokens = tokens_per_step(traffic)
    h, p, n = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    g = cfg["mamba_n_groups"]
    nbytes = 4.0 * (tokens * (2 * h * p + 2 * g * n + h) + h)
    flops = 4.0 * p * n * h * tokens
    return (nbytes, flops), (nbytes, 2 * flops)


def ssd_bound_ms(cfg: dict, traffic: dict, forward_calls: int, backward_calls: int) -> float:
    """The least time of that many scan calls on one card (`work.bound_ms`)."""
    fwd, bwd = ssd_work(cfg, traffic)
    return forward_calls * work.bound_ms(*fwd) + backward_calls * work.bound_ms(*bwd)


def parameter_count(cfg: dict) -> int:
    return sum(math.prod(s) for s in shapes(cfg))
