"""Seq2seq + additive attention translation model.

Counterpart of `psgd_tf_tpu/models/nmt.py`: encoder = embedding + vanilla
RNN; additive (Bahdanau) attention scored by a (2*units, attn) tanh layer
and a (1, attn) output row; decoder = embedding + RNN over [context, emb, h]
+ fc to the target vocabulary; masked cross-entropy that zeroes PAD
positions. All seven weights are PSGD matrices in the JAX layout (an RNN or
fc weight is (fan_in + 1, fan_out) with the bias as the last row), and
`kron_formats()` gives the reference's per-layer mixed Kronecker formats.

The JAX model's two `lax.scan`s are Python loops over the source and the
target positions here: PyTorch runs eagerly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from psgd_tf_tpu_torch.data.translation import PAD
from psgd_tf_tpu_torch.ops.hopper import attention
from psgd_tf_tpu_torch.utils import transforms


class Config(NamedTuple):
    vocab_src: int = 32
    vocab_tgt: int = 32
    embed: int = 64
    units: int = 128
    attn: int = 10


def ref_config() -> Config:
    """The TF reference's real-run dimensions: embedding 256, units 1024,
    vocabularies 9414 (spa) and 4935 (eng) from its fitted tokenizers."""
    return Config(vocab_src=9414, vocab_tgt=4935, embed=256, units=1024)


def layer_shapes(cfg: Config):
    return [
        (cfg.vocab_src, cfg.embed),                     # encoder embedding
        (cfg.embed + cfg.units + 1, cfg.units),         # encoder rnn
        (2 * cfg.units, cfg.attn),                      # attention input
        (1, cfg.attn),                                  # attention output
        (cfg.vocab_tgt, cfg.embed),                     # decoder embedding
        (2 * cfg.units + cfg.embed + 1, cfg.units),     # decoder rnn
        (cfg.units + 1, cfg.vocab_tgt),                 # decoder fc
    ]


def kron_formats(cfg: Config):
    """The reference's hand-assigned per-layer format pairs."""
    return [
        ("scale", "dense"),   # encoder embedding
        ("norm", "scale"),    # encoder rnn
        ("scale", "dense"),   # attention input
        ("dense", "dense"),   # attention output
        ("scale", "dense"),   # decoder embedding
        ("norm", "scale"),    # decoder rnn
        ("norm", "scale"),    # decoder fc
    ]


def init(generator: torch.Generator, cfg: Config = Config(), dtype=torch.float32):
    """N(0, 1) embeddings; 1/sqrt(fan_in)-scaled dense layers, on the
    generator's device."""
    scales = [
        1.0,
        (cfg.embed + cfg.units + 1) ** -0.5,
        (2.0 * cfg.units) ** -0.5,
        10.0**-0.5,
        1.0,
        (2 * cfg.units + cfg.embed + 1) ** -0.5,
        (cfg.units + 1) ** -0.5,
    ]
    return [
        s * torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
        for s, shape in zip(scales, layer_shapes(cfg))
    ]


def encode(params, src: torch.Tensor) -> torch.Tensor:
    """src: (batch, S) int64 -> encoder states (batch, S, units)."""
    w_emb, w_rnn = params[0], params[1]
    x = w_emb[src]  # (batch, S, embed)
    h = x.new_zeros((src.shape[0], w_rnn.shape[1]))
    hs = []
    for t in range(src.shape[1]):
        h = torch.tanh(torch.cat([x[:, t], h], dim=1) @ w_rnn[:-1] + w_rnn[-1])
        hs.append(h)
    return torch.stack(hs, dim=1)


def decode_step(params, tok: torch.Tensor, h: torch.Tensor, ctx: torch.Tensor):
    """One teacher-forced decoder step from the attention's context."""
    w_emb, w_rnn, w_fc = params[4], params[5], params[6]
    x = torch.cat([ctx, w_emb[tok], h], dim=1)
    h = torch.tanh(x @ w_rnn[:-1] + w_rnn[-1])
    return h @ w_fc[:-1] + w_fc[-1], h


def _teacher_forced_logits(params, src: torch.Tensor, tgt: torch.Tensor,
                           mask_attention: bool = True) -> torch.Tensor:
    """(batch, T-1, vocab) logits: feed tgt[:, t], predict tgt[:, t+1].
    `mask_attention=False` leaves PAD positions in the attention softmax,
    as the TF reference does.

    Additive attention over all source positions, PAD positions masked out
    of the softmax: the encoder states' projection ow = enc W_o does not
    depend on the decoder state, so it is formed once, before the decoder
    loop. Each position's score, softmax and context then run through
    `ops/hopper/attention.py`'s Functions, which read `enc` once a position
    and form its gradient once a pass; under a `torch.func` transform
    (`utils.transforms`), through the same plain ops
    (`attention.attend_plain`)."""
    src_mask = (src != PAD) if mask_attention else torch.ones_like(src, dtype=torch.bool)
    enc = encode(params, src)
    units = enc.shape[2]
    w_h, w_o, v = params[2][:units], params[2][units:], params[3][0]
    positions = tgt.shape[1] - 1
    plain = transforms.active()
    if plain:
        ow = enc @ w_o
    else:
        stash = attention.Stash(positions)
        ow = attention.project(enc, w_o, stash)
    h = enc[:, -1, :]  # the decoder starts from the encoder's last state
    logits = []
    for t in range(positions):
        hw = h @ w_h
        if plain:
            ctx = attention.attend_plain(hw, ow, v, src_mask, enc)[0]
        else:
            ctx = attention.step(hw, ow, v, src_mask, enc, stash, t)
        step_logits, h = decode_step(params, tgt[:, t], h, ctx)
        logits.append(step_logits)
    return torch.stack(logits, dim=1)


def loss(params, src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Masked teacher-forcing cross-entropy over the whole target."""
    logits = _teacher_forced_logits(params, src, tgt)
    real = tgt[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, real[..., None])[..., 0]
    return torch.mean(nll * (real != PAD).to(nll.dtype))


def token_accuracy(params, src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Teacher-forced next-token accuracy on non-PAD positions."""
    logits = _teacher_forced_logits(params, src, tgt)
    real = tgt[:, 1:]
    hit = (torch.argmax(logits, dim=-1) == real).to(torch.float32)
    mask = (real != PAD).to(torch.float32)
    return torch.sum(hit * mask) / torch.clamp(torch.sum(mask), min=1.0)
