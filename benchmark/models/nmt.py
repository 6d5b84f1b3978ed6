"""The NMT model (seq2seq + additive attention) for the benchmark.

The weights are the benchmark's: N(0, 1) embeddings and 1/sqrt(fan_in)
scaled dense layers, drawn on the card from the seed in one call a tensor,
handed alike to the program and to the reference. A step's inputs are a
batch of token ids, uniform over each vocabulary (a copy of the port's
`translation.random_tokens`: ids in [3, vocab), no PAD), at the traffic's
`batch`, `src_len` and `tgt_len`.
"""
from __future__ import annotations

import torch

from benchmark import work

SPECIALS = 3  # PAD, BOS, EOS: the first content id

# the reference's hand-assigned format pairs, one a weight in `shapes` order
REFERENCE_FORMATS = [
    ("scale", "dense"),   # encoder embedding
    ("norm", "scale"),    # encoder rnn
    ("scale", "dense"),   # attention input
    ("dense", "dense"),   # attention output
    ("scale", "dense"),   # decoder embedding
    ("norm", "scale"),    # decoder rnn
    ("norm", "scale"),    # decoder fc
]


def shapes(cfg: dict):
    e, u, a = cfg["embed"], cfg["units"], cfg["attn"]
    return [(cfg["vocab_src"], e), (e + u + 1, u), (2 * u, a), (1, a), (cfg["vocab_tgt"], e),
            (2 * u + e + 1, u), (u + 1, cfg["vocab_tgt"])]


def weights(generator: torch.Generator, cfg: dict):
    e, u = cfg["embed"], cfg["units"]
    scales = [1.0, (e + u + 1) ** -0.5, (2.0 * u) ** -0.5, 10.0 ** -0.5, 1.0,
              (2 * u + e + 1) ** -0.5, (u + 1) ** -0.5]
    return [s * torch.randn(shape, generator=generator, device=generator.device)
            for s, shape in zip(scales, shapes(cfg))]


def formats(cfg: dict):
    name = cfg["optimizer"].get("formats", "reference")
    if name != "reference":
        raise ValueError(f"the NMT model has no format set {name!r}")
    return list(REFERENCE_FORMATS)


def inputs(traffic: dict, cfg: dict, generator: torch.Generator):
    """One step's (src, tgt), rows first, on the generator's device."""
    b, dev = int(traffic["batch"]), generator.device
    src = torch.randint(SPECIALS, cfg["vocab_src"], (b, int(traffic["src_len"])),
                        generator=generator, device=dev)
    tgt = torch.randint(SPECIALS, cfg["vocab_tgt"], (b, int(traffic["tgt_len"])),
                        generator=generator, device=dev)
    return src, tgt


def tokens_per_step(traffic: dict) -> int:
    """Source and target tokens of one step's global batch."""
    return int(traffic["batch"]) * (int(traffic["src_len"]) + int(traffic["tgt_len"]))


def program_loss():
    """The program's loss entry, which the timed step differentiates."""
    from psgd_tf_tpu_torch.models import nmt
    return nmt.loss


def reference_loss():
    from benchmark.reference import nmt
    return nmt.loss


def forward_flops(cfg: dict, traffic: dict) -> float:
    """Matmul FLOPs of one step's forward pass over the global batch."""
    return int(traffic["batch"]) * work.nmt_forward_flops(
        cfg["vocab_tgt"], cfg["embed"], cfg["units"], cfg["attn"], int(traffic["src_len"]),
        int(traffic["tgt_len"]))
