"""Synthetic translation task for the seq2seq + attention workload.

Counterpart of `psgd_tf_tpu/data/translation.py`, on a `torch.Generator`
(the numbers differ from the JAX package's for one seed; the construction
is the same):

  source: a random token sequence over vocabulary A (variable length,
          padded with 0), wrapped in <s> ... </s>.
  target: the source reversed and mapped through a fixed bijection (a
          cyclic shift) into vocabulary B, also <s> ... </s> padded.

Token ids: 0 = PAD, 1 = BOS, 2 = EOS, content tokens are 3..vocab+2.
"""
from __future__ import annotations

import torch

PAD, BOS, EOS = 0, 1, 2
SPECIALS = 3


def vocab_size(content_vocab: int = 29) -> int:
    return content_vocab + SPECIALS


def batch(
    generator: torch.Generator,
    batch_size: int = 64,
    max_len: int = 16,
    content_vocab: int = 29,
    min_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, tgt), each (batch, max_len + 2) int64 with BOS/EOS/PAD, on the
    generator's device. `min_len=max_len` yields a PAD-free batch."""
    dev = generator.device
    lo = max_len // 4 if min_len is None else min_len
    lengths = torch.randint(lo, max_len + 1, (batch_size,), generator=generator, device=dev)
    toks = torch.randint(SPECIALS, SPECIALS + content_vocab, (batch_size, max_len),
                         generator=generator, device=dev)
    pos = torch.arange(max_len, device=dev)[None, :]
    valid = pos < lengths[:, None]
    toks = torch.where(valid, toks, PAD)

    # target content: reversed valid prefix, bijection = cyclic shift in vocab B
    rev = torch.gather(toks, 1, (lengths[:, None] - 1 - pos) % max_len)
    mapped = torch.where(valid, SPECIALS + (rev - SPECIALS + 7) % content_vocab, PAD)

    def wrap(seq):
        out = torch.cat([
            torch.full((batch_size, 1), BOS, dtype=seq.dtype, device=dev),
            seq,
            torch.zeros((batch_size, 1), dtype=seq.dtype, device=dev),
        ], dim=1)
        out[torch.arange(batch_size, device=dev), lengths + 1] = EOS
        return out

    return wrap(toks), wrap(mapped)


def random_tokens(
    generator: torch.Generator,
    vocab_src: int,
    vocab_tgt: int,
    batch_size: int = 64,
    src_len: int = 18,
    tgt_len: int = 13,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference-widths token recipe of the JAX package's bench
    (`bench.py` `bench_nmt_ref_dims`): ids drawn uniformly per vocabulary,
    (batch, src_len) in [3, vocab_src) and (batch, tgt_len) in
    [3, vocab_tgt), no PAD. The kernels do not care about text."""
    dev = generator.device
    src = torch.randint(SPECIALS, vocab_src, (batch_size, src_len), generator=generator, device=dev)
    tgt = torch.randint(SPECIALS, vocab_tgt, (batch_size, tgt_len), generator=generator, device=dev)
    return src, tgt
