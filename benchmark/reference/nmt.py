"""The NMT model in plain PyTorch: a frozen copy of the seq2seq + additive
attention model (lixilinx/psgd_tf's `neural_machine_translation_with_attention.py`,
after TensorFlow's "NMT with attention" tutorial).

Encoder: embedding, then a tanh RNN over [x, h]. Decoder: additive
attention scored by a (2 units, attn) tanh layer and an (attn,) output row,
a tanh RNN over [context, embedding, h], and a fully connected layer to the
target vocabulary. An RNN or fc weight is (fan_in + 1, fan_out) with the
bias as its last row. The loss is the teacher-forced cross-entropy over the
target positions, PAD (id 0) positions zeroed and counted in the mean.
"""
from __future__ import annotations

import torch

PAD = 0


def loss(params, src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    w_emb_s, w_enc, w_att, v_att, w_emb_t, w_dec, w_fc = params
    units = w_enc.shape[1]
    x = w_emb_s[src]
    h = x.new_zeros((src.shape[0], units))
    hs = []
    for t in range(src.shape[1]):
        h = torch.tanh(torch.cat([x[:, t], h], dim=1) @ w_enc[:-1] + w_enc[-1])
        hs.append(h)
    enc = torch.stack(hs, dim=1)
    src_mask = src != PAD
    h = enc[:, -1, :]
    logits = []
    for t in range(tgt.shape[1] - 1):
        hw = h @ w_att[:units]
        ow = enc @ w_att[units:]
        score = torch.tanh(hw[:, None, :] + ow) @ v_att[0]
        score = torch.where(src_mask, score, -torch.inf)
        ctx = torch.einsum("bs,bsu->bu", torch.softmax(score, dim=1), enc)
        h = torch.tanh(torch.cat([ctx, w_emb_t[tgt[:, t]], h], dim=1) @ w_dec[:-1] + w_dec[-1])
        logits.append(h @ w_fc[:-1] + w_fc[-1])
    logits = torch.stack(logits, dim=1)
    real = tgt[:, 1:]
    nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, real[..., None])[..., 0]
    return torch.mean(nll * (real != PAD).to(nll.dtype))
