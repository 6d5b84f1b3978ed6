"""Simple RNN on the delayed-XOR task with the low-rank (UVd) preconditioner.

Counterpart of `psgd_tf_tpu/workloads/rnn_xor_lra.py`: rank 10, init scale
1.0, both lrs 0.01, grad-norm clip 1.0, update probability 1.0, exact Hvp,
batch 128, sequences of 16; success is a train loss below 0.1 at a check
(every `check_every` steps). `switch_to_fd_at` switches to the
finite-difference Hvp at that step, as the reference demonstrates its
mutable hyperparameters. It runs on the card unless `device` says
otherwise.
"""
from __future__ import annotations

import dataclasses

import torch

from psgd_tf_tpu_torch.data import xor
from psgd_tf_tpu_torch.models import rnn
from psgd_tf_tpu_torch.optim.psgd import PSGD


def run(
    max_iters: int = 100_000,
    seq_len: int = 16,
    batch_size: int = 128,
    hidden: int = 30,
    rank: int = 10,
    seed: int = 0,
    switch_to_fd_at: int | None = None,
    check_every: int = 100,
    device: torch.device | str = "cuda",
) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    params = rnn.init(g, hidden=hidden)
    opt = PSGD(
        preconditioner="lra",
        rank=rank,
        init_scale=1.0,
        lr_params=0.01,
        lr_preconditioner=0.01,
        grad_clip_max_norm=1.0,
        exact_hessian_vector_product=True,
    )
    state = opt.init(params, seed=seed)
    opt_fd = dataclasses.replace(opt, exact_hessian_vector_product=False)

    loss = None
    for it in range(max_iters):
        x, y = xor.batch(g, batch_size, seq_len)
        active = opt_fd if switch_to_fd_at is not None and it >= switch_to_fd_at else opt
        params, state, aux = active.step(rnn.loss, params, state, g, x, y)
        if (it + 1) % check_every == 0:
            loss = float(aux["loss"])
            if loss < 0.1:
                return {"loss": loss, "success": True, "steps": it + 1}
    return {"loss": loss, "success": False, "steps": max_iters}


if __name__ == "__main__":
    print(run())
