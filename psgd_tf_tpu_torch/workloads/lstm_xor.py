"""LSTM on the delayed-XOR task with Kronecker preconditioners.

Counterpart of `psgd_tf_tpu/workloads/lstm_xor.py`: sequences of 100,
batch 128, hidden 30, (dense, dense) identity Qs, lr 0.02, preconditioner
step 0.01, grad-norm clip 1.0, exact Hvp; success is a train loss below
0.1 at a check (every `check_every` steps) within `max_iters`. The loss is
read back only at a check, so the host does not wait for the card every
step. Both layers share one (128, 128) bucket, below `kron_batch_min`, so
they ride K1 together. It runs on the card unless `device` says otherwise.

    python -m psgd_tf_tpu_torch.workloads.lstm_xor
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.data import xor
from psgd_tf_tpu_torch.models import lstm
from psgd_tf_tpu_torch.optim.psgd import PSGD


def optimizer(lr: float = 0.02) -> PSGD:
    """The workload's PSGD: (dense, dense) factors, preconditioner step 0.01,
    grad-norm clip 1.0, exact Hvp."""
    return PSGD(
        preconditioner="kron",
        kron_formats=[("dense", "dense")] * 2,
        lr_params=lr,
        lr_preconditioner=0.01,
        grad_clip_max_norm=1.0,
    )


def run(
    max_iters: int = 100_000,
    seq_len: int = 100,
    batch_size: int = 128,
    hidden: int = 30,
    seed: int = 0,
    lr: float = 0.02,
    check_every: int = 100,
    device: torch.device | str = "cuda",
) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    params = lstm.init(g, dim_hidden=hidden)
    opt = optimizer(lr)
    state = opt.init(params, seed=seed)

    loss = None
    for it in range(max_iters):
        x, y = xor.batch(g, batch_size, seq_len)
        params, state, aux = opt.step(lstm.loss, params, state, g, x, y)
        if (it + 1) % check_every == 0:
            loss = float(aux["loss"])
            if loss < 0.1:
                return {"loss": loss, "success": True, "steps": it + 1}
    return {"loss": loss, "success": False, "steps": max_iters}


if __name__ == "__main__":
    print(run())
