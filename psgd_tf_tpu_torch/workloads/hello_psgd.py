"""Rosenbrock with the dense preconditioner: the hello-world workload.

Counterpart of `psgd_tf_tpu/workloads/hello_psgd.py`: init scale 0.1,
preconditioner lr 0.2, parameter lr 0.5, 500 steps, from (-1, 1); success
is a final loss below 1e-4. It runs on the card unless `device` says
otherwise.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.models import rosenbrock
from psgd_tf_tpu_torch.optim.psgd import PSGD


def run(
    steps: int = 500,
    preconditioner: str = "dense",
    seed: int = 0,
    lr_params: float = 0.5,
    lr_preconditioner: float = 0.2,
    device: torch.device | str = "cuda",
) -> dict:
    params = rosenbrock.init(device=device)
    opt = PSGD(
        preconditioner=preconditioner,
        rank=2,
        init_scale=0.1,
        lr_params=lr_params,
        lr_preconditioner=lr_preconditioner,
    )
    state = opt.init(params, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    loss = None
    for _ in range(steps):
        params, state, aux = opt.step(rosenbrock.loss, params, state, g)
        loss = aux["loss"]
    final = float(loss)
    return {"loss": final, "success": final < 1e-4, "steps": steps}


if __name__ == "__main__":
    print(run())
