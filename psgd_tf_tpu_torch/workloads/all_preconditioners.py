"""The tensor-decomposition workload under every preconditioner family.

Counterpart of `psgd_tf_tpu/workloads/all_preconditioners.py` (the TF
reference's `demo_usage_of_all_preconditioners.py`, at its own widths):
rank-5 CP decomposition of a random 10x20x50 tensor with an L1 penalty,
100 steps, init scale 0.1, both learning rates 0.1. Success is a final
loss below a tenth of the first. It runs on the card unless `device` says
otherwise.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.models import tensor_decomp
from psgd_tf_tpu_torch.optim.psgd import PSGD

FAMILIES = ("dense", "diag", "xmat", "shift", "splu", "lra", "kron")


def run(
    preconditioner: str = "dense",
    steps: int = 100,
    seed: int = 0,
    rank: int = 10,
    lr: float = 0.1,
    device: torch.device | str = "cuda",
) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    target = tensor_decomp.make_target(g)
    params = tensor_decomp.init(g)
    opt = PSGD(
        preconditioner=preconditioner,
        rank=rank,
        init_scale=0.1,  # the reference scales every initial Q by 0.1
        lr_params=lr,
        lr_preconditioner=lr,
    )
    state = opt.init(params, seed=seed)
    first = loss = None
    for _ in range(steps):
        params, state, aux = opt.step(tensor_decomp.loss, params, state, g, target)
        if first is None:
            first = float(aux["loss"])
        loss = aux["loss"]
    final = float(loss)
    return {"loss": final, "first_loss": first, "success": final < 0.1 * first, "steps": steps}


def run_all(steps: int = 100, seed: int = 0, device: torch.device | str = "cuda") -> dict:
    return {fam: run(fam, steps=steps, seed=seed, device=device) for fam in FAMILIES}


if __name__ == "__main__":
    for fam, result in run_all().items():
        print(fam, result)
