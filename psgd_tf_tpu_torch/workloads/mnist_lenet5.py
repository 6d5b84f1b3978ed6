"""LeNet5 digit classification with (dense, dense) Kronecker preconditioners.

Counterpart of `psgd_tf_tpu/workloads/mnist_lenet5.py`, with its
hyperparameters: batch 64, lr 0.1 annealed by 0.01^(1/9) per epoch,
grad-norm clip 0.1*sqrt(num_params), identity Kron Qs, preconditioner step
0.1, exact Hvp. It runs on the card unless `device` says otherwise.

Data: MNIST's IDX files when `data_dir` is given (`data.mnist.load_idx`;
the training set moves to the run's device once, each batch is drawn there
by `torch.randint`, the test set is the t10k files), with the reference's
bar of a best test error below 0.7%; else the hard procedural digit set
(`data.mnist.synthetic_hard`), whose bar is 5%, the JAX workload's for it.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.data import mnist
from psgd_tf_tpu_torch.models import lenet5
from psgd_tf_tpu_torch.optim.psgd import PSGD


def run(
    epochs: int = 10,
    steps_per_epoch: int = 200,
    batch_size: int = 64,
    seed: int = 0,
    device: torch.device | str = "cuda",
    lr: float = 0.1,
    eval_size: int = 2000,
    data_dir: str | None = None,
) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    params = lenet5.init(g)
    num_params = sum(p.numel() for p in params)
    opt = PSGD(
        preconditioner="kron",
        kron_formats=[("dense", "dense")] * 5,
        lr_params=lr,
        lr_preconditioner=0.1,
        grad_clip_max_norm=0.1 * num_params**0.5,
    )
    state = opt.init(params, seed=seed)
    if data_dir is not None:
        x_train, y_train, x_test, y_test = _device_idx(data_dir, device)

        def get_batch():
            idx = torch.randint(0, x_train.shape[0], (batch_size,), generator=g, device=device)
            return x_train[idx], y_train[idx]

        test_batch = (x_test, y_test)
    else:
        get_batch = lambda: mnist.synthetic_hard(g, batch_size)
        test_batch = mnist.synthetic_hard(g, eval_size)

    anneal = 0.01 ** (1.0 / 9.0)
    best_err = 1.0
    loss = None
    for epoch in range(epochs):
        for _ in range(steps_per_epoch):
            params, state, aux = opt.step(lenet5.loss, params, state, g, *get_batch())
            loss = aux["loss"]
        with torch.no_grad():
            err = float(lenet5.error_rate(params, *test_batch))
        best_err = min(best_err, err)
        state = PSGD.set_hyper(state, lr_params=lr * anneal ** (epoch + 1))
    target = 0.007 if data_dir is not None else 0.05
    return {
        "loss": float(loss),
        "best_test_error": best_err,
        "success": best_err < target,
        "steps": epochs * steps_per_epoch,
    }


def _device_idx(data_dir: str, device):
    """`load_idx`'s four arrays on `device`: images float32 NHWC, int64
    labels."""
    x_train, y_train, x_test, y_test = mnist.load_idx(data_dir)
    return (torch.as_tensor(x_train, device=device),
            torch.as_tensor(y_train, dtype=torch.int64, device=device),
            torch.as_tensor(x_test, device=device),
            torch.as_tensor(y_test, dtype=torch.int64, device=device))


if __name__ == "__main__":
    print(run())
