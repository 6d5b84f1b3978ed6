"""PSGD's training step in plain PyTorch: a frozen copy of the mathematics
of `PSGD.step` with a finite-difference Hvp, over a preconditioner family's
plain module (`reference/<family>.py`), and the helpers those share.

One step: maybe update Q from (v, H v), precondition the gradient with the
updated Q, clip the preconditioned gradient's global norm, descend. The
caller hands in everything random: the probes, the update coin, and the
family's coins. Nothing here imports the program.
"""
from __future__ import annotations

import math

import torch

_EPS = float(torch.finfo(torch.float32).eps)
TINY = float(torch.finfo(torch.float32).tiny) * _EPS  # the smallest fp32 subnormal
DELTA = math.sqrt(_EPS)                               # the finite-difference step


# ------------------------------------------------------------------ curvature

def grad(loss_fn, params, *args):
    """(loss, gradients) by reverse mode."""
    ps = [p.detach().requires_grad_(True) for p in params]
    value = loss_fn(ps, *args)
    return value.detach(), [g.detach() for g in torch.autograd.grad(value, ps)]


def finite_diff(loss_fn, params, v, *args):
    """(loss, gradient, (grad(theta + delta v) - grad(theta)) / delta)."""
    value, g0 = grad(loss_fn, params, *args)
    _, g1 = grad(loss_fn, [p + DELTA * t for p, t in zip(params, v)], *args)
    return value, g0, [(a - b) / DELTA for a, b in zip(g1, g0)]


# ------------------------------------------------------------------ helpers

def step_scale(step, max_grad: torch.Tensor) -> torch.Tensor:
    """step / (max|grad| + tiny), saturated at fp32's largest finite value."""
    return torch.clamp(step / (max_grad + TINY), max=torch.finfo(torch.float32).max)


def max_abs(x: torch.Tensor) -> torch.Tensor:
    return x.abs().amax()


def solve_ut_t(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with U^T x = b, U upper triangular."""
    return torch.linalg.solve_triangular(u.mT, b, upper=False)


# ------------------------------------------------------------------ the step

class Trainer:
    """The reference's optimizer over a list of 2-D parameter tensors.

    `opt` is the configuration's optimizer block: preconditioner, hvp
    ('finite_diff'), lr_params, lr_preconditioner, grad_clip_max_norm
    (None: no clipping), init_scale. `family` is the preconditioner's
    plain module (`reference/<family>.py`: init, update, apply), and
    `kwargs` what its `init` takes besides."""

    def __init__(self, opt: dict, params, family, seed: int = 0, **kwargs):
        if opt.get("hvp", "finite_diff") != "finite_diff":
            raise ValueError(f"the reference has no Hvp {opt['hvp']!r}")
        self.opt, self.family = opt, family
        self.state = family.init(opt, params, seed, **kwargs)

    def step(self, loss_fn, params, batch, probes, update: bool, coins):
        """(new params, loss, gradient as the optimizer gets it)."""
        step = float(self.opt["lr_preconditioner"])
        if update:
            loss, grads, hvs = finite_diff(loss_fn, params, probes, *batch)
            self.state = self.family.update(self.state, probes, hvs, step, coins)
        else:
            loss, grads = grad(loss_fn, params, *batch)
        pre = self.family.apply(self.state, grads)
        norm = torch.sqrt(sum(torch.sum(x * x) for x in pre)) + TINY
        clip = self.opt.get("grad_clip_max_norm")
        scale = 1.0 if clip is None else torch.clamp(float(clip) / norm, max=1.0)
        lr = float(self.opt["lr_params"]) * scale
        return [p - lr * x for p, x in zip(params, pre)], loss, grads
