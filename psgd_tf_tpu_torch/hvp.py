"""Curvature probes: Hessian-vector products, exact and finite-difference.

Counterpart of `psgd_tf_tpu/hvp.py`. Parameters and probes are lists (or
any pytree `torch.func` accepts) of tensors. Probes `v` are unit normals and
the finite-difference result is rescaled by 1/delta, so exact and FD give
(v, h) pairs on the same scale.

The gradients of `finite_diff` and `grad_only` are plain reverse mode
(`torch.autograd.grad` on leaves cut from the parameters), which needs no
graph of the backward: `torch.func.grad` records one (it differentiates
with `create_graph=True`, so that transforms can nest), and so keeps every
activation the forward saved, and what the backward makes from it, until
the gradient is whole. `exact` keeps `torch.func`, whose forward-over-
reverse needs that graph.

Spans (`utils.profiling.scope`): `psgd_forward` around each call of
`loss_fn` (the model's forward; its backward runs after the call returns),
`psgd_grad` around the gradient at theta, `psgd_hvp` around the FD's
perturbation, second gradient and difference, or the whole exact pass.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from psgd_tf_tpu_torch.ops import linalg
from psgd_tf_tpu_torch.utils.profiling import scope

PyTree = Any


def random_like(generator: torch.Generator, params: PyTree, stddev: float = 1.0) -> PyTree:
    """One N(0, stddev^2) probe per parameter tensor, drawn from `generator`
    (which lies on the parameters' device)."""
    leaves, spec = pytree.tree_flatten(params)
    probes = [
        stddev * torch.randn(p.shape, generator=generator, dtype=p.dtype, device=p.device)
        for p in leaves
    ]
    return pytree.tree_unflatten(probes, spec)


def _forward(loss_fn: Callable) -> Callable:
    """`loss_fn` with each call in a `psgd_forward` span."""

    def forward(*a):
        with scope("psgd_forward"):
            return loss_fn(*a)

    return forward


def _grad_and_value(loss_fn: Callable, params: PyTree, *args):
    """(grad, loss) of `loss_fn` at `params` by reverse mode; a parameter
    the loss does not reach gets a zero gradient."""
    leaves, spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(pytree.tree_unflatten(xs, spec), *args)
        grads = torch.autograd.grad(loss, xs, allow_unused=True, materialize_grads=True)
    return pytree.tree_unflatten(list(grads), spec), loss.detach()


def exact(loss_fn: Callable, params: PyTree, v: PyTree, *args):
    """(loss, grad, H v) by forward-over-reverse in one pass:
    `torch.func.jvp` of `torch.func.grad_and_value`."""
    gv = lambda p: torch.func.grad_and_value(_forward(loss_fn))(p, *args)
    with scope("psgd_hvp"):
        (grads, loss), (hvs, _) = torch.func.jvp(gv, (params,), (v,))
    return loss, grads, hvs


def finite_diff(loss_fn: Callable, params: PyTree, v: PyTree, *args, delta: float | None = None):
    """(loss, grad, (grad(theta + delta v) - grad(theta)) / delta), with
    delta = sqrt(eps) of the parameter dtype by default. The gradient
    returned is the unperturbed one, which is what gets preconditioned."""
    if delta is None:
        delta = linalg.delta_scale(pytree.tree_leaves(params)[0].dtype)
    fwd = _forward(loss_fn)
    with scope("psgd_grad"):
        grads, loss = _grad_and_value(fwd, params, *args)
    with scope("psgd_hvp"):
        pert = pytree.tree_map(lambda p, t: p + delta * t, params, v)
        grads_pert = _grad_and_value(fwd, pert, *args)[0]
        hvs = pytree.tree_map(lambda a, b: (a - b) / delta, grads_pert, grads)
    return loss, grads, hvs


def grad_only(loss_fn: Callable, params: PyTree, *args):
    """(loss, grad): the branch without a preconditioner update."""
    with scope("psgd_grad"):
        grads, loss = _grad_and_value(_forward(loss_fn), params, *args)
    return loss, grads
