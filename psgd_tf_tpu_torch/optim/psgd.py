"""The PSGD optimizer: the Kronecker branch and the flat families.

Counterpart of `psgd_tf_tpu/optim/psgd.py`. API shape:

    opt = PSGD(preconditioner="lra", rank=10, lr_params=0.01, ...)
    state = opt.init(params, seed=0)              # params: list of tensors
    params, state, aux = opt.step(loss_fn, params, state, generator, *batch)

'kron' keeps one (Ql, Qr) pair per parameter tensor. `kron_formats` takes
any of the seven format pairs (per leaf, one pair for all, a callable of
the shape, or 'auto'); every step updates all the Kronecker factors
through `kron.update_multi`, which routes each layer to its kernel as
`kron.route` reports.

'dense', 'diag', 'xmat', 'shift', 'splu' and 'lra' precondition the
flattened parameter vector: the tensors raveled in list order and
concatenated (the JAX package's `ravel_pytree` order for the same leaves).
`rank` is lra's rank and splu's corner order.

`generator` is a `torch.Generator` on the parameters' device; the probes of
the Hvp are drawn from it (one flat probe for the flat families). The
update coin, and lra's rebalance and U-vs-V coins, come from CPU
generators in the state, so a draw never waits for the device.
`step(..., probes=v, coins=(balance, update_u))` takes the probes (one per
parameter tensor) and lra's coins from the caller instead (the tests feed
the JAX package and the port the same ones). PyTorch runs eagerly, so the
hyperparameters are plain Python numbers that `PSGD.set_hyper` replaces
between steps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch

from psgd_tf_tpu_torch import hvp
from psgd_tf_tpu_torch.groups import dense, diag, kron, lra, shift, splu, xmat
from psgd_tf_tpu_torch.ops import linalg

_FLAT_FAMILIES = {"dense": dense, "diag": diag, "xmat": xmat, "shift": shift, "splu": splu,
                  "lra": lra}

# psgd_tf_tpu/ops/pallas/kron_dd.py MAX_SIDE: the JAX package buckets only
# (dense, dense) layers up to this side. Kept so the bucketing matches.
_BUCKET_MAX_SIDE = 1024


@dataclasses.dataclass(frozen=True)
class Hyper:
    """Hyperparameters that may be rescheduled between steps."""

    lr_params: float
    lr_preconditioner: float
    grad_clip_max_norm: float  # inf = no clipping
    update_probability: float


@dataclasses.dataclass(frozen=True)
class PSGDState:
    count: int
    hyper: Hyper
    precond: Any  # list[kron.KronState], one per tensor; or a flat family's state
    always_update: bool = False
    # True when the constructor's update probability is >= 1: no coin is
    # drawn. Otherwise the coin comes from `coin`, a CPU generator, so the
    # draw never waits for the device.
    coin: torch.Generator | None = None
    # lra only: the CPU generator of the rebalance and U-vs-V coins
    branch: torch.Generator | None = None

    def replace(self, **kwargs) -> "PSGDState":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class PSGD:
    preconditioner: str = "lra"
    rank: int = 10  # lra rank, splu corner order
    init_scale: float = 1.0
    lr_params: float = 0.01
    lr_preconditioner: float = 0.01
    grad_clip_max_norm: float | None = None
    preconditioner_update_probability: float = 1.0
    exact_hessian_vector_product: bool = True
    kron_formats: Any = "auto"  # 'auto' | (fmt_l, fmt_r) | callable(shape) | per-leaf list
    kron_batch_min: int = 4     # buckets this large take K4 in the JAX package
    dtype: torch.dtype = torch.float32

    # ------------------------------------------------------------------ init

    def init(self, params: Sequence[torch.Tensor], seed: int = 0) -> PSGDState:
        """State for a list of parameter tensors. `seed` seeds the CPU
        generators of the update coin (unused at probability >= 1) and of
        lra's coins, and the draw of lra's initial U and V."""
        if self.preconditioner != "kron" and self.preconditioner not in _FLAT_FAMILIES:
            raise ValueError(f"unknown preconditioner {self.preconditioner!r}")
        hyper = Hyper(
            lr_params=float(self.lr_params),
            lr_preconditioner=float(self.lr_preconditioner),
            grad_clip_max_norm=(
                math.inf if self.grad_clip_max_norm is None else float(self.grad_clip_max_norm)
            ),
            update_probability=float(self.preconditioner_update_probability),
        )
        always = self.preconditioner_update_probability >= 1.0
        coin = None if always else torch.Generator().manual_seed(seed)
        branch = None
        if self.preconditioner == "kron":
            precond = self._init_kron(params)
        else:
            params = list(params)
            n = sum(p.numel() for p in params)
            where = dict(dtype=self.dtype, device=params[0].device)
            if self.preconditioner == "lra":
                precond = lra.init(torch.Generator().manual_seed(seed), n, rank=self.rank,
                                   init_scale=self.init_scale, **where)
                branch = torch.Generator().manual_seed(seed + 1)
            elif self.preconditioner == "splu":
                precond = splu.init(n, rank=self.rank, init_scale=self.init_scale, **where)
            else:
                precond = _FLAT_FAMILIES[self.preconditioner].init(
                    n, init_scale=self.init_scale, **where)
        return PSGDState(
            count=0, hyper=hyper, precond=precond,
            always_update=always, coin=coin, branch=branch,
        )

    def _leaf_format(self, shape: tuple[int, int], index: int, n_leaves: int):
        if isinstance(self.kron_formats, str) and self.kron_formats == "auto":
            return kron.auto_format(shape)
        if callable(self.kron_formats):
            return self.kron_formats(shape)
        fmts = list(self.kron_formats)
        if fmts and not isinstance(fmts[0], str):  # per-leaf list of pairs
            if len(fmts) != n_leaves:
                raise ValueError(
                    f"kron_formats lists {len(fmts)} pairs for {n_leaves} "
                    "parameter tensors"
                )
            return fmts[index]
        return tuple(fmts)

    def _init_kron(self, params: Sequence[torch.Tensor]) -> list:
        leaves = list(params)
        shapes = [_matrix_shape(p.shape) for p in leaves]
        fmts = [tuple(self._leaf_format(s, i, len(leaves))) for i, s in enumerate(shapes)]
        pad = lambda d: -(-d // 128) * 128
        buckets: dict[tuple[int, int], list[int]] = {}
        for i, (s, f) in enumerate(zip(shapes, fmts)):
            if f == ("dense", "dense") and max(s) <= _BUCKET_MAX_SIDE:
                buckets.setdefault((pad(s[0]), pad(s[1])), []).append(i)
        big = [idx for idx in buckets.values() if len(idx) >= max(2, self.kron_batch_min)]
        if big and self.dtype == torch.float32:
            raise NotImplementedError(
                f"(dense, dense) layers {big} share a padded bucket of "
                f">= {self.kron_batch_min}: the batched path (K4, "
                "kron_dd.fused_update_batched) is not ported yet (ROADMAP queue 2)"
            )
        return [
            kron.init(s, fmt=f, init_scale=self.init_scale, dtype=self.dtype,
                      device=p.device)
            for p, s, f in zip(leaves, shapes, fmts)
        ]

    # ------------------------------------------------------------------ step

    def step(
        self,
        loss_fn: Callable,
        params: Sequence[torch.Tensor],
        state: PSGDState,
        generator: torch.Generator | None,
        *args,
        probes: Sequence[torch.Tensor] | None = None,
        coins: tuple[bool, bool] | None = None,
    ):
        """One PSGD step: maybe-update Q, precondition, clip, descend.
        Returns (new_params, new_state, aux); aux values are 0-d tensors."""
        params = list(params)
        hyper = state.hyper
        do_update = state.always_update or (
            torch.rand((), generator=state.coin).item() < hyper.update_probability
        )
        branch = self._flat_step if self.preconditioner != "kron" else self._kron_step
        loss, grads, precond, pre_grads = branch(
            loss_fn, params, state, generator, args, do_update, probes, coins)

        # global-norm clipping
        sq = sum(torch.sum(g * g) for g in pre_grads)
        pre_grad_norm = torch.sqrt(sq) + linalg.tiny(self.dtype)
        lr = hyper.lr_params * linalg.norm_clip_scale(pre_grad_norm, hyper.grad_clip_max_norm)
        new_params = [p - lr * g.to(p.dtype) for p, g in zip(params, pre_grads)]
        new_state = state.replace(count=state.count + 1, precond=precond)
        aux = {
            "loss": loss,
            "grad_norm": torch.sqrt(sum(torch.sum(g * g) for g in grads)),
            "pre_grad_norm": pre_grad_norm,
            "lr_effective": lr,
        }
        return new_params, new_state, aux

    def _kron_step(self, loss_fn, params, state, generator, args, do_update, probes, coins):
        """(loss, grads, precond, pre_grads) of the Kronecker family."""
        if do_update:
            v = list(probes) if probes is not None else hvp.random_like(generator, params)
            if self.exact_hessian_vector_product:
                loss, grads, hvs = hvp.exact(loss_fn, params, v, *args)
            else:
                loss, grads, hvs = hvp.finite_diff(loss_fn, params, v, *args)
            precond = kron.update_multi(
                state.precond,
                [_as_matrix(x).to(self.dtype) for x in v],
                [_as_matrix(x).to(self.dtype) for x in hvs],
                step=state.hyper.lr_preconditioner,
            )
        else:
            loss, grads = hvp.grad_only(loss_fn, params, *args)
            precond = state.precond
        pre_grads = [
            kron.apply(ks, _as_matrix(g.to(self.dtype))).reshape(g.shape)
            for ks, g in zip(precond, grads)
        ]
        return loss, grads, precond, pre_grads

    def _flat_step(self, loss_fn, params, state, generator, args, do_update, probes, coins):
        """(loss, grads, precond, pre_grads) of a flat family: one Q over the
        raveled parameters."""
        fam = _FLAT_FAMILIES[self.preconditioner]
        hyper = state.hyper
        shapes = [p.shape for p in params]

        def unravel(flat):
            return [x.reshape(s) for x, s in zip(torch.split(flat, [s.numel() for s in shapes]), shapes)]

        if not do_update:
            loss, grads = hvp.grad_only(loss_fn, params, *args)
            g_flat = _ravel(grads)
            pre = fam.apply(state.precond, g_flat.to(self.dtype))
            return loss, grads, state.precond, unravel(pre.to(g_flat.dtype))

        if probes is not None:
            v = list(probes)
            v_flat = _ravel(v)
        else:
            # the probe in the parameters' dtype (the Hvp runs through the
            # model); cast to the preconditioner's dtype at the family
            v_flat = torch.randn(sum(s.numel() for s in shapes), generator=generator,
                                 dtype=params[0].dtype, device=params[0].device)
            v = unravel(v_flat)
        if self.exact_hessian_vector_product:
            loss, grads, hvs = hvp.exact(loss_fn, params, v, *args)
        else:
            loss, grads, hvs = hvp.finite_diff(loss_fn, params, v, *args)
        g_flat = _ravel(grads)
        extra = {}
        if self.preconditioner == "lra":
            if coins is None:
                coins = (torch.rand((), generator=state.branch).item() < 0.01,
                         torch.rand((), generator=state.branch).item() < 0.5)
            extra["coins"] = coins
        v_flat, h_flat = v_flat.to(self.dtype), _ravel(hvs).to(self.dtype)
        if hasattr(fam, "update_apply"):
            # Q update and preconditioning in one sweep (K11-K13, K15)
            precond, pre = fam.update_apply(state.precond, v_flat, h_flat, g_flat.to(self.dtype),
                                            step=hyper.lr_preconditioner, **extra)
        else:
            precond = fam.update(state.precond, v_flat, h_flat, step=hyper.lr_preconditioner)
            pre = fam.apply(precond, g_flat.to(self.dtype))
        return loss, grads, precond, unravel(pre.to(g_flat.dtype))

    # ----------------------------------------------------------------- hyper

    @staticmethod
    def set_hyper(state: PSGDState, **kwargs) -> PSGDState:
        """Reschedule hyperparameters between steps. Scheduling
        `update_probability` on an always-update state raises: no coin
        generator exists there. Build PSGD with a probability < 1 instead."""
        if "update_probability" in kwargs and state.always_update:
            raise ValueError(
                "update_probability cannot be scheduled on an always-update "
                "state: the optimizer was constructed with "
                "preconditioner_update_probability >= 1.0"
            )
        hyper = dataclasses.replace(
            state.hyper, **{k: float(v) for k, v in kwargs.items()}
        )
        return state.replace(hyper=hyper)


def _matrix_shape(shape: Sequence[int]) -> tuple[int, int]:
    """Canonical 2-D shape for the kron family: scalars -> (1, 1),
    vectors -> (n, 1), higher-rank tensors fold leading dims."""
    shape = tuple(shape)
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (shape[0], 1)
    if len(shape) == 2:
        return shape
    return (math.prod(shape[:-1]), shape[-1])


def _ravel(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors raveled in list order and concatenated."""
    return torch.cat([x.reshape(-1) for x in xs])


def _as_matrix(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(_matrix_shape(x.shape))
