"""The closure-style `UVd` optimizer: the reference's class API.

Counterpart of `psgd_tf_tpu/optim/uvd.py`, on top of `optim.PSGD`. The
constructor takes the reference's keywords (`rank_of_modification`,
`preconditioner_init_scale`, `lr_params`, `lr_preconditioner`,
`grad_clip_max_norm` (None = no clipping),
`preconditioner_update_probability`, `exact_hessian_vector_product`) and
`preconditioner` ('lra' is the reference's UVd; 'dense' and 'diag' work
too). A `seed` and an optional `generator` take the place of the JAX key:
`seed` seeds the state (lra's U and V, the CPU generators of the coins),
and `generator`, on the parameters' device, draws the Hvp probes (one
seeded with `seed` is made when none is given).

The hyperparameters are mutable between steps: `opt.lr_params = 0.005`
and the like. Setting `preconditioner_update_probability` below 1 on an
always-update optimizer switches it to the coin; setting
`exact_hessian_vector_product` switches the Hvp between exact and finite
differences from the next step on.

`step(closure, *args)` takes `closure(params, *args) -> loss`, or an
iterable whose first element is the loss, and returns what the closure
returns at the pre-step parameters. A closure that returns only the loss
is evaluated once per step, inside the Hvp; one that returns more is
evaluated once more, under `no_grad`, for the rest.

The JAX class keeps a cache of jitted steps (`uvd.py:90-102`, `:185-208`);
eager PyTorch has no counterpart, so there is none here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

from psgd_tf_tpu_torch.optim.psgd import PSGD


class UVd:
    """Stateful PSGD optimizer with the low-rank Q = (I + U V^T) diag(d)."""

    def __init__(
        self,
        params_with_grad: Sequence[torch.Tensor],
        rank_of_modification: int = 10,
        preconditioner_init_scale: float = 1.0,
        lr_params: float = 0.01,
        lr_preconditioner: float = 0.01,
        grad_clip_max_norm: float | None = None,
        preconditioner_update_probability: float = 1.0,
        exact_hessian_vector_product: bool = True,
        seed: int = 0,
        generator: torch.Generator | None = None,
        preconditioner: str = "lra",
    ):
        self._params = list(params_with_grad)
        self._seed = seed
        self._opt = PSGD(
            preconditioner=preconditioner,
            rank=rank_of_modification,
            init_scale=preconditioner_init_scale,
            lr_params=lr_params,
            lr_preconditioner=lr_preconditioner,
            grad_clip_max_norm=grad_clip_max_norm,
            preconditioner_update_probability=preconditioner_update_probability,
            exact_hessian_vector_product=exact_hessian_vector_product,
        )
        self._state = self._opt.init(self._params, seed=seed)
        if generator is None:
            generator = torch.Generator(device=self._params[0].device).manual_seed(seed)
        self._gen = generator
        self.last_aux: dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------ properties

    @property
    def params(self) -> list[torch.Tensor]:
        """The current parameters (the wrapper owns them)."""
        return self._params

    @property
    def state(self):
        return self._state

    def _set_hyper(self, **kw):
        self._state = PSGD.set_hyper(self._state, **kw)

    @property
    def lr_params(self) -> float:
        return self._state.hyper.lr_params

    @lr_params.setter
    def lr_params(self, v: float):
        self._set_hyper(lr_params=v)

    @property
    def lr_preconditioner(self) -> float:
        return self._state.hyper.lr_preconditioner

    @lr_preconditioner.setter
    def lr_preconditioner(self, v: float):
        self._set_hyper(lr_preconditioner=v)

    @property
    def grad_clip_max_norm(self) -> float:
        return self._state.hyper.grad_clip_max_norm

    @grad_clip_max_norm.setter
    def grad_clip_max_norm(self, v: float | None):
        self._set_hyper(grad_clip_max_norm=math.inf if v is None else v)

    @property
    def preconditioner_update_probability(self) -> float:
        return self._state.hyper.update_probability

    @preconditioner_update_probability.setter
    def preconditioner_update_probability(self, v: float):
        if self._state.always_update:
            if v >= 1.0:
                return  # still always-update
            # constructed always-update: no coin generator exists yet
            self._opt = dataclasses.replace(self._opt, preconditioner_update_probability=float(v))
            self._state = self._state.replace(
                always_update=False, coin=torch.Generator().manual_seed(self._seed))
        self._set_hyper(update_probability=v)

    @property
    def exact_hessian_vector_product(self) -> bool:
        return self._opt.exact_hessian_vector_product

    @exact_hessian_vector_product.setter
    def exact_hessian_vector_product(self, flag: bool):
        self._opt = dataclasses.replace(self._opt, exact_hessian_vector_product=bool(flag))

    # ------------------------------------------------------------------ step

    def step(self, closure: Callable, *args):
        """One PSGD step; returns what `closure(params, *args)` returns at
        the pre-step parameters."""
        more = []

        def scalar_loss(p, *a):
            out = closure(p, *a)
            if isinstance(out, (tuple, list)):
                more.append(True)
                return out[0]
            return out

        before = self._params
        self._params, self._state, self.last_aux = self._opt.step(
            scalar_loss, before, self._state, self._gen, *args)
        if not more:
            return self.last_aux["loss"]
        with torch.no_grad():
            return closure(before, *args)
