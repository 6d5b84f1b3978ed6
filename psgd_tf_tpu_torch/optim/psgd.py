"""The PSGD optimizer: the Kronecker branch and the flat families.

Counterpart of `psgd_tf_tpu/optim/psgd.py`. API shape:

    opt = PSGD(preconditioner="lra", rank=10, lr_params=0.01, ...)
    state = opt.init(params, seed=0)              # params: list of tensors
    params, state, aux = opt.step(loss_fn, params, state, generator, *batch)

'kron' keeps one (Ql, Qr) pair per parameter tensor. `kron_formats` takes
any of the seven format pairs (per leaf, one pair for all, a callable of
the shape, or 'auto'); every step updates the Kronecker factors through
`kron.update_multi`, which routes each layer to its kernel as `kron.route`
reports. With `kron_batched` (the default), an fp32 state stacks each
bucket of at least `kron_batch_min` (dense, dense) layers whose 128-padded
shapes agree into a `kron.BatchedDDState` (the state is then a
`KronPrecond`), and updates it with `kron.update_batched` (K4 on the card).

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

Inside `hopper.sharding(mesh)` (as `parallel.build_sharded_step` runs it)
the loss, gradients and Hvps are averaged over the mesh's `data` ranks in
one all-reduce, and a flat family's state is this rank's slice: every rank
draws the full probe from its identically seeded generator and takes its
slice, the family updates and applies on the slice, and P g is gathered to
full length over `shard`. The parameters are full inside the step; under
tensor-parallel specs (`hopper.sharding(mesh, param_specs)`) only the
split leaves' slices are averaged over `data` and the means gathered back.
The coins come from CPU generators seeded alike on every rank, so every
rank branches alike. The Kronecker states replicate and their step does
not change.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch

from psgd_tf_tpu_torch import hvp
from psgd_tf_tpu_torch.groups import dense, diag, kron, lra, shift, splu, xmat
from psgd_tf_tpu_torch.ops import hopper, linalg

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
    precond: Any  # list[kron.KronState], one per tensor, or a KronPrecond; or a flat family's
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
class KronPrecond:
    """Kron state with the (dense, dense) layers of each large enough
    bucket (128-padded sides that agree) stacked into one
    `kron.BatchedDDState`, updated at once (K4 on the card). `singles` holds
    the other layers' states, including buckets below `kron_batch_min`.
    The index tuples map each group back to the parameter list's order."""

    batches: list
    singles: list
    batched_idx: tuple[tuple[int, ...], ...] = ()
    single_idx: tuple[int, ...] = ()

    def replace(self, **kwargs) -> "KronPrecond":
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
    kron_batched: bool = True   # stack each bucket of same-padded (dense, dense) layers
    kron_batch_min: int = 4     # the fewest layers a stacked bucket takes (JAX's crossover)
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

    def _init_kron(self, params: Sequence[torch.Tensor]):
        """A list of per-layer states, or a `KronPrecond` when an fp32
        state has a bucket of at least max(2, kron_batch_min) (dense, dense)
        layers of side <= 1024 whose 128-padded shapes agree (the JAX
        package's bucketing)."""
        leaves = list(params)
        shapes = [_matrix_shape(p.shape) for p in leaves]
        fmts = [tuple(self._leaf_format(s, i, len(leaves))) for i, s in enumerate(shapes)]
        pad = lambda d: -(-d // 128) * 128
        buckets: dict[tuple[int, int], list[int]] = {}
        for i, (s, f) in enumerate(zip(shapes, fmts)):
            if f == ("dense", "dense") and max(s) <= _BUCKET_MAX_SIDE:
                buckets.setdefault((pad(s[0]), pad(s[1])), []).append(i)
        batched_idx = tuple(tuple(idx) for idx in buckets.values()
                            if len(idx) >= max(2, self.kron_batch_min))

        def single(i):
            return kron.init(shapes[i], fmt=fmts[i], init_scale=self.init_scale,
                             dtype=self.dtype, device=leaves[i].device)

        if not self.kron_batched or not batched_idx or self.dtype != torch.float32:
            return [single(i) for i in range(len(leaves))]
        in_batch = {i for idx in batched_idx for i in idx}
        single_idx = tuple(i for i in range(len(leaves)) if i not in in_batch)
        return KronPrecond(
            batches=[kron.init_batched([shapes[i] for i in idx], init_scale=self.init_scale,
                                       dtype=self.dtype, device=leaves[idx[0]].device)
                     for idx in batched_idx],
            singles=[single(i) for i in single_idx],
            batched_idx=batched_idx,
            single_idx=single_idx,
        )

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
            loss, grads, hvs = _data_mean(loss, grads, hvs)
            vs = [_as_matrix(x).to(self.dtype) for x in v]
            hs = [_as_matrix(x).to(self.dtype) for x in hvs]
            step = state.hyper.lr_preconditioner
            pc = state.precond
            if isinstance(pc, KronPrecond):
                precond = pc.replace(
                    batches=[kron.update_batched(b, [vs[i] for i in idx], [hs[i] for i in idx],
                                                 step=step)
                             for b, idx in zip(pc.batches, pc.batched_idx)],
                    singles=kron.update_multi(pc.singles, [vs[i] for i in pc.single_idx],
                                              [hs[i] for i in pc.single_idx], step=step),
                )
            else:
                precond = kron.update_multi(pc, vs, hs, step=step)
        else:
            loss, grads, _ = _data_mean(*hvp.grad_only(loss_fn, params, *args))
            precond = state.precond
        return loss, grads, precond, self._kron_apply(precond, grads)

    def _kron_apply(self, precond, grads):
        """P g for every parameter tensor, in the preconditioner's dtype."""
        gs = [_as_matrix(g.to(self.dtype)) for g in grads]
        if not isinstance(precond, KronPrecond):
            pre = [kron.apply(ks, g) for ks, g in zip(precond, gs)]
        else:
            pre = [None] * len(gs)
            for b, idx in zip(precond.batches, precond.batched_idx):
                for i, p in zip(idx, kron.apply_batched(b, [gs[i] for i in idx])):
                    pre[i] = p
            for ks, i in zip(precond.singles, precond.single_idx):
                pre[i] = kron.apply(ks, gs[i])
        return [p.reshape(g.shape) for p, g in zip(pre, grads)]

    def _flat_step(self, loss_fn, params, state, generator, args, do_update, probes, coins):
        """(loss, grads, precond, pre_grads) of a flat family: one Q over the
        raveled parameters."""
        fam = _FLAT_FAMILIES[self.preconditioner]
        hyper = state.hyper
        shapes = [p.shape for p in params]

        n = sum(s.numel() for s in shapes)
        mesh = hopper.shard_ctx()
        if mesh is None:
            local = full = lambda x: x
        else:
            from psgd_tf_tpu_torch.parallel import policies  # late: policies imports this module

            local = lambda x: policies.slice_vec(mesh, state.precond, x)
            full = lambda y: policies.gather_vec(mesh, state.precond, y, n)

        def unravel(flat):
            return [x.reshape(s) for x, s in zip(torch.split(flat, [s.numel() for s in shapes]), shapes)]

        if not do_update:
            loss, grads, _ = _data_mean(*hvp.grad_only(loss_fn, params, *args))
            g_flat = _ravel(grads)
            pre = full(fam.apply(state.precond, local(g_flat.to(self.dtype))))
            return loss, grads, state.precond, unravel(pre.to(g_flat.dtype))

        if probes is not None:
            v = list(probes)
            v_flat = _ravel(v)
        else:
            # the probe in the parameters' dtype (the Hvp runs through the
            # model); cast to the preconditioner's dtype at the family
            v_flat = torch.randn(n, generator=generator, dtype=params[0].dtype,
                                 device=params[0].device)
            v = unravel(v_flat)
        if self.exact_hessian_vector_product:
            loss, grads, hvs = hvp.exact(loss_fn, params, v, *args)
        else:
            loss, grads, hvs = hvp.finite_diff(loss_fn, params, v, *args)
        loss, grads, hvs = _data_mean(loss, grads, hvs)
        g_flat = _ravel(grads)
        extra = {}
        if self.preconditioner == "lra":
            if coins is None:
                coins = (torch.rand((), generator=state.branch).item() < 0.01,
                         torch.rand((), generator=state.branch).item() < 0.5)
            extra["coins"] = coins
        v_flat, h_flat = local(v_flat.to(self.dtype)), local(_ravel(hvs).to(self.dtype))
        g_loc = local(g_flat.to(self.dtype))
        if hasattr(fam, "update_apply"):
            # Q update and preconditioning in one sweep (K11-K16)
            precond, pre = fam.update_apply(state.precond, v_flat, h_flat, g_loc,
                                            step=hyper.lr_preconditioner, **extra)
        else:
            precond = fam.update(state.precond, v_flat, h_flat, step=hyper.lr_preconditioner)
            pre = fam.apply(precond, g_loc)
        return loss, grads, precond, unravel(full(pre).to(g_flat.dtype))

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


def _data_mean(loss, grads, hvs=None):
    """(loss, grads, hvs) averaged over the data ranks of the sharding
    context's mesh, in one all-reduce; as they are outside it.

    Under tensor-parallel specs (`hopper.param_specs()`) the all-reduce
    carries, of each gradient and Hvp, the part that the ranks of this
    rank's data group hold between them (`policies.part` along `shard`
    alone): this rank's block of a leaf that `data` does not split, every
    data rank's block of one that it does (those ranks hold different
    blocks, so their blocks' sum would mix unrelated entries). One gather
    over `shard` then joins the means; a leaf split over `data` alone needs
    none. A reduce-scatter over `data` would reduce less of such a leaf
    but then need a gather over `data` too; this route keeps one collective
    an axis a step and asks the backend for no reduce-scatter."""
    mesh = hopper.shard_ctx()
    if mesh is None or mesh.data == 1:
        return loss, grads, hvs
    from psgd_tf_tpu_torch.parallel import _collectives, policies  # late: policies imports this

    k = len(grads)
    leaves = list(grads) + (list(hvs) if hvs is not None else [])
    specs = hopper.param_specs()
    if specs is not None:
        layouts = policies.param_layouts(mesh, leaves, list(specs) * (len(leaves) // k))
        leaves = [policies.part(mesh, x, layout, ("shard",)) for x, layout in zip(leaves, layouts)]
    out = _collectives.data_mean(mesh, [loss] + leaves)
    loss, leaves = out[0], out[1:]
    if specs is not None:
        leaves = policies.join(mesh, leaves, layouts, [{"shard"}] * len(leaves), "shard")
    return loss, leaves[:k], (leaves[k:] if hvs is not None else None)


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
