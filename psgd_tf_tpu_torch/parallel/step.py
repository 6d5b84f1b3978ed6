"""The sharded training step.

Counterpart of `psgd_tf_tpu/parallel/step.py:20-94`. The JAX package jits
`opt.step` with shardings and lets GSPMD insert the collectives; here the
step runs eagerly on every rank of the mesh and the collectives are
explicit: each rank takes its `data` slice of every batch argument, the
loss, gradients and Hvps are averaged over `data` in one all-reduce, and
the optimizer step runs inside `hopper.sharding(mesh)`, where the flat
families hold their rank-local state (`policies.shard_state`) and reduce
their rank-space quantities over `shard` (K14, the sharded K16). The
parameters replicate, or split over `data`, `shard` or both where
`param_specs` says so. Under `param_specs` the gather of the blocks and
the return to them are `psgd_exchange` spans (`utils.profiling.scope`).
"""
from __future__ import annotations

from typing import Any, Callable

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.optim.psgd import PSGD, PSGDState
from psgd_tf_tpu_torch.parallel import policies
from psgd_tf_tpu_torch.utils.profiling import scope


def build_sharded_step(opt: PSGD, loss_fn: Callable, mesh, state: PSGDState, params: Any,
                       batch_axes: tuple[int, ...] | None = None, param_specs: Any = None):
    """Returns `step(params, local_state, generator, *batch, probes=None,
    coins=None) -> (params, local_state, aux)`.

    `local_state` is this rank's slice of the state, `policies.shard_state(
    mesh, opt.init(params, seed))` at the start, alike on every rank's
    seed; `generator` is seeded alike on every rank too, so every rank draws
    the same probes. Every positional batch argument (or those `batch_axes`
    names) is split along its leading axis over `data`, which must divide
    it. `state` selects the family's policy (it raises for a state with
    none).

    `param_specs` (a list aligned with the full `params`) makes the
    parameters tensor-parallel. Each entry is None (replicated) or a tuple
    in `PartitionSpec` order, with at most one entry per leading dimension:
    None, "data", "shard" or a tuple of both names, the first the major one
    as in GSPMD (under `("data", "shard")` the rank at (d, s) holds block
    d * shard + s of that dimension, under `("shard", "data")` block
    s * data + d); each mesh axis appears once at most. The step takes and
    returns each split parameter as this rank's block
    (`policies.shard_params`). Inside it gathers the blocks (one gather over
    `shard`, then one over `data`), runs `loss_fn`, the probes and the Hvp
    on the full parameters, averages the gradients and Hvps over `data`
    (with the loss, one all-reduce that carries of each split leaf the part
    this rank's data group holds) and joins the means over `shard` (one
    gather; see `optim.psgd._data_mean`; with data = 1 a rank's gradient is
    already the mean, and neither runs). The family's step then runs as
    without specs: Kronecker factors replicate on the full matrices, lra
    and splu take their lane slices over `shard`. A duplicate or unknown
    axis name, more entries than dimensions, or a dimension that the
    product of its entry's degrees does not divide raises ValueError, as
    JAX's jit does."""
    policies.state_sharding(mesh, state)
    if param_specs is not None:
        param_specs = list(param_specs)
        local_shapes = [p.shape for p in policies.shard_params(mesh, params, param_specs)]

    def take(i, x):
        if batch_axes is not None and i not in batch_axes:
            return x
        b = x.shape[0]
        if b % mesh.data:
            raise ValueError(f"batch argument {i} has {b} rows, not divisible by data={mesh.data}")
        k = b // mesh.data
        return x[mesh.data_rank * k:(mesh.data_rank + 1) * k]

    def step(params, local_state, generator, *batch, probes=None, coins=None):
        local = [take(i, x) for i, x in enumerate(batch)]
        if param_specs is not None:
            shapes = [p.shape for p in params]
            if shapes != local_shapes:
                raise ValueError(f"the step takes this rank's parameter blocks {local_shapes}, "
                                 f"got {shapes}")
            with scope("psgd_exchange"):
                params = policies.gather_params(mesh, params, param_specs)
        with hopper.sharding(mesh, param_specs):
            params, local_state, aux = opt.step(loss_fn, params, local_state, generator, *local,
                                                probes=probes, coins=coins)
        if param_specs is not None:
            with scope("psgd_exchange"):
                params = policies.shard_params(mesh, params, param_specs)
        return params, local_state, aux

    return step
