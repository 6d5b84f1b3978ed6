"""The sharded training step.

Counterpart of `psgd_tf_tpu/parallel/step.py:20-94`. The JAX package jits
`opt.step` with shardings and lets GSPMD insert the collectives; here the
step runs eagerly on every rank of the mesh and the collectives are
explicit: each rank takes its `data` slice of every batch argument, the
loss, gradients and Hvps are averaged over `data` in one all-reduce, and
the optimizer step runs inside `hopper.sharding(mesh)`, where the flat
families hold their rank-local state (`policies.shard_state`) and reduce
their rank-space quantities over `shard` (K14, the sharded K16). The
parameters replicate.
"""
from __future__ import annotations

from typing import Any, Callable

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.optim.psgd import PSGD, PSGDState
from psgd_tf_tpu_torch.parallel import policies


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
    none). Tensor-parallel `param_specs` are not ported."""
    if param_specs is not None:
        raise NotImplementedError(
            "tensor-parallel param_specs are not ported (ROADMAP queue 1: tensor-parallel "
            "parameters)")
    policies.state_sharding(mesh, state)

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
        with hopper.sharding(mesh):
            return opt.step(loss_fn, params, local_state, generator, *local, probes=probes,
                            coins=coins)

    return step
