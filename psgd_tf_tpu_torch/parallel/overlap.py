"""Ring reductions over a shard group, and the model of what a sharded step
exchanges.

Counterpart of `psgd_tf_tpu/parallel/overlap.py:28-187`. `ring_reduce` is
an all-reduce made of n - 1 hops of point-to-point sends around the ring,
each hop independent of any kernel launched after it: the pipelined K14
(`ops/hopper/lra_upd.fused_update_sharded(pipelined=True)`, where its hops
need no host memory) reduces one lane chunk's Gram this way while the next
chunk streams. Each
rank keeps every rank's value as it passes and folds them in rank order,
so all ranks hold the same bits (the JAX ring folds in arrival order).
`comm_model` is plain arithmetic, copied from the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from psgd_tf_tpu_torch.parallel import _collectives


def ring_reduce(x: torch.Tensor, group, size: int, rank: int,
                op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.add
                ) -> torch.Tensor:
    """`x` reduced with `op` over the `size` ranks of `group`, by n - 1 ring
    hops; `x` itself for one rank."""
    if size == 1:
        return x
    vals = {rank: x}
    buf = x
    for hop in range(1, size):
        buf = _collectives.ring_hop(buf, group, size, rank)
        vals[(rank - hop) % size] = buf
    acc = vals[0]
    for k in range(1, size):
        acc = op(acc, vals[k])
    return acc


def ring_max(x: torch.Tensor, group, size: int, rank: int) -> torch.Tensor:
    return ring_reduce(x, group, size, rank, op=torch.maximum)


def comm_model(family: str, n_params: int | None = None, rank: int = 10,
               dtype_bytes: int = 4,
               param_shapes: list[tuple[int, ...]] | None = None,
               param_specs: list | None = None,
               mesh_shape: dict[str, int] | None = None) -> dict[str, Any]:
    """Analytic bytes exchanged per SHARDED training step, per device pair
    of collectives (payload, not wire framing) — computable today,
    measurable when multi-chip hardware exists.

    Replicated-params (pure DP) call: `comm_model(family, n_params)`.
    Tensor-parallel call: pass `param_shapes` (per-param shapes),
    `param_specs` (aligned per-axis specs, or None: a tuple with one entry
    per dimension, each None, an axis name or a tuple of axis names, as a
    JAX PartitionSpec iterates) and
    `mesh_shape` (e.g. `{"data": 4, "shard": 2}`); the DP term is then
    computed PER PARAM from its local shard size rather than the
    full-replication `2 * n_params`.

    Terms:
      * data parallelism: the loss gradient AND the Hvp probe all-reduce
        over the `data` axis every step. A param sharded d ways over
        `shard` contributes its LOCAL size (GSPMD reduces each shard
        independently over `data`) -> 2 * sum(local sizes) * dtype_bytes.
      * tensor parallelism: a `shard`-sharded param's probe (dX), Hvp (dG)
        and gradient each all-gather at the preconditioner boundary — the
        kron factor algebra and the flatten-concat families consume
        replicated per-tensor views (parallel/step.py docstring: "GSPMD
        gathering each TP layer's probe at the shard_map boundary").
        Per-device received payload per gather of a size-s param sharded
        d ways: s * (d-1)/d elements -> 3 gathers per sharded param.
        (The preconditioned-grad slice back to the shard is local.)
      * preconditioner state sharding over `shard`: only RANK-SPACE
        quantities cross devices (the design invariant of every family's
        sharded kernel); O(n) state never moves.
          lra  : stage-1 Gram (2r+2)^2 + apply Gram (2r+2)^2 + maxes
          splu : corner solves replicate r-vectors / r^2 corners
          dense/kron/diag/xmat/shift: zero (replicated factors or
              lane-local folded updates)
    """
    z = 2 * rank + 2
    shard_payload = {
        "lra": (2 * z * z + 8 + 1) * dtype_bytes,
        "splu": (2 * rank * rank + 6 * rank + 8) * dtype_bytes,
        "dense": 0,
        "diag": 0,
        "xmat": 0,
        "shift": 0,
        "kron": 0,
    }[family]

    def _axis_degree(axis_entry):
        d = 1
        for ax in (axis_entry if isinstance(axis_entry, tuple)
                   else (axis_entry,)):
            if ax is not None:
                d *= mesh_shape.get(ax, 1)
        return d

    def _local_size(shape, spec):
        """Per-device shard elements. GSPMD pads each non-divisible
        SHARDED AXIS up to its mesh degree, so the local size is the
        product of per-axis ceil(dim/degree) — not ceil of the flat
        size."""
        if spec is None or mesh_shape is None:
            return int(_prod(shape))
        ent = tuple(spec)
        out = 1
        for k, dim in enumerate(shape):
            d = _axis_degree(ent[k]) if k < len(ent) else 1
            out *= -(-int(dim) // d)
        return out

    def _shard_degree(spec):
        if spec is None or mesh_shape is None:
            return 1
        d = 1
        for axis_entry in tuple(spec):
            d *= _axis_degree(axis_entry)
        return d

    if param_shapes is not None:
        if param_specs is None:
            param_specs = [None] * len(param_shapes)
        if len(param_specs) != len(param_shapes):
            raise ValueError("param_specs must align with param_shapes")
        if mesh_shape is None and any(sp is not None for sp in param_specs):
            # a forgotten mesh_shape would silently treat every spec as
            # degree 1 (tp_gather_bytes_per_step=0, full-size DP terms) —
            # a plausible-looking but wrong TP accounting (ADVICE r4)
            raise ValueError(
                "param_specs given without mesh_shape: pass mesh_shape "
                "(e.g. {'data': 4, 'shard': 2}) so shard degrees resolve"
            )
        sizes = [int(_prod(s)) for s in param_shapes]
        degrees = [_shard_degree(sp) for sp in param_specs]
        locals_ = [_local_size(s, sp)
                   for s, sp in zip(param_shapes, param_specs)]
        n_params = sum(sizes)
        # both the DP reduce and the (d-1) gathered remote shards move
        # the PADDED per-device size
        dp_payload = 2 * sum(locals_) * dtype_bytes
        tp_payload = 3 * sum(
            (d - 1) * loc for loc, d in zip(locals_, degrees)
        ) * dtype_bytes
        n_tp = sum(1 for d in degrees if d > 1)
    else:
        if n_params is None:
            raise ValueError("pass n_params or param_shapes")
        dp_payload = 2 * n_params * dtype_bytes
        tp_payload = 0
        n_tp = 0
    return {
        "family": family,
        "n_params": n_params,
        "rank": rank,
        "dp_bytes_per_step": dp_payload,
        "tp_gather_bytes_per_step": tp_payload,
        "tp_sharded_params": n_tp,
        "shard_bytes_per_step": shard_payload,
        "shard_to_state_ratio": shard_payload
        / max(1, n_params * dtype_bytes),
    }


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out
