"""Sharding policies: where each piece of PSGD state lives on the mesh.

Counterpart of `psgd_tf_tpu/parallel/policies.py:43-114`, with the same
placement per family:

  dense  : Q replicates (its update is sequential along the rows).
  diag   : q over `shard` (lanes).
  xmat   : the folded (2, m) columns over `shard`; the centre replicates.
  shift  : as xmat (each orbit {i, i+m} is a column).
  splu   : the tail columns of Lt and U12 and the tails l3, u3 over
           `shard`; the r x r corners replicate.
  lra    : the columns of UV and d over `shard`.
  kron   : every factor replicates (a list of KronStates or a KronPrecond).

Parameters replicate and batches shard their leading axis over `data`.
Torch has no `NamedSharding`: `precond_sharding` returns the same structure
with a placement spec in each field, as a tuple in the JAX package's
`PartitionSpec` order (`()` replicated, `("shard",)` lanes, `(None,
"shard")` columns).

`shard_state(mesh, state)` takes a full state to this rank's slice and
`gather_state(mesh, local, n)` takes the slices back to the full state
of n parameters. A lane axis of length L pads to S * ceil(L / S) (S the
shard ranks), as the JAX kernels pad it, with values that keep the pad
inert: q = 1, d = 1, l3 = u3 = 1, af = 1 and zero elsewhere. `slice_vec`
and `gather_vec` do the same for a length-n vector (a probe, an Hvp, a
gradient, P g) in the family's layout: diag and lra take lanes, splu the
corner's r entries and a slice of the tail, xmat and shift the folded
columns and the centre (`groups/_pairs.join_local`).
"""
from __future__ import annotations

from typing import Any

import torch

from psgd_tf_tpu_torch.groups import _pairs, dense, diag, lra, shift, splu, xmat
from psgd_tf_tpu_torch.optim.psgd import KronPrecond, PSGDState

REP, ROW, COLS = (), ("shard",), (None, "shard")


def replicated(mesh) -> tuple:
    return REP


def batch_sharding(mesh) -> tuple:
    """Leading (batch) axis over `data`."""
    return ("data",)


def precond_sharding(mesh, precond: Any) -> Any:
    """The family state's structure with a placement spec in each field."""
    if isinstance(precond, dense.DenseState):
        return dense.DenseState(Q=REP)
    if isinstance(precond, diag.DiagState):
        return diag.DiagState(q=ROW)
    if isinstance(precond, (xmat.XMatState, shift.ShiftState)):
        return type(precond)(af=COLS, bf=COLS, ac=REP, odd=precond.odd)
    if isinstance(precond, splu.SpLUState):
        # the corner columns [:, :r] of Lt and U12 replicate, the tail shards
        return splu.SpLUState(Lt=COLS, l3=ROW, U12=COLS, u3=ROW)
    if isinstance(precond, lra.LRAState):
        return lra.LRAState(UV=COLS, d=ROW)
    if isinstance(precond, (list, tuple)):
        return type(precond)(REP for _ in precond)
    if isinstance(precond, KronPrecond):
        return precond.replace(batches=[REP for _ in precond.batches],
                               singles=[REP for _ in precond.singles])
    raise TypeError(f"no sharding policy for {type(precond)!r}")


def state_sharding(mesh, state: PSGDState) -> PSGDState:
    """Specs for the whole PSGDState: everything but the family's state replicates."""
    return state.replace(count=REP, hyper=REP, precond=precond_sharding(mesh, state.precond))


# ------------------------------------------------------------ lanes

def _chunk(length: int, shards: int) -> int:
    return -(-length // shards)


def _take(mesh, x: torch.Tensor, fill: float) -> torch.Tensor:
    """This rank's slice of the last axis of x, padded with `fill`."""
    c = _chunk(x.shape[-1], mesh.shard)
    pad = c * mesh.shard - x.shape[-1]
    if pad:
        x = torch.cat([x, x.new_full(x.shape[:-1] + (pad,), fill)], -1)
    return x[..., mesh.shard_rank * c:(mesh.shard_rank + 1) * c].contiguous()


def _valid(mesh, length: int) -> int:
    """How many lanes of this rank's slice of a length-`length` axis are not padding."""
    c = _chunk(length, mesh.shard)
    return max(0, min(c, length - mesh.shard_rank * c))


def _gather(mesh, x: torch.Tensor, length: int) -> torch.Tensor:
    """The ranks' slices of the last axis of x, concatenated and trimmed."""
    lead = x.shape[:-1]
    flat = mesh.all_gather_lanes(x.reshape(-1))
    full = flat.reshape((mesh.shard,) + lead + (x.shape[-1],)).movedim(0, -2)
    return full.reshape(lead + (-1,))[..., :length]


def _fold(precond, x: torch.Tensor):
    """(folded (2, n // 2), centre) of a full (n,) vector."""
    mod = xmat if isinstance(precond, xmat.XMatState) else shift
    return mod._fold(x, x.shape[0] // 2, bool(x.shape[0] % 2))


def shard_state(mesh, state):
    """A full PSGDState (or family state) -> this rank's slice."""
    if isinstance(state, PSGDState):
        return state.replace(precond=shard_state(mesh, state.precond))
    p = state
    if isinstance(p, diag.DiagState):
        return diag.DiagState(q=_take(mesh, p.q, 1.0))
    if isinstance(p, (xmat.XMatState, shift.ShiftState)):
        return type(p)(af=_take(mesh, p.af, 1.0), bf=_take(mesh, p.bf, 0.0), ac=p.ac, odd=p.odd)
    if isinstance(p, splu.SpLUState):
        r = p.rank
        return splu.SpLUState(
            Lt=torch.cat([p.Lt[:, :r], _take(mesh, p.Lt[:, r:], 0.0)], 1), l3=_take(mesh, p.l3, 1.0),
            U12=torch.cat([p.U12[:, :r], _take(mesh, p.U12[:, r:], 0.0)], 1),
            u3=_take(mesh, p.u3, 1.0), tail_valid=_valid(mesh, p.l3.shape[0]))
    if isinstance(p, lra.LRAState):
        return lra.LRAState(UV=_take(mesh, p.UV, 0.0), d=_take(mesh, p.d, 1.0))
    precond_sharding(mesh, p)  # raises for a type with no policy
    return p


def gather_state(mesh, local, n: int):
    """This rank's slice (a PSGDState or family state) -> the full state of
    n parameters, trimmed; the same on every rank."""
    if isinstance(local, PSGDState):
        return local.replace(precond=gather_state(mesh, local.precond, n))
    p = local
    if isinstance(p, diag.DiagState):
        return diag.DiagState(q=_gather(mesh, p.q, n))
    if isinstance(p, (xmat.XMatState, shift.ShiftState)):
        m = n // 2
        return type(p)(af=_gather(mesh, p.af, m), bf=_gather(mesh, p.bf, m), ac=p.ac, odd=p.odd)
    if isinstance(p, splu.SpLUState):
        r = p.rank
        return splu.SpLUState(
            Lt=torch.cat([p.Lt[:, :r], _gather(mesh, p.Lt[:, r:], n - r)], 1),
            l3=_gather(mesh, p.l3, n - r),
            U12=torch.cat([p.U12[:, :r], _gather(mesh, p.U12[:, r:], n - r)], 1),
            u3=_gather(mesh, p.u3, n - r))
    if isinstance(p, lra.LRAState):
        return lra.LRAState(UV=_gather(mesh, p.UV, n), d=_gather(mesh, p.d, n))
    precond_sharding(mesh, p)
    return p


def slice_vec(mesh, precond, x: torch.Tensor) -> torch.Tensor:
    """A full (n,) vector -> this rank's slice in the family's layout."""
    if isinstance(precond, (diag.DiagState, lra.LRAState)):
        return _take(mesh, x, 0.0)
    if isinstance(precond, splu.SpLUState):
        r = precond.rank
        return torch.cat([x[:r], _take(mesh, x[r:], 0.0)])
    if isinstance(precond, (xmat.XMatState, shift.ShiftState)):
        xf, xc = _fold(precond, x)
        return _pairs.join_local(_take(mesh, xf, 0.0), xc)
    return x


def gather_vec(mesh, precond, y: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's slice of a vector (as `slice_vec` lays it) -> the full (n,)."""
    if isinstance(precond, (diag.DiagState, lra.LRAState)):
        return _gather(mesh, y, n)
    if isinstance(precond, splu.SpLUState):
        r = precond.rank
        return torch.cat([y[:r], _gather(mesh, y[r:], n - r)])
    if isinstance(precond, (xmat.XMatState, shift.ShiftState)):
        yf, yc = _pairs.split_local(y)
        mod = xmat if isinstance(precond, xmat.XMatState) else shift
        return mod._unfold(_gather(mesh, yf, n // 2), yc[None] if precond.odd else None)
    return y
