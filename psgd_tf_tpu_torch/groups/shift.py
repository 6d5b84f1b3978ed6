"""Butterfly (half-length circular-shift subgroup) preconditioner.

Counterpart of `psgd_tf_tpu/groups/shift.py`. Q[i, i] = a_i and
Q[i, σ(i)] = b_i with σ(i) = (i + n//2) mod n for even n: the group
algebra of {e, σ}, with the same pair math as the X-shape family
(`groups/_pairs.py`) and another pairing, coordinate i with the one half
the vector away.

Layout: the fold that puts each orbit {i, i + m} in a column of a (2, m)
array is a reshape, `xf = x[:2m].reshape(2, m)`. For odd n the pairs are
i <-> i + m (m = n // 2) for i < m, and the LAST index is the σ-fixed
centre, with a diagonal entry `ac` and a shift entry of exactly 0.
"""
from __future__ import annotations

import dataclasses

import torch

from psgd_tf_tpu_torch.groups import _pairs
from psgd_tf_tpu_torch.ops import hopper


@dataclasses.dataclass(frozen=True)
class ShiftState:
    af: torch.Tensor  # (2, m) folded diagonal: af[0, i] = a_i, af[1, i] = a_{i+m}
    bf: torch.Tensor  # (2, m) folded shift part: bf[0, i] = Q[i, i+m], bf[1, i] = Q[i+m, i]
    ac: torch.Tensor  # () centre (last index) diagonal entry; meaningful only when odd
    odd: bool = False

    @property
    def n(self) -> int:
        return 2 * self.af.shape[1] + int(self.odd)

    @property
    def a(self) -> torch.Tensor:
        """The unfolded (n,) diagonal (tests, diagnostics)."""
        return _unfold(self.af, self.ac[None] if self.odd else None)

    @property
    def b(self) -> torch.Tensor:
        """The unfolded (n,) shift part; the centre is 0."""
        return _unfold(self.bf, self.bf.new_zeros(1) if self.odd else None)


def _fold(x: torch.Tensor, m: int, odd: bool):
    """(n,) -> folded (2, m) and the centre scalar (a reshape)."""
    return x[: 2 * m].reshape(2, m), (x[2 * m] if odd else x.new_zeros(()))


def _unfold(xf: torch.Tensor, center: torch.Tensor | None) -> torch.Tensor:
    flat = xf.reshape(-1)
    return flat if center is None else torch.cat([flat, center])


def init(n: int, init_scale: float = 1.0, dtype=torch.float32,
         device: torch.device | str = "cuda") -> ShiftState:
    m = n // 2
    return ShiftState(
        af=torch.full((2, m), init_scale, dtype=dtype, device=device),
        bf=torch.zeros((2, m), dtype=dtype, device=device),
        ac=torch.tensor(init_scale, dtype=dtype, device=device),
        odd=bool(n % 2),
    )


def matvec(state: ShiftState, x: torch.Tensor) -> torch.Tensor:
    """Q x = a*x + b*(x shifted by n//2)."""
    m, odd = state.af.shape[1], state.odd
    yf, yc = _pairs.matvec(state.af, state.bf, state.ac, *_fold(x, m, odd), odd)
    return _unfold(yf, yc[None] if odd else None)


def update(state: ShiftState, v: torch.Tensor, h: torch.Tensor, step=0.01) -> ShiftState:
    """One step. Under the sharding context, state, v and h are this rank's
    slices (`parallel/policies.slice_vec`)."""
    m, odd = state.af.shape[1], state.odd
    mesh = hopper.shard_ctx()
    if mesh is not None:
        (vf, vc), (hf, hc) = _pairs.split_local(v), _pairs.split_local(h)
        af, bf, ac = _pairs.update(state.af, state.bf, state.ac, vf, hf, vc, hc, step, odd,
                                   pmax=mesh.pmax)
        return ShiftState(af=af, bf=bf, ac=ac, odd=odd)
    hf, hc = _fold(h, m, odd)
    vf, vc = _fold(v, m, odd)
    af, bf, ac = _pairs.update(state.af, state.bf, state.ac, vf, hf, vc, hc, step, odd)
    return ShiftState(af=af, bf=bf, ac=ac, odd=odd)


def apply(state: ShiftState, g: torch.Tensor) -> torch.Tensor:
    """P g = Q^T (Q g); this rank's slice of it under the sharding context."""
    m, odd = state.af.shape[1], state.odd
    if hopper.shard_ctx() is not None:
        gf, gc = _pairs.split_local(g)
        of, oc = _pairs.apply(state.af, state.bf, state.ac, gf, gc, odd)
        return _pairs.join_local(of, oc if odd else gc.new_zeros(()))
    of, oc = _pairs.apply(state.af, state.bf, state.ac, *_fold(g, m, odd), odd)
    return _unfold(of, oc[None] if odd else None)


def materialize(state: ShiftState) -> torch.Tensor:
    """Dense P = Q^T Q, for tests."""
    n, m = state.n, state.af.shape[1]
    perm = (torch.arange(n, device=state.af.device) + m) % (2 * m)
    if state.odd:
        perm[2 * m] = 2 * m
    q = torch.diag(state.a)
    q[torch.arange(n, device=q.device), perm] += state.b
    return q.T @ q
