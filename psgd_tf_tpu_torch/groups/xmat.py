"""X-shape (flipping-subgroup) preconditioner: Q = diag(a) + antidiag(b).

Counterpart of `psgd_tf_tpu/groups/xmat.py`. Q[i, i] = a_i and
Q[i, n-1-i] = b_i; the invertible X-matrices are the group algebra of
{e, flip}, so the Lie-group update applies with the gradient projected on
the X pattern (the math is in `groups/_pairs.py`).

Layout: FOLDED, as in JAX. The state keeps both halves stacked,
`af[0, i] = a_i`, `af[1, i] = a_{n-1-i}` (i < n // 2), so "flip" is "the
other row". Only the probe fold and unfold reverse data. For odd n the
centre index lies on both diagonals: its diagonal entry is the scalar `ac`
and its anti-diagonal entry stays exactly 0.
"""
from __future__ import annotations

import dataclasses

import torch

from psgd_tf_tpu_torch.groups import _pairs
from psgd_tf_tpu_torch.ops import hopper


@dataclasses.dataclass(frozen=True)
class XMatState:
    af: torch.Tensor  # (2, m) folded diagonal: af[0, i] = a_i, af[1, i] = a_{n-1-i}
    bf: torch.Tensor  # (2, m) folded anti-diagonal
    ac: torch.Tensor  # () centre diagonal entry; meaningful only when odd
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
        """The unfolded (n,) anti-diagonal; the centre is 0."""
        return _unfold(self.bf, self.bf.new_zeros(1) if self.odd else None)


def _fold(x: torch.Tensor, m: int, odd: bool):
    """(n,) -> folded (2, m) and the centre scalar (the only reversal)."""
    xf = torch.stack([x[:m], torch.flip(x[m + 1:] if odd else x[m:], (0,))])
    return xf, (x[m] if odd else x.new_zeros(()))


def _unfold(xf: torch.Tensor, center: torch.Tensor | None) -> torch.Tensor:
    parts = [xf[0]] + ([center] if center is not None else []) + [torch.flip(xf[1], (0,))]
    return torch.cat(parts)


def init(n: int, init_scale: float = 1.0, dtype=torch.float32,
         device: torch.device | str = "cuda") -> XMatState:
    m = n // 2
    return XMatState(
        af=torch.full((2, m), init_scale, dtype=dtype, device=device),
        bf=torch.zeros((2, m), dtype=dtype, device=device),
        ac=torch.tensor(init_scale, dtype=dtype, device=device),
        odd=bool(n % 2),
    )


def matvec(state: XMatState, x: torch.Tensor) -> torch.Tensor:
    """Q x = a*x + b*flip(x)."""
    m, odd = state.af.shape[1], state.odd
    yf, yc = _pairs.matvec(state.af, state.bf, state.ac, *_fold(x, m, odd), odd)
    return _unfold(yf, yc[None] if odd else None)


def update(state: XMatState, v: torch.Tensor, h: torch.Tensor, step=0.01) -> XMatState:
    """One step. Under the sharding context, state, v and h are this rank's
    slices (`parallel/policies.slice_vec`)."""
    m, odd = state.af.shape[1], state.odd
    mesh = hopper.shard_ctx()
    if mesh is not None:
        (vf, vc), (hf, hc) = _pairs.split_local(v), _pairs.split_local(h)
        af, bf, ac = _pairs.update(state.af, state.bf, state.ac, vf, hf, vc, hc, step, odd,
                                   pmax=mesh.pmax)
        return XMatState(af=af, bf=bf, ac=ac, odd=odd)
    hf, hc = _fold(h, m, odd)
    vf, vc = _fold(v, m, odd)
    af, bf, ac = _pairs.update(state.af, state.bf, state.ac, vf, hf, vc, hc, step, odd)
    return XMatState(af=af, bf=bf, ac=ac, odd=odd)


def apply(state: XMatState, g: torch.Tensor) -> torch.Tensor:
    """P g = Q^T (Q g); this rank's slice of it under the sharding context."""
    m, odd = state.af.shape[1], state.odd
    if hopper.shard_ctx() is not None:
        gf, gc = _pairs.split_local(g)
        of, oc = _pairs.apply(state.af, state.bf, state.ac, gf, gc, odd)
        return _pairs.join_local(of, oc if odd else gc.new_zeros(()))
    of, oc = _pairs.apply(state.af, state.bf, state.ac, *_fold(g, m, odd), odd)
    return _unfold(of, oc[None] if odd else None)


def materialize(state: XMatState) -> torch.Tensor:
    """Dense P = Q^T Q, for tests."""
    q = torch.diag(state.a) + torch.fliplr(torch.diag(state.b))
    return q.T @ q
