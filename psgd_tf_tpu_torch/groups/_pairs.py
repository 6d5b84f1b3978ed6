"""Row-pair math shared by the involution-subgroup preconditioners.

Counterpart of `psgd_tf_tpu/groups/_pairs.py`. An index involution σ
(σ∘σ = identity) gives the group algebra of {e, σ}: Q = diag(a) + diag(b)·Pσ
with Q[i, i] = a_i and Q[i, σ(i)] = b_i. Once vectors are FOLDED so that
each orbit {i, σ(i)} is a column of a (2, m) array (`xf[0, i] = x_i`,
`xf[1, i] = x_σ(i)`), the X-shape family (σ = flip, `groups/xmat.py`) and
the butterfly family (σ = half-length shift, `groups/shift.py`) share this
math; they differ only in the fold and in which index, for odd n, is the
σ-fixed centre carried as a scalar.

On a folded pair, with (a0, a1) = (a_i, a_σ(i)):
  Q x        : y0 = a0·x0 + b0·x1,  y1 = a1·x1 + b1·x0
  Q^{-T} v   : a 2×2 solve per pair, det = a0·a1 − b0·b1
  group grad : p = u∘u − w∘w (diagonal), q = u0·u1 − w0·w1 (σ part),
               u = Q h, w = Q^{-T} v
  Q ← Q − step/(max|G| + tiny) · G·Q
Every op is elementwise: the JAX package has no kernel for these families,
and neither has the port. Under the sharding context (`hopper.sharding`)
a rank holds a slice of the folded columns; the one exchange is the max
of the step normalizer.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.ops import linalg


def matvec(af, bf, ac, xf, xc, odd: bool):
    """Q x on folded rows; returns (yf, yc), yc None for even n."""
    (a0, a1), (b0, b1) = af, bf
    x0, x1 = xf
    yf = torch.stack([a0 * x0 + b0 * x1, a1 * x1 + b1 * x0])
    return yf, (ac * xc if odd else None)


def update(af, bf, ac, vf, hf, vc, hc, step, odd: bool, pmax=None):
    """One Lie-group step; returns (af', bf', ac'). `pmax` takes the step
    normalizer's max over the ranks that hold the other columns."""
    a0, a1 = af
    b0, b1 = bf
    h0, h1 = hf
    v0, v1 = vf

    u0 = a0 * h0 + b0 * h1                            # Q h
    u1 = a1 * h1 + b1 * h0
    det = a0 * a1 - b0 * b1
    w0 = (a1 * v0 - b1 * v1) / det                    # Q^{-T} v
    w1 = (a0 * v1 - b0 * v0) / det

    p0 = u0 * u0 - w0 * w0                            # diagonal gradient
    p1 = u1 * u1 - w1 * w1
    qv = u0 * u1 - w0 * w1                            # σ gradient (symmetric)

    max_p = torch.maximum(linalg.max_abs(p0), linalg.max_abs(p1))
    pc = None
    if odd:
        uc = ac * hc
        wc = vc / ac
        pc = uc * uc - wc * wc
        max_p = torch.maximum(max_p, pc.abs())
    max_g = torch.maximum(max_p, linalg.max_abs(qv))
    if pmax is not None:
        max_g = pmax(max_g)
    step0 = linalg.step_scale(step, max_g, af.dtype)

    new_af = torch.stack([a0 - step0 * (p0 * a0 + qv * b1), a1 - step0 * (p1 * a1 + qv * b0)])
    new_bf = torch.stack([b0 - step0 * (p0 * b0 + qv * a1), b1 - step0 * (p1 * b1 + qv * a0)])
    new_ac = ac - step0 * pc * ac if odd else ac
    return new_af, new_bf, new_ac


def apply(af, bf, ac, gf, gc, odd: bool):
    """P g = Q^T (Q g) on folded rows; returns (of, oc), oc None for even n."""
    a0, a1 = af
    b0, b1 = bf
    g0, g1 = gf
    t0 = a0 * g0 + b0 * g1                            # Q g
    t1 = a1 * g1 + b1 * g0
    of = torch.stack([a0 * t0 + b1 * t1, a1 * t1 + b0 * t0])  # Q^T (Q g)
    return of, (ac * ac * gc if odd else None)


def join_local(xf: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """A rank's slice of a folded vector under the sharding context: its
    (2, c) columns and the centre (0 for even n), as one (2c + 1,) vector
    (`parallel/policies.slice_vec`)."""
    return torch.cat([xf.reshape(-1), xc.reshape(1).to(xf.dtype)])


def split_local(x: torch.Tensor):
    """(xf (2, c), xc) of a slice laid out by `join_local`."""
    c = (x.shape[0] - 1) // 2
    return x[:2 * c].reshape(2, c), x[2 * c]
