"""Sparse-LU preconditioner: P = Q^T Q with Q = L U.

Counterpart of `psgd_tf_tpu/groups/splu.py`:

  L = [L1   0      ]      U = [U1  U2       ]
      [L2   diag(l3)]         [0   diag(u3) ]

with a dense order-r corner (L1 lower, U1 upper triangular) and diagonal
tails, so the state is O(n r) for n parameters.

State layout: rank-major, as in JAX, `Lt = [L1^T | L2^T]` (r, n),
`U12 = [U1 | U2]` (r, n), `l3` and `u3` (n - r,). The port keeps ONE layout
for both regimes, at these logical shapes: the kernels of K15 and K16 read
it in place (the tail is lanes r.. of each row) and mask the ragged last
tile, so nothing is padded in memory. JAX's second class,
`SpLUStreamState`, exists only for the TPU kernels' pad copies; its
logical views `Lt`, `l3`, `U12`, `u3` feed `interop.splu_state` like a
`SpLUState`'s fields.

Routing (`route`) follows the JAX package: fp32 on CUDA with n - r >= 1
takes K15 (`splu_one`) while JAX's VMEM cap `splu_one.fits(r, n)` holds
and K16 (`splu_upd`) past it; the CPU, `hopper.disabled()` and other
dtypes take the direct form (`update_plain`, the JAX XLA path with the
balancing up front). `update_apply` takes K15's fused apply in the
resident regime; in the streaming regime it runs K16's update and then
the apply in torch, as JAX does.

Under the sharding context (`hopper.sharding`) a state is this rank's
slice: the corners replicate and the tail is split over the shard ranks
(`parallel/policies`). Both `update` and `update_apply` then take the
sharded K16 (its plain chain on the CPU), whatever n is.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from psgd_tf_tpu_torch.ops import hopper, linalg
from psgd_tf_tpu_torch.ops.hopper import splu_one, splu_upd


@dataclasses.dataclass(frozen=True)
class SpLUState:
    Lt: torch.Tensor   # (r, n) = L12^T: [:, :r] = L1^T (upper triangular), [:, r:] = L2^T
    l3: torch.Tensor   # (n - r,)
    U12: torch.Tensor  # (r, n): [U1 (upper triangular), U2]
    u3: torch.Tensor   # (n - r,)
    # under the sharding context: the tail lanes of this rank's slice that
    # are not padding (`parallel/policies.shard_state`); None: all of them
    tail_valid: int | None = None

    @property
    def rank(self) -> int:
        return self.U12.shape[0]

    @property
    def L12(self) -> torch.Tensor:
        """The (n, r) column layout (tests, diagnostics)."""
        return self.Lt.T


def init(n: int, rank: int = 10, init_scale: float = 1.0, dtype=torch.float32,
         device: torch.device | str = "cuda") -> SpLUState:
    """L = U = init_scale I, with r = min(rank, n)."""
    r = min(rank, n)
    f = dict(dtype=dtype, device=device)
    corner = torch.cat([init_scale * torch.eye(r, **f), torch.zeros(r, n - r, **f)], 1)
    return SpLUState(Lt=corner, l3=torch.full((n - r,), init_scale, **f),
                     U12=corner.clone(), u3=torch.full((n - r,), init_scale, **f))


def walked_state(n: int, rank: int, generator: torch.Generator,
                 device: torch.device | str = "cuda", steps: int = 3) -> SpLUState:
    """A state off 0.7 I, l3 spread so that the balance moves it, walked
    `steps` direct-form updates on random probes from `generator`: the
    starting point of the kernels' checks."""
    st = init(n, rank=rank, init_scale=0.7, device=device)
    r = st.rank
    st = SpLUState(st.Lt, st.l3 * (1.0 + torch.rand(n - r, generator=generator, device=device)),
                   st.U12, st.u3)
    for _ in range(steps):
        st = update_plain(st, *(torch.randn(n, generator=generator, device=device)
                                for _ in range(2)), 0.1)
    return st


def route(r: int, n: int, device: torch.device | str, dtype=torch.float32) -> str:
    """Which path serves the update of a rank-r state over n parameters on
    `device`: 'plain' on the CPU, inside `hopper.disabled()`, for a dtype
    other than fp32 or when n - r < 1; on a CUDA device 'splu_one' (K15)
    while the JAX package's cap `splu_one.fits(r, n)` holds, 'splu_upd'
    (K16) past it."""
    if dtype != torch.float32 or n - r < 1 or not hopper.use_kernel(device):
        return "plain"
    return "splu_one" if splu_one.fits(r, n) else "splu_upd"


def _route(state: SpLUState) -> str:
    r, n = state.U12.shape
    return route(r, n, state.Lt.device, state.Lt.dtype)


def _sharded(state: SpLUState, v, h, step, mesh, g=None):
    """The update (and P' g) on this rank's slice: the sharded K16 for fp32,
    never K15, as `psgd_tf_tpu/groups/splu.py:274-296` routes under its
    sharding context; its plain chain on the CPU and for other dtypes."""
    plain = hopper.disabled() if state.Lt.dtype != torch.float32 else contextlib.nullcontext()
    with plain:
        out = splu_upd.fused_update_sharded(state.Lt, state.l3, state.U12, state.u3, v, h, step,
                                            mesh, state.tail_valid, g)
    return SpLUState(*out[:4], tail_valid=state.tail_valid), out[4]


def update(state: SpLUState, v: torch.Tensor, h: torch.Tensor, step=0.01) -> SpLUState:
    """One Lie-group step fitting Q to the curvature pair (v, h). Under the
    sharding context, state, v and h are this rank's slices."""
    mesh = hopper.shard_ctx()
    if mesh is not None:
        return _sharded(state, v, h, step, mesh)[0]
    rt = _route(state)
    if rt == "plain":
        return update_plain(state, v, h, step)
    mod = splu_one if rt == "splu_one" else splu_upd
    return SpLUState(*mod.fused_update(state.Lt, state.l3, state.U12, state.u3, v, h, step))


def update_apply(state: SpLUState, v: torch.Tensor, h: torch.Tensor, g: torch.Tensor,
                 step=0.01) -> tuple[SpLUState, torch.Tensor]:
    """update() followed by apply() of the UPDATED state; K15 fuses the two,
    and so does the sharded K16 under the sharding context."""
    mesh = hopper.shard_ctx()
    if mesh is not None:
        return _sharded(state, v, h, step, mesh, g)
    if _route(state) == "splu_one":
        *new, pre = splu_one.fused_update_apply(state.Lt, state.l3, state.U12, state.u3,
                                                v, h, g, step)
        return SpLUState(*new), pre
    new = update(state, v, h, step)
    return new, apply(new, g)


def _blocks(state: SpLUState):
    """(L1, L2t, U1, U2): L1 (r, r) lower triangular, L2t = L2^T (r, n - r)."""
    r = state.rank
    return state.Lt[:, :r].T, state.Lt[:, r:], state.U12[:, :r], state.U12[:, r:]


def apply(state: SpLUState, g: torch.Tensor) -> torch.Tensor:
    """P g by the block matvec chain U -> L -> L^T -> U^T; under the
    sharding context this rank's slice of it, the tail's two rank vectors
    summed over the shard ranks."""
    mesh = hopper.shard_ctx()
    psum = mesh.psum if mesh is not None else (lambda x: x)
    r = state.rank
    L1, L2t, U1, U2 = _blocks(state)
    l3, u3 = state.l3, state.u3
    g1, g2 = g[:r], g[r:]
    Ug1 = U1 @ g1 + psum(U2 @ g2)
    Qg2 = Ug1 @ L2t + l3 * (u3 * g2)
    LtQg1 = L1.T @ (L1 @ Ug1) + psum(L2t @ Qg2)
    return torch.cat([U1.T @ LtQg1, LtQg1 @ U2 + u3 * (l3 * Qg2)])


def materialize(state: SpLUState) -> torch.Tensor:
    """Dense P = (L U)^T (L U), for tests."""
    r = state.rank
    L1, L2t, U1, U2 = _blocks(state)
    n = state.Lt.shape[1]
    f = dict(dtype=state.Lt.dtype, device=state.Lt.device)
    L, U = torch.zeros(n, n, **f), torch.zeros(n, n, **f)
    L[:r, :r], L[r:, :r], L[r:, r:] = L1, L2t.T, torch.diag(state.l3)
    U[:r, :r], U[:r, r:], U[r:, r:] = U1, U2, torch.diag(state.u3)
    q = L @ U
    return q.T @ q


# ------------------------------------------------------------ the direct form

def _max0(x: torch.Tensor) -> torch.Tensor:
    """max(x), -inf for an empty tail (rank >= n)."""
    return x.max() if x.numel() else x.new_full((), -torch.inf)


def update_plain(state: SpLUState, v: torch.Tensor, h: torch.Tensor, step=0.01) -> SpLUState:
    """The direct form of the update (the JAX package's XLA path,
    `groups/splu.py:301-381`), the L/U balancing up front. Empty tails
    (rank >= n) are allowed."""
    r = state.rank
    dtype = state.Lt.dtype
    Lt, l3, U12, u3 = state.Lt, state.l3, state.U12, state.u3
    max_l = torch.maximum(torch.diagonal(Lt[:, :r]).max(), _max0(l3))
    max_u = torch.maximum(torch.diagonal(U12[:, :r]).max(), _max0(u3))
    rho = torch.sqrt(max_l / max_u)
    Lt, l3, U12, u3 = Lt / rho, l3 / rho, rho * U12, rho * u3

    L1, L2t, U1, U2 = Lt[:, :r].T, Lt[:, r:], U12[:, :r], U12[:, r:]
    dx1, dx2 = v[:r], v[r:]
    dg1, dg2 = h[:r], h[r:]

    # Q dg
    Ug1 = U1 @ dg1 + U2 @ dg2
    Ug2 = u3 * dg2
    Qg1 = L1 @ Ug1
    Qg2 = Ug1 @ L2t + l3 * Ug2
    # Q^{-T} dx
    iUtx1 = linalg.solve_ut_t(U1, dx1)
    iUtx2 = (dx2 - iUtx1 @ U2) / u3
    iQtx2 = iUtx2 / l3
    iQtx1 = linalg.solve_lt_t(L1, iUtx1 - L2t @ iQtx2)
    # P dg
    LtQg1 = L1.T @ Qg1 + L2t @ Qg2
    LtQg2 = l3 * Qg2
    Pg1 = U1.T @ LtQg1
    Pg2 = LtQg1 @ U2 + u3 * LtQg2
    # P^{-1} dx
    iLiQtx1 = linalg.solve_lt(L1, iQtx1)
    iLiQtx2 = (iQtx2 - iLiQtx1 @ L2t) / l3
    iPx2 = iLiQtx2 / u3
    iPx1 = linalg.solve_ut(U1, iLiQtx1 - U2 @ iPx2)

    # update L
    gl1 = torch.tril(torch.outer(Qg1, Qg1) - torch.outer(iQtx1, iQtx1))
    gl3 = Qg2 * Qg2 - iQtx2 * iQtx2
    gl2_max = linalg.max_abs(torch.outer(Qg1, Qg2) - torch.outer(iQtx1, iQtx2))
    mx = torch.maximum(linalg.max_abs(gl1), torch.maximum(gl2_max, linalg.max_abs(gl3)))
    step_l = linalg.step_scale(step, mx, dtype)
    new_l1 = L1 - step_l * (gl1 @ L1)
    c1, c2 = L1.T @ Qg1, L1.T @ iQtx1  # (gl2 @ L1)^T is rank 2
    new_l2t = L2t - step_l * (torch.outer(c1, Qg2) - torch.outer(c2, iQtx2)) - step_l * gl3 * L2t
    new_l3 = l3 - step_l * gl3 * l3

    # update U
    gu1 = torch.triu(torch.outer(Pg1, dg1) - torch.outer(dx1, iPx1))
    gu3 = Pg2 * dg2 - dx2 * iPx2
    gu2_max = linalg.max_abs(torch.outer(Pg1, dg2) - torch.outer(dx1, iPx2))
    mx = torch.maximum(linalg.max_abs(gu1), torch.maximum(gu2_max, linalg.max_abs(gu3)))
    step_u = linalg.step_scale(step, mx, dtype)
    new_u1 = U1 - step_u * (U1 @ gu1)
    d1, d2 = U1 @ Pg1, U1 @ dx1  # U1 @ gu2 is rank 2
    new_u2 = U2 - step_u * (torch.outer(d1, dg2) - torch.outer(d2, iPx2)) - step_u * gu3 * U2
    new_u3 = u3 - step_u * gu3 * u3

    return SpLUState(Lt=torch.cat([new_l1.T, new_l2t], 1), l3=new_l3,
                     U12=torch.cat([new_u1, new_u2], 1), u3=new_u3)
