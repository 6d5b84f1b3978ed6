"""Low-rank (UVd) preconditioner: Q = (I + U V^T) diag(d).

Counterpart of `psgd_tf_tpu/groups/lra.py`. The factors stay packed and
rank-major: `UV` (2r, n) holds U's rows then V's, `d` is (n,). The update
fits both ends of the spectrum with two r x r Woodbury solves; each step
rebalances U and V with probability 0.01 and updates either U or V.

The JAX package draws those two coins from a key inside `update`; here they
arrive as host booleans `coins = (balance, update_u)`, which the optimizer
draws from a CPU generator (so a draw never waits for the device, and the
tests can inject the JAX package's decisions). fp32 goes to K13's wrapper
(`ops/hopper/lra_upd`) whatever n is, as in JAX: on CUDA it launches the
kernel, on the CPU and inside `hopper.disabled()` it runs the kernel's
plain stages. Other dtypes run the direct form.
"""
from __future__ import annotations

import dataclasses

import torch

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import lra_upd


@dataclasses.dataclass(frozen=True)
class LRAState:
    UV: torch.Tensor  # (2r, n) packed rank-major factors, U rows then V rows
    d: torch.Tensor   # (n,)

    @property
    def U(self) -> torch.Tensor:
        return self.UV[: self.UV.shape[0] // 2]

    @property
    def V(self) -> torch.Tensor:
        return self.UV[self.UV.shape[0] // 2:]


def init(generator: torch.Generator, n: int, rank: int = 10, init_scale: float = 1.0,
         dtype=torch.float32, device: torch.device | str = "cuda") -> LRAState:
    """U, V ~ N(0, 1/(n r)) drawn on the generator's device, d = init_scale."""
    scale = (1.0 / (n * rank)) ** 0.5
    uv = torch.randn(2 * rank, n, generator=generator, dtype=dtype, device=generator.device)
    return LRAState(UV=(scale * uv).to(device),
                    d=torch.full((n,), init_scale, dtype=dtype, device=device))


def pack(U: torch.Tensor, V: torch.Tensor, d: torch.Tensor) -> LRAState:
    """The packed state from separate (r, n) factors."""
    return LRAState(UV=torch.cat([U, V]), d=d)


def _fused(state: LRAState) -> bool:
    return state.d.dtype == torch.float32


def update(state: LRAState, v: torch.Tensor, h: torch.Tensor, step=0.01,
           coins: tuple[bool, bool] | None = None) -> LRAState:
    """One step with `coins = (balance, update_u)`."""
    if coins is None:
        raise ValueError("lra.update requires coins = (balance, update_u)")
    mesh = hopper.shard_ctx()
    if mesh is not None:
        if _fused(state):
            return LRAState(*lra_upd.fused_update_sharded(state.UV, state.d, v, h, step, coins,
                                                          mesh))
        return LRAState(*lra_upd.update_plain(state.UV, state.d, v, h, step, coins,
                                              psum=mesh.psum, pmax=mesh.pmax))
    if _fused(state):
        return LRAState(*lra_upd.fused_update(state.UV, state.d, v, h, step, coins))
    return LRAState(*lra_upd.update_plain(state.UV, state.d, v, h, step, coins))


def apply(state: LRAState, g: torch.Tensor) -> torch.Tensor:
    """P g = d (I + V U^T) (I + U V^T) (d g); this rank's lanes of it under
    the sharding context."""
    mesh = hopper.shard_ctx()
    if mesh is not None:
        return lra_upd.apply_plain(state.UV, state.d, g, psum=mesh.psum)
    return lra_upd.apply_plain(state.UV, state.d, g)


def update_apply(state: LRAState, v: torch.Tensor, h: torch.Tensor, g: torch.Tensor, step=0.01,
                 coins: tuple[bool, bool] | None = None) -> tuple[LRAState, torch.Tensor]:
    """update() then apply() of the UPDATED state; K13 fuses the apply into
    its stage-3 sweep."""
    if coins is None:
        raise ValueError("lra.update_apply requires coins = (balance, update_u)")
    mesh = hopper.shard_ctx()
    if mesh is not None and _fused(state):
        uv, d, pre = lra_upd.fused_update_apply_sharded(state.UV, state.d, v, h, g, step, coins,
                                                        mesh)
        return LRAState(uv, d), pre
    if mesh is None and _fused(state):
        uv, d, pre = lra_upd.fused_update_apply(state.UV, state.d, v, h, g, step, coins)
        return LRAState(uv, d), pre
    st = update(state, v, h, step, coins)
    return st, apply(st, g)


def materialize(state: LRAState) -> torch.Tensor:
    """Dense P = Q^T Q, for tests."""
    n = state.d.shape[0]
    q = (torch.eye(n, dtype=state.d.dtype, device=state.d.device) + state.U.T @ state.V) \
        * state.d[None, :]
    return q.T @ q
