"""The low-rank family in plain PyTorch: a frozen copy of lra's update
and apply, Q = (I + U V^T) diag(d) over all parameters raveled. The caller
hands in the (rebalance, update-U) coins. Nothing here imports the
program."""
from __future__ import annotations

import torch

from benchmark.reference.psgd import max_abs, step_scale



def init(opt: dict, params, seed: int, rank: int):
    """U, V ~ N(0, 1/(n r)) from a CPU generator seeded with `seed`, the
    rows of U then of V; d = init_scale."""
    n, device = sum(p.numel() for p in params), params[0].device
    uv = torch.randn(2 * rank, n, generator=torch.Generator().manual_seed(seed))
    scale = float(opt.get("init_scale", 1.0))
    return ((1.0 / (n * rank)) ** 0.5 * uv).to(device), torch.full((n,), scale, device=device)


def _flat(xs):
    return torch.cat([x.reshape(-1) for x in xs])


def update(state, probes, hvs, step, coins):
    return _update(*state, _flat(probes), _flat(hvs), step, coins)


def apply(state, grads):
    pg = _apply(*state, _flat(grads))
    return [x.reshape(g.shape) for x, g in zip(torch.split(pg, [g.numel() for g in grads]), grads)]


def _update(UV, d, v, h, step, coins):
    balance, update_u = coins
    r = UV.shape[0] // 2
    if balance:
        rho = torch.sqrt(max_abs(UV[:r]) / max_abs(UV[r:]))
        UV = torch.cat([UV[:r] / rho, UV[r:] * rho])
    U, V = UV[:r], UV[r:]
    Qh = d * h + (V @ (d * h)) @ U
    Ph = d * (Qh + (U @ Qh) @ V)
    IpVtU = torch.eye(r, device=d.device) + V @ U.T
    invQtv = v / d
    invQtv = invQtv - torch.linalg.solve(IpVtU.T, U @ invQtv) @ V
    invPv = (invQtv - torch.linalg.solve(IpVtU, V @ invQtv) @ U) / d
    nablaD = Ph * h - v * invPv
    new_d = d - step_scale(step, max_abs(nablaD)) * d * nablaD
    a, b = Qh, invQtv
    if update_u:
        atV, btV = V @ a, V @ b
        x, y = atV @ V, btV @ V
        norm = torch.sqrt(torch.abs((a @ a) * (x @ x) + (b @ b) * (y @ y)
                                    - 2.0 * (a @ b) * (x @ y)))
        U = U - step_scale(step, norm) * (torch.outer(IpVtU.T @ atV, a)
                                          - torch.outer(IpVtU.T @ btV, b))
    else:
        atU, btU = U @ a, U @ b
        x, y = atU @ U, btU @ U
        norm = torch.sqrt(torch.abs((x @ x) * (a @ a) + (y @ y) * (b @ b)
                                    - 2.0 * (x @ y) * (a @ b)))
        V = V - step_scale(step, norm) * (torch.outer(atU, a + atU @ V)
                                          - torch.outer(btU, b + btU @ V))
    return torch.cat([U, V]), new_d


def _apply(UV, d, g):
    r = UV.shape[0] // 2
    U, V = UV[:r], UV[r:]
    x = d * g
    x = x + (V @ x) @ U
    return d * (x + (U @ x) @ V)
