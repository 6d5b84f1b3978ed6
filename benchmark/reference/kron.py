"""The Kronecker family in plain PyTorch: a frozen copy of the (dense,
dense), (dense, scale) and (norm, scale) pair updates and applies and
their mirrors, one pair a weight. Nothing here imports the program."""
from __future__ import annotations

import torch

from benchmark.reference.psgd import max_abs, solve_ut_t, step_scale



def _arrow_mul(ql, X):          # Ql X for the arrow (norm) factor
    return ql[0][:, None] * X + torch.outer(ql[1], X[-1])


def _arrow_t_mul(ql, X):        # Ql^T X
    out = ql[0][:, None] * X
    out[-1] += ql[1] @ X
    return out


def _arrow_inv_t_mul(ql, X):    # Ql^-T X
    out = X / ql[0][:, None]
    out[-1] = out[-1] - (ql[1] / (ql[0] * ql[0][-1])) @ X
    return out


def _scale_step(qr, A, Bt, step):
    g2 = torch.sum(A * A, dim=0) - torch.sum(Bt * Bt, dim=0)
    return qr - step_scale(step, max_abs(g2)) * g2 * qr


def _update_dd(ql, qr, dx, dg, step):
    rho = torch.sqrt(torch.diagonal(ql).amax() / torch.diagonal(qr).amax())
    ql, qr = ql / rho, rho * qr
    a = ql @ (dg @ qr.T)
    bt = solve_ut_t(ql, solve_ut_t(qr, dx.T).T)
    g1 = torch.triu(a @ a.T - bt @ bt.T)
    g2 = torch.triu(a.T @ a - bt.T @ bt)
    return (ql - step_scale(step, max_abs(g1)) * (g1 @ ql),
            qr - step_scale(step, max_abs(g2)) * (g2 @ qr))


def _update_ds(Ql, qr, dx, dg, step):
    rho = torch.sqrt(torch.diagonal(Ql).amax() / qr.amax())
    Ql, qr = Ql / rho, rho * qr
    A = (Ql @ dg) * qr[None, :]
    Bt = solve_ut_t(Ql, dx) / qr[None, :]
    g1 = torch.triu(A @ A.T - Bt @ Bt.T)
    return Ql - step_scale(step, max_abs(g1)) * (g1 @ Ql), _scale_step(qr, A, Bt, step)


def _update_ns(ql, qr, dx, dg, step):
    rho = torch.sqrt(ql[0].amax() / qr.amax())
    ql, qr = ql / rho, rho * qr
    A = _arrow_mul(ql, dg) * qr[None, :]
    Bt = _arrow_inv_t_mul(ql, dx) / qr[None, :]
    diag = torch.sum(A * A, dim=1) - torch.sum(Bt * Bt, dim=1)
    bias = torch.cat([A[:-1] @ A[-1] - Bt[:-1] @ Bt[-1], A.new_zeros(1)])
    s = step_scale(step, torch.maximum(max_abs(diag), max_abs(bias)))
    new_l = torch.stack([ql[0] - s * diag * ql[0], ql[1] - s * (diag * ql[1] + ql[0, -1] * bias)])
    return new_l, _scale_step(qr, A, Bt, step)


def _apply_dd(Ql, Qr, G):
    if G.shape[0] < G.shape[1]:
        return ((Ql.T @ Ql) @ G) @ (Qr.T @ Qr)
    return Ql.T @ (Ql @ (G @ (Qr.T @ Qr)))


def _apply_ds(Ql, qr, G):
    pre = (Ql.T @ Ql) @ G if G.shape[0] < G.shape[1] else Ql.T @ (Ql @ G)
    return pre * (qr * qr)[None, :]


def _apply_ns(ql, qr, G):
    return _arrow_t_mul(ql, _arrow_mul(ql, G) * (qr * qr)[None, :])


# format pair -> (update, apply, mirrored): a mirror transposes into its sibling
_PAIRS = {
    ("dense", "dense"): (_update_dd, _apply_dd, False),
    ("dense", "scale"): (_update_ds, _apply_ds, False),
    ("scale", "dense"): (_update_ds, _apply_ds, True),
    ("norm", "scale"): (_update_ns, _apply_ns, False),
    ("scale", "norm"): (_update_ns, _apply_ns, True),
}


def _factors(shape, fmt, init_scale, device):
    def factor(f, d):
        if f == "dense":
            return init_scale * torch.eye(d, device=device)
        if f == "norm":
            return torch.stack([torch.full((d,), init_scale, device=device),
                                torch.zeros(d, device=device)])
        return torch.full((d,), init_scale, device=device)
    if tuple(fmt) not in _PAIRS:
        raise ValueError(f"the reference has no Kronecker pair {fmt}")
    return (factor(fmt[0], shape[0]), factor(fmt[1], shape[1]), tuple(fmt))


def _update_pair(state, dx, dg, step):
    ql, qr, fmt = state
    upd, _, mirrored = _PAIRS[fmt]
    if mirrored:
        nr, nl = upd(qr, ql, dx.T, dg.T, step)
    else:
        nl, nr = upd(ql, qr, dx, dg, step)
    return (nl, nr, fmt)


def _apply_pair(state, G):
    ql, qr, fmt = state
    _, app, mirrored = _PAIRS[fmt]
    return app(qr, ql, G.T).T if mirrored else app(ql, qr, G)


def init(opt: dict, params, seed: int, formats):
    """A factor pair a weight, each side at `init_scale` times the identity."""
    scale = float(opt.get("init_scale", 1.0))
    return [_factors(p.shape, f, scale, p.device) for p, f in zip(params, formats)]


def update(state, probes, hvs, step, coins):
    return [_update_pair(s, v, h, step) for s, v, h in zip(state, probes, hvs)]


def apply(state, grads):
    return [_apply_pair(s, g) for s, g in zip(state, grads)]
