"""Kronecker-factored preconditioner for matrix parameters.

Counterpart of `psgd_tf_tpu/groups/kron.py`, limited to what the first
slice of the port needs: the (dense, dense) pair. P = (Qr^T Qr) ⊗ (Ql^T Ql)
acts on an (m, n) gradient as Ql^T Ql @ G @ Qr^T Qr, with Ql (m, m) and
Qr (n, n) upper-triangular factors.

The other format pairs ((norm, dense), (dense, scale), (norm, scale) and
their mirrors) raise NotImplementedError: they come with the NMT slice
(ROADMAP queue 1, slice 2).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import torch

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import kron_dd, kron_multi

Format = Literal["dense", "norm", "scale"]

# fmt -> (canonical kind, mirrored); mirrors transpose in
_CANON = {
    ("dense", "dense"): ("dd", False),
    ("norm", "dense"): ("nd", False),
    ("dense", "norm"): ("nd", True),
    ("dense", "scale"): ("ds", False),
    ("scale", "dense"): ("ds", True),
    ("norm", "scale"): ("ns", False),
    ("scale", "norm"): ("ns", True),
}
_NOT_PORTED = (
    "Kronecker format pair {fmt} is not ported yet: the sparse pairs come "
    "with the NMT slice (ROADMAP queue 1, slice 2)"
)


@dataclasses.dataclass(frozen=True)
class KronState:
    ql: torch.Tensor
    qr: torch.Tensor
    fmt: tuple[Format, Format] = ("dense", "dense")

    def replace(self, **kwargs) -> "KronState":
        return dataclasses.replace(self, **kwargs)


def _check_ported(fmt) -> None:
    fmt = tuple(fmt)
    if fmt not in _CANON:
        raise ValueError(f"unsupported Kronecker format pair: {fmt}")
    if _CANON[fmt][0] != "dd":
        raise NotImplementedError(_NOT_PORTED.format(fmt=fmt))


def auto_format(shape: tuple[int, int], dense_max: int = 1024) -> tuple[Format, Format]:
    """Dense up to ~1e3 per side, else norm on the left / scale on the
    right (the TF reference's capacity guidance)."""
    m, n = shape
    return (
        "dense" if m <= dense_max else "norm",
        "dense" if n <= dense_max else "scale",
    )


def init(
    shape: tuple[int, int],
    fmt: tuple[Format, Format] | Literal["auto"] = "auto",
    init_scale: float = 1.0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> KronState:
    m, n = shape
    if fmt == "auto":
        fmt = auto_format(shape)
    fmt = (fmt[0], fmt[1])
    _check_ported(fmt)
    return KronState(
        ql=init_scale * torch.eye(m, dtype=dtype, device=device),
        qr=init_scale * torch.eye(n, dtype=dtype, device=device),
        fmt=fmt,
    )


def _apply_dd(Ql, Qr, G):
    # multiplication order chosen by shape to minimise FLOPs
    if G.shape[0] < G.shape[1]:
        return ((Ql.T @ Ql) @ G) @ (Qr.T @ Qr)
    return Ql.T @ (Ql @ (G @ (Qr.T @ Qr)))


def update(state: KronState, dX: torch.Tensor, dG: torch.Tensor, step: float = 0.01) -> KronState:
    """One Lie-group step on one layer. A (dense, dense) layer goes through
    `kron_dd.fused_update` (K2 on a CUDA device, the plain version on the
    CPU)."""
    _check_ported(state.fmt)
    ql, qr = kron_dd.fused_update(state.ql, state.qr, dX, dG, step)
    return state.replace(ql=ql, qr=qr)


def update_multi(
    states: Sequence[KronState],
    dXs: Sequence[torch.Tensor],
    dGs: Sequence[torch.Tensor],
    step: float = 0.01,
) -> list[KronState]:
    """Element-wise `update` over a layer list. With two or more layers,
    every (dense, dense) member goes through K1 (`kron_multi`) in one fixed
    chain of launches; a lone layer goes through `update`."""
    states = list(states)
    if not (len(states) == len(dXs) == len(dGs)):
        raise ValueError("states/dXs/dGs length mismatch")
    for st in states:
        _check_ported(st.fmt)
    if len(states) < 2:
        return [update(st, dx, dg, step) for st, dx, dg in zip(states, dXs, dGs)]
    qls, qrs = kron_multi.fused_update_multi(
        [st.ql for st in states], [st.qr for st in states], list(dXs), list(dGs), step
    )
    return [st.replace(ql=a, qr=b) for st, a, b in zip(states, qls, qrs)]


def route(fmt: tuple[Format, Format], shape: tuple[int, int], device: torch.device | str) -> str:
    """Which path would serve the update of a layer with this format pair
    and probe shape on `device`: 'kron_dd' (the CUDA chain) on a CUDA device,
    'plain' on the CPU or inside `hopper.disabled()`. The chain has no side
    cap (it tiles every operand), so every (dense, dense) shape routes to it.
    """
    del shape
    _check_ported(fmt)
    return "kron_dd" if hopper.use_kernel(device) else "plain"


def apply(state: KronState, G: torch.Tensor) -> torch.Tensor:
    """P G = Ql^T Ql G Qr^T Qr, by plain matmuls (as the JAX package leaves
    it to XLA outside any kernel)."""
    _check_ported(state.fmt)
    return _apply_dd(state.ql, state.qr, G)
