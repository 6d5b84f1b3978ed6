"""Kronecker-factored preconditioner for matrix parameters.

Counterpart of `psgd_tf_tpu/groups/kron.py`. P = (Qr^T Qr) ⊗ (Ql^T Ql) acts
on an (m, n) gradient as Ql^T Ql @ G @ Qr^T Qr. Each side is one of three
formats, in the JAX package's layouts:

  dense : (d, d) upper-triangular factor
  norm  : (2, d) "arrow" factor; row 0 = diag(Q), row 1 = last column of Q
          (its last entry is 0 by convention)
  scale : (d,) diagonal factor

The seven supported pairs are (dense, dense), (norm, dense), (dense, norm),
(dense, scale), (scale, dense), (norm, scale) and (scale, norm). Mirrors
transpose into their canonical sibling (dd, nd, ds, ns), as in the JAX
package. The plain per-pair updates and applies below are the CPU path and
the oracle of every kernel; on a CUDA device `update` and `update_multi`
route fp32 states to the Hopper kernels as `route` reports. A bucket of
(dense, dense) layers of one padded size can be held stacked
(`BatchedDDState`) and updated at once (`update_batched`, K4 on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import torch

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import kron_dd, kron_multi, kron_sparse, kron_sparse_big

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
# psgd_tf_tpu/ops/pallas/kron_dd.py MAX_SIDE: the side up to which a
# (dense, dense) layer is eligible for K1 in the JAX package
DD_MULTI_MAX_SIDE = 1024


@dataclasses.dataclass(frozen=True)
class KronState:
    ql: torch.Tensor
    qr: torch.Tensor
    fmt: tuple[Format, Format] = ("dense", "dense")

    def replace(self, **kwargs) -> "KronState":
        return dataclasses.replace(self, **kwargs)


def _canon(fmt) -> tuple[str, bool]:
    fmt = tuple(fmt)
    if fmt not in _CANON:
        raise ValueError(f"unsupported Kronecker format pair: {fmt}")
    return _CANON[fmt]


def _factor_init(fmt: Format, d: int, scale: float, dtype, device) -> torch.Tensor:
    """Typical initial guesses (the TF reference's README)."""
    if fmt == "dense":
        return scale * torch.eye(d, dtype=dtype, device=device)
    if fmt == "norm":
        return torch.stack([
            torch.full((d,), scale, dtype=dtype, device=device),
            torch.zeros((d,), dtype=dtype, device=device),
        ])
    if fmt == "scale":
        return torch.full((d,), scale, dtype=dtype, device=device)
    raise ValueError(f"unknown kron factor format: {fmt!r}")


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
    device: torch.device | str = "cuda",
) -> KronState:
    m, n = shape
    if fmt == "auto":
        fmt = auto_format(shape)
    fmt = (fmt[0], fmt[1])
    _canon(fmt)
    return KronState(
        ql=_factor_init(fmt[0], m, init_scale, dtype, device),
        qr=_factor_init(fmt[1], n, init_scale, dtype, device),
        fmt=fmt,
    )


# ---------------------------------------------------------------------------
# plain per-pair applies (psgd_tf_tpu/groups/kron.py:122-241)
# ---------------------------------------------------------------------------
# The plain per-pair updates live beside their kernels' wrappers
# (kron_dd.update_plain, kron_sparse.update_plain_*; kron_multi.PLAIN maps
# each kind to its own), which take them for CPU tensors.

def _apply_dd(Ql, Qr, G):
    # multiplication order chosen by shape to minimise FLOPs
    if G.shape[0] < G.shape[1]:
        return ((Ql.T @ Ql) @ G) @ (Qr.T @ Qr)
    return Ql.T @ (Ql @ (G @ (Qr.T @ Qr)))


def _apply_ds(Ql, qr, G):
    if G.shape[0] < G.shape[1]:
        preG = (Ql.T @ Ql) @ G
    else:
        preG = Ql.T @ (Ql @ G)
    return preG * (qr * qr)[None, :]


# the arrow-left applies' plain chains live beside K17's wrappers
_APPLY = {"dd": _apply_dd, "nd": kron_sparse_big.apply_nd_plain, "ds": _apply_ds,
          "ns": kron_sparse_big.apply_ns_plain}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _oriented(state: KronState, dX, dG):
    """(kind, mirrored, a, b, dx, dg): mirrors transpose into their sibling."""
    kind, mirrored = _canon(state.fmt)
    if mirrored:
        return kind, True, state.qr, state.ql, dX.T, dG.T
    return kind, False, state.ql, state.qr, dX, dG


# the streaming kernels; the (norm, scale) one takes K7/K8 past MAX_LANES
_BIG = {"ns": kron_sparse_big.fused_update_ns, "nd": kron_sparse_big.fused_update_nd,
        "ds": kron_sparse_big.fused_update_ds}


def _kernel_route(kind: str, m: int, n: int) -> str:
    """The route name of a canonical (kind, m, n) layer on a CUDA device."""
    if kind == "dd":
        return "kron_dd"
    if kron_sparse.fits(m, n):
        return f"kron_sparse:{kind}"
    if kron_sparse_big.fits_grid(kind, m, n):
        if kind == "ns" and -(-n // 128) * 128 > kron_sparse_big.MAX_LANES:
            return "kron_sparse_big:ns_wide"
        return f"kron_sparse_big:{kind}"
    return "xla"


def _sparse_dispatch(kind, a, b, dX, dG, step):
    """Route one canonical sparse-pair update: the single-layer kernel K5
    for probes `kron_sparse.fits`, the streaming kernels K6/K7/K8 (ns), K9
    (nd) and K10 (ds) up to the JAX package's capacity envelope, else the
    plain update (the JAX package's XLA path). Every wrapper takes its
    plain version for CPU tensors. Only fp32 states go to a kernel."""
    m, n = dX.shape
    r = _kernel_route(kind, m, n) if a.dtype == torch.float32 else "xla"
    if r.startswith("kron_sparse:"):
        return kron_sparse.FUSED_UPDATE[kind](a, b, dX, dG, step)
    if r.startswith("kron_sparse_big:"):
        return _BIG[kind](a, b, dX, dG, step)
    return kron_multi.PLAIN[kind](a, b, dX, dG, step)


def update(state: KronState, dX: torch.Tensor, dG: torch.Tensor, step: float = 0.01) -> KronState:
    """One Lie-group step on one layer. (dense, dense) goes through
    `kron_dd.fused_update` (K2); the sparse pairs through `_sparse_dispatch`.
    A state of another dtype than fp32 takes the plain update of its kind
    on its device, as the JAX package sends it to XLA. `step` is a Python
    number."""
    kind, mirrored, a, b, dx, dg = _oriented(state, dX, dG)
    if kind == "dd" and a.dtype == torch.float32:
        na, nb = kron_dd.fused_update(a, b, dx, dg, step)
    elif kind == "dd":
        na, nb = kron_dd.update_plain(a, b, dx, dg, step)
    else:
        na, nb = _sparse_dispatch(kind, a, b, dx, dg, step)
    if mirrored:
        na, nb = nb, na
    return state.replace(ql=na, qr=nb)


def update_multi(
    states: Sequence[KronState],
    dXs: Sequence[torch.Tensor],
    dGs: Sequence[torch.Tensor],
    step: float = 0.01,
) -> list[KronState]:
    """Element-wise `update` over a layer list, with the JAX package's
    eligibility rule: a (dense, dense) layer of side <= 1024 and a sparse
    layer that `kron_sparse.fits` are eligible; when two or more are, they
    all go through K1 (`kron_multi`) in one fixed chain of launches, and
    every other layer goes through `update`. Mirrors transpose in, as in
    `update`. Per layer identical to `update`."""
    states = list(states)
    if not (len(states) == len(dXs) == len(dGs)):
        raise ValueError("states/dXs/dGs length mismatch")
    eligible, entries = [], []
    for i, st in enumerate(states):
        if st.ql.dtype != torch.float32:
            continue
        kind, mirrored, a, b, dx, dg = _oriented(st, dXs[i], dGs[i])
        ok = (max(dx.shape) <= DD_MULTI_MAX_SIDE if kind == "dd"
              else kron_sparse.fits(*dx.shape))
        if ok:
            eligible.append(i)
            entries.append((kind, mirrored, a, b, dx, dg))
    out: list = [None] * len(states)
    if len(eligible) >= 2:
        res = kron_multi.fused_update_multi(
            [e[0] for e in entries], [e[2] for e in entries], [e[3] for e in entries],
            [e[4] for e in entries], [e[5] for e in entries], step,
        )
        for (kind, mirrored, *_), i, (na, nb) in zip(entries, eligible, res):
            ql, qr = (nb, na) if mirrored else (na, nb)
            out[i] = states[i].replace(ql=ql, qr=qr)
    for i in range(len(states)):
        if out[i] is None:
            out[i] = update(states[i], dXs[i], dGs[i], step)
    return out


def route(fmt: tuple[Format, Format], shape: tuple[int, int], device: torch.device | str,
          dtype: torch.dtype = torch.float32) -> str:
    """Which path serves the single-layer update of a layer with this
    format pair and probe shape on `device`: 'plain' on the CPU, inside
    `hopper.disabled()` or for a state dtype other than fp32; on a CUDA
    device the JAX package's route names:

      'kron_dd'                 (dense, dense): K2 (K1 when listed)
      'kron_sparse:<kind>'      single-launch sparse kernel K5
      'kron_sparse_big:<kind>'  streaming kernel, K6 (ns), K10 (ds), K9 (nd)
      'kron_sparse_big:ns_wide' the wide (norm, scale) path, K7 (up to 2^21
                                lanes) or K8
      'xla'                     no kernel; the plain update on the device

    Mirrors report their canonical sibling's route. One difference from the
    JAX package: the port's (dense, dense) chain has no side cap, so
    (dense, dense) reports 'kron_dd' at every side where JAX reports 'xla'
    above 1024.
    """
    kind, mirrored = _canon(fmt)
    if dtype != torch.float32 or not hopper.use_kernel(device):
        return "plain"
    m, n = (shape[1], shape[0]) if mirrored else shape
    return _kernel_route(kind, m, n)


def apply(state: KronState, G: torch.Tensor) -> torch.Tensor:
    """P G by plain torch for every pair (the JAX package leaves every
    apply to XLA too; its streamed arrow applies, K17/K18 here, are entry
    points of their own, `kron_sparse_big.fused_apply_*`)."""
    kind, mirrored = _canon(state.fmt)
    if mirrored:
        return _APPLY[kind](state.qr, state.ql, G.T).T
    return _APPLY[kind](state.ql, state.qr, G)


# ---------------------------------------------------------------------------
# the batched (dense, dense) path (psgd_tf_tpu/groups/kron.py:472-627)
# ---------------------------------------------------------------------------
# A bucket of (dense, dense) layers whose 128-padded sides agree is stored
# stacked: Ql (B, S, S), Qr (B, T, T), each layer's true factor in the
# top-left corner and exact identity beyond. Padded probe rows and columns
# are zero, so A and Bt vanish outside each (m, n) corner, the group
# gradients outside (m, m) and (n, n), and the update leaves the identity
# extension exactly as it was. The balancing maxima are masked to the
# corners. On a CUDA fp32 stack the update is K4.


@dataclasses.dataclass(frozen=True)
class BatchedDDState:
    """Stacked padded (dense, dense) factors of B layers; `shapes` records
    each layer's true (m_i, n_i)."""

    ql: torch.Tensor  # (B, S, S)
    qr: torch.Tensor  # (B, T, T)
    shapes: tuple[tuple[int, int], ...] = ()

    def replace(self, **kwargs) -> "BatchedDDState":
        return dataclasses.replace(self, **kwargs)


def _pad_factor(q: torch.Tensor, side: int) -> torch.Tensor:
    """An (d, d) factor in the corner of a (side, side) identity."""
    d = q.shape[0]
    if d == side:
        return q
    out = torch.eye(side, dtype=q.dtype, device=q.device)
    out[:d, :d] = q
    return out


def init_batched(
    shapes: Sequence[tuple[int, int]],
    init_scale: float = 1.0,
    dtype: torch.dtype = torch.float32,
    pad_multiple: int = 128,
    device: torch.device | str = "cuda",
) -> BatchedDDState:
    """Stacked identity init of B (dense, dense) layers: `init_scale` on
    each true diagonal, 1 on the padding."""
    shapes = tuple((int(m), int(n)) for m, n in shapes)
    S = max(-(-m // pad_multiple) * pad_multiple for m, _ in shapes)
    T = max(-(-n // pad_multiple) * pad_multiple for _, n in shapes)

    def one(d, side):
        return _pad_factor(_factor_init("dense", d, init_scale, dtype, device), side)

    return BatchedDDState(ql=torch.stack([one(m, S) for m, _ in shapes]),
                          qr=torch.stack([one(n, T) for _, n in shapes]), shapes=shapes)


def stack_padded(mats: Sequence[torch.Tensor], S: int, T: int) -> torch.Tensor:
    """Zero-pad each (m_i, n_i) matrix into an (S, T) slot and stack."""
    out = mats[0].new_zeros((len(mats), S, T))
    for i, x in enumerate(mats):
        out[i, :x.shape[0], :x.shape[1]] = x
    return out


def update_batched(
    state: BatchedDDState,
    dXs: Sequence[torch.Tensor],
    dGs: Sequence[torch.Tensor],
    step: float = 0.01,
) -> BatchedDDState:
    """One Lie-group step on every stacked layer: K4 for a CUDA fp32 stack
    (its wrapper takes the plain version for CPU tensors); the plain update
    (`kron_dd.update_batched_plain`, the JAX package's vmapped
    `_update_dd_padded`) for any other dtype, as the JAX package sends it
    to XLA. `step` is a Python number."""
    S, T = state.ql.shape[1], state.qr.shape[1]
    dx, dg = stack_padded(dXs, S, T), stack_padded(dGs, S, T)
    ms = [m for m, _ in state.shapes]
    ns = [n for _, n in state.shapes]
    fn = (kron_dd.fused_update_batched if state.ql.dtype == torch.float32
          else kron_dd.update_batched_plain)
    ql, qr = fn(state.ql, state.qr, dx, dg, ms, ns, step)
    return state.replace(ql=ql, qr=qr)


def apply_batched(state: BatchedDDState, Gs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """P_i G_i = Ql_i^T Ql_i G_i Qr_i^T Qr_i for every stacked layer, by
    batched products (the JAX package computes it outside any kernel too).
    Zero padding in G confines every product to the true corner."""
    S, T = state.ql.shape[1], state.qr.shape[1]
    g = stack_padded(Gs, S, T)
    pre = state.ql.mT @ (state.ql @ (g @ (state.qr.mT @ state.qr)))
    return [pre[i, :m, :n] for i, (m, n) in enumerate(state.shapes)]


def unbatch(state: BatchedDDState) -> list[KronState]:
    """Per-layer (dense, dense) states of a batched state (tests, interop)."""
    return [KronState(ql=state.ql[i, :m, :m].contiguous(), qr=state.qr[i, :n, :n].contiguous(),
                      fmt=("dense", "dense"))
            for i, (m, n) in enumerate(state.shapes)]


def _factor_dense(fmt: Format, q: torch.Tensor) -> torch.Tensor:
    if fmt == "dense":
        return q
    if fmt == "scale":
        return torch.diag(q)
    # norm: diag(q[0]) with last column [q[1, :-1]; q[0, -1]]
    m = torch.diag(q[0])
    m[:-1, -1] = q[1, :-1]
    return m


def materialize(state: KronState) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (Ql, Qr) factors, for tests only."""
    return _factor_dense(state.fmt[0], state.ql), _factor_dense(state.fmt[1], state.qr)
