"""Move the JAX package's parameters and preconditioner states into the port.

The tests hand both packages the same numbers: they take what the JAX
package computed, as numpy arrays, and turn it into the port's tensors on a
given device, so that both compute the same thing from there. Every function
places on the card unless the caller asks for another device (the CPU tests
pass `device="cpu"`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from psgd_tf_tpu_torch.groups.dense import DenseState
from psgd_tf_tpu_torch.groups.diag import DiagState
from psgd_tf_tpu_torch.groups.kron import BatchedDDState, KronState
from psgd_tf_tpu_torch.groups.lra import LRAState
from psgd_tf_tpu_torch.groups.shift import ShiftState
from psgd_tf_tpu_torch.groups.splu import SpLUState
from psgd_tf_tpu_torch.groups.xmat import XMatState
from psgd_tf_tpu_torch.optim.psgd import KronPrecond


def tensors(arrays: Sequence[np.ndarray],
            device: torch.device | str = "cuda") -> list[torch.Tensor]:
    """numpy arrays (e.g. `np.asarray` of JAX parameters) -> tensors."""
    return [torch.from_numpy(np.array(a, copy=True)).to(device) for a in arrays]


def kron_states(
    states: Sequence[tuple[np.ndarray, np.ndarray, tuple[str, str]]],
    device: torch.device | str = "cuda",
) -> list[KronState]:
    """(ql, qr, fmt) triples, e.g. from a JAX KronState list as
    `[(np.asarray(s.ql), np.asarray(s.qr), s.fmt) for s in states]`."""
    out = []
    for ql, qr, fmt in states:
        a, b = tensors([ql, qr], device)
        out.append(KronState(ql=a, qr=b, fmt=(fmt[0], fmt[1])))
    return out


def batched_dd_state(ql: np.ndarray, qr: np.ndarray, shapes: Sequence[tuple[int, int]],
                     device: torch.device | str = "cuda") -> BatchedDDState:
    """From a JAX BatchedDDState's `np.asarray(s.ql)`, `np.asarray(s.qr)`
    and `s.shapes`."""
    a, b = tensors([ql, qr], device)
    return BatchedDDState(ql=a, qr=b, shapes=tuple((int(m), int(n)) for m, n in shapes))


def kron_precond(
    batches: Sequence[tuple[np.ndarray, np.ndarray, Sequence[tuple[int, int]]]],
    singles: Sequence[tuple[np.ndarray, np.ndarray, tuple[str, str]]],
    batched_idx: Sequence[Sequence[int]],
    single_idx: Sequence[int],
    device: torch.device | str = "cuda",
) -> KronPrecond:
    """From a JAX KronPrecond: `batches` as (ql, qr, shapes) triples of its
    BatchedDDStates, `singles` as `kron_states` takes them, and its two
    index tuples."""
    return KronPrecond(
        batches=[batched_dd_state(ql, qr, shapes, device) for ql, qr, shapes in batches],
        singles=kron_states(singles, device),
        batched_idx=tuple(tuple(int(i) for i in idx) for idx in batched_idx),
        single_idx=tuple(int(i) for i in single_idx),
    )


def dense_state(Q: np.ndarray, device: torch.device | str = "cuda") -> DenseState:
    """From a JAX DenseState's `np.asarray(s.Q)`."""
    return DenseState(Q=tensors([Q], device)[0])


def diag_state(q: np.ndarray, device: torch.device | str = "cuda") -> DiagState:
    """From a JAX DiagState's `np.asarray(s.q)`."""
    return DiagState(q=tensors([q], device)[0])


def lra_state(UV: np.ndarray, d: np.ndarray, device: torch.device | str = "cuda") -> LRAState:
    """From a JAX LRAState's packed `np.asarray(s.UV)` and `np.asarray(s.d)`."""
    uv, dd = tensors([UV, d], device)
    return LRAState(UV=uv, d=dd)


def splu_state(Lt: np.ndarray, l3: np.ndarray, U12: np.ndarray, u3: np.ndarray,
               device: torch.device | str = "cuda") -> SpLUState:
    """From a JAX SpLUState's fields, or a SpLUStreamState's logical views
    (`np.asarray(s.Lt)`, `s.l3`, `s.U12`, `s.u3`: both are (r, n), (n - r,))."""
    return SpLUState(*tensors([Lt, l3, U12, u3], device))


def xmat_state(af: np.ndarray, bf: np.ndarray, ac: np.ndarray, odd: bool,
               device: torch.device | str = "cuda") -> XMatState:
    """From a JAX XMatState's folded `af`, `bf`, `ac` and its `odd`."""
    return XMatState(*tensors([af, bf, ac], device), odd=bool(odd))


def shift_state(af: np.ndarray, bf: np.ndarray, ac: np.ndarray, odd: bool,
                device: torch.device | str = "cuda") -> ShiftState:
    """From a JAX ShiftState's folded `af`, `bf`, `ac` and its `odd`."""
    return ShiftState(*tensors([af, bf, ac], device), odd=bool(odd))


def local_state(mesh, state):
    """A full family state (or PSGDState) built by the functions above, from
    a JAX global state's arrays, -> this rank's slice on `mesh`
    (`parallel.shard_state`)."""
    from psgd_tf_tpu_torch.parallel import policies

    return policies.shard_state(mesh, state)


def global_arrays(mesh, local, n: int) -> dict[str, np.ndarray]:
    """This rank's slice of a family state -> the full state's tensor
    fields as numpy arrays (as `np.asarray` of the JAX global arrays gives
    them), gathered over the shard ranks and trimmed to n parameters."""
    from psgd_tf_tpu_torch.parallel import policies

    full = policies.gather_state(mesh, local, n)
    return {f.name: getattr(full, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(full) if isinstance(getattr(full, f.name), torch.Tensor)}
