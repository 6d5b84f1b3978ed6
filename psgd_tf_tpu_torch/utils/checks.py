"""Finite-state checks: detect NaN/Inf divergence in params or Q state.

Counterpart of `psgd_tf_tpu/utils/checks.py`. A tree is a dict, list or
tuple of tensors, or one of the port's state dataclasses holding them
(`utils._tree`). `all_finite` stays on the device; `first_nonfinite` names
the offending leaves in the JAX package's path form (`['b']`, `[0]`,
`.precond`).
"""
from __future__ import annotations

from typing import Any

import torch

from psgd_tf_tpu_torch.utils import _tree


def all_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every entry of every tensor leaf is finite. A
    reduction on the leaves' device; no host sync unless the caller reads
    it."""
    ok = None
    for leaf in _tree.tensors(tree):
        leaf_ok = torch.isfinite(leaf).all()
        ok = leaf_ok if ok is None else ok & leaf_ok.to(ok.device)
    return torch.tensor(True) if ok is None else ok


def assert_finite(tree: Any, name: str = "state") -> None:
    """Raise FloatingPointError, naming `name` and the offending leaves,
    when a leaf holds NaN or Inf. PyTorch has no `checkify`: this reads
    `all_finite` on the host, so it waits for the device."""
    if not bool(all_finite(tree)):
        raise FloatingPointError(f"non-finite values in {name}: {first_nonfinite(tree)}")


def first_nonfinite(tree: Any) -> list[str]:
    """Host-side debugging: paths of the leaves containing NaN/Inf."""
    return [path for path, leaf in _tree.tensors_with_path(tree)
            if not bool(torch.isfinite(leaf).all())]
