"""Hand-written Hopper (sm_90a) kernels for the hot structured linear algebra.

Counterpart of `psgd_tf_tpu/ops/pallas/`. Kernel inventory:

  - tri: exact upper-triangular inverse of a list of factors (K3, the
    recursive block form), and the blocked triangular solve (K19,
    `solve_triangular`).
  - kron_dd: the Kronecker factor update chain of `csrc/kron_dd.cu`;
    `fused_update` takes one (dense, dense) layer (K2),
    `fused_update_multi` a (dense, dense) layer list (K20),
    `kron_sparse.fused_update_*` one sparse layer (K5),
    `kron_multi.fused_update_multi` a whole layer list of any kinds in one
    fixed chain of grouped launches (K1), and
    `kron_dd.fused_update_batched` a stacked, identity-padded bucket of
    (dense, dense) layers through the same stages over the whole stack
    (K4, `csrc/kron_batched.cu`, with its K3 counted under 'tri'). A list
    with a sparse side (`kron_dd.route`) runs its stage bodies in one
    cooperative launch instead, counted under 'kron_mono' (the chain's own
    K3 launch under 'tri').
  - kron_sparse_big: the streaming (norm, scale) reductions (K6), their
    wide-lane kernel (K7/K8: one kernel counted under the JAX package's
    two routes), the streaming (norm, dense) chain (K9) and the streaming
    (dense, scale) chain (K10), `csrc/kron_sparse_big.cu`; and the
    streamed applies of an arrow left factor, `fused_apply_ns`/`_nd`
    (K17) and `fused_apply_ns_wide` (K18), which no path routes (as in the
    JAX package).
  - dense_upd / dense_big: the dense family's rank-2 update, with the
    fused apply (K11 / K12: one streaming chain, `csrc/dense.cu`, counted
    under the JAX package's two routes).
  - lra_upd: the low-rank family's update and fused apply (K13,
    `csrc/lra.cu`): one C call, the rank-space algebra in two
    single-block corner kernels; any rank (a rank-generic chain past 32,
    as splu's, `csrc/rank_space.cuh`).
  - splu_one / splu_upd: the sparse-LU family's update with the fused
    apply (K15: one launch a call, the chain's bodies between barriers)
    and its streaming update (K16: one chain with the corner algebra on
    the device), `csrc/splu.cu`, counted under the JAX package's two
    routes; `splu_upd.fused_update(g=...)`, the chain with the apply as an
    entry of its own (`splu_upd_apply`), and
    `splu_upd.fused_update_apply_mono`, the whole update and apply in one
    launch at any rank (`splu_upd_mono`, K15's kernel), which no path
    routes (as in the JAX package).
  - lra_upd.fused_update(_apply)_sharded (K14) and
    splu_upd.fused_update_sharded (the sharded K16): the same stage
    kernels on each rank's slice of the lanes, with the rank-space
    reductions all-reduced by the host between them (`parallel/`).
  - attention: the NMT decoder's attention over the encoder states
    (`csrc/attention.cu`, replacing no TPU kernel): a forward and a
    backward launch a decoder position (`attn_fwd`, `attn_bwd`) and the
    encoder states' gradient once a backward pass (`attn_enc_grad`).

Dispatch: each wrapper runs its plain PyTorch version for a tensor on the
CPU (the CPU path, and the oracle the kernels are checked against), and
launches its CUDA kernel for a tensor on a CUDA device, or raises. The
`disabled()` context forces the plain versions on every device; only the
tests and the A/B timing of `chip_smoke.py` use it.

`counts` holds one launch counter per kernel; a wrapper adds one where it
launches its kernel, so a run can show that it went through the kernels.

`sharding(mesh)` is the counterpart of the JAX package's trace-time mesh
context (`psgd_tf_tpu/ops/pallas/__init__.py:59-121`): inside it the
flat families hold their rank-local slice of the state and call the
sharded wrappers, which all-reduce over `mesh`'s `shard` group. Dense and
Kronecker states replicate: every rank runs the same kernel on its full
copy, with no wrapper (JAX's `replicated_call` has nothing to do here).
`sharding(mesh, param_specs)` also carries the tensor-parallel specs of
`parallel.build_sharded_step` to the optimizer's all-reduce over `data`
(`param_specs()`).
"""
from __future__ import annotations

import contextlib

import torch

counts: dict[str, int] = {
    "tri": 0, "kron_dd": 0, "kron_dd_batched": 0, "kron_multi": 0, "kron_sparse": 0,
    "kron_sparse_big_ns": 0, "kron_sparse_big_ns_wide2": 0, "kron_sparse_big_ns_wide_xla": 0,
    "kron_sparse_big_nd": 0, "kron_sparse_big_ds": 0, "kron_sparse_big_apply_ns": 0,
    "kron_sparse_big_apply_nd": 0, "kron_sparse_big_apply_ns_wide": 0, "tri_solve": 0,
    "kron_dd_multi": 0, "kron_mono": 0,
    "lra_upd": 0, "dense_upd": 0, "dense_big": 0, "splu_one": 0, "splu_upd": 0,
    "lra_upd_sharded": 0, "splu_upd_sharded": 0, "splu_upd_apply": 0, "splu_upd_mono": 0,
    "attn_fwd": 0, "attn_bwd": 0, "attn_enc_grad": 0,
}
_disabled_depth = 0
_shard_mesh = None
_shard_specs = None


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0


@contextlib.contextmanager
def disabled():
    """Force the plain PyTorch versions inside this context."""
    global _disabled_depth
    _disabled_depth += 1
    try:
        yield
    finally:
        _disabled_depth -= 1


@contextlib.contextmanager
def sharding(mesh, param_specs=None):
    """Run the flat families sharded over `mesh` (a `parallel.Mesh`) inside
    this context: their states are rank-local slices (`parallel.shard_state`)
    and their rank-space reductions all-reduce over `mesh`'s shard group.
    `param_specs`, aligned with the parameters the step takes, names the
    tensor-parallel leaves and the mesh axes that split them
    (`parallel.policies.shard_params`); `optim.psgd._data_mean` reads it."""
    global _shard_mesh, _shard_specs
    prev = _shard_mesh, _shard_specs
    _shard_mesh, _shard_specs = mesh, param_specs
    try:
        yield
    finally:
        _shard_mesh, _shard_specs = prev


def shard_ctx():
    """The active mesh of `sharding()`, or None."""
    return _shard_mesh


def param_specs():
    """The tensor-parallel parameter specs of `sharding()`, or None."""
    return _shard_specs


def use_kernel(x: torch.Tensor | torch.device | str) -> bool:
    """True when a wrapper must launch its kernel for tensor `x` (or for a
    tensor on device `x`): on a CUDA device outside `disabled()`. False on
    the CPU. Raises for any other device."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if dev.type == "cpu" or _disabled_depth:
        return False
    if dev.type == "cuda":
        return True
    raise NotImplementedError(f"no Hopper kernel path for device {dev}")


def check_operands(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every operand is a contiguous fp32 tensor on one CUDA
    device: the kernels take nothing else."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: kernel takes contiguous float32 CUDA tensors on one "
                f"device, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})"
            )

