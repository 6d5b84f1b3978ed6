"""K1/K2/K4/K5 device chain: the Kronecker factor update of a layer list.

Replaces `psgd_tf_tpu/ops/pallas/kron_dd.py` `fused_update` (:181),
`fused_update_batched` (:252) and `fused_update_multi` (:424). The CUDA
chain in `csrc/kron_dd.cu` updates a whole list of layers of kinds
dd/ds/nd/ns in a fixed chain of grouped launches (balance, K3, arrow
pre-pass, grouped GEMMs, reductions, factor rewrites); `fused_update` here
is its single (dense, dense) layer entry point (K2), `fused_update_batched`
its stacked (dense, dense) bucket entry point (K4), `fused_update_multi` its
(dense, dense) list entry point (K20), `kron_sparse.fused_update_*` its
single sparse layer entry points (K5), and `kron_multi.fused_update_multi`
its list entry point of any kinds (K1).

The plain versions follow `psgd_tf_tpu/groups/kron.py` `_update_dd`
(:107-119) and `_update_dd_padded` (:541-561): triangular solves and plain
matmuls. They are the CPU path and the oracles the kernels are checked
against on the card.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.ops import hopper, linalg
from psgd_tf_tpu_torch.ops.hopper import _build

MAX_LAYERS = 16  # PSGD_MAX_LAYERS in csrc/psgd.cuh


def update_plain(ql, qr, dx, dg, step):
    """One (dense, dense) Lie-group step on one layer; returns the balanced,
    updated (Ql', Qr')."""
    rho = torch.sqrt(torch.diagonal(ql).amax() / torch.diagonal(qr).amax())
    ql, qr = ql / rho, rho * qr
    a = ql @ (dg @ qr.T)
    bt = linalg.solve_ut_t(ql, linalg.solve_ut_t(qr, dx.T).T)
    grad1 = linalg.triu(a @ a.T - bt @ bt.T)
    grad2 = linalg.triu(a.T @ a - bt.T @ bt)
    step1 = linalg.step_scale(step, linalg.max_abs(grad1), ql.dtype)
    step2 = linalg.step_scale(step, linalg.max_abs(grad2), qr.dtype)
    return ql - step1 * (grad1 @ ql), qr - step2 * (grad2 @ qr)


# kind codes of csrc/kron_dd.cu; the left factor is an arrow for nd/ns, the
# right factor a scale vector for ds/ns
KIND_CODE = {"dd": 0, "ds": 1, "nd": 2, "ns": 3}


def _factor_shapes(kind: str, m: int, n: int):
    left = (2, m) if kind in ("nd", "ns") else (m, m)
    right = (n,) if kind in ("ds", "ns") else (n, n)
    return left, right


def launch(kinds, qls, qrs, dxs, dgs, step: float, counter: str):
    """Run the CUDA chain on up to MAX_LAYERS layers of the given kinds;
    returns the lists of new factors. `counter` names the entry point whose
    launch this is (K1, K2 or K5)."""
    L = len(qls)
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"kron_dd chain takes 1..{MAX_LAYERS} layers, got {L}")
    for kind, ql, qr, dx, dg in zip(kinds, qls, qrs, dxs, dgs, strict=True):
        m, n = dx.shape
        left, right = _factor_shapes(kind, m, n)
        if tuple(ql.shape) != left or tuple(qr.shape) != right or dg.shape != (m, n):
            raise ValueError(
                f"{counter}: {kind} shapes Ql {tuple(ql.shape)}, Qr {tuple(qr.shape)}, "
                f"dX {tuple(dx.shape)}, dG {tuple(dg.shape)} do not agree"
            )
    hopper.check_operands(counter, *qls, *qrs, *dxs, *dgs)
    lib = _build.lib()
    codes = _build.int_array([KIND_CODE[k] for k in kinds])
    ms = _build.int_array([x.shape[0] for x in dxs])
    ns = _build.int_array([x.shape[1] for x in dxs])
    dev = qls[0].device
    scratch = torch.empty(
        lib.psgd_kron_multi_scratch_floats(L, codes, ms, ns), dtype=torch.float32, device=dev
    )
    new_qls = [torch.empty_like(q) for q in qls]
    new_qrs = [torch.empty_like(q) for q in qrs]
    p = _build.ptr_array
    rc = lib.psgd_kron_multi_update(
        L, codes, p(qls), p(qrs), p(dxs), p(dgs), p(new_qls), p(new_qrs), ms, ns,
        float(step), scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, f"{counter} kernel chain")
    hopper.counts[counter] += 1
    if any(k != "ns" for k in kinds):
        hopper.counts["tri"] += 1  # the chain's step (b) is K3
    return new_qls, new_qrs


def launch_chains(kinds, qls, qrs, dxs, dgs, step: float, counter: str):
    """`launch` over a list of any length, `MAX_LAYERS` layers a chain, each
    chain counted under `counter`; returns the lists of new factors."""
    new_qls, new_qrs = [], []
    for i in range(0, len(qls), MAX_LAYERS):
        sl = slice(i, i + MAX_LAYERS)
        nql, nqr = launch(list(kinds[sl]), qls[sl], qrs[sl], dxs[sl], dgs[sl], step, counter)
        new_qls += nql
        new_qrs += nqr
    return new_qls, new_qrs


def fused_update(ql, qr, dx, dg, step):
    """K2: one (dense, dense) layer update. The plain version for CPU
    tensors, the CUDA chain for CUDA tensors. `step` is a Python number."""
    if not hopper.use_kernel(ql):
        return update_plain(ql, qr, dx, dg, step)
    (new_ql,), (new_qr,) = launch(["dd"], [ql], [qr], [dx], [dg], step, "kron_dd")
    return new_ql, new_qr


def fused_update_multi(qls, qrs, dxs, dgs, step):
    """K20: (dense, dense) updates of a list of layers, as the JAX
    package's dd-only `kron_dd.fused_update_multi` (:424, superseded there
    by K1); returns the lists (new_qls, new_qrs). The per-layer plain
    version for CPU tensors; for CUDA tensors K1's chain with every kind dd,
    `MAX_LAYERS` layers a chain (JAX chunks its one launch by a VMEM budget,
    `chunk_layers` :360), each chain counted under 'kron_dd_multi' with its
    K3 step under 'tri'. `step` is a Python number."""
    if not hopper.use_kernel(qls[0]):
        pairs = [update_plain(*a, step) for a in zip(qls, qrs, dxs, dgs, strict=True)]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return launch_chains(["dd"] * len(qls), qls, qrs, dxs, dgs, step, "kron_dd_multi")


def update_batched_plain(ql, qr, dx, dg, ms, ns, step):
    """`update_plain` on every layer of a stack at once, with the JAX
    package's padded semantics (`psgd_tf_tpu/groups/kron.py`
    `_update_dd_padded`, vmapped): ql (B, S, S) and qr (B, T, T) hold layer
    i's factors in their (m_i, m_i) and (n_i, n_i) corners and identity
    beyond, dx and dg (B, S, T) its probes in the (m_i, n_i) corner and zeros
    beyond. The diagonal maxima are masked to the corners, the padding rows
    are held at identity, and the padding stays exact identity: its group
    gradients are exactly zero."""
    B, S, _ = ql.shape
    T = qr.shape[1]
    dev, dtype = ql.device, ql.dtype
    rows_l = torch.arange(S, device=dev)[None, :] < torch.as_tensor(ms, device=dev)[:, None]
    rows_r = torch.arange(T, device=dev)[None, :] < torch.as_tensor(ns, device=dev)[:, None]
    neg = torch.tensor(-torch.inf, dtype=dtype, device=dev)
    max_l = torch.where(rows_l, torch.diagonal(ql, dim1=1, dim2=2), neg).amax(1)
    max_r = torch.where(rows_r, torch.diagonal(qr, dim1=1, dim2=2), neg).amax(1)
    rho = torch.sqrt(max_l / max_r)[:, None, None]
    ql = torch.where(rows_l[:, :, None], ql / rho, torch.eye(S, dtype=dtype, device=dev))
    qr = torch.where(rows_r[:, :, None], qr * rho, torch.eye(T, dtype=dtype, device=dev))
    a = ql @ (dg @ qr.mT)
    bt = linalg.solve_ut_t(ql, linalg.solve_ut_t(qr, dx.mT).mT)
    grad1 = torch.triu(a @ a.mT - bt @ bt.mT)
    grad2 = torch.triu(a.mT @ a - bt.mT @ bt)
    step1 = linalg.step_scale(step, grad1.abs().amax((1, 2), keepdim=True), dtype)
    step2 = linalg.step_scale(step, grad2.abs().amax((1, 2), keepdim=True), dtype)
    return ql - step1 * (grad1 @ ql), qr - step2 * (grad2 @ qr)


def _host_sizes(xs, what: str) -> list[int]:
    """Per-layer sizes as host ints; a device tensor would make the host
    wait for the card."""
    if isinstance(xs, torch.Tensor):
        if xs.device.type != "cpu":
            raise ValueError(f"kron_dd_batched: {what} must be host ints or a CPU tensor, "
                             f"got a tensor on {xs.device}")
        xs = xs.tolist()
    return [int(x) for x in xs]


def fused_update_batched(ql, qr, dx, dg, ms, ns, step):
    """K4: the update of B stacked (dense, dense) layers of one padded
    bucket, ql (B, S, S), qr (B, T, T), dx and dg (B, S, T), layer i's true
    sides (ms[i], ns[i]) given as host ints or a CPU int tensor. Returns the
    new (B, S, S) and (B, T, T) stacks, padding exact identity; the inputs
    are not written. The plain version for CPU tensors; for CUDA tensors
    the CUDA chain of K1 over the stack, `MAX_LAYERS` layers a chain, each
    counted under 'kron_dd_batched' with its K3 step under 'tri'. `step` is
    a Python number."""
    if not hopper.use_kernel(ql):
        return update_batched_plain(ql, qr, dx, dg, ms, ns, step)
    ms, ns = _host_sizes(ms, "ms"), _host_sizes(ns, "ns")
    B, S, T = ql.shape[0], ql.shape[1], qr.shape[1]
    if (tuple(ql.shape) != (B, S, S) or tuple(qr.shape) != (B, T, T)
            or tuple(dx.shape) != (B, S, T) or tuple(dg.shape) != (B, S, T)
            or len(ms) != B or len(ns) != B
            or not all(1 <= m <= S for m in ms) or not all(1 <= n <= T for n in ns)):
        raise ValueError(
            f"kron_dd_batched: shapes Ql {tuple(ql.shape)}, Qr {tuple(qr.shape)}, "
            f"dX {tuple(dx.shape)}, dG {tuple(dg.shape)}, sides {ms} x {ns} do not agree"
        )
    hopper.check_operands("kron_dd_batched", ql, qr, dx, dg)
    lib = _build.lib()
    mi, ni = _build.int_array(ms), _build.int_array(ns)
    scratch = torch.empty(lib.psgd_kron_dd_batched_scratch_floats(B, S, T, mi, ni),
                          dtype=torch.float32, device=ql.device)
    new_ql, new_qr = torch.empty_like(ql), torch.empty_like(qr)
    rc = lib.psgd_kron_dd_batched_update(
        B, S, T, ql.data_ptr(), qr.data_ptr(), dx.data_ptr(), dg.data_ptr(), new_ql.data_ptr(),
        new_qr.data_ptr(), mi, ni, float(step), scratch.data_ptr(),
        torch.cuda.current_stream(ql.device).cuda_stream,
    )
    _build.check(rc, "kron_dd_batched kernel chain")
    chains = -(-B // MAX_LAYERS)
    hopper.counts["kron_dd_batched"] += chains
    hopper.counts["tri"] += chains  # each chain's step (b) is K3
    return new_ql, new_qr


# ------------------------------------------------ the grouped GEMM, one problem

# psgd.cuh's Epilogue and Cut codes
EPI = {"store": 0, "triu_max": 1, "update": 2, "colmul": 3, "coldiv": 4, "triu": 5,
       "arrow": 6, "rowdiv": 7}
CUT = {"a_upper": 1, "a_lower": 2, "b_upper": 4, "b_lower": 8}
TILES = {"auto": 0, "64": 1, "128": 2}


def _op(x, t, rows, cols):
    """The (rows, cols) operand read from x's rows: x[:cols, :rows]^T when
    t, else x[:rows, :cols] (x's row stride is the GEMM's ld)."""
    return x[:cols, :rows].T if t else x[:rows, :cols]


def gemm_plain(M, N, K, a, ta, b, tb, a2=None, b2=None, epi="store", q=None, v=None, r=None,
               mx=None, step=0.0):
    """The grouped GEMM's problem in torch, in the operands' dtype:
    (C after its epilogue, max|C| of the triu_max epilogue or None).
    op(a) (M, K), op(b) (K, N) as `_op` reads them; with a2/b2 the
    difference op(a) op(b) - op(a2) op(b2); `mx` the max|grad| the update
    epilogue divides the step by."""
    c = _op(a, ta, M, K) @ _op(b, tb, K, N)
    if a2 is not None:
        c = c - _op(a2, ta, M, K) @ _op(b2, tb, K, N)
    if epi in ("triu", "triu_max"):
        c = torch.triu(c)
        return c, (c.abs().max() if epi == "triu_max" else None)
    if epi == "update":
        s = min(step / (mx + linalg.tiny(torch.float32)), torch.finfo(torch.float32).max)
        return q[:M, :N] - s * c, None
    if epi == "colmul":
        return c * v[:N], None
    if epi == "coldiv":
        return c / v[:N], None
    if epi in ("arrow", "rowdiv"):
        keep = torch.ones(M, 1, dtype=c.dtype, device=c.device)
        keep[M - 1] = 0
        if epi == "rowdiv":
            return keep * c / r[:M, None], None
        return keep * r[:M, None] * c + r[M:2 * M, None] * v[None, :N], None
    return c, None


def gemm(M, N, K, a, ta, b, tb, a2=None, b2=None, epi="store", cut=(), q=None, v=None, r=None,
         mx=None, step=0.0, tile="auto", splits=1):
    """One problem through `csrc/kron_dd.cu`'s grouped GEMM (the card's
    kernel test entry, `psgd_gemm_test`; no path calls it): (C, max|C| of
    the triu_max epilogue or None). The operands' row strides are their
    `ld`s; `tile` forces the 64 x 64 or the 128 x 128 instantiation; with
    `splits` > 1 the (splits, M, N) partial products of K's bands (store
    and triu epilogues). On CPU tensors, `gemm_plain`."""
    if not hopper.use_kernel(a):
        if splits > 1:
            raise ValueError("gemm: splits are the kernel's own")
        return gemm_plain(M, N, K, a, ta, b, tb, a2, b2, epi, q, v, r, mx, step)
    ops = [x for x in (a, b, a2, b2, q, v, r) if x is not None]
    hopper.check_operands("gemm", *ops)
    f = dict(dtype=torch.float32, device=a.device)
    c = torch.empty((splits, M, N) if splits > 1 else (M, N), **f)
    mxb = torch.zeros(1, dtype=torch.int32, device=a.device)
    if mx is not None:
        mxb = torch.tensor([float(mx)], **f).view(torch.int32)
    p = lambda x: x.data_ptr() if x is not None else None
    rc = _build.lib().psgd_gemm_test(
        M, N, K, p(a), int(ta), a.stride(0), p(b), int(tb), b.stride(0), p(a2), p(b2), p(c), p(q),
        p(v), p(r), p(mxb), float(step), EPI[epi], sum(CUT[x] for x in cut), TILES[tile], splits,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "gemm")
    return c, (mxb.view(torch.float32)[0] if epi == "triu_max" else None)
