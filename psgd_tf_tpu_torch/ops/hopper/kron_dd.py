"""K1/K2/K4/K5 device chain: the Kronecker factor update of a layer list.

Replaces `psgd_tf_tpu/ops/pallas/kron_dd.py` `fused_update` (:181),
`fused_update_batched` (:252) and `fused_update_multi` (:424). The CUDA
chain in `csrc/kron_dd.cu` updates a whole list of layers of kinds
dd/ds/nd/ns in its stages (balance, K3, arrow pre-pass, grouped GEMMs,
reductions, factor rewrites): a fixed chain of grouped launches, or, for a
list with a sparse side (`route`), the same stage bodies in one
cooperative launch with the same bits (`forced_route` picks either for the
tests and timing tools). `fused_update` here
is its single (dense, dense) layer entry point (K2), `fused_update_multi`
its (dense, dense) list entry point (K20), `kron_sparse.fused_update_*` its
single sparse layer entry points (K5), and `kron_multi.fused_update_multi`
its list entry point of any kinds (K1). `fused_update_batched` (K4) runs
the same stages over a whole stacked (dense, dense) bucket in
`csrc/kron_batched.cu`: one chain a call at any B, its factors written
into their slots.

The plain versions follow `psgd_tf_tpu/groups/kron.py` `_update_dd`
(:107-119) and `_update_dd_padded` (:541-561): triangular solves and plain
matmuls. They are the CPU path and the oracles the kernels are checked
against on the card.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

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
# the chain's routes (ROUTE_* in csrc/kron_dd.cu): the fixed chain of
# grouped launches, or the same stage bodies in one cooperative launch
ROUTE_CODE = {None: 0, "chain": 1, "mono": 2}
MONO_MAX_MFLOP = 1400  # KRON_MONO_MAX_MFLOP in csrc/kron_dd.cu (its note has the sweep)
_forced: str | None = None


@contextlib.contextmanager
def forced_route(route: str):
    """Run every list of the chain (K1, K2, K5, K20) on `route`, 'chain' or
    'mono', inside this context, instead of `route()`'s pick: for the card
    tests and the timing tools; no path uses it. A list whose products take
    the chain's 128 x 128 tiles raises under 'mono'. K4 has one route, its
    stacked chain, and takes no part."""
    global _forced
    if route not in ("chain", "mono"):
        raise ValueError(f"forced_route: 'chain' or 'mono', got {route!r}")
    prev, _forced = _forced, route
    try:
        yield
    finally:
        _forced = prev


def _factor_shapes(kind: str, m: int, n: int):
    left = (2, m) if kind in ("nd", "ns") else (m, m)
    right = (n,) if kind in ("ds", "ns") else (n, n)
    return left, right


def chain_flops(kinds, ms, ns) -> float:
    """The chain's products in FLOPs (2 M N K a product, the triangular
    bands counted whole), as `csrc/kron_dd.cu` `chain_flops` counts them."""
    f = 0.0
    for k, m, n in zip(kinds, ms, ns, strict=True):
        m, n = float(m), float(n)
        if k == "dd":
            f += 8 * m * n * (m + n) + 2 * (m**3 + n**3)
        elif k == "ds":
            f += 8 * m * m * n + 2 * m**3
        elif k == "nd":
            f += 8 * m * n * n + 2 * n**3
    return f


def route(kinds, ms, ns, sms: int = 132) -> str:
    """The route `csrc/kron_dd.cu` `run_chain` picks for one list of at
    most MAX_LAYERS layers (K4 takes no route: its stacked chain is one):
    'mono', the one cooperative launch, where the sweep of
    `tools/kron_gemm_ab.py --route` measured it faster on the card: a list
    with a sparse side (a layer of kind ds, nd or ns), every GEMM stage of
    the chain in the 64 x 64 tiles on a card of `sms` SMs (fewer than
    4 sms tiles of 128 x 128 a stage) and its products at most
    MONO_MAX_MFLOP MFLOP (the largest such list measured, K5 nd at
    (512, 512), 1,342); else 'chain' (lists of dense sides alone measured
    slower on one launch, LeNet5's by 6%)."""
    def tiles128(shapes):
        return sum(-(-a // 128) * -(-b // 128) for a, b in shapes)

    mn = [(m, n) for k, m, n in zip(kinds, ms, ns, strict=True) if k != "ns"]
    stages = [[s for s in mn for _ in range(2)],                             # c1
              [(m, n) for k, m, n in zip(kinds, ms, ns) if k == "dd" for _ in range(2)],
              [(m, m) for k, m in zip(kinds, ms) if k in ("dd", "ds")]
              + [(n, n) for k, n in zip(kinds, ns) if k in ("dd", "nd")]]   # c3 (d: the same)
    tiles64 = all(tiles128(s) < 4 * sms for s in stages)
    sparse = any(k != "dd" for k in kinds)
    return ("mono" if sparse and tiles64 and chain_flops(kinds, ms, ns) <= MONO_MAX_MFLOP * 1e6
            else "chain")


def _count(counter: str, kinds, chains: int, monos: int) -> None:
    """`chains` chains of `counter`, `monos` of them one launch each
    ('kron_mono'); the others launch K3 on their own ('tri'), unless the
    list has no dense factor (ns layers alone)."""
    hopper.counts[counter] += chains
    hopper.counts["kron_mono"] += monos
    if any(k != "ns" for k in kinds):
        hopper.counts["tri"] += chains - monos


@functools.lru_cache(maxsize=512)
def _plan(kinds: tuple, lefts: tuple, rights: tuple, probes: tuple, dgs: tuple):
    """Per list of kinds and shapes, checked once: (kind codes and sides as
    the C entry's descriptor takes them, scratch floats)."""
    for kind, left, right, p, g in zip(kinds, lefts, rights, probes, dgs, strict=True):
        m, n = p
        if (left, right) != _factor_shapes(kind, m, n) or g != p:
            raise ValueError(f"kron_dd: {kind} shapes Ql {left}, Qr {right}, dX {p}, dG {g} "
                             "do not agree")
    lib = _build.lib()
    codes = [KIND_CODE[k] for k in kinds]
    ms, ns = [p[0] for p in probes], [p[1] for p in probes]
    floats = lib.psgd_kron_multi_scratch_floats(len(kinds), _build.int_array(codes),
                                                _build.int_array(ms), _build.int_array(ns))
    return [(c, m, n) for c, m, n in zip(codes, ms, ns)], floats


def launch(kinds, qls, qrs, dxs, dgs, step: float, counter: str):
    """Run the CUDA chain on up to MAX_LAYERS layers of the given kinds, on
    the route `route()` picks (or `forced_route`'s); returns the lists of
    new factors. `counter` names the entry point whose call this is (K1, K2,
    K5 or K20)."""
    L = len(qls)
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"kron_dd chain takes 1..{MAX_LAYERS} layers, got {L}")
    sides, floats = _plan(tuple(kinds), tuple(q.shape for q in qls), tuple(q.shape for q in qrs),
                          tuple(x.shape for x in dxs), tuple(g.shape for g in dgs))
    dev = qls[0].device
    operands = (*qls, *qrs, *dxs, *dgs)
    if not all(t.dtype is torch.float32 and t.is_contiguous() and t.device == dev
               for t in operands):
        hopper.check_operands(counter, *operands)  # raises, naming the operand
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    new_qls = [torch.empty_like(q) for q in qls]
    new_qrs = [torch.empty_like(q) for q in qrs]
    desc = []
    for side, *ts in zip(sides, qls, qrs, dxs, dgs, new_qls, new_qrs):
        desc += side
        desc += [t.data_ptr() for t in ts]
    desc = (ctypes.c_longlong * (len(desc) + 1))(*desc)
    rc = _build.lib().psgd_kron_multi_update(
        L, desc, float(step), scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        ROUTE_CODE[_forced])
    _build.check(rc, f"{counter} kernel chain")
    _count(counter, kinds, 1, int(desc[9 * L] == ROUTE_CODE["mono"]))
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
    `chunk_layers` :360), each chain counted under 'kron_dd_multi' (and
    under 'kron_mono' or, for its own K3 launch, 'tri'). `step` is a Python
    number."""
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


@functools.lru_cache(maxsize=64)
def _stack_plan(B: int, S: int, T: int, ms: tuple, ns: tuple, device: torch.device):
    """K4's plan of one bucket on `device`'s card, made once: (its table on
    the card, the sides as C int arrays, the scratch's floats, the kernels
    a call launches)."""
    if len(ms) != B or len(ns) != B or not all(1 <= m <= S for m in ms) or not all(
            1 <= n <= T for n in ns):
        raise ValueError(f"kron_dd_batched: sides {list(ms)} x {list(ns)} do not fit a stack of "
                         f"{B} ({S}, {T}) slots")
    lib = _build.lib()
    mi, ni = _build.int_array(ms), _build.int_array(ns)
    sizes = (ctypes.c_size_t * 3)()
    with torch.cuda.device(device):
        _build.check(lib.psgd_kron_batched_plan(B, S, T, mi, ni, None, sizes), "kron_dd_batched plan")
        table = (ctypes.c_int * sizes[0])()
        lib.psgd_kron_batched_plan(B, S, T, mi, ni, table, sizes)
    return (torch.tensor(list(table), dtype=torch.int32, device=device), mi, ni, sizes[1],
            sizes[2])


def batched_launches(ms, ns, S: int, T: int, device="cuda") -> int:
    """The kernels one K4 call launches on a bucket of sides (ms, ns) in
    (S, T) slots: balance, K3, and one or two a GEMM stage, 6 to 10
    whatever B (`csrc/kron_batched.cu` picks each stage's tiles)."""
    ms, ns = tuple(int(m) for m in ms), tuple(int(n) for n in ns)
    return _stack_plan(len(ms), S, T, ms, ns, torch.device(device))[4]


def fused_update_batched(ql, qr, dx, dg, ms, ns, step):
    """K4: the update of B stacked (dense, dense) layers of one padded
    bucket, ql (B, S, S), qr (B, T, T), dx and dg (B, S, T) (S and T at
    most 32,768 on the card), layer i's true sides (ms[i], ns[i]) given as
    host ints or a CPU int tensor. Returns the
    new (B, S, S) and (B, T, T) stacks, padding exact identity; the inputs
    are not written. The plain version for CPU tensors; for CUDA tensors
    one chain of `csrc/kron_batched.cu` over the whole stack at any B (its
    K3 among its launches), counted once under 'kron_dd_batched' and once
    under 'tri'. `step` is a Python number."""
    if not hopper.use_kernel(ql):
        return update_batched_plain(ql, qr, dx, dg, ms, ns, step)
    ms, ns = tuple(_host_sizes(ms, "ms")), tuple(_host_sizes(ns, "ns"))
    B, S, T = ql.shape[0], ql.shape[1], qr.shape[1]
    if (ql.shape != (B, S, S) or qr.shape != (B, T, T) or dx.shape != (B, S, T)
            or dg.shape != (B, S, T)):
        raise ValueError(
            f"kron_dd_batched: shapes Ql {tuple(ql.shape)}, Qr {tuple(qr.shape)}, "
            f"dX {tuple(dx.shape)}, dG {tuple(dg.shape)} do not agree")
    hopper.check_operands("kron_dd_batched", ql, qr, dx, dg)
    table, mi, ni, floats, _ = _stack_plan(B, S, T, ms, ns, ql.device)
    scratch = torch.empty(floats, dtype=torch.float32, device=ql.device)
    new_ql, new_qr = torch.empty_like(ql), torch.empty_like(qr)
    rc = _build.lib().psgd_kron_dd_batched_update(
        B, S, T, ql.data_ptr(), qr.data_ptr(), dx.data_ptr(), dg.data_ptr(), new_ql.data_ptr(),
        new_qr.data_ptr(), mi, ni, table.data_ptr(), float(step), scratch.data_ptr(),
        torch.cuda.current_stream(ql.device).cuda_stream,
    )
    _build.check(rc, "kron_dd_batched kernel chain")
    hopper.counts["kron_dd_batched"] += 1
    hopper.counts["tri"] += 1
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
